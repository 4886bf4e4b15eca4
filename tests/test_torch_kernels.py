"""Parity of the port's ``ca_attention`` with the JAX package's.

The JAX side runs as ``tests/test_kernels.py`` runs it on the CPU: the
Pallas kernel in interpret mode, and ``agents.attention``'s references.
On the CPU the port's wrapper takes its plain version
(``ca_attention_ref``), the function the CUDA kernel is held to on the
card by ``chip_smoke.py``. Inputs are drawn with numpy from a seed and
fed to both sides.

Tolerances: forward f32 ``atol 2e-5`` (the reference kernel test's);
gradients ``atol/rtol 2e-4`` with ``wq_h`` exactly zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.agents import attention as JATT  # noqa: E402
from repro.kernels.ops import ca_attention as jax_ca_attention  # noqa: E402
from repro_torch.core.agents import attention as TATT  # noqa: E402
from repro_torch.kernels import ca_attention as CA  # noqa: E402

# the shapes of test_kernels.py's CA parity test, then the SAC rollout's,
# the U 22 env's with a history of 16 (NetworkConfig(num_devices=22):
# obs_dim 76, pair_dim 132) and a wide attention:
# (batch, obs_dim, pair_dim, I, attn_dim, blk)
CA_SHAPES = [
    (1, 10, 14, 4, 8, 128),
    (7, 25, 51, 4, 64, 4),  # ragged batch, tiny blocks
    (128, 25, 51, 4, 64, 128),
    (130, 16, 32, 8, 32, 64),  # ragged vs block size, longer history
    (32, 28, 52, 4, 64, 128),  # the rollout's call
    (64, 76, 132, 16, 64, 64),  # U 22, hist_len 16
    (16, 28, 52, 8, 256, 16),  # C 256
]


def _inputs(b, obs_dim, pair_dim, i, c, seed=0):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(pair_dim)
    params = {
        "wq_s": rng.standard_normal((obs_dim, c)) / np.sqrt(obs_dim),
        "wq_h": rng.standard_normal((pair_dim, c)) * s,
        "wk": rng.standard_normal((pair_dim, c)) * s,
        "wv": rng.standard_normal((pair_dim, c)) * s,
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    obs = rng.standard_normal((b, obs_dim)).astype(np.float32)
    hist = rng.standard_normal((b, i, pair_dim)).astype(np.float32)
    mask = (rng.uniform(size=(b, i)) > 0.4).astype(np.float32)
    mask[0] = 0.0  # row with no history -> zero summary
    return params, obs, hist, mask


def _t(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("shape", CA_SHAPES)
def test_ca_attention_plain_matches_jax(shape):
    """Port forward (wrapper on CPU -> plain version, and the plain
    cross_attention / cross_attention_slim) vs JAX's Pallas kernel in
    interpret mode and JAX's cross_attention, incl. an all-masked row."""
    b, obs_dim, pair_dim, i, c, blk = shape
    params, obs, hist, mask = _inputs(b, obs_dim, pair_dim, i, c)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref = np.asarray(jax.vmap(lambda o, h, m: JATT.cross_attention(jp, o, h, m))(
        obs, hist, mask))
    jk = np.asarray(jax_ca_attention(jp, obs, hist, mask, blk=blk,
                                     interpret=True))

    tp, to, th, tm = _t(params), _t(obs), _t(hist), _t(mask)
    outs = {
        "wrapper": CA.ca_attention(tp, to, th, tm),
        "plain": CA.ca_attention_ref(to, th, tm, tp["wq_s"], tp["wk"], tp["wv"]),
        "cross_attention": TATT.cross_attention(tp, to, th, tm),
        "cross_attention_slim": TATT.cross_attention_slim(tp, to, th, tm),
    }
    for name, out in outs.items():
        out = out.numpy()
        np.testing.assert_allclose(out, jk, atol=2e-5, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5, err_msg=name)
        np.testing.assert_array_equal(out[0, obs_dim:], 0.0, err_msg=name)


def test_ca_attention_grads_match_jax():
    """The port's autograd.Function (slim-reference backward) reproduces
    JAX's custom-VJP gradients, ``wq_h`` exactly zero, and the obs/history
    gradients of JAX's full reference."""
    b, obs_dim, pair_dim, i, c = 16, 12, 20, 4, 16
    params, obs, hist, mask = _inputs(b, obs_dim, pair_dim, i, c, seed=3)
    tgt = np.random.default_rng(4).standard_normal((b, obs_dim + c)).astype(np.float32)

    def loss_jax(p, o, h):
        out = jax_ca_attention(p, o, h, mask, interpret=True)
        return jnp.sum((out - tgt) ** 2)

    def loss_ref(p, o, h):
        out = jax.vmap(lambda oo, hh, m: JATT.cross_attention(p, oo, hh, m))(
            o, h, mask)
        return jnp.sum((out - tgt) ** 2)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    gj = jax.grad(loss_jax, argnums=(0, 1, 2))(jp, obs, hist)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(jp, obs, hist)

    tp = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    to, th = _t(obs).requires_grad_(True), _t(hist).requires_grad_(True)
    loss = torch.sum((CA.ca_attention(tp, to, th, _t(mask)) - _t(tgt)) ** 2)
    loss.backward()
    for name in ("wq_s", "wk", "wv", "wq_h"):
        for ref in (gj[0][name], gr[0][name]):
            np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(ref),
                                       atol=2e-4, rtol=2e-4, err_msg=name)
    np.testing.assert_array_equal(tp["wq_h"].grad.numpy(), 0.0)
    for got, j, r in ((to.grad, gj[1], gr[1]), (th.grad, gj[2], gr[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(j), atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_ca_attention_low_precision_mask_safe(dtype):
    """finfo-based masking: fully masked rows stay finite (exact zeros) in
    bf16/fp16, and partial rows agree with the f32 result."""
    b, obs_dim, pair_dim, i, c = 9, 12, 20, 4, 16
    params, obs, hist, _ = _inputs(b, obs_dim, pair_dim, i, c, seed=5)
    mask = np.zeros((b, i), np.float32)
    mask[1:, :2] = 1.0
    tp, to, th, tm = _t(params), _t(obs), _t(hist), _t(mask)
    ref = CA.ca_attention(tp, to, th, tm).numpy()
    dt = getattr(torch, dtype)
    cast = {k: v.to(dt) for k, v in tp.items()}
    for fn in (CA.ca_attention, TATT.cross_attention, TATT.cross_attention_slim):
        out = fn(cast, to.to(dt), th.to(dt), tm.to(dt)).float().numpy()
        assert np.isfinite(out).all(), (fn.__name__, dtype)
        np.testing.assert_array_equal(out[0, obs_dim:], 0.0)
        np.testing.assert_allclose(out, ref, atol=0.15)


def test_ca_attention_wrapper_rejects_bad_inputs():
    """The wrapper checks shapes and device before any work; a tensor on
    a device other than cuda or cpu is refused (no fallback)."""
    params, obs, hist, mask = (_t(x) for x in _inputs(4, 6, 8, 4, 8))
    with pytest.raises(ValueError):
        CA.ca_attention(params, obs, hist[:, :, :5], mask)
    with pytest.raises(ValueError):
        CA.ca_attention(params, obs, hist, mask[:, :3])
    meta = {k: v.to("meta") for k, v in params.items()}
    with pytest.raises(TypeError):
        CA.ca_attention(meta, obs.to("meta"), hist.to("meta"), mask.to("meta"))
