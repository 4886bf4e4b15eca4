"""Parity of the port's SAC update path with the JAX package's.

A replay batch of real uniform-policy transitions is rolled out by the
JAX engine, carried to the port as numpy arrays, and fed to both sides
with the JAX agent's parameters and AdamW state (``repro_torch.weights``).
The JAX side takes ``ca_impl="pallas"`` (the kernel in interpret mode, as
on the CPU) or ``"ref"``; the port has one route, the kernel wrapper,
which on CPU tensors runs the plain version.

Tolerances: ``joint_loss`` value and gradients ``rtol 2e-5`` (as
``tests/test_update_path.py``); after 8 update steps parameters
``rtol 1e-4``; state keys and Gumbel-max samples bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.core.agents import action_space as JA  # noqa: E402
from repro.core.agents import rollout as JR  # noqa: E402
from repro.core.agents import sac as JSAC  # noqa: E402
from repro.core.agents.loops import _pack_obs_keys_np, _sac_example, _SAC_FIELDS  # noqa: E402
from repro.core.env import MHSLEnv as JEnv  # noqa: E402
from repro.core.profiles import resnet101_profile  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core.agents import action_space as TA  # noqa: E402
from repro_torch.core.agents import rollout as TR  # noqa: E402
from repro_torch.core.agents import sac as TSAC  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


def _tt(tree):
    """numpy tree -> torch tree (copies: JAX hands out read-only arrays)."""
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


SMALL = dict(hidden=32, feat_dim=8, attn_dim=8, batch=16)


@pytest.fixture(scope="module")
def env():
    return JEnv(profile=resnet101_profile(batch=1))


@pytest.fixture(scope="module")
def replay(env):
    """JAX params + a 512-slot buffer of real uniform-policy transitions,
    as numpy trees."""
    cfg = JSAC.SACConfig(**SMALL)
    buf = JR.buffer_init(512, _sac_example(env, cfg))
    rollout = JR.make_batched_rollout(env, JR.uniform_policy(env.action_dims),
                                      cfg.hist_len)
    st0 = JR.make_batched_reset(env)(jax.random.split(jax.random.PRNGKey(5), 6))
    _, traj = rollout(None, st0, jax.random.split(jax.random.PRNGKey(6), 6))
    buf = JR.buffer_add(buf, JR.flatten_transitions(traj, _SAC_FIELDS))
    size = int(buf.size)
    return jax.tree.map(lambda x: np.asarray(x)[:size], buf.data), np.asarray(traj["obs"])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(got, want, rtol, atol=1e-6, what=""):
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, w in flat_w:
        g = got
        for p in path:
            g = g[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_allclose(g.detach().cpu().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("use_icm,use_ca,impl", [
    (True, True, "pallas"), (True, True, "ref"),
    (False, True, "ref"), (True, False, "ref"),
])
def test_joint_loss_and_grads_match_jax(env, replay, use_icm, use_ca, impl):
    data, _ = replay
    dims = env.action_dims
    jcfg = JSAC.SACConfig(**SMALL, use_icm=use_icm, use_ca=use_ca, ca_impl=impl)
    tcfg = TSAC.SACConfig(**SMALL, use_icm=use_icm, use_ca=use_ca)
    params = JSAC.init_agent(jax.random.PRNGKey(0), env.obs_dim, dims, jcfg)
    idx = np.random.default_rng(0).integers(0, len(data["obs"]), jcfg.batch)
    batch = jax.tree.map(lambda x: x[idx], data)

    (jl, jm), jg = jax.jit(lambda p, b: jax.value_and_grad(
        JSAC.joint_loss, has_aux=True)(p, b, dims, jcfg))(params, batch)
    tparams = W.sac_params_from_jax(_np(params), "cpu")
    tbatch = _tt(batch)
    tl, tm, tg = TSAC.loss_and_grads(tparams, tbatch, dims, tcfg)

    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   atol=1e-7, err_msg=k)
    _close_tree(tg, jg, rtol=2e-5, atol=1e-6, what="grad")
    if use_ca:
        np.testing.assert_array_equal(tg["actor"]["ca"]["wq_h"].numpy(), 0.0)


def test_eight_update_steps_match_jax(env, replay):
    """8 consecutive joint updates from the same params, AdamW state and
    replay-index matrix: parameters and AdamW moments agree at rtol 1e-4."""
    data, _ = replay
    dims = env.action_dims
    jcfg = JSAC.SACConfig(**SMALL, ca_impl="pallas")
    tcfg = TSAC.SACConfig(**SMALL)
    params = JSAC.init_agent(jax.random.PRNGKey(1), env.obs_dim, dims, jcfg)
    jupd, jinit = JSAC.make_update(dims, jcfg)
    jopt = jinit(params)
    tupd, _ = TSAC.make_update(dims, tcfg)
    tparams = W.sac_params_from_jax(_np(params), "cpu")
    topt = W.sac_opt_state_from_jax(_np(jopt), "cpu")

    idx = np.random.default_rng(2).integers(0, len(data["obs"]), (8, jcfg.batch))
    tbuf = TR.BufferState(data=_tt(data), size=len(data["obs"]))
    for row in idx:
        params, jopt, jm = jupd(params, jopt, jax.tree.map(lambda x: x[row], data))
        tparams, topt, tm = tupd(tparams, topt,
                                 TR.buffer_gather(tbuf, torch.from_numpy(row)))
    _close_tree(tparams, _np(params), rtol=1e-4, atol=1e-6, what="params")
    for head in ("actor", "critic", "icm"):
        assert int(topt[head].step) == int(jopt[head].step) == 8
        _close_tree(topt[head].mu, _np(jopt[head].mu), rtol=1e-4, atol=1e-5,
                    what=f"mu {head}")
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)


def test_pack_obs_keys_bit_equal(replay):
    """32-bit key packing: the port's int64-masked lanes are bit-equal to
    the reference's uint32 lanes and host keys, negative bins included."""
    _, obs = replay
    obs = np.concatenate([obs, -obs], axis=0)
    lanes = TR.pack_obs_keys(torch.from_numpy(obs)).numpy()
    np.testing.assert_array_equal(lanes, np.asarray(JR.pack_obs_keys(obs)).astype(np.int64))
    combined = (lanes[..., 0].astype(np.uint64) << np.uint64(32)) | lanes[..., 1].astype(np.uint64)
    np.testing.assert_array_equal(combined, _pack_obs_keys_np(obs))


def test_action_space_matches_jax(env, replay):
    """Masked logits, log-prob, entropy and the Gumbel-max sample: JAX's
    categorical draw equals the port's argmax(logits + g) on JAX's own
    Gumbel noise."""
    data, _ = replay
    dims = env.action_dims
    rng = np.random.default_rng(3)
    n = 24
    masks = jax.tree.map(lambda x: x[:n], data["masks"])
    action = jax.tree.map(lambda x: x[:n], data["action"])
    raw = {k: rng.standard_normal((n, dims[k])).astype(np.float32)
           for k in ("u", "size", "p_tx", "p_d")}
    raw["decoys"] = rng.standard_normal((n, dims["decoys"], 2)).astype(np.float32)
    jl = JA.masked_logits(raw, masks)
    tl = TA.masked_logits(_tt(raw), _tt(masks))
    _close_tree(tl, _np(jl), rtol=1e-6, what="logits")
    tact = _tt(action)
    np.testing.assert_allclose(TA.log_prob(tl, tact).numpy(),
                               np.asarray(JA.log_prob(jl, action)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TA.entropy(tl).numpy(), np.asarray(JA.entropy(jl)),
                               rtol=1e-5, atol=1e-6)
    lp, ent = TA.log_prob_entropy(tl, tact)
    jlp, jent = JA.log_prob_entropy(jl, action)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(TA.onehot(tact, dims).numpy(),
                                  np.asarray(JA.onehot(action, dims)))

    key = jax.random.PRNGKey(9)
    ks = jax.random.split(key, 5)
    gumbel = _tt({name: jax.random.gumbel(k, jl[name].shape)
                  for name, k in zip(TA.HEADS, ks)})
    got = TA.sample(tl, gumbel)
    want = JA.sample(key, jl)
    for name in TA.HEADS:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                      err_msg=name)
