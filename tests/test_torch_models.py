"""Parity of the port's model stack and its two split-executor kernels'
plain versions with the JAX package, on the CPU.

Configs field for field, ``transformer_profile`` tables bit-equal, the
layers (``rms_norm``, rope, each attention ``impl``, ``mlp_block``), the
plain versions of the ``flash_attention`` and ``stage_mlp_block`` kernels
against the Pallas kernels in interpret mode (as ``tests/test_kernels.py``
runs them), and ``forward`` / ``loss_fn`` / the optimizer. Inputs are
numpy draws from a seed; params are drawn by the JAX package and carried
with ``weights.model_params_from_jax``.

Tolerances: f32 ``rtol 2e-5`` for layers and the model (the JAX package's
own f32 gate), gradients leaf-scale (``atol = rtol * max|ref|``, as
``tests/test_pipeline_schedule.py`` holds them); ``flash_attention`` f32
``atol 1e-5`` and bf16 ``2e-2``; ``stage_mlp_block`` from the measured
error (see ``STAGE_ATOL``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import profiles as JP  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.stage_block import stage_mlp_block as jax_stage  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core import profiles as TP  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import stage_block as SB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402

RTOL = 2e-5
ARCHS = ("stablelm-1.6b", "qwen2.5-3b")  # untied MHA-ish / tied GQA + bias


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a, np.float32)))
    return t if dtype is None else t.to(dtype)


def _close(port, ref, rtol=RTOL, what=""):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _params(cfg, seed=0):
    jp = JM.init_params(jax.random.PRNGKey(seed), cfg)
    return jp, W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------------------
# configs and profiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_configs_match_field_for_field(arch):
    ref, port = JC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.pattern == ref.pattern
    assert TC.ARCH_IDS == JC.ARCH_IDS


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_transformer_profile_is_bit_equal(arch):
    """Every zoo arch (dense, MoE, SSM, hybrid): the float64 host tables
    and the kind column are bit-equal, as is the derived ProfileTable."""
    for batch, seq in ((1, 128), (2, 2048)):
        ref = JP.transformer_profile(JC.get_config(arch), batch, seq)
        port = TP.transformer_profile(TC.get_config(arch), batch, seq)
        assert port.name == ref.name
        for field in ("param_bytes", "act_bytes", "grad_bytes", "fwd_flops",
                      "bwd_flops", "leak_value", "state_bytes", "kind"):
            a, b = getattr(port, field), getattr(ref, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert TP.profile_digest(port) == JP.profile_digest(ref)
        cfg = TC.get_config(arch)
        assert [TP.block_kind(cfg, i) for i in range(cfg.num_layers)] == [
            JP.block_kind(JC.get_config(arch), i) for i in range(cfg.num_layers)]
    np.testing.assert_array_equal(TP.get_profile(arch, 1, 64).fwd_flops,
                                  JP.get_profile(arch, 1, 64).fwd_flops)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    for dt, jdt, rtol in ((torch.float32, jnp.float32, RTOL),
                          (torch.bfloat16, jnp.bfloat16, 1e-2)):
        ref = JL.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w))
        port = TL.rms_norm(_t(x, dt), _t(w))
        _close(port.float().numpy(), np.asarray(ref, np.float32), rtol)
    pos = np.arange(9)
    for theta in (1e4, 1e6):
        jc, js = JL.rope_angles(jnp.asarray(pos), 64, theta)
        tc, ts = TL.rope_angles(torch.from_numpy(pos), 64, theta)
        _close(tc.numpy(), jc)
        _close(ts.numpy(), js)
        _close(TL.apply_rope(_t(x), tc, ts).numpy(),
               JL.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("window", [None, 8])
def test_dense_and_chunked_attention(window):
    """GQA, ragged chunks, a window: the port's dense and chunked paths
    against the reference's."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 37, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 37, 2, 16)).astype(np.float32)
    ref = JL.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_offset=0, window=window)
    _close(TL.dense_attention(_t(q), _t(k), _t(v), q_offset=0,
                              window=window).numpy(), ref)
    refc = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                window=window, q_chunk=16, kv_chunk=8)
    _close(TL.chunked_attention(_t(q), _t(k), _t(v), window=window,
                                q_chunk=16, kv_chunk=8).numpy(), refc)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["auto", "dense", "chunked", "pallas"])
def test_attention_apply_each_impl(arch, impl):
    cfg = JC.get_config(arch).reduced()
    jp = JL.init_attention(jax.random.PRNGKey(3), cfg)
    tp = W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    if cfg.qkv_bias:  # non-zero biases, so the bias path is exercised
        rng = np.random.default_rng(4)
        for name in ("bq", "bk", "bv"):
            b = (0.1 * rng.standard_normal(jp[name].shape)).astype(np.float32)
            jp[name], tp[name] = jnp.asarray(b), _t(b)
    x = np.random.default_rng(5).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24)
    ref, _ = JL.attention_apply(jp, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
                                impl=impl)
    with torch.no_grad():
        port, _ = TL.attention_apply(tp, _t(x), TC.get_config(arch).reduced(),
                                     positions=torch.from_numpy(pos), impl=impl)
    _close(port.numpy(), ref)


@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu2", "silu"])
def test_mlp_block(activation):
    jp = JL.init_mlp(jax.random.PRNGKey(0), 64, 96, activation)
    tp = W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    nw = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    x = rng.standard_normal((3, 11, 64)).astype(np.float32)
    ref = JL.mlp_block(jnp.asarray(nw), jp, jnp.asarray(x), activation)
    _close(TL.mlp_block(_t(nw), tp, _t(x), activation).numpy(), ref)


# ---------------------------------------------------------------------------
# the two kernels' plain versions (what the wrappers run on CPU tensors)
# ---------------------------------------------------------------------------

# test_kernels.py's FLASH_SHAPES, plus a q_offset case:
# (B, Sq, Skv, H, KH, hd, window, q_blk, kv_blk, q_offset)
FLASH_CASES = [
    (1, 128, 128, 2, 2, 32, None, 64, 64, 0),
    (2, 256, 256, 4, 2, 64, None, 128, 128, 0),
    (1, 200, 200, 4, 1, 32, None, 64, 64, 0),  # ragged seq, MQA
    (2, 256, 256, 8, 2, 64, 64, 64, 64, 0),  # sliding window
    (1, 512, 512, 2, 2, 16, 128, 128, 64, 0),  # window, uneven blocks
    (2, 32, 128, 4, 2, 32, None, 32, 64, 96),  # queries at offset 96
    (1, 64, 64, 6, 2, 192, None, 32, 32, 0),  # Nemotron-4-340B's head dim
    (1, 72, 72, 4, 2, 80, None, 32, 32, 0),  # padded to 96 on the card
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax_kernel(case, dtype):
    b, sq, skv, h, kh, hd, win, qb, kb, off = case
    rng = np.random.default_rng(sq + h)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, kh, hd)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                    window=win, q_blk=qb, kv_blk=kb, q_offset=off, interpret=True)
    with torch.no_grad():
        port = FA.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                                  window=win, q_offset=off)
    assert port.dtype == tdt and tuple(port.shape) == (b, sq, h, hd)
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=atol)


@pytest.mark.parametrize("hd", [8, 48, 80, 100, 160, 192, 250])
def test_flash_attention_pad_and_slice_keeps_the_function(hd):
    """The wrapper's rewrite for head dims the kernel is not built for:
    zero-padding q, k and v to the next instantiated width and scoring
    with the true head dim's scale gives the plain version's output in
    the first hd columns and exact zeros in the rest."""
    assert FA.padded_head_dim(hd) == min(w for w in FA.HEAD_DIMS if w >= hd)
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 40, 4, hd), (2, 40, 2, hd), (2, 40, 2, hd)))
    qp, kp, vp, width = FA.pad_head_dim(q, k, v)
    assert width == FA.padded_head_dim(hd) and qp.shape[-1] == width
    ref = FA.flash_attention_ref(q, k, v, window=16)
    out = FA.flash_attention_ref(qp, kp, vp, window=16, scale=1.0 / np.sqrt(hd))
    np.testing.assert_allclose(out[..., :hd].numpy(), ref.numpy(), atol=1e-6, rtol=1e-6)
    assert float(out[..., hd:].abs().max() if width > hd else 0.0) == 0.0
    with pytest.raises(ValueError):
        FA.padded_head_dim(272)


def test_flash_attention_wrapper_refuses_gradients_and_counts_no_cpu_launch():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16)
    before = FA.launches
    with pytest.raises(RuntimeError):
        FA.flash_attention(q, k, k)
    with torch.no_grad():
        FA.flash_attention(q, k, k)
    assert FA.launches == before


# test_kernels.py's STAGE_SHAPES: (B, S, D, F)
STAGE_SHAPES = [(1, 32, 64, 128), (2, 48, 64, 160), (3, 37, 128, 96)]
# measured max |port - jax| over these 24 cases (|out| up to ~9): f32
# 2.9e-6 (reassociated f32 sums); bf16 7.8e-3, one bf16 ulp at |out| ~ 2,
# on < 0.01% of the elements, where a reassociated f32 sum lands on the
# other side of a bf16 rounding. Limits: f32 1e-5; bf16 one ulp at the
# largest outputs (|out| in [4, 8): 3.2e-2)
STAGE_ATOL = {"float32": 1e-5, "bfloat16": 3.2e-2}


def _stage_inputs(shape, activation, seed=0):
    b, s, d, f = shape
    jp = JL.init_mlp(jax.random.PRNGKey(seed), d, f, activation)
    rng = np.random.default_rng(seed + 1)
    nw = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    return jp, nw, x


@pytest.mark.parametrize("shape", STAGE_SHAPES)
@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu2", "silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_mlp_block_plain_matches_jax_kernel(shape, activation, dtype):
    jp, nw, x = _stage_inputs(shape, activation)
    tp = W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_stage(jnp.asarray(nw), jp, jnp.asarray(x, jdt),
                    activation=activation, blk=32, interpret=True)
    with torch.no_grad():
        port = SB.stage_mlp_block(_t(nw), tp, _t(x, tdt), activation=activation)
    assert port.dtype == tdt
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=STAGE_ATOL[dtype])


@pytest.mark.parametrize("activation", ["swiglu", "relu2"])
def test_stage_mlp_block_grads_match_jax_vjp(activation):
    """Gradients through the wrapper (autograd of mlp_block) against JAX's
    custom VJP of the kernel, leaf-scale rtol 1e-5."""
    jp, nw, x = _stage_inputs((2, 48, 64, 160), activation, seed=3)
    gy = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda n, p, xx: jax_stage(n, p, xx, activation=activation,
                                                blk=32, interpret=True),
                     jnp.asarray(nw), jp, jnp.asarray(x))
    gn, gp, gx = vjp(jnp.asarray(gy))
    tp = {k: v.requires_grad_(True) for k, v in
          W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu").items()}
    tn, tx = _t(nw).requires_grad_(True), _t(x).requires_grad_(True)
    out = SB.stage_mlp_block(tn, tp, tx, activation=activation)
    names = sorted(tp)
    grads = torch.autograd.grad(out, [tn, tx] + [tp[k] for k in names], _t(gy))
    _close(grads[0].numpy(), gn, 1e-5, "norm_w")
    _close(grads[1].numpy(), gx, 1e-5, "x")
    for k, g in zip(names, grads[2:]):
        _close(g.numpy(), gp[k], 1e-5, k)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _batch(cfg, rows, seq, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_forward_and_loss_match_jax(arch, impl):
    """f32 compute: logits and loss at ``impl`` auto and pallas; gradients
    at auto (the pallas attention is forward-only on both sides)."""
    cfg = JC.get_config(arch).reduced()
    tcfg = TC.get_config(arch).reduced()
    jp, tp = _params(cfg)
    tok, lab = _batch(cfg, 2, 24)

    def jloss(p):
        logits, _, _ = JM.forward(p, jnp.asarray(tok), cfg, impl=impl,
                                  compute_dtype=jnp.float32)
        return JM.softmax_xent(logits, jnp.asarray(lab)), logits

    (lref, logits_ref), gref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp) \
        if impl == "auto" else (jax.jit(jloss)(jp), None)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()}
    with torch.no_grad():
        logits, _, _ = TM.forward(tp, batch["tokens"], tcfg, impl=impl,
                                  compute_dtype=torch.float32)
        _, (loss, aux) = TM.loss_fn(tp, batch, tcfg, impl=impl,
                                    compute_dtype=torch.float32)
    _close(logits.numpy(), logits_ref)
    _close(float(loss), float(lref))
    assert float(aux) == 0.0
    if impl == "auto":
        (_, (loss2, _)), grads = TM.loss_and_grads(tp, batch, tcfg,
                                                   compute_dtype=torch.float32)
        _close(float(loss2), float(lref))
        gnp = W.model_params_to_numpy(grads)
        jax.tree_util.tree_map_with_path(
            lambda path, a, b: _close(b, a, RTOL, jax.tree_util.keystr(path)),
            jax.tree.map(np.asarray, gref), gnp)
    else:
        with pytest.raises(RuntimeError):
            TM.loss_and_grads(tp, batch, tcfg, impl="pallas",
                              compute_dtype=torch.float32)


def test_bf16_loss_fn_matches_jax_default():
    """The reference's default bf16 compute: the loss agrees to bf16
    rounding (``rtol 1e-2``)."""
    cfg = JC.get_config("qwen2.5-3b").reduced()
    jp, tp = _params(cfg, seed=1)
    tok, lab = _batch(cfg, 2, 24, seed=1)
    _, (lref, _) = JM.loss_fn(jp, {"tokens": jnp.asarray(tok),
                                   "labels": jnp.asarray(lab)}, cfg)
    with torch.no_grad():
        _, (loss, _) = TM.loss_fn(tp, {"tokens": torch.from_numpy(tok).long(),
                                       "labels": torch.from_numpy(lab).long()},
                                  TC.get_config("qwen2.5-3b").reduced())
    np.testing.assert_allclose(float(loss), float(lref), rtol=1e-2)


def test_model_refuses_unported_blocks():
    """Every block kind is ported (attention, Mamba, dense MLP, MoE, and
    hybrid periods), and so are the caches of serving
    (``tests/test_torch_cache.py``) and the modality frontends (held to
    the reference in ``tests/test_torch_frontends.py``): the frontend
    configs build, and their features are prepended."""
    tok = torch.zeros((1, 4), dtype=torch.long)
    for arch in ("pixtral-12b", "musicgen-large"):
        fcfg = TC.get_config(arch).reduced()
        fp = TM.init_params(torch.Generator().manual_seed(0), fcfg, device="cpu")
        d_in = fp["frontend"]["proj"].shape[0]
        with torch.no_grad():
            logits, _, _ = TM.forward(fp, tok, fcfg,
                                      frontend_feats=torch.zeros((1, 2, d_in)))
        assert logits.shape == (1, 6, fcfg.vocab_size)
    cfg = TC.get_config("qwen2.5-3b").reduced()
    tp = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    caches = TM.init_caches(cfg, 1, 8, dtype=torch.float32, device="cpu")
    logits, new, _ = TM.forward(tp, tok, cfg, caches=caches, cache_index=0,
                                compute_dtype=torch.float32)
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert new[0]["k"].shape == caches[0]["k"].shape


def test_init_params_has_the_reference_layout():
    for arch in ARCHS:
        cfg = JC.get_config(arch).reduced()
        jshape = jax.tree.map(lambda a: a.shape, jax.eval_shape(
            lambda: JM.init_params(jax.random.PRNGKey(0), cfg)))
        tp = TM.init_params(torch.Generator().manual_seed(0),
                            TC.get_config(arch).reduced(), device="cpu")
        tshape = jax.tree.map(lambda a: tuple(a.shape), W.model_params_to_numpy(tp))
        assert tshape == jshape


def test_optimizer_matches_jax():
    """adamw with a warmup-cosine lr and global-norm clipping, three steps
    from the same params and grads: params and moments rtol 1e-6."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": (rng.standard_normal(3)).astype(np.float32)}
    grads = [{k: (3 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jopt = JO.adamw(JO.linear_warmup_cosine(1e-2, 2, 10), weight_decay=0.1,
                    max_grad_norm=1.0)
    topt = TO.adamw(TO.linear_warmup_cosine(1e-2, 2, 10), weight_decay=0.1,
                    max_grad_norm=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = JO.apply_updates(jp, ju)
        tu, ts = topt.update({k: _t(v) for k, v in g.items()}, ts, tp)
        tp = TO.apply_updates(tp, tu)
    for k in params:
        _close(tp[k].numpy(), jp[k], 1e-6, k)
        _close(ts.mu[k].numpy(), js.mu[k], 1e-6, k)
    assert int(ts.step) == int(js.step) == 3
    for step in range(12):
        s = jnp.asarray(step, jnp.int32)
        _close(float(TO.cosine_schedule(1.0, 8)(torch.tensor(step, dtype=torch.int32))),
               float(JO.cosine_schedule(1.0, 8)(s)), 1e-6)
    g = {k: _t(v) for k, v in grads[0].items()}
    _close(float(TO.global_norm(g)),
           float(JO.global_norm(jax.tree.map(jnp.asarray, grads[0]))), 1e-6)


def test_model_weights_round_trip():
    cfg = JC.get_config("qwen2.5-3b").reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    np_p = jax.tree.map(np.asarray, jp)
    back = W.model_params_to_numpy(W.model_params_from_jax(np_p, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, np_p)
    opt = JO.adamw(1e-3).init(jp)
    topt = W.model_opt_state_from_jax(jax.tree.map(np.asarray, opt), "cpu")
    assert topt.step.dtype == torch.int32
    back = W.model_opt_state_to_numpy(topt)
    jax.tree.map(np.testing.assert_array_equal, tuple(back),
                 tuple(jax.tree.map(np.asarray, opt)))
