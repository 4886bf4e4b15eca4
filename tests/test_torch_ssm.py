"""Parity of the port's Mamba-2 (SSD) block and the ``ssd_scan`` kernel's
plain version with the JAX package, on the CPU.

``ssd_chunked`` (ragged lengths and an initial state included) and the
plain ``ssd_scan`` against the Pallas kernel in interpret mode, on
``tests/test_kernels.py``'s ``SSD_SHAPES``; ``causal_conv1d`` and
``mamba_apply`` on both scan routes at ``mamba2-370m.reduced()`` widths;
the reduced model's forward, loss and gradients; a 2-stage 1F1B and
fill-drain step against ``jax.value_and_grad``. Inputs are numpy draws
from a seed; params are drawn by the JAX package and carried with
``weights.model_params_from_jax``. The JAX references are ``jax.jit``-ed.

Tolerances (f32): the scans leaf-scale ``SSD_RTOL`` (``atol = SSD_RTOL *
max|ref|``), set from the measured error: at most 1.8e-6 of max|ref|
(2.0e-4 at outputs up to 115, the Pallas kernel's and the plain
version's f32 sums taken in other orders); ``rtol 2e-5``
for the block, the model and the pipeline (gradients leaf-scale,
``atol = rtol * max|ref|``), the JAX package's own f32 gate. bf16 block
outputs ``rtol 2e-2`` leaf-scale (a bf16 ulp is 2^-8; the two frameworks
round the projections' f32 sums to bf16 after summing in other orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core import pipeline as TPIPE  # noqa: E402
from repro_torch.kernels import ssd_scan as SK  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

RTOL = 2e-5
SSD_RTOL = 1e-5
# (B, S, H, P, N, chunk): tests/test_kernels.py's SSD_SHAPES
SSD_SHAPES = [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 96, 2, 64, 128, 64),
    (1, 80, 1, 8, 4, 32),  # ragged
]
ARCH = "mamba2-370m"

_jit_chunked = jax.jit(JS.ssd_chunked, static_argnames=("chunk",))


def _close(port, ref, rtol=RTOL, what=""):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _ssd_inputs(shape, seed=0):
    b, s, h, p, n, _ = shape
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    a = (-np.exp(0.3 * rng.standard_normal(h))).astype(f)
    bm = rng.standard_normal((b, s, n)).astype(f)
    cm = rng.standard_normal((b, s, n)).astype(f)
    return x, dt, a, bm, cm


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(shape, with_h0):
    arrays = _ssd_inputs(shape)
    chunk = shape[-1]
    b, _, h, p, n, _ = shape
    h0 = (np.random.default_rng(1).standard_normal((b, h, p, n)).astype(np.float32)
          if with_h0 else None)
    yr, hr = _jit_chunked(*map(jnp.asarray, arrays), chunk=chunk,
                          h0=None if h0 is None else jnp.asarray(h0))
    y, hl = TS.ssd_chunked(*_t(*arrays), chunk=chunk,
                           h0=None if h0 is None else torch.from_numpy(h0))
    _close(y.numpy(), yr, SSD_RTOL)
    _close(hl.numpy(), hr, SSD_RTOL)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_plain_matches_jax_kernel(shape):
    """The kernel's plain version against the Pallas kernel in interpret
    mode, ``y`` and the final state; and the CPU wrapper takes it without
    counting a launch."""
    arrays = _ssd_inputs(shape, seed=2)
    chunk = shape[-1]
    yr, hr = jax_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    y, hl = SK.ssd_scan_ref(*_t(*arrays), chunk=chunk)
    _close(y.numpy(), yr, SSD_RTOL)
    _close(hl.numpy(), hr, SSD_RTOL)
    before = SK.launches
    yw, hw = SK.ssd_scan(*_t(*arrays), chunk=chunk)
    assert SK.launches == before
    np.testing.assert_array_equal(yw.numpy(), y.numpy())
    np.testing.assert_array_equal(hw.numpy(), hl.numpy())


@pytest.mark.parametrize("shape", [
    (1, 300, 2, 16, 8, 128),  # chunk 128: the kernel runs at 64
    (1, 96, 2, 16, 256, 32),  # N 256: two state tiles of 128
    (1, 200, 2, 8, 300, 100),  # both, with a ragged last state tile
])
def test_ssd_scan_rewrite_matches_jax_kernel(shape):
    """The wrapper's rewrite onto the kernel's limits (chunk <= 64, N <=
    128), applied to the plain version, against the Pallas kernel in
    interpret mode at the requested chunk and N: y and the final state."""
    arrays = _ssd_inputs(shape, seed=3)
    chunk = shape[-1]
    yr, hr = jax_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    calls = []

    def scan(*args, chunk):
        calls.append((chunk, args[3].shape[-1]))
        return SK.ssd_scan_ref(*args, chunk=chunk)

    y, hl = SK.by_state_tiles(scan, *_t(*arrays), chunk=chunk)
    assert all(c <= SK.MAX_CHUNK and n <= SK.MAX_STATE for c, n in calls)
    assert len(calls) == -(-shape[4] // SK.MAX_STATE)
    _close(y.numpy(), yr, SSD_RTOL)
    _close(hl.numpy(), hr, SSD_RTOL)


def test_ssd_scan_wrapper_refuses_gradients_and_bad_shapes():
    x, dt, a, bm, cm = _t(*_ssd_inputs(SSD_SHAPES[0]))
    with pytest.raises(RuntimeError):
        SK.ssd_scan(x.requires_grad_(True), dt, a, bm, cm, chunk=16)
    with torch.no_grad():
        SK.ssd_scan(x, dt, a, bm, cm, chunk=16)  # no gradient needed: runs
    with pytest.raises(ValueError):
        SK.ssd_scan(x.detach(), dt[:, :-1], a, bm, cm, chunk=16)
    with pytest.raises(ValueError):
        SK.ssd_scan(x.detach(), dt, a[:1], bm, cm, chunk=16)


def test_segsum_matches_jax():
    v = np.random.default_rng(3).standard_normal((2, 3, 9)).astype(np.float32)
    port = TS.segsum(torch.from_numpy(v)).numpy()
    ref = np.asarray(JS.segsum(jnp.asarray(v)))
    np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
    fin = np.isfinite(ref)
    _close(port[fin], ref[fin])


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------


def _block_params(cfg, seed=0):
    jp = JS.init_mamba(jax.random.PRNGKey(seed), cfg)
    return jp, W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    yr, sr = JS.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    y, st = TS.causal_conv1d(*_t(x, w, bias))
    _close(y.numpy(), yr)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sr))
    # a zero state is the zero padding (the conv state of serving is held
    # to JAX in tests/test_torch_cache.py)
    y0, st0 = TS.causal_conv1d(*_t(x, w, bias), state=torch.zeros(2, 3, 24))
    assert torch.equal(y0, y) and torch.equal(st0, st)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches_jax(use_pallas, dtype):
    """``mamba_apply`` at ``mamba2-370m.reduced()`` widths (D 256, H 16,
    P 32, N 16, chunk 64) on a ragged 80-step sequence, on the
    ``ssd_chunked`` route and on the scan kernel's route."""
    cfg = JC.get_config(ARCH).reduced()
    tcfg = TC.get_config(ARCH).reduced()
    jp, tp = _block_params(cfg)
    x = np.random.default_rng(5).standard_normal((2, 80, cfg.d_model)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref, (hr, _) = jax.jit(lambda p, xx: JS.mamba_apply(
        p, xx, cfg, use_pallas=use_pallas))(jp, jnp.asarray(x, jdt))
    with torch.no_grad():
        out, (hl, _) = TS.mamba_apply(tp, torch.from_numpy(x).to(tdt), tcfg,
                                      use_pallas=use_pallas)
    assert out.dtype == tdt and hl.dtype == torch.float32
    rtol = RTOL if dtype == "float32" else 2e-2
    _close(out.float().numpy(), np.asarray(ref, np.float32), rtol)
    _close(hl.numpy(), np.asarray(hr), rtol)
    # zero states are the cache-free path on both routes (the cached block
    # is held to JAX in tests/test_torch_cache.py)
    with torch.no_grad():
        out0, (h0, _) = TS.mamba_apply(
            tp, torch.from_numpy(x).to(tdt), tcfg,
            ssm_state=torch.zeros(tuple(hl.shape)),
            conv_state=torch.zeros((2, tcfg.ssm.d_conv - 1,
                                    tcfg.ssm.d_inner(tcfg.d_model)
                                    + 2 * tcfg.ssm.d_state), dtype=tdt),
            use_pallas=use_pallas)
    _close(out0.float().numpy(), out.float().numpy(), rtol)
    _close(h0.numpy(), hl.numpy(), rtol)


def test_init_mamba_has_the_reference_layout():
    cfg = TC.get_config(ARCH).reduced()
    for dtype in (torch.float32, torch.bfloat16):
        tp = TS.init_mamba(torch.Generator().manual_seed(0), cfg, dtype,
                           device="cpu")
        jshape = jax.eval_shape(lambda: JS.init_mamba(
            jax.random.PRNGKey(0), JC.get_config(ARCH).reduced(),
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
        assert {k: tuple(v.shape) for k, v in tp.items()} == {
            k: v.shape for k, v in jshape.items()}
        for k, v in tp.items():
            assert str(v.dtype).split(".")[-1] == str(jshape[k].dtype), k


def test_bf16_mamba_weights_carry_leaf_for_leaf():
    """A bf16 JAX model: every leaf carried exactly, ``a_log``, ``dt_bias``
    and ``d_skip`` staying f32."""
    cfg = JC.get_config(ARCH).reduced()
    jp = jax.jit(lambda k: JM.init_params(k, cfg, dtype=jnp.bfloat16))(
        jax.random.PRNGKey(0))
    np_p = jax.tree.map(np.asarray, jp)
    tp = W.model_params_from_jax(np_p, "cpu")
    mamba = tp["slots"][0]["mamba"]
    for k in ("a_log", "dt_bias", "d_skip"):
        assert mamba[k].dtype == torch.float32
    assert mamba["in_proj"].dtype == torch.bfloat16
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a, np.float32), b), np_p, W.model_params_to_numpy(tp))


# ---------------------------------------------------------------------------
# the model and the pipeline
# ---------------------------------------------------------------------------


def _model(layers=2, seed=0):
    cfg = dataclasses.replace(JC.get_config(ARCH).reduced(), num_layers=layers)
    tcfg = dataclasses.replace(TC.get_config(ARCH).reduced(), num_layers=layers)
    jp = jax.jit(lambda k: JM.init_params(k, cfg))(jax.random.PRNGKey(seed))
    return cfg, tcfg, jp, W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, rows, seq, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32))


def test_forward_and_loss_and_grads_match_jax():
    """f32 compute: logits on both scan routes, and the loss and every
    gradient leaf of ``loss_and_grads`` against ``jax.value_and_grad``."""
    cfg, tcfg, jp, tp = _model()
    tok, lab = _tokens(cfg, 2, 40)

    def jloss(p, impl):
        logits, _, aux = JM.forward(p, jnp.asarray(tok), cfg, impl=impl,
                                    compute_dtype=jnp.float32)
        return JM.softmax_xent(logits, jnp.asarray(lab)) + aux, logits

    (lref, logits_ref), gref = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, "auto"), has_aux=True))(jp)
    _, logits_pallas = jax.jit(lambda p: jloss(p, "pallas"))(jp)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()}
    with torch.no_grad():
        for impl, ref in (("auto", logits_ref), ("pallas", logits_pallas)):
            logits, _, aux = TM.forward(tp, batch["tokens"], tcfg, impl=impl,
                                        compute_dtype=torch.float32)
            _close(logits.numpy(), ref, what=impl)
            assert float(aux) == 0.0
    (total, (loss, _)), grads = TM.loss_and_grads(tp, batch, tcfg,
                                                  compute_dtype=torch.float32)
    _close(float(total), float(lref))
    _close(float(loss), float(lref))
    jax.tree_util.tree_map_with_path(
        lambda path, a, b: _close(b, a, RTOL, jax.tree_util.keystr(path)),
        jax.tree.map(np.asarray, gref), W.model_params_to_numpy(grads))
    with pytest.raises(RuntimeError):  # the scan kernel has no backward
        TM.loss_and_grads(tp, batch, tcfg, impl="pallas",
                          compute_dtype=torch.float32)


_PIPE_REF = {}


def _pipeline_reference():
    """The reduced Mamba2 at 3 layers, its data, and ``jax.value_and_grad``
    of the unpipelined f32 loss (computed once for both schedules)."""
    if not _PIPE_REF:
        cfg, tcfg, jp, tp = _model(layers=3, seed=1)
        tok, lab = _tokens(cfg, 4, 24, seed=1)

        def jloss(p):
            logits, _, _ = JM.forward(p, jnp.asarray(tok), cfg,
                                      compute_dtype=jnp.float32)
            return JM.softmax_xent(logits, jnp.asarray(lab))

        lref, gref = jax.jit(jax.value_and_grad(jloss))(jp)
        _PIPE_REF.update(tcfg=tcfg, tp=tp, tok=tok, lab=lab, lref=float(lref),
                         gref=jax.tree.map(np.asarray, gref))
    return _PIPE_REF


@pytest.mark.parametrize("schedule", ["1f1b", "fill_drain"])
def test_pipeline_step_matches_jax_value_and_grad(schedule):
    """A 2-stage uneven split (1 + 2 layers) of the reduced Mamba2, f32:
    loss and every gradient leaf against ``jax.value_and_grad`` of the
    unpipelined loss."""
    ref = _pipeline_reference()
    step = TPIPE.pipeline_step_fn(ref["tcfg"], (1, 3), 2, pipe=TPIPE.PipelineConfig(
        schedule=schedule, stage_impl="pallas", compute_dtype="float32"))
    loss, grads = step(ref["tp"], torch.from_numpy(ref["tok"]).long(),
                       torch.from_numpy(ref["lab"]).long())
    _close(float(loss), ref["lref"])
    jax.tree_util.tree_map_with_path(
        lambda path, a, b: _close(b, a, RTOL, jax.tree_util.keystr(path)),
        ref["gref"], W.model_params_to_numpy(grads))


def test_launcher_runs_mamba_end_to_end_on_cpu():
    """The launcher on the reduced Mamba2 (plan on the 48-layer profile,
    a 1F1B step through ``ssd_chunked``, the held-out loss through the
    scan route) returns every kernel's launch count: all 0 on the CPU,
    where the wrappers take their plain versions."""
    from repro_torch.launch import train_mhsl_rl as LAUNCH

    res = LAUNCH.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--episodes", "2", "--num-envs", "2", "--depth", "4",
                       "--pipeline-steps", "1", "--batch", "4", "--seq", "16",
                       "--eval-batch", "2", "--eval-seq", "80"])
    assert res["cfg"].pattern == "MMMM" and res["boundaries"][-1] == 4
    assert np.isfinite(res["losses"]).all() and np.isfinite(res["eval_loss"])
    assert res["launches"] == dict.fromkeys(LAUNCH.KERNEL_MODULES, 0)
