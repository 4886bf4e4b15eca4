"""Parity of the port's MoE layers and the ``grouped_moe_ffn`` kernel's
plain version with the JAX package, on the CPU.

Routing, the capacity dispatch (``moe_apply``), the dense per-expert
reference and the dropless dispatch at both routes and block sizes 8 and
32, at ``qwen3-moe-30b-a3b.reduced()`` widths and at the MoE slot of
``jamba-v0.1-52b.reduced()``; the plain grouped FFN against the Pallas
kernel in interpret mode for the four activations in f32 and bf16, and
the wrapper's gradients against JAX's VJP; the model's loss with the
router ``aux``; a pipelined MoE step (``aux`` dropped, as in the JAX
executor); and jamba's period-2 ``"AM"`` forward. Inputs are numpy draws
from a seed (ties in the top-k are measure-zero); params are drawn by
the JAX package and carried with ``weights.model_params_from_jax``.

Tolerances: f32 ``rtol 2e-5`` leaf-scale (``atol = rtol * max|ref|``),
the JAX package's own f32 gate; bf16 grouped FFN outputs within
``BF16_ATOL_REL * max|ref|``, set from the measured error: at most
5.0e-3 of max|ref| (swiglu; one bf16 ulp at outputs in [2, 4)), because
the JAX body rounds silu's sigmoid and its product separately where
torch's ``silu`` rounds once; relu2 agrees exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.kernels import moe_dispatch as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core import pipeline as TPIPE  # noqa: E402
from repro_torch.kernels import moe_dispatch as MD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

RTOL = 2e-5
BF16_ATOL_REL = 2.0 ** -7
ARCHS = ("qwen3-moe-30b-a3b", "jamba-v0.1-52b")
ACTIVATIONS = ("swiglu", "gelu", "relu2", "silu")


def _close(port, ref, rtol=RTOL, what=""):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _cfgs(arch):
    return JC.get_config(arch).reduced(), TC.get_config(arch).reduced()


def _moe_params(cfg, seed=0):
    jp = JL.init_moe(jax.random.PRNGKey(seed), cfg)
    return jp, W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(cfg, b=2, s=12, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# routing and the three dispatches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    cfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(cfg)
    xt = _x(cfg).reshape(-1, cfg.d_model)
    gr, ir, ar = JL._moe_route(jp, jnp.asarray(xt), cfg)
    g, i, a = TL._moe_route(tp, torch.from_numpy(xt), tcfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    _close(g.numpy(), gr)
    _close(float(a), float(ar))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch", ["capacity", "dense"])
def test_moe_apply_and_dense_match_jax(arch, dispatch):
    """The capacity dispatch, at capacity factor 0.5 so that choices past
    an expert's capacity are dropped (12 tokens x top-2 over 4 experts:
    3 slots each), and the dense per-expert reference: outputs and
    ``aux``."""
    cfg, tcfg = _cfgs(arch)
    if dispatch == "capacity":
        cfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=0.5)) for c in (cfg, tcfg))
    jp, tp = _moe_params(cfg)
    x = _x(cfg)
    jfn = JL.moe_apply if dispatch == "capacity" else JL.moe_apply_dense
    tfn = TL.moe_apply if dispatch == "capacity" else TL.moe_apply_dense
    yr, ar = jax.jit(lambda p, xx: jfn(p, xx, cfg))(jp, jnp.asarray(x))
    with torch.no_grad():
        y, a = tfn(tp, torch.from_numpy(x), tcfg)
        if dispatch == "capacity":
            _, ids, _ = TL._moe_route(tp, torch.from_numpy(x[0]), tcfg)
            assert int(torch.bincount(ids.reshape(-1)).max()) > TL.moe_capacity(
                x.shape[1], tcfg)  # something is dropped
    _close(y.numpy(), yr)
    _close(float(a), float(ar))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("block_size", [8, 32])
def test_moe_apply_dropless_matches_jax(arch, impl, block_size):
    """Dropless at both routes and block sizes: the output against JAX's
    dropless dispatch at the same route, and against the port's dense
    reference (every routed choice computed)."""
    cfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(cfg)
    x = _x(cfg, seed=1)
    yr, ar = jax.jit(lambda p, xx: JL.moe_apply_dropless(
        p, xx, cfg, impl=impl, block_size=block_size, interpret=True))(
            jp, jnp.asarray(x))
    with torch.no_grad():
        y, a = TL.moe_apply_dropless(tp, torch.from_numpy(x), tcfg, impl=impl,
                                     block_size=block_size)
        yd, _ = TL.moe_apply_dense(tp, torch.from_numpy(x), tcfg)
    _close(y.numpy(), yr)
    _close(float(a), float(ar))
    _close(y.numpy(), yd.numpy())


def test_dropless_layout_matches_jax():
    """The padded layout: buffer rows, the static row bound and every
    block's expert, with an empty expert and trailing empty blocks."""
    e, blk = 5, 8
    ids = np.random.default_rng(2).choice([0, 1, 3, 4], size=(19, 2)).astype(np.int32)
    order, dest, p_rows, block_eid = TL.dropless_layout(
        torch.from_numpy(ids).long(), e, blk)
    flat = jnp.asarray(ids.reshape(-1))
    jorder = jnp.argsort(flat)
    counts = jnp.zeros((e,), jnp.int32).at[flat].add(1)
    padded = ((counts + blk - 1) // blk) * blk
    starts = jnp.cumsum(padded) - padded
    excl = jnp.cumsum(counts) - counts
    sorted_eids = flat[jorder]
    jdest = starts[sorted_eids] + jnp.arange(ids.size) - excl[sorted_eids]
    jrows = -(-(ids.size + e * (blk - 1)) // blk) * blk
    jeid = jnp.minimum(jnp.searchsorted(jnp.cumsum(padded),
                                        jnp.arange(jrows // blk) * blk,
                                        side="right"), e - 1)
    assert p_rows == jrows
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(block_eid.numpy(), np.asarray(jeid))
    assert block_eid.dtype == torch.int32
    with pytest.raises(ValueError):
        TL.moe_apply_dropless({}, torch.zeros(1, 1, 4), TC.get_config(
            "qwen3-moe-30b-a3b").reduced(), impl="cuda")


# ---------------------------------------------------------------------------
# the grouped FFN kernel's plain version and the wrapper's gradients
# ---------------------------------------------------------------------------


def _grouped_case(activation, nb=5, blk=8, d=64, f=96, e=3, seed=0):
    """A block-padded sorted buffer: sorted block experts, the last rows
    of each block zero (padding), and f32 expert weights."""
    rng = np.random.default_rng(seed)
    eid = np.sort(rng.integers(0, e, nb)).astype(np.int32)
    buf = rng.standard_normal((nb * blk, d)).astype(np.float32)
    buf.reshape(nb, blk, d)[:, blk - 3:] = 0.0
    names = (("w_gate", (e, d, f)),) if activation == "swiglu" else ()
    names += (("w_up", (e, d, f)), ("w_down", (e, f, d)))
    params = {k: (rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
              for k, s in names}
    return buf, eid, params


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ffn_plain_matches_jax_kernel(activation, dtype):
    buf, eid, params = _grouped_case(activation)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = JD.grouped_moe_ffn(jnp.asarray(buf, jdt), jnp.asarray(eid),
                             jax.tree.map(jnp.asarray, params),
                             activation=activation, interpret=True)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tbuf = torch.from_numpy(buf).to(tdt)
    out = MD.grouped_ffn_reference(tbuf, torch.from_numpy(eid), tp.get("w_gate"),
                                   tp["w_up"], tp["w_down"], activation)
    before = MD.launches
    with torch.no_grad():
        wrapped = MD.grouped_moe_ffn(tbuf, torch.from_numpy(eid), tp,
                                     activation=activation)
    assert MD.launches == before  # a CPU tensor takes the plain version
    assert out.dtype == tdt
    np.testing.assert_array_equal(wrapped.float().numpy(), out.float().numpy())
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        _close(out.numpy(), ref)
    else:
        err = np.abs(out.float().numpy() - ref).max()
        assert err <= BF16_ATOL_REL * np.abs(ref).max(), err
    pad = out.reshape(5, 8, -1)[:, 5:]
    assert float(pad.abs().max()) == 0.0  # FFN(0) = 0


@pytest.mark.parametrize("activation", ["swiglu", "relu2"])
def test_grouped_moe_ffn_grads_match_jax_vjp(activation):
    """Gradients through the wrapper's autograd.Function (backward =
    autograd of grouped_ffn_reference) against JAX's custom VJP, f32. The
    ungated case passes no placeholder gate, so w_up's gradient is
    counted once."""
    buf, eid, params = _grouped_case(activation, seed=1)
    gy = np.random.default_rng(3).standard_normal(buf.shape).astype(np.float32)

    def jfn(b, p):
        out = JD.grouped_moe_ffn(b, jnp.asarray(eid), p, activation=activation,
                                 interpret=True)
        return jnp.sum(out * jnp.asarray(gy))

    gb_ref, gp_ref = jax.grad(jfn, argnums=(0, 1))(
        jnp.asarray(buf), jax.tree.map(jnp.asarray, params))
    tb = torch.from_numpy(buf).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    out = MD.grouped_moe_ffn(tb, torch.from_numpy(eid), tp, activation=activation)
    grads = torch.autograd.grad((out * torch.from_numpy(gy)).sum(),
                                [tb] + [tp[k] for k in sorted(tp)])
    _close(grads[0].numpy(), gb_ref, what="buf")
    for k, g in zip(sorted(tp), grads[1:]):
        _close(g.numpy(), gp_ref[k], what=k)


def test_grouped_moe_ffn_refuses_bad_inputs():
    buf, eid, params = _grouped_case("swiglu")
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tb, te = torch.from_numpy(buf), torch.from_numpy(eid)
    with pytest.raises(ValueError):
        MD.grouped_moe_ffn(tb[:-1], te, tp, activation="swiglu")
    with pytest.raises(ValueError):
        MD.grouped_moe_ffn(tb, te, {k: v for k, v in tp.items() if k != "w_gate"},
                           activation="swiglu")
    with pytest.raises(ValueError):
        MD.grouped_moe_ffn(tb, te, tp, activation="tanh")
    assert [MD.row_tile(b) for b in (128, 32, 8, 24)] == [64, 32, 8, 8]
    with pytest.raises(ValueError):
        MD.row_tile(12)


# ---------------------------------------------------------------------------
# the model and the pipeline
# ---------------------------------------------------------------------------


def _model(arch, layers=2, seed=0):
    cfg, tcfg = _cfgs(arch)
    if layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
    jp = jax.jit(lambda k: JM.init_params(k, cfg))(jax.random.PRNGKey(seed))
    return cfg, tcfg, jp, W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, rows, seq, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32))


def _batch(tok, lab):
    return {"tokens": torch.from_numpy(tok).long(),
            "labels": torch.from_numpy(lab).long()}


def test_loss_with_aux_and_grads_match_jax():
    """Qwen3-MoE reduced, f32: ``loss_fn`` returns ``loss + aux`` with the
    router losses of both layers summed, and every gradient leaf of the
    total against ``jax.value_and_grad``."""
    cfg, tcfg, jp, tp = _model("qwen3-moe-30b-a3b")
    tok, lab = _tokens(cfg, 2, 16)

    def jloss(p):
        logits, _, aux = JM.forward(p, jnp.asarray(tok), cfg,
                                    compute_dtype=jnp.float32)
        loss = JM.softmax_xent(logits, jnp.asarray(lab))
        return loss + aux, (loss, aux)

    (tref, (lref, aref)), gref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    (total, (loss, aux)), grads = TM.loss_and_grads(tp, _batch(tok, lab), tcfg,
                                                    compute_dtype=torch.float32)
    assert float(aref) > 0.0
    _close(float(total), float(tref))
    _close(float(loss), float(lref))
    _close(float(aux), float(aref))
    jax.tree_util.tree_map_with_path(
        lambda path, a, b: _close(b, a, RTOL, jax.tree_util.keystr(path)),
        jax.tree.map(np.asarray, gref), W.model_params_to_numpy(grads))


_PIPE_REF = {}


def _pipeline_reference():
    """The reduced Qwen3-MoE, its data and ``jax.value_and_grad`` of the
    cross-entropy alone (computed once for both schedules)."""
    if not _PIPE_REF:
        cfg, tcfg, jp, tp = _model("qwen3-moe-30b-a3b", seed=1)
        tok, lab = _tokens(cfg, 4, 8, seed=1)

        def jloss(p):
            logits, _, _ = JM.forward(p, jnp.asarray(tok), cfg,
                                      compute_dtype=jnp.float32)
            return JM.softmax_xent(logits, jnp.asarray(lab))

        lref, gref = jax.jit(jax.value_and_grad(jloss))(jp)
        _PIPE_REF.update(tcfg=tcfg, tp=tp, tok=tok, lab=lab, lref=float(lref),
                         gref=jax.tree.map(np.asarray, gref))
    return _PIPE_REF


@pytest.mark.parametrize("schedule", ["1f1b", "fill_drain"])
def test_pipelined_moe_step_matches_jax(schedule):
    """2 stages of the reduced Qwen3-MoE, f32: the stage loss drops the
    router ``aux`` as the JAX executor does, so the reference is
    ``jax.value_and_grad`` of the cross-entropy alone."""
    ref = _pipeline_reference()
    step = TPIPE.pipeline_step_fn(ref["tcfg"], (1, 2), 2, pipe=TPIPE.PipelineConfig(
        schedule=schedule, stage_impl="pallas", compute_dtype="float32"))
    loss, grads = step(ref["tp"], torch.from_numpy(ref["tok"]).long(),
                       torch.from_numpy(ref["lab"]).long())
    _close(float(loss), ref["lref"])
    jax.tree_util.tree_map_with_path(
        lambda path, a, b: _close(b, a, RTOL, jax.tree_util.keystr(path)),
        ref["gref"], W.model_params_to_numpy(grads))


def test_jamba_period_two_forward_matches_jax():
    """Jamba reduced: ``"AM"``, MoE on the attention block (every 2nd), a
    dense MLP after the Mamba block: two slots, logits and ``aux``, f32.
    The pipeline's 1F1B runs the period-2 config (held to the reference
    in ``tests/test_torch_mixed_pipeline.py``); its fill-drain reference
    refuses it, naming ``1f1b``."""
    cfg, tcfg, jp, tp = _model("jamba-v0.1-52b")
    assert len(tp["slots"]) == 2
    assert set(tp["slots"][0]) == {"norm1", "attn", "norm2", "moe"}
    assert set(tp["slots"][1]) == {"norm1", "mamba", "norm2", "mlp"}
    tok, _ = _tokens(cfg, 2, 16, seed=2)
    logits_ref, _, aux_ref = jax.jit(lambda p: JM.forward(
        p, jnp.asarray(tok), cfg, compute_dtype=jnp.float32))(jp)
    with torch.no_grad():
        logits, _, aux = TM.forward(tp, torch.from_numpy(tok).long(), tcfg,
                                    compute_dtype=torch.float32)
    _close(logits.numpy(), logits_ref)
    _close(float(aux), float(aux_ref))
    assert callable(TPIPE.pipeline_step_fn(tcfg, (1, 2), 2))
    with pytest.raises(ValueError, match="1f1b"):
        TPIPE.pipeline_step_fn(tcfg, (1, 2), 2, pipe=TPIPE.PipelineConfig(
            schedule="fill_drain"))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-v0.1-52b",
                                  "mamba2-370m"])
def test_init_params_has_the_reference_layout(arch):
    cfg, tcfg = _cfgs(arch)
    jshape = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), cfg)))
    tp = TM.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    tshape = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                          W.model_params_to_numpy(tp))
    assert tshape == jshape


def test_launcher_runs_qwen3_moe_end_to_end_on_cpu():
    """The launcher on the reduced Qwen3-MoE at 2 layers on 2 stages
    returns every kernel's launch count (all 0 on the CPU)."""
    from repro_torch.launch import train_mhsl_rl as LAUNCH

    res = LAUNCH.main(["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device",
                       "cpu", "--episodes", "2", "--num-envs", "2", "--depth",
                       "2", "--stages", "2", "--pipeline-steps", "1", "--batch",
                       "4", "--seq", "16", "--eval-batch", "2", "--eval-seq", "32"])
    assert res["boundaries"] == (1, 2)
    assert np.isfinite(res["losses"]).all() and np.isfinite(res["eval_loss"])
    assert res["launches"] == dict.fromkeys(LAUNCH.KERNEL_MODULES, 0)
