"""Parity of the port's split executor with the JAX package, on the CPU.

The port's 1F1B and fill-drain executors (every stage in one process)
against ``jax.value_and_grad`` of the reference model's f32 loss, at
both stage implementations and on even and uneven 2-3-stage splits; one
2-stage case with a bf16 wire against the JAX package's own
``pipeline_step_fn`` on a 2-device mesh (run in a subprocess); boundary
validation; the plan rescaling; and the launcher end to end.

Tolerance: loss ``rtol 2e-5`` and gradients leaf-scale ``rtol 2e-5``
(``atol = rtol * max|ref|``), the JAX package's own 1F1B gate. The
bf16-wire case is held at the gates stated beside ``WIRE_GRAD_RTOL``,
which a run without the wire cast fails.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core import pipeline as TPIPE  # noqa: E402
from repro_torch.kernels import stage_block as SB  # noqa: E402
from repro_torch.launch import train_mhsl_rl as LAUNCH  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

RTOL = 2e-5
# bf16 wire: f32 sums taken in another order by the two frameworks put a
# few stage outputs on the other side of a bf16 rounding, one bf16 ulp
# (2^-8) each, and the backward spreads those into every gradient leaf.
# Measured on this case: port vs JAX loss 1.9e-7 relative, gradients at
# most 3.8e-4 in relative Frobenius norm per leaf; dropping the wire cast
# moves the loss by 8.4e-6 and every leaf by at least 1.9e-3. The gates
# sit between the two.
WIRE_LOSS_RTOL = 2e-6
WIRE_GRAD_RTOL = 1e-3


def _cfgs(arch, layers):
    return (dataclasses.replace(JC.get_config(arch).reduced(), num_layers=layers),
            dataclasses.replace(TC.get_config(arch).reduced(), num_layers=layers))


def _data(cfg, rows, seq, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32))


def _assert_grads_close(ref_np, port_np, rtol=RTOL):
    def one(path, a, b):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(b, a, rtol=rtol,
                                   atol=rtol * max(np.abs(a).max(), 1e-8),
                                   err_msg=jax.tree_util.keystr(path))

    assert jax.tree.structure(ref_np) == jax.tree.structure(port_np)
    jax.tree_util.tree_map_with_path(one, ref_np, port_np)


_REF_CACHE = {}


def _reference(arch, layers, rows, seq):
    """JAX params, data and value_and_grad of the f32 model loss."""
    key = (arch, layers, rows, seq)
    if key not in _REF_CACHE:
        jcfg, _ = _cfgs(arch, layers)
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        tok, lab = _data(jcfg, rows, seq)

        def loss(p):
            logits, _, _ = JM.forward(p, jnp.asarray(tok), jcfg,
                                      compute_dtype=jnp.float32)
            return JM.softmax_xent(logits, jnp.asarray(lab))

        l, g = jax.jit(jax.value_and_grad(loss))(jp)
        _REF_CACHE[key] = (jax.tree.map(np.asarray, jp), tok, lab, float(l),
                           jax.tree.map(np.asarray, g))
    return _REF_CACHE[key]


@pytest.mark.parametrize("schedule", ["1f1b", "fill_drain"])
@pytest.mark.parametrize("stage_impl", ["reference", "pallas"])
@pytest.mark.parametrize("arch,bounds", [
    ("qwen2.5-3b", (2, 4)),      # tied head, GQA + bias: even 2 stages
    ("qwen2.5-3b", (1, 3, 4)),   # uneven 3 stages (lengths 1/2/1)
    ("stablelm-1.6b", (3, 4)),   # untied head: uneven 2 stages
])
def test_pipeline_matches_jax_value_and_grad(schedule, stage_impl, arch, bounds):
    np_params, tok, lab, lref, gref = _reference(arch, 4, 6, 16)
    _, tcfg = _cfgs(arch, 4)
    params = W.model_params_from_jax(np_params, "cpu")
    step = TPIPE.pipeline_step_fn(
        tcfg, bounds, 3, pipe=TPIPE.PipelineConfig(
            schedule=schedule, stage_impl=stage_impl, compute_dtype="float32"))
    loss, grads = step(params, torch.from_numpy(tok).long(),
                       torch.from_numpy(lab).long())
    np.testing.assert_allclose(float(loss), lref, rtol=RTOL)
    _assert_grads_close(gref, W.model_params_to_numpy(grads))


def test_1f1b_launch_count_formula(monkeypatch):
    """Stage-kernel wrapper calls per 1F1B step: the forward slot and the
    rematerialized backward of every non-last stage, the loss VJP of the
    last: M * (2 * (L - len_last) + len_last)."""
    _, tcfg = _cfgs("qwen2.5-3b", 8)
    params = LAUNCH.M.init_params(torch.Generator().manual_seed(0), tcfg,
                                  device="cpu")
    tok, lab = _data(tcfg, 8, 8)
    calls = []
    orig = SB._forward

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(SB, "_forward", counting)
    step = TPIPE.pipeline_step_fn(tcfg, (2, 4, 6, 8), 4,
                                  pipe=TPIPE.PipelineConfig(stage_impl="pallas"))
    step(params, torch.from_numpy(tok).long(), torch.from_numpy(lab).long())
    assert len(calls) == 4 * (2 * (8 - 2) + 2) == 56


def test_bf16_wire_matches_jax_pipeline_step(subproc, tmp_path):
    """2 stages, f32 compute, bf16 on the wire: the port's 1F1B against
    the JAX package's ``pipeline_step_fn`` on a 2-device stage mesh."""
    out = tmp_path / "jax_wire.npz"
    subproc(
        f"""
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
from repro.configs import get_config
from repro.models import init_params
from repro.core.pipeline import PipelineConfig, make_stage_mesh, pipeline_step_fn
cfg = replace(get_config('qwen2.5-3b').reduced(), num_layers=4)
params = init_params(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(0)
tok = jnp.asarray(rng.integers(0, cfg.vocab_size, (6, 16)), jnp.int32)
lab = jnp.asarray(rng.integers(0, cfg.vocab_size, (6, 16)), jnp.int32)
step = pipeline_step_fn(cfg, make_stage_mesh(2), (1, 4), 3,
                        pipe=PipelineConfig(compute_dtype='float32',
                                            wire_dtype='bfloat16'))
loss, grads = jax.jit(step)(params, tok, lab)
flat = {{jax.tree_util.keystr(p): np.asarray(a)
         for p, a in jax.tree_util.tree_flatten_with_path(grads)[0]}}
np.savez({str(out)!r}, loss=np.asarray(loss), **flat)
print('WIRE_OK')
""",
        n_devices=2,
    )
    ref = np.load(out)
    np_params, tok, lab, _, _ = _reference("qwen2.5-3b", 4, 6, 16)
    _, tcfg = _cfgs("qwen2.5-3b", 4)

    def port(wire):
        step = TPIPE.pipeline_step_fn(
            tcfg, (1, 4), 3, pipe=TPIPE.PipelineConfig(compute_dtype="float32",
                                                       wire_dtype=wire))
        loss, grads = step(W.model_params_from_jax(np_params, "cpu"),
                           torch.from_numpy(tok).long(),
                           torch.from_numpy(lab).long())
        flat = jax.tree_util.tree_flatten_with_path(W.model_params_to_numpy(grads))[0]
        assert len(flat) == len(ref.files) - 1
        return float(loss), {jax.tree_util.keystr(p): a for p, a in flat}

    def rel(a, r):
        return float(np.linalg.norm(a - r) / np.linalg.norm(r))

    loss16, g16 = port("bfloat16")
    loss32, g32 = port("float32")
    np.testing.assert_allclose(loss16, float(ref["loss"]), rtol=WIRE_LOSS_RTOL)
    for k, a in g16.items():
        assert rel(a, ref[k]) <= WIRE_GRAD_RTOL, (k, rel(a, ref[k]))
        # the gate tells a bf16 wire from none
        assert rel(g32[k], ref[k]) > WIRE_GRAD_RTOL, (k, rel(g32[k], ref[k]))
    assert abs(loss32 - float(ref["loss"])) > WIRE_LOSS_RTOL * abs(loss32)


def test_boundary_validation():
    """Malformed split plans are refused before they reach the executor;
    what this slice does not run raises NotImplementedError."""
    for bad in [(), (2, 2, 4), (3, 2), (0, 2), (-1, 4)]:
        with pytest.raises(ValueError):
            TPIPE.stage_lengths(bad)
    assert TPIPE.stage_lengths((1, 4)) == (1, 3)
    _, tcfg = _cfgs("qwen2.5-3b", 4)
    with pytest.raises(ValueError):
        TPIPE.pipeline_step_fn(tcfg, (1, 3), 2)  # last boundary != layers
    with pytest.raises(ValueError):
        TPIPE.pipeline_loss_fn(tcfg, (2, 2, 4), 2)
    with pytest.raises(NotImplementedError):
        TPIPE.pipeline_step_fn(tcfg, (2, 4), 2, env_axis="env")
    with pytest.raises(NotImplementedError):
        TPIPE.pipeline_step_fn(TC.get_config("jamba-v0.1-52b").reduced(), (1, 2), 2)
    with pytest.raises(ValueError):  # serving checks its plan too
        TPIPE.pipeline_serve_fns(tcfg, (1, 3))
    for bad in (dict(transport="async"), dict(schedule="gpipe"),
                dict(stage_impl="cuda")):
        with pytest.raises(ValueError):
            TPIPE.PipelineConfig(**bad)
    with pytest.raises(ValueError):  # rows do not split into microbatches
        TPIPE.pipeline_step_fn(tcfg, (2, 4), 4)(
            LAUNCH.M.init_params(torch.Generator().manual_seed(0), tcfg,
                                 device="cpu"),
            torch.zeros((6, 4), dtype=torch.long),
            torch.zeros((6, 4), dtype=torch.long))


@pytest.mark.parametrize("full,depth,stages,expect", [
    ((9, 28, 32, 36), 8, 4, (2, 6, 7, 8)),    # lens 9/19/4/4 -> 2/4/1/1
    ((1, 2, 3, 36), 8, 4, (1, 2, 3, 8)),      # floors of 1, then trimmed
    ((9, 28, 32, 36), 8, 2, (4, 8)),          # fewer stages: padded up
    ((36,), 8, 4, (8,)),
    ((12, 24, 36), 6, 3, (2, 4, 6)),
])
def test_rescale_boundaries(full, depth, stages, expect):
    assert LAUNCH.rescale_boundaries(full, depth, stages) == expect


def test_launch_main_end_to_end_on_cpu():
    """Plan (SAC on the full Qwen profile) -> rescaled 4-stage 1F1B
    training of the reduced model through the stage-kernel route ->
    held-out loss through the flash route, all on the CPU."""
    res = LAUNCH.main(["--reduced", "--device", "cpu", "--episodes", "4",
                       "--num-envs", "2", "--pipeline-steps", "2",
                       "--batch", "4", "--seq", "16", "--eval-batch", "2",
                       "--eval-seq", "32"])
    assert len(res["plan_full"]) == 4
    assert res["boundaries"][-1] == 8 and len(res["boundaries"]) <= 4
    TPIPE.stage_lengths(res["boundaries"])
    assert len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"])) and np.isfinite(res["eval_loss"])
    assert res["params"]["embed"].device.type == "cpu"
    with pytest.raises(SystemExit):  # the population mesh is not ported
        LAUNCH.parse_args(["--shard-envs"])
    args = LAUNCH.parse_args(["--checkpoint-dir", "ck", "--checkpoint-every",
                              "5", "--fresh"])
    assert (args.checkpoint_dir, args.checkpoint_every, args.fresh) == ("ck", 5, True)


def test_split_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the model constructors and the launcher raise
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("qwen2.5-3b", 2)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError):
        LAUNCH.M.init_params(gen, tcfg)
    with pytest.raises(RuntimeError):
        LAUNCH.M.L.init_mlp(gen, 8, 16, "swiglu")
    with pytest.raises(RuntimeError):
        LAUNCH.main(["--reduced", "--episodes", "1"])
    assert LAUNCH.M.init_params(gen, tcfg, device="cpu")["embed"].device.type == "cpu"


def test_make_train_step_matches_jax_value_and_grad():
    """The unpipelined step (the pipelined step's reference on the card):
    its loss and the gradients it hands its optimizer, f32, against the
    JAX reference, at the 1F1B gate."""
    np_params, tok, lab, lref, gref = _reference("qwen2.5-3b", 4, 6, 16)
    _, tcfg = _cfgs("qwen2.5-3b", 4)
    seen = []

    class Capture:
        def update(self, grads, state, params):
            seen.append(grads)
            return tree_map(torch.zeros_like, grads), state

    params = W.model_params_from_jax(np_params, "cpu")
    step = LAUNCH.M.make_train_step(tcfg, Capture(), compute_dtype=torch.float32)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()}
    _, _, metrics = step(params, None, batch)
    np.testing.assert_allclose(float(metrics["loss"]), lref, rtol=RTOL)
    _assert_grads_close(gref, W.model_params_to_numpy(seen[0]))
