"""The split executor with one stage per rank, on gloo ranks on the CPU.

A 2-stage 1F1B step of reduced Qwen2.5-3B (4 layers, bounds (1, 4), M
3, tied embeddings) on two ranks, each holding only its own stage's
parameters and handing its hops to its neighbour as point-to-point
transfers, against the same step in one process (bit for bit, at an f32
and a bf16 wire) and against the JAX package's ``pipeline_step_fn`` on a
2-device stage mesh (a forced-device subprocess) at the gates
``tests/test_torch_pipeline.py`` holds the in-process step to. Then the
(2 x 2) stage x env step with ``env_axis="env"`` on four ranks against
the 1-D step, at the JAX package's own gate for that pair
(``tests/test_population_mesh.py``: loss 1e-6 relative, gradients
``rtol 1e-5``). Weights are the JAX package's, carried.

Fill-drain on stage ranks, in the same group: the f32 fill-drain step on
the 2 ranks bit for bit the in-process fill-drain (its loss alone,
``pipeline_loss_fn(mesh=)``, too), within the in-process gates of JAX's
fill-drain on ``make_stage_mesh(2)`` (same JAX subprocess), and against
1F1B on the same ranks at the reference's gate for that pair
(``tests/test_pipeline_schedule.py``: loss 2e-5 relative, gradients
``rtol 2e-5``, ``atol 2e-5 max|ref|``); on the (2 x 2) stage x env mesh
against the 1-D fill-drain at the env gates.

Serving on stage ranks, in the same group: the token ring
(``PipelineRunner(mesh=)``, ``pipeline_serve_fns(mesh=)``) on 2 and on 4
ranks, f32 and bf16 wire, a prefill and one decode tick, bit for bit the
in-process ring (the logits on every rank, each rank's KV ring), and the
2-rank ring against JAX's ``pipeline_serve_fns`` on ``make_stage_mesh(2)``
(in the same JAX subprocess) at ``tests/test_torch_serving_pipeline.py``'s
gates (f32 ``rtol 2e-5`` of max|ref|; the bf16 wire 1e-3 relative
Frobenius norm); ``ServingService(mesh=)`` on 4 ranks over a Poisson
trace, without and with ``reference_schedule(4, 3)`` faults, every
completion on every rank bit for bit the one-process service's. The
launcher (``launch.train_mhsl_rl``) on 2 stage ranks of the group against
one process: the plan, the losses (``rtol 1e-6``), the clip's norm of
the whole gradient with the tied embedding counted once (``rtol 1e-6``,
measured 7e-8: per-rank partial sums), the updated parameters (1e-6 of
max|ref| per leaf, measured 1.2e-7 absolute) and the held-out loss (bf16
compute: ``rtol 1e-3``); with a checkpoint directory, rank 0 alone
trains the controller and writes it, and a second launch resumes.

The collective recorder (``distribution.collectives.record_collectives``)
in the same group, the counterpart of ``tests/test_hlo_analysis.py``'s
``test_overlap_issues_no_more_collectives_than_sync``: the 1F1B step of
reduced Qwen2.5-3B on 3 stage ranks issues no more collectives per tick
under ``transport="overlap"`` than under ``"sync"``, some of them
``collective-permute`` hops, and the recorded run is bit for bit the
unrecorded one; the fill-drain step on the same 3 ranks issues the
hops its tick loop implies; an all-gather of a 256 B result over 2 ranks
records 128 wire bytes and an all-reduce of 64 B over 4 records 96.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import _torch_ranks as TR  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core import pipeline as TPIPE  # noqa: E402
from repro_torch.distribution.sharding import stage_shardings  # noqa: E402
from repro_torch.launch import train_mhsl_rl as LAUNCH  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.train_mhsl_rl import executed_config  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH, LAYERS, BOUNDS, MICRO, ROWS, SEQ = "qwen2.5-3b", 4, (1, 4), 3, 6, 16
WIRES = ("float32", "bfloat16")
# the in-process step's gates against JAX (tests/test_torch_pipeline.py)
RTOL = 2e-5
WIRE_LOSS_RTOL = 2e-6
WIRE_GRAD_RTOL = 1e-3
# the JAX package's gate for the (stage x env) step against the 1-D one
ENV_LOSS_RTOL = 1e-6
ENV_GRAD_RTOL = 1e-5
# the serving gates (tests/test_torch_serving_pipeline.py's) and the
# launcher's
SERVE_RTOL, SERVE_WIRE_REL = 2e-5, 1e-3
LAUNCH_RTOL, LAUNCH_EVAL_RTOL = 1e-6, 1e-3
# the rank group's and the JAX subprocess's limit: ~20-30 s when run
# alone, several times that beside five busy test workers
GROUP_TIMEOUT_S = 240

JAX_STEP = """
import sys
sys.path.insert(0, {tests!r})
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
import _torch_ranks as TR
from repro.configs import get_config
from repro.core.pipeline import (PipelineConfig, make_stage_mesh, pipeline_serve_fns,
                                 pipeline_step_fn, stage_kv_caches)
cfg = replace(get_config({arch!r}).reduced(), num_layers={layers})
with np.load({params!r}) as z:
    flat = {{k: z[k] for k in z.files}}
params = jax.tree.map(jnp.asarray, TR.unflatten(flat))
tok, lab = jnp.asarray(flat['__tokens__']), jnp.asarray(flat['__labels__'])
out = {{}}
for wire in {wires!r}:
    step = pipeline_step_fn(cfg, make_stage_mesh(2), {bounds!r}, {micro},
                            pipe=PipelineConfig(compute_dtype='float32',
                                                wire_dtype=wire))
    loss, grads = jax.jit(step)(params, tok, lab)
    out.update({{wire + '|' + k: v for k, v in TR.flatten(
        jax.tree.map(np.asarray, grads)).items()}})
    out[wire + '|__loss__'] = np.asarray(loss)
    prompts, s_tok, s_pos = (jnp.asarray(np.asarray(x), jnp.int32)
                             for x in TR.serve_inputs(cfg.vocab_size))
    prefill, decode = pipeline_serve_fns(cfg, make_stage_mesh(2), TR.SERVE_BOUNDS[2],
                                         pipe=PipelineConfig(compute_dtype='float32',
                                                             wire_dtype=wire))
    caches = stage_kv_caches(cfg, TR.SERVE_BOUNDS[2], TR.SERVE_B,
                             TR.SERVE_P + TR.SERVE_EXTRA)
    lg, caches = jax.jit(prefill)(params, caches, prompts)
    dl, caches = jax.jit(decode)(params, s_tok, caches, s_pos)
    for k, v in (('prefill', lg), ('decode', dl), ('k', caches['k']),
                 ('v', caches['v'])):
        out['serve|' + wire + '|' + k] = np.asarray(v)
step = pipeline_step_fn(cfg, make_stage_mesh(2), {bounds!r}, {micro},
                        pipe=PipelineConfig(schedule='fill_drain',
                                            compute_dtype='float32'))
loss, grads = jax.jit(step)(params, tok, lab)
out.update({{'fd|' + k: v for k, v in TR.flatten(
    jax.tree.map(np.asarray, grads)).items()}})
out['fd|__loss__'] = np.asarray(loss)
np.savez({out!r}, **out)
print('JAX_STAGE_OK')
"""


def _cfg():
    return dataclasses.replace(TC.get_config(ARCH).reduced(), num_layers=LAYERS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and the four torch ranks run side by side; then
    the in-process steps."""
    tmp = tmp_path_factory.mktemp("stage_mesh")
    jcfg = dataclasses.replace(JC.get_config(ARCH).reduced(), num_layers=LAYERS)
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    flat = TR.flatten(jp)
    flat["__tokens__"] = rng.integers(0, jcfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
    flat["__labels__"] = rng.integers(0, jcfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
    path = os.fspath(tmp / "params.npz")
    np.savez(path, **flat)
    jax_out = os.fspath(tmp / "jax.npz")
    env = dict(os.environ, PYTHONPATH=TR.SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    jproc = subprocess.Popen(
        [sys.executable, "-c", JAX_STEP.format(
            tests=TR.HERE, arch=ARCH, layers=LAYERS, params=path, wires=WIRES,
            bounds=BOUNDS, micro=MICRO, out=jax_out)],
        env=env, cwd=TR.REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        group = TR.start("stage_runs", 4, tmp / "ranks", params_path=path,
                         arch=ARCH, layers=LAYERS, bounds=list(BOUNDS),
                         micro=MICRO, wires=list(WIRES), env_axis_case=True)
        params = W.model_params_from_jax(jp, "cpu")
        tok = torch.from_numpy(flat["__tokens__"]).long()
        lab = torch.from_numpy(flat["__labels__"]).long()
        local = {}
        for wire in WIRES:
            step = TPIPE.pipeline_step_fn(_cfg(), BOUNDS, MICRO,
                                          pipe=TPIPE.PipelineConfig(
                                              compute_dtype="float32",
                                              wire_dtype=wire))
            local[wire] = step(params, tok, lab)
        local["fd"] = TPIPE.pipeline_step_fn(
            _cfg(), BOUNDS, MICRO, pipe=TPIPE.PipelineConfig(
                schedule="fill_drain", compute_dtype="float32"))(params, tok, lab)
        cfg = _cfg()
        serve = {(n, wire): TR.serve_pass(cfg, params, TR.SERVE_BOUNDS[n], wire)
                 for n in (2, 4) for wire in WIRES}
        service = TR.service_runs(cfg, params)
        launched = LAUNCH.main(TR.LAUNCH_ARGV)
        ranks = TR.finish(group, GROUP_TIMEOUT_S)
        out, _ = jproc.communicate(timeout=GROUP_TIMEOUT_S)
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0 and "JAX_STAGE_OK" in out, out[-4000:]
    with np.load(jax_out) as z:
        jax_res = {k: z[k] for k in z.files}
    return dict(ranks=ranks, jax=jax_res, local=local, params=params, serve=serve,
                service=service, launched=launched,
                ckpt=os.fspath(tmp / "ranks" / "launcher_ckpt"))


def _flat_np(grads):
    return TR.flatten(W.model_params_to_numpy(grads))


@pytest.mark.parametrize("wire", WIRES)
def test_two_stage_ranks_bitwise_in_process(runs, wire):
    """Stage k on rank k, hops as transfers: loss and every gradient leaf
    equal the in-process step's bit for bit (ranks 2-3 sit out)."""
    loss, grads = runs["ranks"][0][wire]
    ref_loss, ref = runs["local"][wire]
    assert loss == float(ref_loss)
    assert runs["ranks"][1][wire][1] is None  # assembled on stage 0 only
    for (ka, a), (kb, b) in zip(_flat_np(grads).items(), _flat_np(ref).items()):
        assert ka == kb and np.array_equal(a, b), ka
    assert wire not in runs["ranks"][2]  # outside the 2-rank stage mesh


@pytest.mark.parametrize("wire", WIRES)
def test_two_stage_ranks_match_jax_stage_mesh(runs, wire):
    """The 2-rank step against JAX's ``pipeline_step_fn`` on
    ``make_stage_mesh(2)``, at the in-process step's gates."""
    loss, grads = runs["ranks"][0][wire]
    jref = {k.split("|", 1)[1]: v for k, v in runs["jax"].items()
            if k.startswith(wire + "|")}
    port = _flat_np(grads)
    assert set(port) == set(jref) - {"__loss__"}
    if wire == "float32":
        np.testing.assert_allclose(loss, float(jref["__loss__"]), rtol=RTOL)
        for k, a in port.items():
            r = np.asarray(jref[k], np.float64)
            np.testing.assert_allclose(np.asarray(a, np.float64), r, rtol=RTOL,
                                       atol=RTOL * max(np.abs(r).max(), 1e-8),
                                       err_msg=k)
    else:
        np.testing.assert_allclose(loss, float(jref["__loss__"]),
                                   rtol=WIRE_LOSS_RTOL)
        for k, a in port.items():
            rel = float(np.linalg.norm(a - jref[k]) / np.linalg.norm(jref[k]))
            assert rel <= WIRE_GRAD_RTOL, (k, rel)


def _close(got, ref, rtol, err_msg=""):
    """Each gradient leaf within ``rtol`` relative and ``rtol`` of the
    reference leaf's max absolute value."""
    for (k, a), (_, b) in zip(_flat_np(got).items(), _flat_np(ref).items()):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=rtol,
                                   atol=rtol * max(np.abs(b).max(), 1e-8),
                                   err_msg=err_msg + k)


def test_fill_drain_on_stage_ranks_bitwise_in_process(runs):
    """Fill-drain with stage k on rank k (each rank keeps its stage's
    graph of every microbatch and pulls the cotangents through them in
    reverse order): loss and every gradient leaf equal the in-process
    fill-drain's (autograd of the whole forward) bit for bit, and the
    loss alone (``pipeline_loss_fn(mesh=)``) its loss."""
    loss, grads = runs["ranks"][0]["fd"]
    ref_loss, ref = runs["local"]["fd"]
    assert loss == float(ref_loss) == runs["ranks"][0]["fd_loss"]
    assert runs["ranks"][1]["fd"][0] == loss and runs["ranks"][1]["fd"][1] is None
    for (ka, a), (kb, b) in zip(_flat_np(grads).items(), _flat_np(ref).items()):
        assert ka == kb and np.array_equal(a, b), ka
    assert "fd" not in runs["ranks"][2]


def test_fill_drain_on_stage_ranks_matches_jax_stage_mesh(runs):
    """The 2-rank fill-drain against JAX's fill-drain ``pipeline_step_fn``
    on ``make_stage_mesh(2)``, at the in-process step's gates."""
    loss, grads = runs["ranks"][0]["fd"]
    jref = {k.split("|", 1)[1]: v for k, v in runs["jax"].items()
            if k.startswith("fd|")}
    port = _flat_np(grads)
    assert set(port) == set(jref) - {"__loss__"}
    np.testing.assert_allclose(loss, float(jref["__loss__"]), rtol=RTOL)
    for k, a in port.items():
        r = np.asarray(jref[k], np.float64)
        np.testing.assert_allclose(np.asarray(a, np.float64), r, rtol=RTOL,
                                   atol=RTOL * max(np.abs(r).max(), 1e-8),
                                   err_msg=k)


def test_fill_drain_matches_1f1b_on_the_same_ranks(runs):
    """The reference's oracle for 1F1B on a mesh: fill-drain on the same
    2 stage ranks (f32 hops both), loss 2e-5 relative, every gradient
    ``rtol 2e-5``, ``atol 2e-5 max|ref|``."""
    loss, grads = runs["ranks"][0]["float32"]
    ref_loss, ref = runs["ranks"][0]["fd"]
    assert abs(loss - ref_loss) <= RTOL * abs(ref_loss)
    _close(grads, ref, RTOL)


def test_fill_drain_stage_env_matches_stage_mesh(runs):
    """Fill-drain on the (2 x 2) stage x env ranks, microbatch rows split
    over env and loss and gradients averaged over it, against the 1-D
    fill-drain."""
    loss, grads = runs["ranks"][0]["fd_env"]
    ref_loss, ref = runs["ranks"][0]["fd"]
    assert abs(loss - ref_loss) <= ENV_LOSS_RTOL * abs(ref_loss)
    _close(grads, ref, ENV_GRAD_RTOL)
    assert runs["ranks"][1]["fd_env"][0] == loss


def test_stage_env_step_matches_stage_mesh(runs):
    """(2 x 2) stage x env on four ranks, microbatch rows split over env
    and the loss and gradients averaged over it, against the 1-D step."""
    loss, grads = runs["ranks"][0]["env"]
    ref_loss, ref = runs["local"]["float32"]
    assert abs(loss - float(ref_loss)) <= ENV_LOSS_RTOL * abs(float(ref_loss))
    for (k, a), (_, b) in zip(_flat_np(grads).items(), _flat_np(ref).items()):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=ENV_GRAD_RTOL,
                                   atol=ENV_GRAD_RTOL * max(np.abs(b).max(), 1e-8),
                                   err_msg=k)
    # the other env column assembles the same tree on its stage 0
    loss1, grads1 = runs["ranks"][1]["env"]
    assert loss1 == loss
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                 tree_leaves(grads1)))


@pytest.mark.parametrize("n,wire", [(n, w) for n in (2, 4) for w in WIRES])
def test_stage_rank_serving_bitwise_in_process(runs, n, wire):
    """The token ring with stage t on rank t: every rank holds the
    in-process ring's logits bit for bit, and each rank's KV ring is the
    in-process ring's row of its stage."""
    ref = runs["serve"][(n, wire)]
    for rank, r in enumerate(runs["ranks"]):
        if rank >= n:
            assert (n, wire) not in r["serve"]  # outside the 2-rank mesh
            continue
        got = r["serve"][(n, wire)]
        for k in ("prefill", "decode"):
            assert got[k].dtype == torch.float32 and torch.equal(got[k], ref[k]), k
        for k in ("k", "v"):
            assert got[k].shape == (1,) + ref[k].shape[1:]
            assert torch.equal(got[k][0], ref[k][rank]), k


@pytest.mark.parametrize("wire", WIRES)
def test_stage_rank_serving_matches_jax_stage_mesh(runs, wire):
    """The 2-rank ring against JAX's ``pipeline_serve_fns`` on
    ``make_stage_mesh(2)``: prefill and decode logits (rank 0's) and the
    rings (stacked from both ranks), at the serving pipeline's gates."""
    got = dict(runs["ranks"][0]["serve"][(2, wire)])
    for k in ("k", "v"):
        got[k] = torch.cat([r["serve"][(2, wire)][k] for r in runs["ranks"][:2]])
    for k in ("prefill", "decode", "k", "v"):
        ref = np.asarray(runs["jax"][f"serve|{wire}|{k}"], np.float64)
        a = got[k].double().numpy()
        assert a.shape == ref.shape, k
        if wire == "float32":
            np.testing.assert_allclose(a, ref, rtol=SERVE_RTOL,
                                       atol=SERVE_RTOL * np.abs(ref).max(), err_msg=k)
        else:
            assert np.linalg.norm(a - ref) / np.linalg.norm(ref) <= SERVE_WIRE_REL, k


@pytest.mark.parametrize("run", ["free", "faulted"])
def test_service_on_stage_ranks_matches_one_process(runs, run):
    """``ServingService(mesh=)`` on 4 stage ranks, rank 0 deciding every
    tick: each rank's completions bit for bit the one-process service's;
    under the reference schedule the outage evicts and requeues."""
    ref = runs["service"][run]
    lead = runs["ranks"][0]["service"][run]
    assert len(ref["completions"]) == 6
    for r in runs["ranks"]:
        got = r["service"][run]["completions"]
        assert got.keys() == ref["completions"].keys()
        assert all(np.array_equal(got[k], v) for k, v in ref["completions"].items())
    assert lead["fault_events"] == ref["fault_events"]
    assert lead["evictions"] == ref["evictions"]
    assert (ref["fault_events"] > 0 and ref["evictions"] > 0) == (run == "faulted")


def test_launcher_on_stage_ranks_matches_one_process(runs):
    """``launch.train_mhsl_rl`` on 2 stage ranks (``--stages 2``; ranks
    2-3 sit out after the plan): the plan, the losses, the clip's global
    norm, the updated parameters (gathered on rank 0) and the held-out
    loss against one process."""
    ref = runs["launched"]
    lead, other = runs["ranks"][0]["launcher"], runs["ranks"][1]["launcher"]
    assert lead["boundaries"] == other["boundaries"] == ref["boundaries"]
    assert len(ref["boundaries"]) == 2
    assert set(runs["ranks"][2]["launcher"]) == {"boundaries", "trained"}
    for got in (lead, other):
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LAUNCH_RTOL)
        np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"],
                                   rtol=LAUNCH_RTOL)
    assert "eval_loss" not in other
    assert lead["eval_loss"] == pytest.approx(ref["eval_loss"], rel=LAUNCH_EVAL_RTOL)
    for a, b in zip(tree_leaves(lead["params"]), tree_leaves(ref["params"])):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= LAUNCH_RTOL * float(b.abs().max())


def test_launcher_on_stage_ranks_checkpoints_on_rank_0(runs):
    """With ``--checkpoint-dir`` on ranks, only rank 0 trains the
    controller and writes its checkpoint (the others take its plan); run
    again, it resumes from that checkpoint and executes the same plan with
    the same losses."""
    from repro_torch.checkpoint import train_state as TS

    ranks = runs["ranks"]
    assert [r["launcher"]["trained"] for r in ranks] == [True, False, False, False]
    episodes = LAUNCH.parse_args(TR.LAUNCH_ARGV).episodes
    assert TS.latest_checkpoint_step(runs["ckpt"]) == episodes
    first, again = ranks[0]["launcher"], ranks[0]["resumed"]
    assert again["trained"] and not ranks[1]["resumed"]["trained"]
    assert again["boundaries"] == first["boundaries"] == runs["launched"]["boundaries"]
    assert again["losses"] == first["losses"]
    assert again["grad_norms"] == first["grad_norms"]


def test_stage_shardings_count_each_leaf_once():
    """The shares' squared norms, each leaf's over its holders, sum to
    the whole tree's (tied embeddings: the first and the last stage hold
    the one gradient; a frontend's on the first stage only)."""
    for arch, bounds in (("qwen2.5-3b", (1, 3, 4)), ("stablelm-1.6b", (3, 4)),
                         ("pixtral-12b", (2, 4))):
        cfg = executed_config(arch, 4, reduced=True)
        tree = TPIPE.M.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
        total = 0.0
        for k in range(len(bounds)):
            share = TPIPE.stage_params(tree, cfg, bounds, k)
            rec = stage_shardings(share, cfg, bounds,
                                  Mesh(("stage",), (len(bounds),), (k,)))
            total += sum(float(torch.sum(x.double() ** 2)) / sh.replicas
                         for x, sh in zip(tree_leaves(share), tree_leaves(rec)))
        whole = sum(float(torch.sum(x.double() ** 2)) for x in tree_leaves(tree))
        assert total == pytest.approx(whole, rel=1e-12), arch


@pytest.mark.parametrize("arch,bounds", [
    ("qwen2.5-3b", (1, 4)),              # tied: the last stage holds the embedding
    ("stablelm-1.6b", (3, 4)),           # untied head
    ("jamba-v0.1-52b", (1, 3, 4)),       # mixed periods: slot rows per stage
])
def test_stage_params_cover_the_tree(arch, bounds):
    """Each stage's share holds its layers' slot rows, the embedding
    first (and last when tied), norm and head last; the shares put back
    together are the tree."""
    cfg = executed_config(arch, 4, reduced=True)
    params = TPIPE.M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    shares = [TPIPE.stage_params(params, cfg, bounds, k) for k in range(len(bounds))]
    for k, sh in enumerate(shares):
        first, last = k == 0, k == len(bounds) - 1
        assert ("embed" in sh) == (first or (last and cfg.tie_embeddings))
        assert ("final_norm" in sh) == last
        assert ("lm_head" in sh) == (last and "lm_head" in params)
    for j, slot in enumerate(params["slots"]):
        whole = tree_map(lambda *xs: torch.cat(xs), *[sh["slots"][j] for sh in shares])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(whole),
                                                     tree_leaves(slot)))
    lens = [hi - lo for lo, hi in zip((0,) + tuple(bounds[:-1]), bounds)]
    for sh, n in zip(shares, lens):
        rows = sum(tree_leaves(s)[0].shape[0] for s in sh["slots"])
        assert rows == n


def test_mesh_refusals():
    """fill-drain on a mesh refuses a mixed-period config, as in one
    process; ``env_axis`` needs a mesh with that axis; the stage axis must
    have a rank per stage; a mesh larger than the world raises."""
    cfg = _cfg()
    stage2 = Mesh(("stage",), (2,), (0,))
    mixed = executed_config("jamba-v0.1-52b", 4, reduced=True)
    assert TPIPE.M.find_period(TPIPE.M.signature(mixed)) > 1
    with pytest.raises(ValueError, match="period"):
        TPIPE.pipeline_step_fn(mixed, (2, 4), MICRO, pipe=TPIPE.PipelineConfig(
            schedule="fill_drain"), mesh=stage2)
    with pytest.raises(ValueError, match="period"):
        TPIPE.pipeline_loss_fn(mixed, (2, 4), MICRO, mesh=stage2)
    with pytest.raises(ValueError, match="env_axis"):
        TPIPE.pipeline_step_fn(cfg, BOUNDS, MICRO, env_axis="env")
    with pytest.raises(ValueError, match="env_axis"):
        TPIPE.pipeline_step_fn(cfg, BOUNDS, MICRO, env_axis="env", mesh=stage2)
    with pytest.raises(ValueError, match="stage"):
        TPIPE.pipeline_step_fn(cfg, (1, 2, 4), MICRO, mesh=stage2)
    from repro_torch.launch.mesh import make_stage_env_mesh, make_stage_mesh

    with pytest.raises(ValueError, match="ranks"):
        make_stage_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        make_stage_env_mesh(2, 2, device="cpu")


def test_overlap_issues_no_more_collectives_than_sync(runs):
    for rank in (0, 1, 2):
        rec = runs["ranks"][rank]["recorded"]
        sync, over = rec["sync"]["per_tick"], rec["overlap"]["per_tick"]
        assert any("permute" in k for k in sync), sync
        assert set(over) <= set(sync), (over, sync)
        for kind, n in sync.items():
            assert over.get(kind, 0.0) <= n + 1e-9, (kind, over, sync)
        assert rec["sync"]["bitwise"] and rec["overlap"]["bitwise"]
    # a permute on its sender for each microbatch's hop across each of the
    # 2 stage boundaries, forward and backward, and the tied embedding's
    # two gradient exchanges between the first and the last stage
    sends = [runs["ranks"][r]["recorded"]["sync"]["counts"]["collective-permute"]
             for r in (0, 1, 2)]
    assert _cfg().tie_embeddings
    assert sends == [MICRO + 1, 2 * MICRO, MICRO + 1]
    assert "sync" not in runs["ranks"][3]["recorded"]  # outside the 3-rank mesh


def test_fill_drain_issues_the_hops_of_its_tick_loop(runs):
    """Fill-drain on 3 stage ranks (M microbatches, S stages): stage
    ``i`` sends one forward hop per microbatch to stage ``i + 1`` when
    ``i < S - 1`` and one backward hop per microbatch to stage ``i - 1``
    when ``i > 0``, and with tied embeddings the last stage sends its
    head gradient to the first and the first the summed gradient back:
    ``M [i < S-1] + M [i > 0] + [tied, i in (0, S-1)]`` sends; the loss
    is one all-reduce over the stage axis."""
    n = len(TR.RECORD_BOUNDS)
    tied = _cfg().tie_embeddings

    def sends(i):
        return (MICRO * (i < n - 1) + MICRO * (i > 0)
                + int(tied and n > 1 and i in (0, n - 1)))

    for i in range(n):
        counts = runs["ranks"][i]["recorded"]["fill_drain"]["counts"]
        assert counts == {"collective-permute": sends(i), "all-reduce": 1}, i
    assert "fill_drain" not in runs["ranks"][3]["recorded"]


def test_recorded_transfers_carry_the_reference_wire_bytes(runs):
    """The reference's HLO example's two collectives as real transfers."""
    lead = runs["ranks"][0]["recorded"]["plain"]
    assert lead["result_bytes"] == {"all-gather": 256, "all-reduce": 64}
    assert lead["wire_bytes"] == {"all-gather": 128.0, "all-reduce": 96.0}
    assert lead["group_sizes"] == {"all-gather": {2: 1}, "all-reduce": {4: 1}}
    assert runs["ranks"][3]["recorded"]["plain"]["counts"] == {"all-reduce": 1}
