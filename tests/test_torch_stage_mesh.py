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
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_ranks as TR  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core import pipeline as TPIPE  # noqa: E402
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
# the rank group's and the JAX subprocess's limit: ~10-15 s when run
# alone, several times that beside five busy test workers
GROUP_TIMEOUT_S = 240

JAX_STEP = """
import sys
sys.path.insert(0, {tests!r})
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
import _torch_ranks as TR
from repro.configs import get_config
from repro.core.pipeline import PipelineConfig, make_stage_mesh, pipeline_step_fn
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
        ranks = TR.finish(group, GROUP_TIMEOUT_S)
        out, _ = jproc.communicate(timeout=GROUP_TIMEOUT_S)
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0 and "JAX_STAGE_OK" in out, out[-4000:]
    with np.load(jax_out) as z:
        jax_res = {k: z[k] for k in z.files}
    return dict(ranks=ranks, jax=jax_res, local=local, params=params)


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
    """fill-drain does not cross processes; ``env_axis`` needs a mesh with
    that axis; the stage axis must have a rank per stage; a mesh larger
    than the world raises."""
    cfg = _cfg()
    stage2 = Mesh(("stage",), (2,), (0,))
    with pytest.raises(NotImplementedError):
        TPIPE.pipeline_step_fn(cfg, BOUNDS, MICRO, pipe=TPIPE.PipelineConfig(
            schedule="fill_drain"), mesh=stage2)
    with pytest.raises(NotImplementedError):
        TPIPE.pipeline_loss_fn(cfg, BOUNDS, MICRO, mesh=stage2)
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
