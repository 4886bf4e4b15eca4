"""The (data x model) mesh on gloo ranks, on the CPU.

One group of 4 ranks on a (2 x 2) host mesh (``tests/_torch_ranks.py``'s
``tensor_parallel_runs``) runs every sharded case below; a JAX
subprocess with 4 forced host devices runs beside it and gives the
``moe_apply_a2a`` reference on the JAX package's own (2 x 2) mesh and
the SSM and hybrid decodes under GSPMD; the
one-process references run in this process meanwhile. Inputs are numpy
draws (or the port's seeded CPU init, the same in every process);
weights of the JAX comparisons are carried by ``repro_torch.weights``.

* (a) The (2 x 2) train step of reduced StableLM-1.6B, reduced
  Qwen3-MoE-30B-A3B with one KV head (GQA whose KV heads the model axis
  does not divide: gathered KV weights; dropless MoE, experts over the
  model axis) and reduced Jamba (attention and MoE over the model axis,
  Mamba gathered), each in f32 and in bf16; in f32 also Qwen3-MoE's
  capacity dispatch, Pixtral (the frontend projector) and Mamba2-370m
  (tied embeddings, vocab-parallel); params and both AdamW moments held as
  ``param_shardings`` blocks, against the one-process port step on the
  same weights and batch, gathered: the clip's mesh-wide global norm, the
  loss, and the params and both moments after one AdamW update
  (``update(..., shardings=)``) of the step's gradients. The clip (0.5)
  is active in every case, so a wrong norm moves the moments.
* (b) The sharded StableLM step's gradients against the JAX package's
  one-device ``make_train_step`` from the same weights.
* (c) ``moe_apply_a2a`` against the JAX package's on its (2 x 2) mesh at
  the reference's default capacity factor, where copies are dropped:
  outputs, aux and the gradients of the output sum; at a capacity factor
  with no drops, against the one-process ``moe_apply``
  (``tests/test_moe_a2a.py``'s check).
* (d) A (2 x 2) train step with ``moe_a2a=True``
  (``tests/test_moe_a2a.py::test_moe_a2a_end_to_end_train_step``) against
  the one-process dropless step at a capacity factor with no drops.
* (e) The sharded decode step against the one-process decode step on
  reduced Qwen2.5-3B, each row at its own position: with one KV head the
  cache is split by length and every step goes through ``flash_decode``
  (``tests/test_flash_decode.py::test_decode_step_uses_flash_decode_under_context``);
  with two, by KV heads. Reduced Mamba2-370m and Jamba on the (2 x 2)
  mesh and on a (1 x 4) one: each Mamba block on its SSM heads and conv
  channels (``in_proj`` columns, ``out_proj`` rows), the hybrid's
  attention by KV heads or by length, its MoE over experts; against the
  one-process port decode and against the JAX package's decode step under
  ``param_shardings(mode="serve")`` / ``cache_shardings`` on the same
  grid (the port's weights and tokens carried).
  A cache split by length also takes a multi-token step and a step on
  the window's ring: reduced Qwen2.5-3B with one KV head on the (1 x 4)
  mesh prefills 16 tokens into a 32-entry cache (each rank gathers the
  cache's entries, updates and attends to them whole, keeps its own),
  then decodes 4 greedy steps through ``flash_decode``, each row from its
  own position (one row crossing a shard boundary), against one
  process and against the JAX package's prefill and decode under GSPMD
  on the same grid (the port's weights, prompts and greedy tokens
  carried); under an 8-entry window whose cache is the window, a 6-token
  prefill and 8 greedy steps that wrap the ring, against one process.
* (f) ``load_pytree(shardings=)``: each rank's blocks, bit for bit.
* (g) ``launch.train.main`` with ``--data-par 2 --model-par 2`` against
  ``--data-par 1`` on the same seed.
* The dry run's counts (``launch.dryrun.resident_bytes``) on a (2 x 2)
  shape record of the mesh: the per-rank bytes of reduced
  Qwen3-MoE-30B-A3B's parameters and AdamW state equal the bytes of the
  blocks each rank holds after (a)'s sharded step.

Tolerances:
- f32 steps (a), (d): loss ``rtol 1e-5`` (measured at most 8e-8); updated
  params and both moments within 1e-5 relative Frobenius norm per tree
  leaf (measured at most 6.3e-6, Mamba2's params); the mesh-wide norm
  ``rtol 1e-6`` (measured 9e-8). (d) runs without the Switch loss, whose value differs
  by design between the two paths: the all-to-all path averages each data
  shard's (the reference's ``pmean``), the dropless path takes the whole
  batch's; with it, (d)'s leaves differ by up to 2e-3 (measured).
- bf16 steps (bf16 compute over a bf16 weight copy): partial sums round
  to bf16 on each rank, and in the MoE cases a rounding can flip a
  token's expert choice. Loss ``rtol 1e-3`` (measured at most 1.7e-4),
  norm ``rtol 1e-2`` (measured 2.6e-3), updated params 1e-2 (measured
  5.2e-3), moments 0.15 (measured at most 0.107, Qwen3-MoE's ``nu``).
- (b): ``tests/test_torch_train_launcher.py``'s gates, loss ``rtol 1e-3``,
  gradients 0.04 relative.
- (c): outputs ``atol 1e-5``, aux ``rtol 1e-6``, gradients 1e-5
  relative Frobenius norm; the no-drop check at 1e-4, as the reference's.
- (e): logits ``atol 1e-3``, as the reference's (measured 1e-6); the
  greedy tokens equal. The prefills at the same gate. The SSM and hybrid decodes: logits ``atol 1e-5``
  (measured at most 6.0e-6, Jamba on (2 x 2): the gated RMSNorm's sum
  of squares and ``out_proj``'s partial products summed over the model
  axis) and the greedy tokens equal; against JAX's sharded decode the
  same gates (measured at most 5.6e-06, Jamba on (1 x 4)).
- (g): the trainer computes in bf16, as the reference's: losses
  ``rtol 1e-3`` (measured at most 1.9e-4).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_ranks as TR  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.launch import train as TRAIN  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# the rank group's and the JAX subprocess's limit: ~10 s alone, several
# times that beside five busy test workers
GROUP_TIMEOUT_S = 240
A2A_CF = 2.0  # E / top_k of the reduced Qwen3-MoE: no expert overflows

F32_LOSS_RTOL, F32_REL, NORM_RTOL = 1e-5, 1e-5, 1e-6
BF16_LOSS_RTOL, BF16_NORM_RTOL, BF16_PARAM_REL, BF16_MOMENT_REL = 1e-3, 1e-2, 1e-2, 0.15
JAX_LOSS_RTOL, JAX_GRAD_REL, BIG_LEAF = 1e-3, 0.04, 10_000
A2A_ATOL, A2A_AUX_RTOL, A2A_GRAD_REL, NO_DROP_ATOL = 1e-5, 1e-6, 1e-5, 1e-4
DECODE_ATOL = 1e-3
SSM_DECODE_ATOL = 1e-5
LAUNCH_RTOL = 1e-3

JAX_MESH = """
import sys
sys.path.insert(0, {tests!r})
import jax, jax.numpy as jnp, numpy as np
import _torch_ranks as TR
from repro.configs import get_config
from repro.distribution.context import activation_sharding
from repro.distribution.sharding import batch_axes, cache_shardings, param_shardings
from repro.launch.mesh import make_host_mesh
from repro.models import init_caches, make_decode_step
from repro.models.moe_a2a import moe_apply_a2a
cfg = get_config('qwen3-moe-30b-a3b').reduced()
with np.load({moe!r}) as z:
    params = {{k: jnp.asarray(z[k]) for k in z.files if not k.startswith('__')}}
    x = jnp.asarray(z['__x__'])
with activation_sharding(make_host_mesh(2, 2), ('data',), moe_a2a=True):
    y, aux = jax.jit(lambda p, x: moe_apply_a2a(p, x, cfg))(params, x)
    g = jax.jit(jax.grad(lambda p: moe_apply_a2a(p, x, cfg)[0].astype(jnp.float32).sum()))(params)
out = dict(y=np.asarray(y), aux=np.asarray(aux),
           **{{'g_' + k: np.asarray(v) for k, v in g.items()}})
# the SSM and hybrid decodes under GSPMD: param_shardings (serve) and
# cache_shardings on each grid, the port's weights and tokens
for arch, path in {ssm!r}.items():
    cfg = get_config(arch).reduced()
    with np.load(path) as z:
        flat = {{k: z[k] for k in z.files}}
    params = jax.tree.map(jnp.asarray, TR.unflatten(flat))
    toks = jnp.asarray(flat['__tokens__'], jnp.int32)
    b = toks.shape[1]
    caches = init_caches(cfg, b, TR.DECODE_CACHE, dtype=jnp.float32)
    idx0 = jnp.arange(b, dtype=jnp.int32)
    for grid in {grids!r}:
        mesh = make_host_mesh(*grid)
        psh = param_shardings(jax.eval_shape(lambda: params), cfg, mesh, mode='serve')
        csh = cache_shardings(jax.eval_shape(lambda: caches), cfg, mesh, b)
        p = jax.tree.map(jax.device_put, params, psh)
        c = jax.tree.map(jax.device_put, caches, csh)
        dec = jax.jit(make_decode_step(cfg, compute_dtype=jnp.float32))
        logits = []
        with activation_sharding(mesh, batch_axes(mesh, b)):
            for t in range(toks.shape[0]):
                lg, c = dec(p, toks[t][:, None], c, idx0 + t)
                logits.append(np.asarray(lg))
        out['decode|%s|%s' % (arch, tuple(grid))] = np.stack(logits)
# a prefill and teacher-forced greedy steps on the (1 x 4) length split,
# the port's weights, prompts and greedy tokens
from dataclasses import replace
from repro.models import make_prefill_step
cfg = replace(get_config('qwen2.5-3b').reduced(), num_kv_heads=1)
with np.load({prefill!r}) as z:
    flat = {{k: z[k] for k in z.files}}
params = jax.tree.map(jnp.asarray, TR.unflatten(flat))
prompts = jnp.asarray(flat['__prompts__'], jnp.int32)
fed = jnp.asarray(flat['__fed__'], jnp.int32)
starts = jnp.asarray(TR.prefill_starts('length'), jnp.int32)
b, plen = prompts.shape
caches = init_caches(cfg, b, TR.PREFILL_CACHE, dtype=jnp.float32)
mesh = make_host_mesh(1, 4)
psh = param_shardings(jax.eval_shape(lambda: params), cfg, mesh, mode='serve')
csh = cache_shardings(jax.eval_shape(lambda: caches), cfg, mesh, b)
p = jax.tree.map(jax.device_put, params, psh)
c = jax.tree.map(jax.device_put, caches, csh)
pre = jax.jit(make_prefill_step(cfg, compute_dtype=jnp.float32))
dec = jax.jit(make_decode_step(cfg, compute_dtype=jnp.float32))
with activation_sharding(mesh, batch_axes(mesh, b)):
    lg, c = pre(p, prompts, c)
    logits = [np.asarray(lg)]
    for t in range(fed.shape[0]):
        lg, c = dec(p, fed[t][:, None], c, starts + t)
        logits.append(np.asarray(lg))
out['prefill|length'] = np.stack(logits)
np.savez({out!r}, **out)
print('JAX_MESH_OK')
"""


def _moe_inputs(path):
    cfg = TR.tp_config("qwen3-moe-30b-a3b")
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.expert_d_ff
    rng = np.random.default_rng(4)
    arrs = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
            "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
            "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
            "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f),
            "__x__": rng.standard_normal((2, 16, d))}
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrs.items()})
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in arrs.items()}


def _one_process():
    """The one-process port references of (a), (c), (d), (e), (g)."""
    ref = {"train": {}}
    for name, arch, over, dtype in TR.tp_train_cases():
        cfg = TR.tp_config(arch, **over)
        params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        batch = TR.tp_batch(cfg, TR.TP_ROWS, TR.TP_SEQ, seed=1)
        _, grads, m = TR.tp_step(cfg, dtype, None, TR.CaptureGrads())(params, None, batch)
        new, state = TR.tp_update(params, grads)
        ref["train"][name] = dict(loss=float(m["loss"]), norm=float(TO.global_norm(grads)),
                                  params=new, mu=state.mu, nu=state.nu)
    cfg = TR.a2a_train_config(A2A_CF)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = TO.adamw(1e-3, max_grad_norm=TR.TP_CLIP)
    new, state, m = TR.tp_step(cfg, "float32", None, opt)(
        params, opt.init(params), TR.tp_batch(cfg, TR.TP_ROWS, TR.TP_SEQ, seed=1))
    ref["a2a_train"] = dict(loss=float(m["loss"]), aux=float(m["aux"]), params=new,
                            mu=state.mu)
    ref["decode"] = {name: TR.decode_run(None, kv) for name, kv in (("length", 1),
                                                                    ("heads", 2))}
    ref["decode"].update({arch: TR.decode_run(None, None, arch)
                          for arch in {a for a, _ in TR.SSM_DECODE_CASES}})
    ref["decode"]["prefill|ring"] = TR.prefill_run(None, "ring")
    ref["launcher"] = TRAIN.main(TR.TRAIN_ARGV)["losses"]
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    # (b)'s weights and batch, the JAX package's
    jcfg = JC.get_config("stablelm-1.6b").reduced()
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    flat = TR.flatten(jp)
    for k in ("__tokens__", "__labels__"):
        flat[k] = rng.integers(0, jcfg.vocab_size, (TR.TP_ROWS, TR.TP_SEQ)).astype(np.int32)
    stablelm = os.fspath(tmp / "stablelm.npz")
    np.savez(stablelm, **flat)
    moe = os.fspath(tmp / "moe.npz")
    moe_in = _moe_inputs(moe)
    jax_out = os.fspath(tmp / "jax_mesh.npz")
    ssm = {}  # the SSM decodes' weights and tokens, for the JAX side
    for arch in {a for a, _ in TR.SSM_DECODE_CASES}:
        cfg, params = TR.decode_case(None, arch)
        dflat = TR.flatten(W.model_params_to_numpy(params))
        dflat["__tokens__"] = TR.decode_tokens(cfg)
        ssm[arch] = os.fspath(tmp / f"ssm_{arch}.npz")
        np.savez(ssm[arch], **dflat)
    # the length-split prefill's one-process run first: its greedy tokens
    # are fed to the JAX side
    length = TR.prefill_run(None, "length")
    cfg, prompts, _, _ = TR.prefill_inputs("length")
    pflat = TR.flatten(W.model_params_to_numpy(
        TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")))
    pflat["__prompts__"], pflat["__fed__"] = prompts, length["tokens"].numpy()
    prefill = os.fspath(tmp / "prefill.npz")
    np.savez(prefill, **pflat)
    env = dict(os.environ, PYTHONPATH=TR.SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jproc = subprocess.Popen([sys.executable, "-c", JAX_MESH.format(
        tests=TR.HERE, moe=moe, ssm=ssm, out=jax_out, prefill=prefill,
        grids=sorted({g for _, g in TR.SSM_DECODE_CASES}))],
                             env=env, cwd=TR.REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        group = TR.start("tensor_parallel_runs", 4, tmp / "ranks",
                         stablelm_path=stablelm, moe_path=moe, a2a_cf=A2A_CF)
        batch = {"tokens": jnp.asarray(flat["__tokens__"]),
                 "labels": jnp.asarray(flat["__labels__"])}

        class Capture:
            def update(self, grads, state, params):
                return jax.tree.map(jnp.zeros_like, grads), grads

        _, jgrads, jm = jax.jit(JM.make_train_step(jcfg, Capture()))(
            jax.tree.map(jnp.asarray, jp), None, batch)
        ref = _one_process()
        ref["decode"]["prefill|length"] = length
        cfg4 = TR.tp_config("qwen3-moe-30b-a3b", moe={"capacity_factor": A2A_CF})
        ref["moe_apply"] = TL.moe_apply({k: v for k, v in moe_in.items()
                                         if not k.startswith("__")},
                                        moe_in["__x__"], cfg4)[0]
        ranks = TR.finish(group, GROUP_TIMEOUT_S)
        out, _ = jproc.communicate(timeout=GROUP_TIMEOUT_S)
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0 and "JAX_MESH_OK" in out, out[-4000:]
    with np.load(jax_out) as z:
        jax_mesh = {k: z[k] for k in z.files}
    return dict(ranks=ranks, lead=ranks[0], ref=ref, jax_mesh=jax_mesh,
                jax_step=(float(jm["loss"]), jax.tree.map(np.asarray, jgrads)))


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def _worst(a, b, skip=()):
    return max(_rel(x, y) for (p, x), y in zip(_paths(a), tree_leaves(b))
               if not any(s in p for s in skip))


def _paths(tree):
    from repro_torch.tree import tree_leaves_with_path

    return [("/".join(p), x) for p, x in tree_leaves_with_path(tree)]


CASES = [c[0] for c in TR.tp_train_cases()]


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_one_process(runs, case):
    got, ref = runs["lead"]["train"][case], runs["ref"]["train"][case]
    f32 = case.endswith("float32")
    assert ref["norm"] > TR.TP_CLIP  # the clip acts
    assert got["norm"] == pytest.approx(ref["norm"], rel=NORM_RTOL if f32 else BF16_NORM_RTOL)
    assert got["loss"] == pytest.approx(ref["loss"], rel=F32_LOSS_RTOL if f32 else BF16_LOSS_RTOL)
    assert _worst(got["params"], ref["params"]) <= (F32_REL if f32 else BF16_PARAM_REL)
    for k in ("mu", "nu"):
        assert _worst(got[k], ref[k]) <= (F32_REL if f32 else BF16_MOMENT_REL), k


def test_each_rank_holds_its_blocks(runs):
    """A quarter of the (data x model)-sharded leaves on each rank: embed
    (V, D) over (model, data), the first moment of the last leaf of
    StableLM's slot (``mlp/w_down`` (F, D)) over (model, data) below the
    repeats."""
    for r in runs["ranks"]:
        shapes = r["train"]["stablelm-float32"]["block_shapes"]
        assert shapes == {"embed": (256, 128), "mu_slot0": (2, 256, 128)}


def test_sharded_step_matches_jax(runs):
    lref, gref = runs["jax_step"]
    got = runs["lead"]["jax_step"]
    assert got["loss"] == pytest.approx(lref, rel=JAX_LOSS_RTOL)
    grads = W.model_params_to_numpy(got["grads"])
    flat = np.concatenate([x.ravel() for x in jax.tree.leaves(grads)])
    rflat = np.concatenate([x.ravel() for x in jax.tree.leaves(gref)])
    assert np.linalg.norm(flat - rflat) <= JAX_GRAD_REL * np.linalg.norm(rflat)
    for g, r in zip(jax.tree.leaves(grads), jax.tree.leaves(gref)):
        if r.size > BIG_LEAF:
            assert np.linalg.norm(g - r) <= JAX_GRAD_REL * np.linalg.norm(r)


def test_moe_a2a_matches_jax_where_copies_drop(runs):
    got, ref = runs["lead"]["a2a"]["default"], runs["jax_mesh"]
    assert got["dropped"] >= 1
    np.testing.assert_allclose(got["y"].numpy(), ref["y"], atol=A2A_ATOL)
    assert got["aux"] == pytest.approx(float(ref["aux"]), rel=A2A_AUX_RTOL)
    for k, g in got["grads"].items():
        assert torch.isfinite(g).all()
        assert _rel(g, torch.from_numpy(ref["g_" + k])) <= A2A_GRAD_REL, k


def test_moe_a2a_without_drops_matches_moe_apply(runs):
    got = runs["lead"]["a2a"]["cf"]
    assert got["dropped"] == 0
    np.testing.assert_allclose(got["y"].numpy(), runs["ref"]["moe_apply"].numpy(),
                               atol=NO_DROP_ATOL)
    assert all(torch.isfinite(g).all() for g in got["grads"].values())


def test_a2a_train_step(runs):
    got, ref = runs["lead"]["a2a_train"], runs["ref"]["a2a_train"]
    assert np.isfinite(got["loss"]) and got["aux"] == ref["aux"] == 0.0
    assert got["loss"] == pytest.approx(ref["loss"], rel=F32_LOSS_RTOL)
    for k in ("params", "mu"):
        assert _worst(got[k], ref[k]) <= F32_REL, k


@pytest.mark.parametrize("cache", ["length", "heads"])
def test_sharded_decode_matches_one_process(runs, cache):
    got, ref = runs["lead"]["decode"][cache], runs["ref"]["decode"][cache]
    length = cache == "length"
    assert got["spec"][2:4] == (("model", None) if length else (None, "model"))
    # every layer of every step through flash_decode on each rank, and only there
    assert got["flash"] == (TR.DECODE_STEPS * 2 if length else 0) and ref["flash"] == 0
    np.testing.assert_allclose(got["logits"].numpy(), ref["logits"].numpy(),
                               atol=DECODE_ATOL)
    assert torch.equal(got["logits"].argmax(-1), ref["logits"].argmax(-1))


@pytest.mark.parametrize("arch,grid", TR.SSM_DECODE_CASES)
def test_sharded_ssm_decode_matches_one_process(runs, arch, grid):
    """A Mamba block decodes on a model axis above 1: this rank's SSM
    heads and conv channels, as ``cache_shardings`` places them."""
    got, ref = runs["lead"]["decode"][f"{arch}|{grid}"], runs["ref"]["decode"][arch]
    assert got["ssm_spec"] == ((None, "data", "model", None, None),
                               (None, "data", None, "model"))
    if arch.startswith("jamba"):  # 2 KV heads: by heads on 2 ranks, by length on 4
        assert got["spec"][2:4] == ((None, "model") if grid == (2, 2) else ("model", None))
        assert got["flash"] == (0 if grid == (2, 2) else TR.DECODE_STEPS)
    np.testing.assert_allclose(got["logits"].numpy(), ref["logits"].numpy(),
                               atol=SSM_DECODE_ATOL)
    assert torch.equal(got["logits"].argmax(-1), ref["logits"].argmax(-1))


@pytest.mark.parametrize("arch,grid", TR.SSM_DECODE_CASES)
def test_sharded_ssm_decode_matches_jax(runs, arch, grid):
    """The same sharded decode against the JAX package's decode step under
    ``param_shardings(mode="serve")`` and ``cache_shardings`` on the same
    grid of forced host devices (GSPMD), from the same weights and
    tokens."""
    got = runs["lead"]["decode"][f"{arch}|{grid}"]["logits"].numpy()
    ref = runs["jax_mesh"][f"decode|{arch}|{tuple(grid)}"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=SSM_DECODE_ATOL)
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


def test_load_pytree_keeps_each_ranks_blocks(runs):
    assert all(r["load"] for r in runs["ranks"])


def test_launcher_trains_on_the_mesh(runs):
    losses = runs["lead"]["launcher"]["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, runs["ref"]["launcher"], rtol=LAUNCH_RTOL)


@pytest.mark.parametrize("case", TR.PREFILL_CASES)
def test_length_split_prefill_matches_one_process(runs, case):
    """A multi-token step and a step on the ring on a cache split by
    length: the prefill's logits and every greedy step's at
    ``DECODE_ATOL``, the greedy tokens equal; ``flash_decode`` only on the
    one-token steps off the ring."""
    got, ref = runs["lead"]["decode"][f"prefill|{case}"], runs["ref"]["decode"][f"prefill|{case}"]
    cfg, prompts, cache, steps = TR.prefill_inputs(case)
    assert got["spec"][2:4] == ("model", None)  # split by length
    assert got["logits"].shape == (steps + 1, TR.DECODE_BATCH, cfg.vocab_size)
    np.testing.assert_allclose(got["logits"].numpy(), ref["logits"].numpy(),
                               atol=DECODE_ATOL)
    assert torch.equal(got["tokens"], ref["tokens"])
    attn = cfg.num_attn_layers
    assert got["flash"] == (0 if case == "ring" else steps * attn) and ref["flash"] == 0
    if case == "ring":
        assert prompts.shape[1] + steps > cfg.attention_window == cache  # it wraps


def test_length_split_prefill_matches_jax(runs):
    got = runs["lead"]["decode"]["prefill|length"]["logits"].numpy()
    ref = runs["jax_mesh"]["prefill|length"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=DECODE_ATOL)
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


def test_dryrun_bytes_equal_the_blocks_each_rank_holds(runs):
    """The counterpart of ``tests/test_flash_decode.py``'s
    ``test_dryrun_builder_on_host_mesh``: the dry run's per-rank parameter
    and moment bytes on a (2 x 2) shape record (no ranks, no storage) equal
    what each rank holds after a sharded train step, whose loss is
    finite."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Mesh

    name, arch, over, _ = next(c for c in TR.tp_train_cases()
                               if c[0] == "qwen3-moe-float32")
    cfg = TR.tp_config(arch, **over)
    record = Mesh(("data", "model"), (2, 2), coords=(0, 0), device=torch.device("meta"))
    want = DR.resident_bytes(cfg, ShapeConfig("tp", TR.TP_SEQ, TR.TP_ROWS, "train"),
                             record)
    for r in runs["ranks"]:
        held = r["train"][name]["held_bytes"]
        assert np.isfinite(r["train"][name]["loss"])
        assert held == {"params": want["params_bytes"], "moments": want["moments_bytes"]}
