"""Gloo ranks for the port's multi-process tests, on the CPU.

``spawn(worker, world, tmp_path, **kwargs)`` (or :func:`start`, then
:func:`finish`) starts ``world`` processes (``python
tests/_torch_ranks.py``), each of which joins one gloo group through a
``FileStore`` under ``tmp_path`` (no TCP port, so parallel test workers
cannot collide), runs ``WORKERS[worker](rank, world, tmp, **kwargs)``,
saves what it returns with ``torch.save`` and destroys its group in
``finally``; ``finish`` returns the ranks' results in rank order. A group
that has not finished within ``timeout`` seconds is killed and the test
fails. This module imports no JAX: the ranks run the port only.
"""
import contextlib
import datetime
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src")

# the multi-rank runs: a small agent whose updates start inside the run
# (batch 16 of 28 transitions a chunk), so replay, updates and their
# generators are exercised
SMALL_SAC = dict(hidden=32, feat_dim=8, attn_dim=8, batch=16, buffer_size=2000)
SAC_KW = dict(episodes=12, warmup_episodes=4, seed=5, num_envs=4)
POP_KW = dict(episodes=8, warmup_episodes=3, seed=5, num_envs=2)
POP_QS = [0.3, 0.5, 0.7, 0.9]


def start(worker, world, tmp_path, backend="gloo", **kwargs):
    """Start ``worker`` on ``world`` ranks of a ``backend`` group;
    :func:`finish` waits."""
    tmp = os.fspath(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, worker, str(r), str(world), tmp,
         json.dumps(kwargs), backend], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return worker, tmp, procs


def finish(handle, timeout=60):
    """The ranks' results in rank order; a group that has not finished
    within ``timeout`` seconds is killed and fails the test."""
    worker, tmp, procs = handle
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 0.1)
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = "\n".join(f"rank {r}: {p.communicate()[0][-2000:]}"
                          for r, p in enumerate(procs))
        raise AssertionError(f"{worker}: {len(procs)} ranks did not finish "
                             f"within {timeout} s\n{tails}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} exited {p.returncode}:\n{out[-3000:]}"
              for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    assert not failed, f"{worker}: " + "\n".join(failed)
    import torch

    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def spawn(worker, world, tmp_path, timeout=60, backend="gloo", **kwargs):
    """Run ``worker`` on ``world`` ranks; their results in rank order."""
    return finish(start(worker, world, tmp_path, backend, **kwargs), timeout)


# ---------------------------------------------------------------------------
# the workers: (rank, world, tmp, **kwargs) -> a picklable result
# ---------------------------------------------------------------------------


def _env():
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile

    return MHSLEnv(profile=resnet101_profile(batch=1), device="cpu")


def curves(res):
    return {k: getattr(res, k) for k in ("episode_reward", "episode_leak",
                                         "episode_violation", "states_explored")}


def _scens(env, qs):
    from repro_torch.core.scenario import scenario_grid, stack_scenarios

    return stack_scenarios(scenario_grid(env.scenario(), monitor_prob=qs))


def population_runs(rank, world, tmp):
    """4 ranks: ``POP_QS`` over a 4-rank population mesh, and two of them
    over a (2 x 2) stage x env mesh (the env axis picked by name)."""
    from repro_torch.core.agents.sac import SACConfig
    from repro_torch.core.scenario import train_population
    from repro_torch.launch.mesh import make_population_mesh, make_stage_env_mesh

    env = _env()
    cfg = SACConfig(**SMALL_SAC)
    out = {}
    pop = train_population(env, cfg, _scens(env, POP_QS),
                           mesh=make_population_mesh(4, device="cpu"), **POP_KW)
    out["pop4"] = dict(results=[curves(r) for r in pop.results], params=pop.params)
    mesh = make_stage_env_mesh(2, 2, device="cpu")
    pop = train_population(env, cfg, _scens(env, POP_QS[:2]), mesh=mesh,
                           **POP_KW)
    out["stage_env"] = dict(results=[curves(r) for r in pop.results],
                            params=pop.params)
    return out


def sac_runs(rank, world, tmp):
    """2 ranks: ``train_sac`` over a 2-rank population mesh; stop and
    resume of both trainers on it; the launcher with ``--shard-envs``."""
    from repro_torch.core.agents.loops import train_sac
    from repro_torch.core.agents.sac import SACConfig
    from repro_torch.core.scenario import train_population
    from repro_torch.launch import train_mhsl_rl as LAUNCH
    from repro_torch.launch.mesh import make_population_mesh

    env = _env()
    cfg = SACConfig(**SMALL_SAC)
    mesh = make_population_mesh(device="cpu")
    out = {}
    res = train_sac(env, cfg, mesh=mesh, **SAC_KW)
    out["sac"] = dict(curves(res), params=res.params, metrics=res.metrics)
    ck = os.path.join(tmp, "sac_ck")
    train_sac(env, cfg, mesh=mesh, checkpoint_dir=ck, checkpoint_every=4,
              **dict(SAC_KW, episodes=8))
    res = train_sac(env, cfg, mesh=mesh, checkpoint_dir=ck, checkpoint_every=4,
                    **SAC_KW)
    out["sac_resumed"] = dict(curves(res), params=res.params)
    scens = _scens(env, POP_QS[:2])
    ck = os.path.join(tmp, "pop_ck")
    train_population(env, cfg, scens, mesh=mesh, checkpoint_dir=ck,
                     checkpoint_every=2, **dict(POP_KW, episodes=4))
    pop = train_population(env, cfg, scens, mesh=mesh, checkpoint_dir=ck,
                           checkpoint_every=2, **POP_KW)
    out["pop_resumed"] = dict(results=[curves(r) for r in pop.results],
                              params=pop.params)
    launched = LAUNCH.main(["--shard-envs", "--reduced", "--device", "cpu",
                            "--episodes", "4", "--num-envs", "2",
                            "--pipeline-steps", "1", "--batch", "4", "--seq",
                            "16", "--eval-batch", "2", "--eval-seq", "16"])
    out["launcher"] = dict(rewards=launched["train"].episode_reward,
                           keys=sorted(launched))
    return out


def _stage_case(params_path, arch, layers):
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs as TC
    from repro_torch import weights as W

    cfg = dataclasses.replace(TC.get_config(arch).reduced(), num_layers=layers)
    with np.load(params_path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    params = W.model_params_from_jax(unflatten(flat), "cpu")
    tok = torch.from_numpy(flat["__tokens__"]).long()
    lab = torch.from_numpy(flat["__labels__"]).long()
    return cfg, params, tok, lab


def flatten(tree, prefix=""):
    """``{"a/b/0": array}`` from a nested tree of dicts and tuples of
    arrays (the layout the JAX package's parameters have)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        import numpy as np

        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat):
    """The nested params tree from ``{"a/b/0": array}`` (``flatten``'s
    inverse; ``__``-prefixed entries are data, not params)."""
    tree = {}
    for k, v in flat.items():
        if k.startswith("__"):
            continue
        node, parts = tree, k.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return tuple(node[str(i)] for i in range(len(node)))
        return node

    return fix(tree)


def stage_runs(rank, world, tmp, params_path, arch, layers, bounds, micro,
               wires, env_axis_case):
    """A 2-stage step on ranks 0-1 for each wire dtype (the other ranks
    idle), then, on 4 ranks, the (2 x 2) ``env_axis`` step; rank 0
    returns the assembled gradients. Then serving on stage ranks: the
    token ring on 2 and on 4 ranks at each wire dtype (every rank returns
    the logits and its ring), ``ServingService`` on 4 ranks without and
    with ``reference_schedule`` faults; and the launcher on 2 stage ranks
    (``LAUNCH_ARGV`` with a checkpoint directory), then again, resuming
    from its checkpoint. Then the collective recorder: the 1F1B step on
    3 stage ranks under each transport, recorded and not, and two plain
    transfers of known size."""
    import torch.distributed as dist

    from repro_torch.core import pipeline as P
    from repro_torch.launch import train_mhsl_rl as LAUNCH
    from repro_torch.launch.mesh import make_stage_env_mesh, make_stage_mesh

    cfg, params, tok, lab = _stage_case(params_path, arch, layers)
    out = {}
    mesh = make_stage_mesh(2, device="cpu")
    for wire in wires:
        if mesh.coords is None:
            continue
        pipe = P.PipelineConfig(compute_dtype="float32", wire_dtype=wire)
        step = P.pipeline_step_fn(cfg, bounds, micro, pipe=pipe, mesh=mesh)
        local = P.stage_params(params, cfg, bounds, mesh.axis_index("stage"))
        loss, grads = step(local, tok, lab)
        out[wire] = (float(loss), P.gather_stage_tree(grads, params, cfg,
                                                      bounds, mesh))
    dist.barrier()
    if env_axis_case and world == 4:
        mesh4 = make_stage_env_mesh(2, 2, device="cpu")
        pipe = P.PipelineConfig(compute_dtype="float32")
        step = P.pipeline_step_fn(cfg, bounds, micro, pipe=pipe, mesh=mesh4,
                                  env_axis="env")
        local = P.stage_params(params, cfg, bounds, mesh4.axis_index("stage"))
        loss, grads = step(local, tok, lab)
        out["env"] = (float(loss), P.gather_stage_tree(grads, params, cfg,
                                                       bounds, mesh4))
    if world == 4:
        ring4 = make_stage_mesh(4, device="cpu")
        out["serve"] = {}
        for n, m in ((2, mesh), (4, ring4)):
            if m.coords is None:
                continue
            for wire in wires:
                out["serve"][(n, wire)] = serve_pass(cfg, params, SERVE_BOUNDS[n],
                                                     wire, m)
        out["service"] = service_runs(cfg, params, ring4)
        ckpt = ["--checkpoint-dir", os.path.join(tmp, "launcher_ckpt")]
        out["launcher"], out["resumed"] = (
            _launched(LAUNCH.main(LAUNCH_ARGV + ckpt)) for _ in range(2))
        out["recorded"] = recorded_runs(cfg, params, tok, lab, micro, mesh, ring4)
    return out


RECORD_BOUNDS = (1, 3, 4)


def recorded_runs(cfg, params, tok, lab, micro, mesh2, mesh4):
    """Under ``record_collectives``: the 1F1B step on a 3-stage mesh
    (ranks 0-2) under ``transport="sync"`` and ``"overlap"``, each
    recorded and then run again unrecorded (its per-tick counts, and
    whether the two runs' loss and this rank's gradients are bit for bit
    equal); an all-gather of a (4, 8) f32 block over the 2-rank mesh and
    an all-reduce of a (4, 4) f32 tensor over the 4-rank one."""
    import torch

    from repro_torch.core import pipeline as P
    from repro_torch.distribution import collectives as C
    from repro_torch.launch.hlo_analysis import pipeline_collective_counts
    from repro_torch.launch.mesh import make_stage_mesh

    mesh3 = make_stage_mesh(3, device="cpu")
    out = {}
    if mesh3.coords is not None:
        local = P.stage_params(params, cfg, RECORD_BOUNDS, mesh3.axis_index("stage"))
        ticks = micro + 2 * (len(RECORD_BOUNDS) - 1)
        for tr in ("sync", "overlap"):
            step = P.pipeline_step_fn(cfg, RECORD_BOUNDS, micro, mesh=mesh3,
                                      pipe=P.PipelineConfig(transport=tr,
                                                            compute_dtype="float32"))
            with C.record_collectives() as st:
                loss, grads = step(local, tok, lab)
            loss0, grads0 = step(local, tok, lab)
            same = bool(torch.equal(loss, loss0)) and all(
                torch.equal(a, b) for a, b in zip(_leaves(grads), _leaves(grads0)))
            out[tr] = dict(per_tick=pipeline_collective_counts(st, ticks),
                           counts=dict(st.counts), bitwise=same)
    with C.record_collectives() as st:
        if mesh2.coords is not None:
            C.all_gather(torch.ones(4, 8), mesh2, "stage", dim=0)
        C.all_reduce(torch.ones(4, 4), mesh4, "stage")
    out["plain"] = st.as_dict()
    return out


def _leaves(tree):
    from repro_torch.tree import tree_leaves

    return tree_leaves(tree)


def _launched(res):
    """What the launcher tests read of ``train_mhsl_rl.main``'s result."""
    out = {k: res[k] for k in ("boundaries", "losses", "grad_norms", "eval_loss",
                               "params") if k in res}
    out["trained"] = res["train"] is not None
    return out


# serving on stage ranks: the token ring's prefill (B x P prompts) and one
# decode tick at per-row positions, on 2 and on 4 stages
SERVE_B, SERVE_P, SERVE_EXTRA = 3, 8, 4
SERVE_BOUNDS = {2: (1, 4), 4: (1, 2, 3, 4)}
# the service on 4 stage ranks: tests/test_torch_faults.py's settings
SERVICE_KW = dict(num_slots=3, arrival_slots=2, prompt_pad=8, max_new=8,
                  decode_chunk=2, fault_tick_s=0.02, max_retries=2,
                  retry_backoff_s=0.005)
# the launcher on 2 stage ranks (a tied config: Qwen2.5-3B reduced)
LAUNCH_ARGV = ["--reduced", "--device", "cpu", "--episodes", "4", "--num-envs", "2",
               "--pipeline-steps", "2", "--batch", "4", "--seq", "16",
               "--eval-batch", "2", "--eval-seq", "16", "--stages", "2"]


def serve_inputs(vocab):
    """The prompts (B, P), the decode tokens (B, 1) and positions (B,)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, vocab, (SERVE_B, SERVE_P)))
    tok = torch.from_numpy(rng.integers(0, vocab, (SERVE_B, 1)))
    return prompts, tok, torch.tensor([SERVE_P, SERVE_P - 3, SERVE_P - 1])


def serve_pass(cfg, params, bounds, wire, mesh=None):
    """A prefill and one decode tick through ``PipelineRunner`` (on
    ``mesh``: this rank's stage over its share of ``params``): the logits
    and the KV rings (on a mesh, this rank's)."""
    from repro_torch.core import pipeline as P
    from repro_torch.serving import PipelineRunner

    pipe = P.PipelineConfig(compute_dtype="float32", wire_dtype=wire)
    runner = PipelineRunner(cfg, bounds, pipe=pipe, device="cpu", mesh=mesh)
    if mesh is not None:
        params = P.stage_params(params, cfg, bounds, mesh.axis_index("stage"))
    prompts, tok, pos = serve_inputs(cfg.vocab_size)
    caches = runner.init_caches(SERVE_B, SERVE_P + SERVE_EXTRA)
    lg, caches = runner.prefill(params, caches, prompts)
    dl, caches = runner.decode(params, tok, caches, pos)
    return {"prefill": lg, "decode": dl, "k": caches["k"], "v": caches["v"]}


def service_runs(cfg, params, mesh=None):
    """``ServingService`` over a Poisson trace on the 4-stage plan of
    reduced Qwen2.5-3B at ``cfg``'s depth (``params``: the whole tree), without
    and with ``reference_schedule(4, 3)`` faults: each run's completions
    (and on the deciding rank its fault counts)."""
    from repro_torch.core.faults import reference_schedule
    from repro_torch.serving import ServeConfig, ServingService, poisson_trace

    scfg = ServeConfig(arch="qwen2_5_3b", num_layers=cfg.num_layers,
                       boundaries=SERVE_BOUNDS[4], **SERVICE_KW)
    assert scfg.model_config() == cfg
    trace = poisson_trace(n_requests=6, rate_per_sec=50.0, vocab_size=cfg.vocab_size,
                          plen_range=(2, 8), gen_range=(2, 8), seed=3)
    out = {}
    for name, faults in (("free", None), ("faulted", reference_schedule(
            4, 3, tick_seconds=SERVICE_KW["fault_tick_s"], device="cpu"))):
        res = ServingService(scfg, params, device="cpu", mesh=mesh).run(
            list(trace), faults=faults)
        out[name] = {k: res[k] for k in ("completions", "fault_events", "evictions")
                     if k in res}
    return out


# ---------------------------------------------------------------------------
# the (data x model) mesh: sharded train and decode steps, moe_a2a,
# load_pytree(shardings=) and the zoo trainer on a (2 x 2) host mesh
# ---------------------------------------------------------------------------


class CaptureGrads:
    """An optimizer that returns zero updates and keeps the gradients as
    its state (so a step hands them back)."""

    def update(self, grads, state, params=None, shardings=None):
        from repro_torch.tree import tree_map

        return tree_map(lambda g: g * 0, grads), grads


def tp_config(arch, **over):
    """The reduced arch with ``over`` replaced (an ``moe`` dict replaces
    fields of the MoE config)."""
    import dataclasses

    from repro_torch import configs as TC

    cfg = TC.get_config(arch).reduced()
    if "moe" in over:
        over = dict(over, moe=dataclasses.replace(cfg.moe, **over["moe"]))
    return dataclasses.replace(cfg, **over)


def tp_batch(cfg, rows, seq, seed):
    """A numpy-drawn batch of the whole ``rows`` (the same on every rank)."""
    from repro_torch.data import synthetic_batch

    return synthetic_batch(cfg, rows, seq, seed=seed, device="cpu")


def tp_train_cases():
    """(name, arch, overrides, dtype) of the (2 x 2) train steps: three
    configs in f32 and bf16, and in f32 the capacity MoE dispatch, a
    frontend (Pixtral's projector) and tied embeddings on an SSM-only
    stack (Mamba2-370m)."""
    out = []
    for name, arch, over in (("stablelm", "stablelm-1.6b", {}),
                             ("qwen3-moe", "qwen3-moe-30b-a3b", {"num_kv_heads": 1}),
                             ("jamba", "jamba-v0.1-52b", {})):
        for dtype in ("float32", "bfloat16"):
            out.append((f"{name}-{dtype}", arch, over, dtype))
    return out + [("qwen3-moe-capacity-float32", "qwen3-moe-30b-a3b",
                   {"moe": {"dispatch": "capacity"}}, "float32"),
                  ("pixtral-float32", "pixtral-12b", {}, "float32"),
                  ("mamba2-float32", "mamba2-370m", {}, "float32")]


TP_ROWS, TP_SEQ, TP_CLIP = 4, 32, 0.5


def a2a_train_config(cf):
    """Reduced Qwen3-MoE for the ``moe_a2a`` train step: capacity factor
    ``cf``, and no Switch loss, whose value differs by design between the
    all-to-all path (each data shard's, averaged) and the dropless one
    (the whole batch's) and whose gradient reaches every leaf before the
    router."""
    return tp_config("qwen3-moe-30b-a3b",
                     moe={"capacity_factor": cf, "router_aux_weight": 0.0})


def tp_step(cfg, dtype, shardings=None, opt=None):
    """The step of a (2 x 2) train case: f32 compute, or bf16 compute over
    a bf16 weight copy."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    bf16 = dtype == "bfloat16"
    return M.make_train_step(
        cfg, opt or adamw(1e-3, max_grad_norm=TP_CLIP),
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        compute_copy_dtype=torch.bfloat16 if bf16 else None,
        param_shardings_tree=shardings)


def tp_update(params, grads, shardings=None):
    """One AdamW update (clipped at ``TP_CLIP``) from fresh moments: the
    optimizer half of a train step, on the gradients a capture step
    handed back."""
    from repro_torch.optim import adamw, apply_updates

    opt = adamw(1e-3, max_grad_norm=TP_CLIP)
    kw = {} if shardings is None else {"shardings": shardings}
    updates, state = opt.update(grads, opt.init(params), params, **kw)
    return apply_updates(params, updates), state


def tensor_parallel_runs(rank, world, tmp, stablelm_path, moe_path, a2a_cf):
    """4 ranks on a (2 x 2) (data x model) mesh: (a) the train cases, their
    gradients' mesh-wide norm and one AdamW step; (b) StableLM's bf16
    gradients from the JAX package's weights; (c) ``moe_apply_a2a`` at the
    default capacity factor (outputs, aux, drops, gradients of the output
    sum) and at ``a2a_cf``; (d) a train step with ``moe_a2a=True``; (e)
    sharded decode steps (a cache split by length, then by heads; Mamba2
    and Jamba on their SSM heads and conv channels); (f)
    ``load_pytree(shardings=)``; (g) ``launch.train`` with ``--data-par 2
    --model-par 2``. Rank 0 returns the gathered trees."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import weights as W
    from repro_torch.checkpoint.store import load_pytree, save_pytree
    from repro_torch.distribution import context as ctx
    from repro_torch.distribution import sharding as SH
    from repro_torch.launch import train as TRAIN
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe_a2a as A2A
    from repro_torch.optim import optimizers as O
    from repro_torch.tree import tree_leaves, tree_map

    mesh = make_host_mesh(2, 2, device="cpu")
    lead = rank == 0
    out = {"train": {}, "decode": {}, "seconds": {}}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        out["seconds"][name] = now - clock[0]
        clock[0] = now

    def rows(batch):
        mine = SH.shard_rows(mesh, SH.batch_axes(mesh, TP_ROWS), TP_ROWS)
        return {k: v[mine] for k, v in batch.items()}

    def gathered(tree, shardings):
        full = SH.gather_tree(tree, shardings)
        return full if lead else None

    # (a) the train cases
    for name, arch, over, dtype in tp_train_cases():
        cfg = tp_config(arch, **over)
        params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        psh = SH.param_shardings(params, cfg, mesh)
        blocks = SH.blocks(params, psh)
        batch = rows(tp_batch(cfg, TP_ROWS, TP_SEQ, seed=1))
        with ctx.activation_sharding(mesh, SH.batch_axes(mesh, TP_ROWS)):
            _, grads, m = tp_step(cfg, dtype, psh, CaptureGrads())(blocks, None, batch)
            norm = float(O.global_norm(grads, psh))
            new, state = tp_update(blocks, grads, psh)
        out["train"][name] = dict(
            loss=float(m["loss"]), aux=float(m["aux"]), norm=norm,
            grads=gathered(grads, psh), params=gathered(new, psh),
            mu=gathered(state.mu, psh), nu=gathered(state.nu, psh),
            block_shapes={"embed": tuple(new["embed"].shape),
                          "mu_slot0": tuple(tree_leaves(state.mu["slots"][0])[-1].shape)},
            held_bytes={"params": _nbytes(new), "moments": _nbytes(state)})

    lap("a")
    # (b) StableLM from the JAX package's weights, bf16 as the reference
    with np.load(stablelm_path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    cfg = tp_config("stablelm-1.6b")
    params = W.model_params_from_jax(unflatten(flat), "cpu")
    psh = SH.param_shardings(params, cfg, mesh)
    batch = {"tokens": torch.from_numpy(flat["__tokens__"]).long(),
             "labels": torch.from_numpy(flat["__labels__"]).long()}
    with ctx.activation_sharding(mesh, SH.batch_axes(mesh, TP_ROWS)):
        _, grads, m = M.make_train_step(cfg, CaptureGrads(), param_shardings_tree=psh)(
            SH.blocks(params, psh), None, rows(batch))
    out["jax_step"] = dict(loss=float(m["loss"]), grads=gathered(grads, psh))

    lap("b")
    # (c) moe_apply_a2a: the default capacity factor, then a2a_cf
    with np.load(moe_path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    x_all = torch.from_numpy(flat["__x__"])
    mp = {k: torch.from_numpy(v) for k, v in flat.items() if not k.startswith("__")}
    out["a2a"] = {}
    for cf in (None, a2a_cf):
        cfg = tp_config("qwen3-moe-30b-a3b")
        if cf is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        msh = SH.param_shardings(mp, cfg, mesh)
        xs = SH.batch_sharding(mesh, x_all.shape[0], extra_dims=2)
        x = xs.block(x_all)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(SH.blocks(mp, msh))]
        blk = dict(zip(mp, leaves))
        with ctx.activation_sharding(mesh, SH.batch_axes(mesh, x_all.shape[0]),
                                     moe_a2a=True):
            split = SH.model_split(cfg, mesh, ctx.batch_axes())
            assert A2A.a2a_applicable(cfg)
            y, aux = A2A.moe_apply_a2a(SH.use_tree(blk, msh, split), x, cfg)
            g = torch.autograd.grad(y.float().sum(), leaves)
            grads = SH.sync_grads(dict(zip(mp, g)), msh, split)
            dropped = torch.tensor(float(A2A.dropped_choices(mp, x, cfg)))
            dropped = SH.gather_tree({"d": dropped[None]}, {"d": SH.Sharding(mesh, ("data",))})
            ys = SH.gather_tree(y.detach(), xs)
        out["a2a"]["default" if cf is None else "cf"] = dict(
            y=ys if lead else None, aux=float(aux.detach()), dropped=float(dropped["d"].sum()),
            grads=gathered(grads, msh))

    lap("c")
    # (d) a train step through moe_a2a, at a capacity factor with no drops
    cfg = a2a_train_config(a2a_cf)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    psh = SH.param_shardings(params, cfg, mesh)
    batch = rows(tp_batch(cfg, TP_ROWS, TP_SEQ, seed=1))
    opt = O.adamw(1e-3, max_grad_norm=TP_CLIP)
    blocks = SH.blocks(params, psh)
    with ctx.activation_sharding(mesh, SH.batch_axes(mesh, TP_ROWS), moe_a2a=True):
        new, state, m = tp_step(cfg, "float32", psh, opt)(blocks, opt.init(blocks), batch)
    out["a2a_train"] = dict(loss=float(m["loss"]), aux=float(m["aux"]),
                            params=gathered(new, psh), mu=gathered(state.mu, psh))

    lap("d")
    # (e) sharded decode steps; Mamba2 and the Jamba hybrid on the (2 x 2)
    # mesh and on a (1 x 4) one
    for name, kv in (("length", 1), ("heads", 2)):
        out["decode"][name] = decode_run(mesh, kv)
    line = make_host_mesh(1, 4, device="cpu")
    for arch, grid in SSM_DECODE_CASES:
        out["decode"][f"{arch}|{grid}"] = decode_run(
            mesh if grid == (2, 2) else line, None, arch)
    # a prefill, then greedy steps, on a cache split by length; the ring
    for case in PREFILL_CASES:
        out["decode"][f"prefill|{case}"] = prefill_run(line, case)

    lap("e")
    # (f) load_pytree(shardings=): the whole tree saved, each rank its blocks
    cfg = tp_config("stablelm-1.6b")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    psh = SH.param_shardings(params, cfg, mesh)
    ck = os.path.join(tmp, "params.npz")
    if lead:
        save_pytree(params, ck)
    dist.barrier()
    blocks = SH.blocks(params, psh)
    back = load_pytree(ck, tree_map(torch.zeros_like, blocks), shardings=psh)
    out["load"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                         tree_leaves(blocks)))

    lap("f")
    # (g) the zoo trainer on the (2 x 2) mesh
    res = TRAIN.main(TRAIN_ARGV + ["--data-par", "2", "--model-par", "2",
                                   "--ckpt", os.path.join(tmp, "trained.npz")])
    out["launcher"] = dict(losses=res["losses"])
    lap("g")
    return out


# the sharded decode of SSM and hybrid configs: (arch, (data, model))
SSM_DECODE_CASES = [(arch, grid) for arch in ("mamba2-370m", "jamba-v0.1-52b")
                    for grid in ((2, 2), (1, 4))]
TRAIN_ARGV = ["--arch", "stablelm-1.6b", "--steps", "3", "--batch", "4", "--seq",
              "32", "--device", "cpu"]
DECODE_STEPS, DECODE_BATCH, DECODE_CACHE = 6, 2, 8


def _nbytes(tree):
    from repro_torch.tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


# a prefill of PREFILL_LEN tokens and PREFILL_STEPS greedy steps on the
# (1 x 4) mesh, one KV head (so the cache is split by length): "length"
# on a PREFILL_CACHE-entry cache (8 entries a rank), each row's steps from
# its own PREFILL_STARTS position (the prefill on ranks 0 and 1; row 0 on
# rank 2, row 1 crossing from rank 2 into 3);
# "ring" under a RING_WINDOW-entry window whose cache is the window (the
# decode steps, from the prompt's end, wrap around it)
PREFILL_CASES = ("length", "ring")
PREFILL_LEN, PREFILL_STEPS, PREFILL_CACHE = 16, 4, 32
PREFILL_STARTS = (16, 22)
RING_WINDOW, RING_PROMPT, RING_STEPS = 8, 6, 8


def prefill_config(case):
    cfg = tp_config("qwen2.5-3b", num_kv_heads=1)
    return cfg.with_window(RING_WINDOW) if case == "ring" else cfg


def prefill_inputs(case):
    """(config, prompts (B, P), cache length, steps) of a prefill case."""
    import numpy as np

    cfg = prefill_config(case)
    plen, cache, steps = ((RING_PROMPT, RING_WINDOW, RING_STEPS) if case == "ring"
                          else (PREFILL_LEN, PREFILL_CACHE, PREFILL_STEPS))
    rng = np.random.default_rng(5)
    return cfg, rng.integers(0, cfg.vocab_size, (DECODE_BATCH, plen)), cache, steps


def prefill_starts(case):
    """Each row's first decode position (B,) of a prefill case."""
    import numpy as np

    if case == "ring":
        return np.full(DECODE_BATCH, RING_PROMPT)
    return np.asarray(PREFILL_STARTS)


def prefill_run(mesh, case, tokens=None):
    """An f32 prefill of a case's prompts, then its greedy decode steps
    (or the given ``tokens`` (steps, B), teacher-forced), on ``mesh``
    (``None``: in one process). Returns the logits (steps + 1, B, V), the
    fed tokens (steps, B) and the ``flash_decode`` calls."""
    import torch

    from repro_torch.distribution import context as ctx
    from repro_torch.distribution import sharding as SH
    from repro_torch.models import flash_decode as FD
    from repro_torch.models import model as M

    cfg, prompts, cache_len, steps = prefill_inputs(case)
    starts = torch.from_numpy(prefill_starts(case)).long()
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    caches = M.init_caches(cfg, DECODE_BATCH, cache_len, dtype=torch.float32,
                           device="cpu")
    prompts = torch.from_numpy(prompts).long()
    kw = dict(compute_dtype=torch.float32)
    calls = []
    real = FD.flash_decode

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    FD.flash_decode = counted
    try:
        if mesh is None:
            prefill, decode = M.make_prefill_step(cfg, **kw), M.make_decode_step(cfg, **kw)
            rows = prows = lambda t: t  # noqa: E731
            whole = lambda lg: lg  # noqa: E731
            spec, run = None, contextlib.nullcontext
        else:
            psh = SH.param_shardings(params, cfg, mesh, mode="serve")
            csh = SH.cache_shardings(caches, cfg, mesh, DECODE_BATCH)
            bsh = SH.batch_sharding(mesh, DECODE_BATCH, extra_dims=0)
            kw.update(param_shardings_tree=psh, cache_shardings_tree=csh)
            prefill, decode = M.make_prefill_step(cfg, **kw), M.make_decode_step(cfg, **kw)
            params, caches = SH.blocks(params, psh), SH.blocks(caches, csh)
            rows = bsh.block
            prows = SH.batch_sharding(mesh, DECODE_BATCH).block
            whole = lambda lg: SH.gather_tree(  # noqa: E731
                lg, SH.batch_sharding(mesh, DECODE_BATCH))
            spec = csh[0]["k"].spec
            run = lambda: ctx.activation_sharding(  # noqa: E731
                mesh, SH.batch_axes(mesh, DECODE_BATCH))
        with run():
            lg, caches = prefill(params, prows(prompts), caches)
            logits, fed = [whole(lg)], []
            for t in range(steps):
                tok = logits[-1].argmax(-1) if tokens is None else tokens[t]
                fed.append(tok)
                lg, caches = decode(params, rows(tok)[:, None], caches,
                                    rows(starts + t))
                logits.append(whole(lg))
        return dict(logits=torch.stack(logits), tokens=torch.stack(fed),
                    flash=len(calls), spec=spec)
    finally:
        FD.flash_decode = real


def decode_tokens(cfg, seed=3):
    """The teacher-forced tokens (steps, B) of the decode runs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (DECODE_STEPS, DECODE_BATCH))


def decode_case(kv, arch="qwen2.5-3b"):
    import torch

    from repro_torch.models import model as M

    cfg = tp_config(arch, **({} if kv is None else {"num_kv_heads": kv}))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, params


def decode_run(mesh, kv, arch="qwen2.5-3b"):
    """``DECODE_STEPS`` f32 decode steps of reduced ``arch`` (with ``kv``
    KV heads, unless None) from an empty ``DECODE_CACHE``-entry cache, each
    row at its own position (row b starts at b), on ``mesh``
    (``mesh=None``: in one process). Returns the logits of every step (B,
    V) and whether the steps went through ``flash_decode``."""
    import torch

    from repro_torch.distribution import context as ctx
    from repro_torch.distribution import sharding as SH
    from repro_torch.models import flash_decode as FD
    from repro_torch.models import model as M

    cfg, params = decode_case(kv, arch)
    caches = M.init_caches(cfg, DECODE_BATCH, DECODE_CACHE, dtype=torch.float32,
                           device="cpu")
    toks = torch.from_numpy(decode_tokens(cfg)).long()
    idx0 = torch.arange(DECODE_BATCH)
    calls = []
    real = FD.flash_decode

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    FD.flash_decode = counted
    try:
        if mesh is None:
            step = M.make_decode_step(cfg, compute_dtype=torch.float32)
            out = []
            for t in range(DECODE_STEPS):
                lg, caches = step(params, toks[t][:, None], caches, idx0 + t)
                out.append(lg)
            return dict(logits=torch.stack(out), flash=len(calls))
        psh = SH.param_shardings(params, cfg, mesh, mode="serve")
        csh = SH.cache_shardings(caches, cfg, mesh, DECODE_BATCH)
        bsh = SH.batch_sharding(mesh, DECODE_BATCH, extra_dims=0)
        step = M.make_decode_step(cfg, compute_dtype=torch.float32,
                                  param_shardings_tree=psh, cache_shardings_tree=csh)
        blocks, cblocks = SH.blocks(params, psh), SH.blocks(caches, csh)
        out = []
        with ctx.activation_sharding(mesh, SH.batch_axes(mesh, DECODE_BATCH)):
            for t in range(DECODE_STEPS):
                lg, cblocks = step(blocks, bsh.block(toks[t])[:, None], cblocks,
                                   bsh.block(idx0 + t))
                out.append(SH.gather_tree(lg, SH.batch_sharding(mesh, DECODE_BATCH)))
        return dict(logits=torch.stack(out), flash=len(calls),
                    spec=next((c["k"].spec for c in csh if "k" in c), None),
                    ssm_spec=next(((c["ssm"].spec, c["conv"].spec) for c in csh
                                   if "ssm" in c), None))
    finally:
        FD.flash_decode = real


# ---------------------------------------------------------------------------
# card workers (``chip_smoke.py``'s mesh phase and ``tests/test_torch_gpu.py``):
# the port on the card, one rank over NCCL or ranks sharing the card over
# gloo. Each reports the kernel launches of its mesh runs (the runs they
# are held to are not counted) and what it measured.
# ---------------------------------------------------------------------------


def _launches():
    from repro_torch.launch.train_mhsl_rl import kernel_launches

    return kernel_launches()


def _since(before):
    return {k: v - before[k] for k, v in _launches().items()}


def run_diff(a, b):
    """Largest difference between two runs' curves and final params (a
    ``TrainResult`` or a ``PopulationResult`` each; ``inf`` when the curves
    differ in length)."""
    from repro_torch.tree import tree_leaves

    worst = 0.0
    for x, y in zip(getattr(a, "results", [a]), getattr(b, "results", [b])):
        for k, u in curves(x).items():
            v = getattr(y, k)
            if len(u) != len(v):
                return float("inf")
            worst = max([worst] + [abs(p - q) for p, q in zip(u, v)])
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        worst = max(worst, float((p - q).abs().max()))
    return worst


def tree_rel_diff(a, b):
    """Per tree, the largest over leaves of ``max|a - b| / max|b|``, and
    whether every leaf is equal bit for bit."""
    import torch

    from repro_torch.tree import tree_leaves

    worst, same = 0.0, True
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.float(), y.float()
        same = same and torch.equal(x, y)
        worst = max(worst, float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30))
    return worst, same


def _card_env():
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile

    return MHSLEnv(profile=resnet101_profile(batch=1))


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def card_one_rank(rank, world, tmp, sac_kw, qs, depth):
    """(M1) one rank over NCCL: ``train_sac`` and ``train_population`` on
    a 1-rank population mesh against ``mesh=None`` (``SACConfig()`` on the
    ResNet-101 env), and a 1-stage step of Qwen2.5-3B at published widths
    and ``depth`` on a 1-rank stage mesh against the in-process step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import pipeline as P
    from repro_torch.core.agents.loops import train_sac
    from repro_torch.core.agents.sac import SACConfig
    from repro_torch.core.scenario import train_population
    from repro_torch.distribution.collectives import transport
    from repro_torch.launch.mesh import make_population_mesh, make_stage_mesh
    from repro_torch.launch.train_mhsl_rl import executed_config
    from repro_torch.models import model as M

    env, cfg = _card_env(), SACConfig()
    mesh = make_population_mesh(1)
    out = {"backend": dist.get_backend(), "transport": transport(mesh),
           "device": str(mesh.device), "launches": {}}
    for name, run in (("train_sac", lambda **k: train_sac(env, cfg, **sac_kw, **k)),
                      ("train_population", lambda **k: train_population(
                          env, cfg, _scens(env, qs), **sac_kw, **k))):
        ref, ref_s = _timed(run)
        before = _launches()
        got, got_s = _timed(lambda: run(mesh=mesh))
        out["launches"][name] = _since(before)
        out[name] = dict(diff=run_diff(ref, got), seconds=got_s, ref_seconds=ref_s)
    cfg = executed_config("qwen2.5-3b", depth, reduced=False)
    pipe = P.PipelineConfig(stage_impl="pallas", compute_dtype="bfloat16")
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           device="cuda")
    rng = np.random.default_rng(0)
    tok, lab = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 256))).cuda()
                for _ in range(2))
    ref_loss, ref = P.pipeline_step_fn(cfg, (depth,), 4, pipe=pipe)(params, tok, lab)
    smesh = make_stage_mesh(1)
    local = P.stage_params(params, cfg, (depth,), 0)
    before = _launches()
    loss, grads = P.pipeline_step_fn(cfg, (depth,), 4, pipe=pipe, mesh=smesh)(
        local, tok, lab)
    out["launches"]["stage"] = _since(before)
    rel, same = tree_rel_diff(grads, ref)
    out["stage"] = dict(loss=float(loss), ref_loss=float(ref_loss), grad_rel=rel,
                        bitwise=same and float(loss) == float(ref_loss))
    return out


def card_two_ranks(rank, world, tmp, sac_kw, pop_kw, qs, small):
    """(M2) two gloo ranks sharing the card: ``train_sac`` with its envs
    split over them and ``train_population`` with its scenarios split,
    each against the 1-rank run (rank 0 reruns ``train_sac`` alone,
    rank 1 the population)."""
    import torch

    from repro_torch.core.agents.loops import train_sac
    from repro_torch.core.agents.sac import SACConfig
    from repro_torch.core.scenario import train_population
    from repro_torch.distribution.collectives import transport
    from repro_torch.launch.mesh import make_population_mesh

    mesh = make_population_mesh()
    env, cfg = _card_env(), SACConfig(**small)
    out = {"transport": transport(mesh), "device": str(mesh.device)}
    before = _launches()
    sac, out["sac_seconds"] = _timed(lambda: train_sac(env, cfg, mesh=mesh, **sac_kw))
    pop, out["pop_seconds"] = _timed(lambda: train_population(
        env, cfg, _scens(env, qs), mesh=mesh, **pop_kw))
    out["launches"] = _since(before)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if rank == 0:
        ref, out["ref_seconds"] = _timed(lambda: train_sac(env, cfg, **sac_kw))
        first = sac_kw["num_envs"]
        out["sac_first_chunk_diff"] = max(
            abs(a - b) for k, u in curves(sac).items()
            for a, b in zip(u[:first], getattr(ref, k)[:first]))
        out["sac_diff"] = run_diff(ref, sac)
        out["sac_updated"] = bool(ref.metrics)
    else:
        ref, out["ref_seconds"] = _timed(lambda: train_population(
            env, cfg, _scens(env, qs), **pop_kw))
        out["pop_diff"] = run_diff(ref, pop)
        out["pop_updated"] = any(r.metrics for r in ref.results)
    return out


def card_stage(rank, world, tmp, arch, depth, bounds, micro, rows, seq, steps,
               env_depth, env_bounds):
    """(M3) four gloo ranks sharing the card: ``arch`` at published widths
    and ``depth`` on ``len(bounds)`` stages, bf16 over f32 masters through
    the stage kernel, ``steps`` timed steps, the gradients assembled on
    rank 0 and held to the in-process step there; then one step of the
    launcher (``make_pipeline_train_step(mesh=)``: the pipelined step and
    AdamW on the shares, clipped by the norm summed over the ranks), its
    norm and its updated shares (gathered) held to the one-process
    launcher step's on the same inputs; then the (2 x 2) stage x env step
    at ``env_depth`` in f32 against the in-process step (the 1-D stage
    mesh's result). Each timed step runs under ``record_collectives``
    (``collectives``: one record a step)."""
    import numpy as np
    import torch

    from repro_torch.core import pipeline as P
    from repro_torch.distribution.collectives import record_collectives, transport
    from repro_torch.launch import train_mhsl_rl as RUN
    from repro_torch.launch.mesh import make_stage_env_mesh, make_stage_mesh
    from repro_torch.launch.train_mhsl_rl import executed_config
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    rng = np.random.default_rng(0)
    tok, lab = (torch.from_numpy(rng.integers(0, 151936, (rows, seq))).cuda()
                for _ in range(2))
    out = {"launches": {}}

    def case(depth, bounds, pipe, mesh, env_axis, n_steps, update=False):
        cfg = executed_config(arch, depth, reduced=False)
        tk, lb = tok % cfg.vocab_size, lab % cfg.vocab_size
        params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                               device="cuda")
        local = P.stage_params(params, cfg, bounds, mesh.axis_index("stage"))
        if mesh.axis_index("stage") != 0:  # the first stage assembles the tree
            del params
            params = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = P.pipeline_step_fn(cfg, bounds, micro, pipe=pipe, mesh=mesh,
                                  env_axis=env_axis)
        before = _launches()
        secs, stats = [], []
        for _ in range(n_steps):  # each step's collectives recorded
            with record_collectives() as st:
                (loss, grads), s = _timed(lambda: step(local, tk, lb))
            secs.append(s)
            stats.append(st.as_dict())
        full = P.gather_stage_tree(grads, params, cfg, bounds, mesh)
        res = dict(seconds=secs, transport=transport(mesh), loss=float(loss),
                   collectives=stats)
        del grads
        new = None
        opt = adamw(RUN.LR, max_grad_norm=1.0)
        if update:  # the launcher's step, from fresh moments
            train = RUN.make_pipeline_train_step(cfg, bounds, micro, pipe, opt,
                                                 mesh=mesh)
            (upd, _, _, norm), upd_s = _timed(
                lambda: train(local, opt.init(local), tk, lb))
            new = P.gather_stage_tree(upd, params, cfg, bounds, mesh)
            res.update(norm=float(norm), update_seconds=upd_s)
            del upd
        launches = _since(before)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if full is not None and mesh.axis_index(mesh.axis_names[-1]) == 0:
            ref_step = P.pipeline_step_fn(cfg, bounds, micro, pipe=pipe)
            saved = _launches()
            ref_step(params, tk, lb)  # warm
            (ref_loss, ref), ref_s = _timed(lambda: ref_step(params, tk, lb))
            rel, same = tree_rel_diff(full, ref)
            del ref
            res.update(ref_loss=float(ref_loss), ref_seconds=ref_s, grad_rel=rel,
                       bitwise=same and float(loss) == float(ref_loss))
            if new is not None:  # the one-process launcher step, same inputs
                train = RUN.make_pipeline_train_step(cfg, bounds, micro, pipe, opt)
                ref_new, _, _, ref_norm = train(params, opt.init(params), tk, lb)
                res.update(ref_norm=float(ref_norm),
                           update_rel=tree_rel_diff(new, ref_new)[0])
                del ref_new
            _restore(saved)  # not the path's
        del full, local, params, new
        torch.cuda.empty_cache()
        return res, launches

    pipe = P.PipelineConfig(stage_impl="pallas", compute_dtype="bfloat16")
    out["stage"], out["launches"]["stage"] = case(
        depth, tuple(bounds), pipe, make_stage_mesh(len(bounds)), None, steps,
        update=True)
    pipe = P.PipelineConfig(stage_impl="pallas", compute_dtype="float32")
    out["stage_env"], out["launches"]["stage_env"] = case(
        env_depth, tuple(env_bounds), pipe, make_stage_env_mesh(2, 2), "env", 1)
    return out


def card_serve_stage(rank, world, tmp, arch, bounds, serve, trace, device="cuda",
                     reduced=None):
    """(M5a) a split plan served on ``len(bounds)`` gloo stage ranks
    sharing the card: ``ServingService(mesh=)`` over a Poisson trace,
    bf16 compute and wire with ``stage_impl="pallas"`` (each rank's dense
    MLP halves through the stage kernel), against the same service in one
    process on rank 0 (same weights, same pipe; run first, its launches
    not counted). Reports every rank's completions, its
    ``stage_mlp_block`` launches and ring passes, ms per decode step and
    peak memory. ``reduced`` (by default on the CPU only) takes the arch's
    reduced widths; ``device="cpu"`` rehearses it."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.distribution.collectives import transport
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.serving import ServeConfig, ServingService, poisson_trace
    from repro_torch.serving.service import init_model_params

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = ServeConfig(arch=arch, reduced=not cuda if reduced is None else reduced,
                      boundaries=tuple(bounds),
                      compute_dtype="bfloat16", wire_dtype="bfloat16", **serve)
    mcfg = cfg.model_config()
    pipe = PipelineConfig(stage_impl="pallas", compute_dtype="bfloat16",
                          wire_dtype="bfloat16")
    reqs = poisson_trace(vocab_size=mcfg.vocab_size, **trace)
    mesh = make_stage_mesh(len(bounds), device=device)
    out = {"transport": transport(mesh), "layers": mcfg.num_layers}
    if rank == 0:
        saved = _launches()
        svc = ServingService(cfg, init_model_params(cfg, mcfg, device),
                             device=device, mesh=False, pipe=pipe)
        sync()
        t0 = time.perf_counter()
        ref = svc.run(list(reqs))
        sync()
        out.update(ref_completions=ref["completions"],
                   ref_seconds=time.perf_counter() - t0,
                   ref_tokens_per_sec=ref["tokens_per_sec"])
        del svc
        _restore(saved)
        if cuda:
            torch.cuda.empty_cache()
    dist.barrier()

    def build():
        svc = ServingService(cfg, init_model_params(cfg, mcfg, device),
                             device=device, mesh=mesh, pipe=pipe)
        if cuda:
            torch.cuda.empty_cache()
        return svc

    svc = _in_turn(rank, world, build)  # one whole model on the card at a time
    runner, passes, decode_s = svc.runner, {"prefill": 0, "decode": 0}, []
    prefill, decode = runner.prefill, runner.decode

    def counted_prefill(*a):
        passes["prefill"] += 1
        return prefill(*a)

    def timed_decode(*a):
        passes["decode"] += 1
        sync()
        t1 = time.perf_counter()
        got = decode(*a)
        sync()
        decode_s.append(time.perf_counter() - t1)
        return got

    runner.prefill, runner.decode = counted_prefill, timed_decode
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = _launches()
    t0 = time.perf_counter()
    res = svc.run(list(reqs))
    sync()
    k = mesh.axis_index("stage")
    out.update(seconds=time.perf_counter() - t0, launches=_since(before),
               completions=res["completions"], passes=passes,
               decode_ms=[x * 1e3 for x in decode_s],
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0,
               stage_layers=bounds[k] - ([0] + list(bounds))[k])
    if rank == 0:
        out.update(tokens_per_sec=res["tokens_per_sec"], ticks=res["ticks"])
    return out


def _tree_rel(a, b):
    """Per leaf, ``|a - b|_F / |b|_F``; the largest over the leaves."""
    import torch

    from repro_torch.tree import tree_leaves

    return max(float(torch.linalg.norm((x.double() - y.double()).flatten())
                     / max(float(torch.linalg.norm(y.double().flatten())), 1e-30))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _in_turn(rank, world, fn):
    """``fn()`` on each rank in turn (rank order, one at a time), so that
    transient whole-model tensors of several ranks never coexist on a
    shared card."""
    import torch.distributed as dist

    out = None
    for r in range(world):
        if r == rank:
            out = fn()
        dist.barrier()
    return out


def card_tensor_parallel(rank, world, tmp, parts, m4a=None, m4b=None, m4c=None,
                         m4c_mamba=None, device="cuda"):
    """(M4) four gloo ranks sharing the card on (data x model) meshes,
    each part against the one-process run on rank 0: (M4a) the zoo
    trainer on a (2 x 2) mesh (``launch.train.main``); (M4b) one (2 x 2)
    train step with ``moe_a2a=True`` (the one-process dropless step first,
    its results kept on the host and freed from the card); (M4c) a
    prefill and greedy decoding on a (1 x 4) mesh, the cache split by
    length (the prefill through the gathered cache, every decode step's
    layers through ``flash_decode``), each pass's collectives recorded,
    and ``M4c_mamba`` a teacher-forced prompt and greedy decoding for an
    SSM config (its Mamba blocks on their SSM heads and conv channels). Runs
    the ``parts`` named, each with its dict of sizes; reports each part's
    kernel launches (none expected).
    ``device="cpu"`` with reduced parts runs it on the CPU."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distribution import context as ctx
    from repro_torch.distribution import sharding as SH
    from repro_torch.distribution.collectives import record_collectives, transport
    from repro_torch.launch import train as TRAIN
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train_mhsl_rl import executed_config
    from repro_torch.models import flash_decode as FD
    from repro_torch.models import model as M
    from repro_torch.models import moe_a2a as A2A
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.tree import tree_leaves, tree_map

    lead = rank == 0
    out = {"launches": {}, "laps": {}}
    cuda = device == "cuda"
    clock = [time.perf_counter()]

    def lap(name):  # wall seconds of each part of the worker, in order
        now = time.perf_counter()
        out["laps"][name] = now - clock[0]
        clock[0] = now

    def peak():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0

    def reset():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if "M4a" in parts:
        # (M4a) the zoo trainer: (2 x 2) mesh, then one process on rank 0
        argv = list(m4a["argv"])
        reset()
        before = _launches()
        t0 = time.perf_counter()
        res = TRAIN.main(argv + ["--data-par", "2", "--model-par", "2"])
        wall = time.perf_counter() - t0
        out["launches"]["M4a"] = _since(before)
        mesh, psh = res["mesh"], res["shardings"]
        resident = sum(t.numel() * t.element_size() for t in
                       tree_leaves((res["params"], res["opt_state"].mu, res["opt_state"].nu)))
        a = dict(losses=res["losses"], seconds=res["step_seconds"], wall=wall,
                 peak_gib=peak(),
                 resident_gib=resident / 2 ** 30, transport=transport(mesh))
        lap("M4a mesh run")
        params = SH.gather_tree(res["params"], psh)
        del res
        reset()
        if lead:
            saved = _launches()
            ref = TRAIN.main(argv)
            a.update(ref_losses=ref["losses"], ref_seconds=ref["step_seconds"],
                     ref_peak_gib=peak(),
                     param_rel=_tree_rel(params, ref["params"]))
            init = M.init_params(torch.Generator(device=device).manual_seed(0), ref["cfg"],
                                 device=device)
            a["update_rel"] = _tree_rel(tree_map(lambda x, y: x - y, params, init),
                                        tree_map(lambda x, y: x - y, ref["params"], init))
            a["n_params"] = sum(t.numel() for t in tree_leaves(init))
            del ref, init
            _restore(saved)
        lap("M4a gather + one process")
        del params
        reset()
        out["M4a"] = a
        dist.barrier()

    if "M4b" in parts:
        # (M4b) one (2 x 2) step through moe_a2a, f32, no Switch loss
        base = executed_config(m4b["arch"], m4b["depth"], reduced=not cuda)
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=m4b["capacity_factor"], router_aux_weight=0.0))
        mesh = make_host_mesh(2, 2, device=device)
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (m4b["rows"], m4b["seq"])))
                 .to(device) for k in ("tokens", "labels")}
        opt = adamw(linear_warmup_cosine(3e-4, 10, 1), max_grad_norm=1.0)
        b = {}
        ref = None
        if lead:  # the one-process dropless step first; its results on the host
            saved = _launches()
            params = M.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                                   device=device)
            step = M.make_train_step(cfg, opt, compute_dtype=torch.float32,
                                     remat=m4b["remat"])
            sync()
            t1 = time.perf_counter()
            new, state, m = step(params, opt.init(params), batch)
            sync()
            b.update(ref_seconds=time.perf_counter() - t1, ref_loss=float(m["loss"]),
                     ref_peak_gib=peak())
            ref = tree_map(lambda x: x.cpu(), state.mu)
            del params, new, state, step
            _restore(saved)
            reset()
        dist.barrier()
        psh = None

        def init_blocks():
            nonlocal psh
            full = M.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                                 device=device)
            psh = SH.param_shardings(full, cfg, mesh)
            blk = SH.blocks(full, psh)
            del full
            reset()
            return blk

        lap("M4b one process")
        blocks = _in_turn(rank, world, init_blocks)
        lap("M4b blocks")
        reset()
        rows = SH.shard_rows(mesh, SH.batch_axes(mesh, m4b["rows"]), m4b["rows"])
        local = {k: v[rows] for k, v in batch.items()}
        before = _launches()
        with ctx.activation_sharding(mesh, SH.batch_axes(mesh, m4b["rows"]), moe_a2a=True):
            calls = []  # each MoE layer's dropped copies on this rank, per call
            real = A2A.moe_apply_a2a

            def counted(p, x, c):
                calls.append(A2A.dropped_choices(p, x, c))
                return real(p, x, c)

            A2A.moe_apply_a2a = counted
            try:
                step = M.make_train_step(cfg, opt, compute_dtype=torch.float32,
                                         remat=m4b["remat"], param_shardings_tree=psh)
                sync()
                t1 = time.perf_counter()
                new, state, m = step(blocks, opt.init(blocks), local)
                sync()
                secs = time.perf_counter() - t1
            finally:
                A2A.moe_apply_a2a = real
        out["launches"]["M4b"] = _since(before)
        b.update(loss=float(m["loss"]), seconds=secs, a2a_calls=len(calls),
                 dropped=calls, peak_gib=peak(),
                 experts_per_rank=tree_leaves(new["slots"][0]["moe"]["w_up"])[0].shape[1])
        lap("M4b mesh step")
        b["mu_rel"] = _scattered_rel(state.mu, psh, ref, mesh, device)
        lap("M4b compare")
        del blocks, new, state, step, ref
        reset()
        out["M4b"] = b
        dist.barrier()

    for part, m4c in (("M4c", m4c), ("M4c_mamba", m4c_mamba)):
        if part not in parts:
            continue
        # (M4c) greedy decoding on a (1 x 4) mesh: Qwen2.5-3B's cache split
        # by length; Mamba2-370m's SSM heads and conv channels over model
        cfg = executed_config(m4c["arch"], None, reduced=not cuda)
        if not cuda and cfg.num_kv_heads:  # a head count 4 ranks do not divide
            cfg = dataclasses.replace(cfg, num_kv_heads=2)
        mesh = make_host_mesh(1, 4, device=device)
        starts = torch.tensor(m4c["starts"], device=device)
        n_prompt = m4c.get("prefill") or m4c["prompt"]
        if m4c.get("prefill") and min(m4c["starts"]) < n_prompt:
            raise ValueError("a row's decode starts inside its prefill")
        prompt = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (n_prompt, len(m4c["starts"])))).to(device)

        def decode(prefill, step, params, caches, record=False):
            """The prompt in one ``prefill`` pass from position 0, then
            greedy steps from each row's start (or, with no prefill, the
            prompt teacher-forced a token a step from each row's start,
            then greedy steps after it). Returns the greedy tokens and the
            logits from the last prompt position on (every row on every
            rank: the mesh has one data rank), the seconds, and with
            ``record`` each pass's collectives (the prompt's first)."""
            rec = record_collectives if record else contextlib.nullcontext
            toks, logits, stats = [], [], []
            t1 = time.perf_counter()
            if prefill is not None:
                with rec() as st:
                    lg, caches = prefill(params, prompt.T.contiguous(), caches)
                stats.append(st)
                base = starts
            else:
                for t in range(n_prompt):
                    with rec() as st:
                        lg, caches = step(params, prompt[t][:, None], caches, starts + t)
                    stats.append(st)
                base = starts + n_prompt
            for t in range(m4c["steps"]):
                tok = lg.argmax(-1)
                logits.append(lg.float().cpu())
                toks.append(tok.cpu())
                with rec() as st:
                    lg, caches = step(params, tok[:, None], caches, base + t)
                stats.append(st)
            sync()
            return (torch.stack(toks), torch.stack(logits), time.perf_counter() - t1,
                    [x.as_dict() for x in stats if x is not None])

        c = {}
        if lead:
            saved = _launches()
            params = M.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                                   device=device)
            caches = M.init_caches(cfg, len(m4c["starts"]), m4c["cache"],
                                   dtype=torch.float32, device=device)
            step = M.make_decode_step(cfg, compute_dtype=torch.float32)
            prefill = (M.make_prefill_step(cfg, compute_dtype=torch.float32)
                       if m4c.get("prefill") else None)
            c["ref_tokens"], c["ref_logits"], c["ref_seconds"], _ = decode(
                prefill, step, params, caches)
            del params, caches, step, prefill
            _restore(saved)
            reset()
        dist.barrier()
        lap(f"{part} one process")
        caches = M.init_caches(cfg, len(m4c["starts"]), m4c["cache"], dtype=torch.float32,
                               device=device)
        csh = SH.cache_shardings(caches, cfg, mesh, len(m4c["starts"]))
        psh = None

        def serve_blocks():
            nonlocal psh
            full = M.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                                 device=device)
            psh = SH.param_shardings(full, cfg, mesh, mode="serve")
            blk = SH.blocks(full, psh)
            del full
            reset()
            return blk

        blocks = _in_turn(rank, world, serve_blocks)
        cblocks = SH.blocks(caches, csh)
        del caches
        reset()
        lap(f"{part} blocks")
        kw = dict(compute_dtype=torch.float32, param_shardings_tree=psh,
                  cache_shardings_tree=csh)
        step = M.make_decode_step(cfg, **kw)
        prefill = M.make_prefill_step(cfg, **kw) if m4c.get("prefill") else None
        calls = []
        real = FD.flash_decode

        def counted(*args, **kw):
            calls.append(1)
            return real(*args, **kw)

        FD.flash_decode = counted
        before = _launches()
        try:
            with ctx.activation_sharding(mesh, SH.batch_axes(mesh, len(m4c["starts"]))):
                c["tokens"], c["logits"], c["seconds"], c["collectives"] = decode(
                    prefill, step, blocks, cblocks, record=True)
        finally:
            FD.flash_decode = real
        out["launches"][part] = _since(before)
        c.update(flash_calls=len(calls), peak_gib=peak(), layers=cfg.num_layers,
                 cache_spec={k: v.spec for k, v in csh[0].items()})
        out[part] = c
        lap(f"{part} mesh decode")
    return out


def card_tp_step(rank, world, tmp, device="cuda"):
    """Four gloo ranks sharing the card: reduced StableLM-1.6B's (2 x 2)
    f32 train step (the gradients, their mesh-wide norm, one AdamW
    update), against the one-process step on rank 0 (same weights: the
    seeded CPU init, moved)."""
    import torch

    from repro_torch.distribution import context as ctx
    from repro_torch.distribution import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_map

    mesh = make_host_mesh(2, 2, device=device)
    cfg = tp_config("stablelm-1.6b")
    params = tree_map(lambda t: t.to(device), M.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    batch = {k: v.to(device) for k, v in tp_batch(cfg, TP_ROWS, TP_SEQ, seed=1).items()}
    psh = SH.param_shardings(params, cfg, mesh)
    rows = SH.shard_rows(mesh, SH.batch_axes(mesh, TP_ROWS), TP_ROWS)
    before = _launches()
    with ctx.activation_sharding(mesh, SH.batch_axes(mesh, TP_ROWS)):
        blocks = SH.blocks(params, psh)
        _, grads, m = tp_step(cfg, "float32", psh, CaptureGrads())(
            blocks, None, {k: v[rows] for k, v in batch.items()})
        norm = float(global_norm(grads, psh))
        new, state = tp_update(blocks, grads, psh)
    out = dict(launches=_since(before), loss=float(m["loss"]), norm=norm,
               device=str(mesh.device))
    new, mu = SH.gather_tree(new, psh), SH.gather_tree(state.mu, psh)
    if rank == 0:
        _, ref_grads, rm = tp_step(cfg, "float32", None, CaptureGrads())(params, None, batch)
        ref, ref_state = tp_update(params, ref_grads)
        out.update(ref_loss=float(rm["loss"]), ref_norm=float(global_norm(ref_grads)),
                   param_rel=_tree_rel(new, ref), mu_rel=_tree_rel(mu, ref_state.mu))
    return out


def _scattered_rel(blocks, shardings, ref, mesh, device):
    """Per leaf, ``|blocks - ref|_F / |ref|_F`` of the whole tree, the
    largest over the leaves. Rank 0 holds ``ref`` (on the host) and
    scatters each rank its block of every leaf; each block's squared
    norms count once (divided by the ranks that hold it), summed over the
    mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distribution import collectives as C
    from repro_torch.distribution.sharding import Sharding
    from repro_torch.launch.mesh import Mesh

    grid = [Mesh(mesh.axis_names, mesh.axis_sizes, tuple(int(c) for c in xy))
            for xy in np.ndindex(*mesh.axis_sizes)]  # rank r at grid[r]
    refs = [r for _, r in _paths(ref)] if mesh.rank == 0 else None
    worst = 0.0
    for i, ((_, x), (_, sh)) in enumerate(zip(_paths(blocks), _paths(shardings))):
        mine = torch.empty(x.shape, dtype=x.dtype)
        parts = None if refs is None else [
            Sharding(at, sh.spec).block(refs[i]).contiguous() for at in grid]
        dist.scatter(mine, parts, src=0)
        y = mine.to(device)
        sq = torch.stack([torch.sum(torch.square((x - y).double())),
                          torch.sum(torch.square(y.double()))]) / sh.replicas
        num, den = C.all_reduce(sq, mesh, mesh.axis_names).tolist()
        worst = max(worst, (num / max(den, 1e-300)) ** 0.5)
    return worst


def _paths(tree):
    from repro_torch.tree import tree_leaves_with_path

    return tree_leaves_with_path(tree)


def _restore(saved):
    """Put the kernel counters back to ``saved`` (a reference run's
    launches are not the path's)."""
    from repro_torch.launch import train_mhsl_rl as RUN

    for name, mod in RUN.KERNEL_MODULES.items():
        mod.launches = saved[name]


WORKERS = {f.__name__: f for f in (population_runs, sac_runs, stage_runs,
                                   tensor_parallel_runs, card_one_rank,
                                   card_two_ranks, card_stage,
                                   card_tensor_parallel, card_tp_step,
                                   card_serve_stage)}


def _main(argv):
    worker, rank, world, tmp, kwargs, backend = (
        argv[1], int(argv[2]), int(argv[3]), argv[4], argv[5], argv[6])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{tmp}/store_{worker}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        out = WORKERS[worker](rank, world, tmp, **json.loads(kwargs))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv)
