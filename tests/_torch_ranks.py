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
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{worker} rank {r} exited {p.returncode}:\n{out[-4000:]}"
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
    returns the assembled gradients."""
    import torch.distributed as dist

    from repro_torch.core import pipeline as P
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
        mesh = make_stage_env_mesh(2, 2, device="cpu")
        pipe = P.PipelineConfig(compute_dtype="float32")
        step = P.pipeline_step_fn(cfg, bounds, micro, pipe=pipe, mesh=mesh,
                                  env_axis="env")
        local = P.stage_params(params, cfg, bounds, mesh.axis_index("stage"))
        loss, grads = step(local, tok, lab)
        out["env"] = (float(loss), P.gather_stage_tree(grads, params, cfg,
                                                       bounds, mesh))
    return out


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
    rank 0 and held to the in-process step there; then the (2 x 2)
    stage x env step at ``env_depth`` in f32 against the in-process step
    (the 1-D stage mesh's result)."""
    import numpy as np
    import torch

    from repro_torch.core import pipeline as P
    from repro_torch.distribution.collectives import transport
    from repro_torch.launch.mesh import make_stage_env_mesh, make_stage_mesh
    from repro_torch.launch.train_mhsl_rl import executed_config
    from repro_torch.models import model as M

    rng = np.random.default_rng(0)
    tok, lab = (torch.from_numpy(rng.integers(0, 151936, (rows, seq))).cuda()
                for _ in range(2))
    out = {"launches": {}}

    def case(depth, bounds, pipe, mesh, env_axis, n_steps):
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
        secs = []
        for _ in range(n_steps):
            (loss, grads), s = _timed(lambda: step(local, tk, lb))
            secs.append(s)
        launches = _since(before)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        full = P.gather_stage_tree(grads, params, cfg, bounds, mesh)
        res = dict(seconds=secs, peak_gib=peak, transport=transport(mesh),
                   loss=float(loss))
        if full is not None and mesh.axis_index(mesh.axis_names[-1]) == 0:
            ref_step = P.pipeline_step_fn(cfg, bounds, micro, pipe=pipe)
            saved = _launches()
            ref_step(params, tk, lb)  # warm
            (ref_loss, ref), ref_s = _timed(lambda: ref_step(params, tk, lb))
            from repro_torch.launch import train_mhsl_rl as RUN

            for name, mod in RUN.KERNEL_MODULES.items():  # not the path's
                mod.launches = saved[name]
            rel, same = tree_rel_diff(full, ref)
            res.update(ref_loss=float(ref_loss), ref_seconds=ref_s, grad_rel=rel,
                       bitwise=same and float(loss) == float(ref_loss))
        del full, grads, local, params
        torch.cuda.empty_cache()
        return res, launches

    pipe = P.PipelineConfig(stage_impl="pallas", compute_dtype="bfloat16")
    out["stage"], out["launches"]["stage"] = case(
        depth, tuple(bounds), pipe, make_stage_mesh(len(bounds)), None, steps)
    pipe = P.PipelineConfig(stage_impl="pallas", compute_dtype="float32")
    out["stage_env"], out["launches"]["stage_env"] = case(
        env_depth, tuple(env_bounds), pipe, make_stage_env_mesh(2, 2), "env", 1)
    return out


WORKERS = {f.__name__: f for f in (population_runs, sac_runs, stage_runs,
                                   card_one_rank, card_two_ranks, card_stage)}


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
