"""End-to-end MHSL loop of the port (the paper's full loop):

1. train the ICM-CA SAC controller on the MHSL environment priced with the
   chosen architecture's full-depth layer profile;
2. roll out the learned policy -> a split plan (boundaries + devices);
3. execute that plan, rescaled to the executed depth, as 1F1B pipelined
   training of the model (every stage on this card; dense MLP halves
   through the hand-written stage kernel, Mamba halves through
   ``ssd_chunked``, MoE halves through the dropless reference route);
4. evaluate the trained model's loss on held-out tokens (attention
   through the hand-written flash-attention kernel, Mamba scans through
   the hand-written SSD scan kernel).

    PYTHONPATH=src python -m repro_torch.launch.train_mhsl_rl --arch qwen2.5-3b
    PYTHONPATH=src python -m repro_torch.launch.train_mhsl_rl \
        --arch mamba2-370m --depth 48
    PYTHONPATH=src python -m repro_torch.launch.train_mhsl_rl \
        --arch qwen3-moe-30b-a3b --depth 2 --stages 2
    PYTHONPATH=src torchrun --nproc-per-node 4 \
        -m repro_torch.launch.train_mhsl_rl --shard-envs

Every arch of the zoo runs: attention with a dense MLP or an MoE, Mamba,
the Jamba hybrid (its block pattern cut to the executed depth), and the
modality-frontend configs (the pipeline runs their tokens; the frontend
projector gets zero gradients, as in the reference).

Counterpart of the JAX package's ``examples/train_mhsl_rl.py``, with its
arguments plus ``--reduced`` (the arch's tiny ``reduced()`` widths, for
the CPU) and the executed shape. Without ``--reduced`` the executed
model has the arch's published widths and ``--depth`` layers. Weights
and tokens are random, from ``--seed``. The routes, compute dtype and
learning rate are the example's (:data:`STAGE_IMPL`, :data:`EVAL_IMPL`,
:data:`COMPUTE_DTYPE`, :data:`LR`). ``--checkpoint-dir DIR`` saves the
controller's training (step 1) there every ``--checkpoint-every``
episodes and resumes it when run again (``--fresh`` ignores a saved
one), as the example does.

Launched on ranks (``torchrun``'s environment initializes the process
group: NCCL when every rank has a card of its own, gloo otherwise),
step 3 runs on a stage mesh, as the example runs it on
``make_stage_mesh(stages)`` over its first ``stages`` devices: the plan
is cut to ``min(--stages, world)`` stages and stage ``k`` runs on rank
``k``, holding its share of the parameters and of AdamW's moments; the
clip reads the norm of the whole gradient, summed over the stage ranks.
Rank 0 trains the controller (step 1), rolls out the plan (step 2) and
sends it to the other ranks; with ``--shard-envs`` every rank trains the
controller on a population mesh of every rank, its ``num_envs`` axis
sharded. Rank 0 prints, writes the checkpoints and computes the held-out
loss on the gathered parameters; ranks past the plan's stages return
after step 2. One process runs every stage in turn, as before.
"""
from __future__ import annotations

import argparse
import datetime
import os
import time
from dataclasses import replace
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.agents import loops as LP
from repro_torch.core.agents import rollout as R
from repro_torch.core.agents.sac import SACConfig
from repro_torch.core.channel import NetworkConfig
from repro_torch.core.env import MHSLEnv
from repro_torch.core.pipeline import PipelineConfig, pipeline_step_fn
from repro_torch.core.profiles import transformer_profile
from repro_torch.device import resolve_device
from repro_torch.kernels import ca_attention, flash_attention, moe_dispatch
from repro_torch.kernels import ssd_scan, stage_block
from repro_torch.distribution.sharding import stage_shardings
from repro_torch.launch.mesh import make_mesh, make_population_mesh, make_stage_mesh
from repro_torch.models import model as M
from repro_torch.optim.optimizers import adamw, apply_updates, global_norm

# episodes of random-policy rollouts before SAC updates start (the
# example's value)
WARMUP_EPISODES = 10
# stage dense MLP halves through the stage kernel; the held-out loss's
# attention through the flash kernel and its Mamba scans through the SSD
# scan kernel; bf16 compute over f32 master weights, AdamW at 3e-4
STAGE_IMPL = "pallas"
EVAL_IMPL = "pallas"
COMPUTE_DTYPE = "bfloat16"
LR = 3e-4

# the five kernel wrappers' modules, by kernel name
KERNEL_MODULES = {"ca_attention": ca_attention,
                  "stage_mlp_block": stage_block,
                  "flash_attention": flash_attention,
                  "ssd_scan": ssd_scan,
                  "grouped_moe_ffn": moe_dispatch}


def kernel_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count, by kernel name."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def rollout_plan(env: MHSLEnv, params, cfg: SACConfig, gen: torch.Generator):
    """One episode of the learned (stochastic) policy at ``num_envs=1``.
    Returns ``(boundaries, stage devices, leaked, T_R, E_R)``."""
    st0 = env.reset(env.sample_positions(gen, 1))
    st, traj = R.rollout_episode(env, R.sac_policy(env.action_dims, cfg),
                                 params, st0, gen, cfg.hist_len)
    return (
        tuple(int(b) for b in st.boundaries[0].tolist()),
        tuple(int(d) for d in st.stage_dev[0].tolist()),
        float(traj["leak"].sum()),
        float(st.t_r[0]),
        float(st.e_r[0]),
    )


def rescale_boundaries(boundaries_full: Sequence[int], depth: int,
                       stages: int):
    """The learned stage-length fractions, rescaled to ``depth`` layers
    over at most ``stages`` stages, each at least one layer long."""
    lens_full = np.diff(np.concatenate([[0], np.asarray(boundaries_full)]))
    lens = np.maximum(1, np.round(lens_full / lens_full.sum() * depth).astype(int))
    lens = lens[:stages]
    while lens.sum() > depth:
        lens[np.argmax(lens)] -= 1
    while lens.sum() < depth:
        lens[np.argmin(lens)] += 1
    return tuple(int(b) for b in np.cumsum(lens))


def executed_config(arch: str, depth: Optional[int],
                    reduced: bool) -> ModelConfig:
    """The arch at ``depth`` layers (None: its own depth), at published
    widths or ``reduced()``. A block pattern is tiled and cut to ``depth``
    letters: Jamba at depth 2 runs its first two layers, ``"MM"``."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if depth is None:
        return cfg
    pattern = cfg.block_pattern
    if pattern is not None:
        pattern = (pattern * -(-depth // len(pattern)))[:depth]
    return replace(cfg, num_layers=depth, block_pattern=pattern)


def make_pipeline_train_step(cfg: ModelConfig, boundaries, n_microbatches: int,
                             pipe: PipelineConfig, opt, *, mesh=None,
                             stage_axis: str = "stage"):
    """``(params, opt_state, tokens, labels) -> (params, opt_state, loss,
    grad_norm)``: one pipelined forward/backward and one optimizer update;
    ``grad_norm`` is the global norm of the gradients (what the clip reads).

    ``mesh``: a stage mesh, stage ``k`` on rank ``k``. ``params`` and
    ``opt_state`` are then this rank's :func:`~repro_torch.core.pipeline.
    stage_params` share and its moments, and the clip's norm is the whole
    gradient's, summed over the ranks with every leaf counted once
    (``distribution.sharding.stage_shardings``: the tied embedding's
    gradient, held by the first and the last stage, once)."""
    step_fn = pipeline_step_fn(cfg, boundaries, n_microbatches, pipe=pipe,
                               mesh=mesh, stage_axis=stage_axis)

    def train_step(params, opt_state, tokens, labels):
        with tracing.span("train.step"):
            loss, grads = step_fn(params, tokens, labels)
            with tracing.span("optim.clip_norm"):
                norm = global_norm(grads, None if mesh is None else stage_shardings(
                    params, cfg, boundaries, mesh, stage_axis))
            with tracing.span("optim.update"):
                ups, opt_state = opt.update(grads, opt_state, params, grad_norm=norm)
                params = apply_updates(params, ups)
        return params, opt_state, loss, norm

    return train_step


def _tokens(rng: np.random.Generator, vocab: int, rows: int, seq: int, dev):
    return torch.from_numpy(rng.integers(0, vocab, (rows, seq))).to(dev)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--episodes", type=int, default=60)
    ap.add_argument("--pipeline-steps", type=int, default=20)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--num-envs", type=int, default=4,
                    help="batched env population per rollout chunk")
    ap.add_argument("--shard-envs", action="store_true",
                    help="shard the num-envs axis over a population mesh "
                         "spanning the launched ranks")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save/resume the RL training state under this directory")
    ap.add_argument("--checkpoint-every", type=int, default=20,
                    help="episodes between checkpoints (with --checkpoint-dir)")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore an existing checkpoint and train from scratch")
    ap.add_argument("--reduced", action="store_true",
                    help="execute the arch's reduced() widths (CPU runs)")
    ap.add_argument("--depth", type=int, default=8,
                    help="executed layers (the plan is rescaled to them)")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8, help="rows per step")
    ap.add_argument("--seq", type=int, default=256, help="tokens per row")
    ap.add_argument("--eval-batch", type=int, default=8)
    ap.add_argument("--eval-seq", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def init_ranks(device) -> bool:
    """Join the process group ``torchrun``'s environment describes, unless
    one is already initialized or there is none (``WORLD_SIZE`` unset).
    NCCL when every rank has a card of its own, else gloo. Returns
    whether this call initialized it (and so should destroy it)."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    own_cards = (resolve_device(device).type == "cuda"
                 and torch.cuda.device_count() >= world)
    if own_cards:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if own_cards else "gloo", init_method="env://",
                            timeout=datetime.timedelta(minutes=10))
    return True


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run plan -> pipelined training -> held-out loss; print progress and
    return what was measured (plan, per-step losses and seconds, the eval
    loss and its seconds, each kernel's launches in this run) and what was
    built (the executed config, the trained params, optimizer and its
    state, the eval batch)."""
    args = parse_args(argv)
    owns_group = init_ranks(args.device)
    try:
        return _run(args)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _plan_from_rank0(mesh, axis, boundaries_full, devices, stages: int):
    """Rank 0's plan on every rank of ``mesh`` (one broadcast along its
    ``axis``, which spans the world)."""
    from repro_torch.distribution.collectives import broadcast

    msg = torch.zeros((1 + 2 * stages,), dtype=torch.long)
    n = len(boundaries_full)
    msg[0] = n
    msg[1:1 + n] = torch.tensor(boundaries_full)
    msg[1 + n:1 + 2 * n] = torch.tensor(devices)
    msg = broadcast(msg.to(mesh.device), mesh, axis, 0).cpu().tolist()
    n = msg[0]
    return tuple(msg[1:1 + n]), tuple(msg[1 + n:1 + 2 * n])


def _run(args) -> Dict[str, Any]:
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = world_mesh = None
    if args.shard_envs:
        mesh = world_mesh = make_population_mesh(device=args.device)
        dev = mesh.device
    elif world > 1:
        world_mesh = make_mesh((world,), ("rank",), args.device)
        dev = world_mesh.device
    else:
        dev = resolve_device(args.device)
    lead = world_mesh is None or world_mesh.rank == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    launches0 = kernel_launches()

    # 1) RL controller on the FULL architecture's layer profile
    prof = transformer_profile(get_config(args.arch), batch=1, seq=128)
    env = MHSLEnv(profile=prof, net=NetworkConfig(max_split=args.stages),
                  device=dev)
    sac_cfg = SACConfig()
    if mesh is not None:
        from repro_torch.distribution.collectives import transport

        say(f"      population mesh: {mesh.size} rank(s), num_envs axis "
            f"sharded, transport {transport(mesh)}")
    say(f"[1/4] training ICM-CA SAC on {args.arch} profile "
        f"({prof.num_layers} layers, {args.episodes} episodes, "
        f"{args.num_envs} batched envs) on {dev}")
    res, boundaries_full, devices = None, (), ()
    if lead or mesh is not None:
        res = LP.train_sac(env, sac_cfg, episodes=args.episodes, seed=args.seed,
                           warmup_episodes=WARMUP_EPISODES,
                           num_envs=args.num_envs, mesh=mesh,
                           checkpoint_dir=args.checkpoint_dir,
                           checkpoint_every=args.checkpoint_every,
                           resume=not args.fresh)
        say(f"      reward: first10={np.mean(res.episode_reward[:10]):.2f} "
            f"last10={np.mean(res.episode_reward[-10:]):.2f}")

    # 2) the plan, rolled out on rank 0 and sent to every rank
    if lead:
        gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
        boundaries_full, devices, leaked, t_r, e_r = rollout_plan(
            env, res.params, sac_cfg, gen)
        say(f"[2/4] learned plan on {prof.num_layers} layers: "
            f"boundaries={boundaries_full} devices={devices} "
            f"leaked={leaked:.3f} T_R={t_r:.2f}s E_R={e_r:.1f}J")
    if world_mesh is not None:
        boundaries_full, devices = _plan_from_rank0(
            world_mesh, world_mesh.axis_names[0], boundaries_full, devices,
            args.stages)

    # 3) execute the plan, rescaled to the executed depth: every stage in
    # this process, or stage k on rank k
    cfg = executed_config(args.arch, args.depth, args.reduced)
    boundaries = rescale_boundaries(boundaries_full, args.depth,
                                    min(args.stages, world) if world > 1
                                    else args.stages)
    smesh = (make_stage_mesh(len(boundaries), device=args.device)
             if world > 1 else None)
    out = {"train": res, "env": env, "mesh": mesh, "stage_mesh": smesh,
           "plan_full": boundaries_full, "devices": devices,
           "boundaries": boundaries}
    if smesh is not None and smesh.coords is None:  # past the plan's stages
        return out
    pipe = PipelineConfig(stage_impl=STAGE_IMPL, compute_dtype=COMPUTE_DTYPE)
    where = ("in this process" if smesh is None else
             f"on {smesh.size} stage rank(s)")
    say(f"[3/4] executing plan {boundaries} as a {len(boundaries)}-stage "
        f"1F1B pipeline of {cfg.name} (d_model {cfg.d_model}, "
        f"{cfg.num_layers} layers) {where}, M={args.microbatches}, "
        f"{args.batch}x{args.seq} tokens/step, {pipe}")
    params = M.init_params(torch.Generator(device=dev).manual_seed(args.seed),
                           cfg, device=dev)
    like = None
    if smesh is not None:  # this rank's share; rank 0 keeps the layout
        from repro_torch.core.pipeline import stage_params
        from repro_torch.tree import tree_map

        if lead:
            like = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                  device="meta"), params)
        params = stage_params(params, cfg, boundaries,
                              smesh.axis_index("stage"))
    opt = adamw(LR, max_grad_norm=1.0)
    opt_state = opt.init(params)
    train_step = make_pipeline_train_step(cfg, boundaries, args.microbatches,
                                          pipe, opt, mesh=smesh)
    rng = np.random.default_rng(args.seed)
    losses, norms, seconds = [], [], []
    for step in range(args.pipeline_steps):
        toks = _tokens(rng, cfg.vocab_size, args.batch, args.seq, dev)
        labs = _tokens(rng, cfg.vocab_size, args.batch, args.seq, dev)
        t0 = time.perf_counter()
        params, opt_state, loss, norm = train_step(params, opt_state, toks, labs)
        loss = float(loss)  # waits for the step
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(float(norm))
        if step % 5 == 0 or step == args.pipeline_steps - 1:
            say(f"      pipeline step {step:3d} loss {loss:.4f} "
                f"({seconds[-1]:.3f} s)")
    out.update(losses=losses, grad_norms=norms, step_seconds=seconds,
               cfg=cfg, pipe=pipe, opt=opt, opt_state=opt_state, params=params)
    if smesh is not None:
        from repro_torch.core.pipeline import gather_stage_tree

        full = gather_stage_tree(params, like, cfg, boundaries, smesh)
        if not lead:
            return out
        out["share"], params = params, full

    # 4) held-out loss
    eval_rng = np.random.default_rng(args.seed + 1)
    batch = {"tokens": _tokens(eval_rng, cfg.vocab_size, args.eval_batch,
                               args.eval_seq, dev),
             "labels": _tokens(eval_rng, cfg.vocab_size, args.eval_batch,
                               args.eval_seq, dev)}
    t0 = time.perf_counter()
    with torch.no_grad():
        _, (eval_loss, _) = M.loss_fn(params, batch, cfg, impl=EVAL_IMPL,
                                      compute_dtype=pipe.dtype)
    eval_loss = float(eval_loss)  # waits for the call
    eval_seconds = time.perf_counter() - t0
    say(f"[4/4] held-out loss ({args.eval_batch}x{args.eval_seq} tokens, "
        f"block impl {EVAL_IMPL!r}): {eval_loss:.4f} "
        f"({eval_seconds:.3f} s)")
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    say(f"      kernel launches in this run: {launches}")
    out.update(launches=launches, eval_loss=eval_loss,
               eval_seconds=eval_seconds, params=params, eval_batch=batch)
    return out


if __name__ == "__main__":
    main()
