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
    PYTHONPATH=src torchrun --nproc-per-node 2 \
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
one), as the example does. ``--shard-envs`` trains the controller on a
population mesh over the launched ranks (``torchrun``'s environment
initializes the process group: NCCL when every rank has a card of its
own, gloo otherwise; without it, one rank), its ``num_envs`` axis
sharded; rank 0 prints, writes the checkpoints and runs steps 2-4 on
its own card, and the other ranks return after step 1.
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
from repro_torch.launch.mesh import make_population_mesh
from repro_torch.models import model as M
from repro_torch.optim.optimizers import adamw, apply_updates

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
                             pipe: PipelineConfig, opt):
    """``(params, opt_state, tokens, labels) -> (params, opt_state, loss)``:
    one pipelined forward/backward and one optimizer update."""
    step_fn = pipeline_step_fn(cfg, boundaries, n_microbatches, pipe=pipe)

    def train_step(params, opt_state, tokens, labels):
        loss, grads = step_fn(params, tokens, labels)
        ups, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, ups), opt_state, loss

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
    owns_group = init_ranks(args.device) if args.shard_envs else False
    try:
        return _run(args)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args) -> Dict[str, Any]:
    mesh = None
    if args.shard_envs:
        mesh = make_population_mesh(device=args.device)
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0

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
    res = LP.train_sac(env, sac_cfg, episodes=args.episodes, seed=args.seed,
                       warmup_episodes=WARMUP_EPISODES,
                       num_envs=args.num_envs, mesh=mesh,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=args.checkpoint_every,
                       resume=not args.fresh)
    say(f"      reward: first10={np.mean(res.episode_reward[:10]):.2f} "
        f"last10={np.mean(res.episode_reward[-10:]):.2f}")
    if not lead:  # steps 2-4 run on rank 0
        return {"train": res, "env": env, "mesh": mesh}

    # 2) the plan
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    boundaries_full, devices, leaked, t_r, e_r = rollout_plan(
        env, res.params, sac_cfg, gen)
    say(f"[2/4] learned plan on {prof.num_layers} layers: "
        f"boundaries={boundaries_full} devices={devices} "
        f"leaked={leaked:.3f} T_R={t_r:.2f}s E_R={e_r:.1f}J")

    # 3) execute the plan, rescaled to the executed depth
    cfg = executed_config(args.arch, args.depth, args.reduced)
    boundaries = rescale_boundaries(boundaries_full, args.depth, args.stages)
    pipe = PipelineConfig(stage_impl=STAGE_IMPL, compute_dtype=COMPUTE_DTYPE)
    say(f"[3/4] executing plan {boundaries} as a {len(boundaries)}-stage "
        f"1F1B pipeline of {cfg.name} (d_model {cfg.d_model}, "
        f"{cfg.num_layers} layers), M={args.microbatches}, "
        f"{args.batch}x{args.seq} tokens/step, {pipe}")
    params = M.init_params(torch.Generator(device=dev).manual_seed(args.seed),
                           cfg, device=dev)
    opt = adamw(LR, max_grad_norm=1.0)
    opt_state = opt.init(params)
    train_step = make_pipeline_train_step(cfg, boundaries, args.microbatches,
                                          pipe, opt)
    rng = np.random.default_rng(args.seed)
    losses, seconds = [], []
    for step in range(args.pipeline_steps):
        toks = _tokens(rng, cfg.vocab_size, args.batch, args.seq, dev)
        labs = _tokens(rng, cfg.vocab_size, args.batch, args.seq, dev)
        t0 = time.perf_counter()
        params, opt_state, loss = train_step(params, opt_state, toks, labs)
        loss = float(loss)  # waits for the step
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        if step % 5 == 0 or step == args.pipeline_steps - 1:
            say(f"      pipeline step {step:3d} loss {loss:.4f} "
                f"({seconds[-1]:.3f} s)")

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
    return {"plan_full": boundaries_full, "devices": devices,
            "launches": launches,
            "boundaries": boundaries, "losses": losses,
            "step_seconds": seconds, "eval_loss": eval_loss,
            "eval_seconds": eval_seconds, "cfg": cfg, "params": params,
            "opt_state": opt_state, "pipe": pipe, "opt": opt,
            "eval_batch": batch, "train": res, "env": env, "mesh": mesh}


if __name__ == "__main__":
    main()
