"""The zoo trainer: unpipelined training of any zoo arch on synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch pixtral-12b \
        --no-reduced --depth 4 --batch 4 --seq 1024 --steps 3 --bf16-compute
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --data-par 2 --model-par 2 --device cpu

Counterpart of the JAX package's ``launch/train.py``, with its arguments,
optimizer (AdamW at ``--lr`` under a 10-step linear warm-up and a cosine
decay over ``--steps``, gradients clipped to global norm 1) and printed
lines. The reference's forward always computes in bf16, and so does this
one; ``--bf16-compute`` adds the bf16 weight copy (the matrices cast
once per step, gradients taken with respect to the copy, f32 masters
updated). Batches come from ``data.synthetic_stream`` (numpy draws, the
reference's values); a frontend config's rows are ``frontend_tokens``
feature positions then text. Weights are random, from seed 0.

On a (``--data-par`` x ``--model-par``) mesh, as the reference, each rank
holds the blocks ``param_shardings`` assigns it of the params and both
AdamW moments (FSDP over ``data``, tensor parallelism over ``model``),
takes its rows of each batch and trains under ``activation_sharding``;
rank 0 prints and ``--ckpt`` writes the whole tree from rank 0. Under a
launcher (``WORLD_SIZE`` set) the ranks join the default group: NCCL when
every rank has a card of its own, gloo otherwise (ranks that share a
card stage their transfers through the host). A mesh larger than the
world raises.

Differences from the reference, each for a reason:
- ``--data-par`` and ``--model-par`` default to 1, not to the
  reference's 2 x 2: a single ``python -m`` start has one rank, and its
  forced host devices have no counterpart here; the run is on
  ``--device`` (``cuda`` by default, or ``cpu``);
- the reference's ``--reduced`` cannot be turned off (``store_true`` with
  ``default=True``); here the reduced widths stay the default and
  ``--no-reduced`` runs the published widths, at ``--depth`` layers (the
  arch's block pattern tiled and cut to that depth).
"""
from __future__ import annotations

import argparse
import time
from contextlib import nullcontext
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import save_pytree
from repro_torch.data import synthetic_stream
from repro_torch.device import resolve_device
from repro_torch.distribution import collectives as C
from repro_torch.distribution import sharding as SH
from repro_torch.distribution.context import activation_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train_mhsl_rl import executed_config, init_ranks
from repro_torch.models import init_params, make_train_step
from repro_torch.optim import adamw, linear_warmup_cosine


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the arch's reduced() widths (default); --no-reduced "
                         "runs the published widths")
    ap.add_argument("--depth", type=int, default=None,
                    help="layers to run (default: the config's)")
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--bf16-compute", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train ``--steps`` steps, print the reference's lines, and return
    the per-step losses and seconds with the executed config, the
    trained params and the optimizer state (this rank's blocks on a mesh,
    with ``"mesh"`` and the params' ``"shardings"``)."""
    args = parse_args(argv)
    sharded = args.data_par * args.model_par > 1
    owns_group = init_ranks(args.device) if sharded else False
    try:
        return _run(args, sharded)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args, sharded: bool) -> Dict[str, Any]:
    mesh = psh = None
    if sharded:
        mesh = make_host_mesh(args.data_par, args.model_par, device=args.device)
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    cfg = executed_config(args.arch, args.depth, args.reduced)
    say(f"mesh: {mesh.shape if mesh else {}}  device: {dev}  model: {cfg.name}")

    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    if sharded:  # this rank's blocks; the whole tree is freed
        psh = SH.param_shardings(params, cfg, mesh)
        params = SH.blocks(params, psh)
    opt = adamw(linear_warmup_cosine(args.lr, 10, args.steps), max_grad_norm=1.0)
    opt_state = opt.init(params)
    step_fn = make_train_step(
        cfg, opt, compute_copy_dtype=torch.bfloat16 if args.bf16_compute else None,
        param_shardings_tree=psh)
    stream = synthetic_stream(cfg, args.batch, args.seq, device=dev)
    # the reference takes the first batch for its shardings and trains on
    # the ones after it; so does this loop, to see the same batches
    next(stream)
    baxes = SH.batch_axes(mesh, args.batch) if sharded else None

    def local(batch):  # this rank's rows of every batch entry
        if not sharded:
            return batch
        rows = SH.shard_rows(mesh, baxes, args.batch)
        return {k: v[rows] for k, v in batch.items()}

    losses, seconds = [], []
    t0 = time.time()
    with (activation_sharding(mesh, baxes) if sharded else nullcontext()):
        for step in range(args.steps):
            batch = local(next(stream))
            t1 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            losses.append(float(m["loss"]))  # waits for the step
            seconds.append(time.perf_counter() - t1)
            if step % 10 == 0 or step == args.steps - 1:
                say(f"step {step:4d}  loss {losses[-1]:.4f}  "
                    f"({time.time() - t0:.1f}s)")
    if args.ckpt:
        whole = SH.gather_tree(params, psh) if sharded else params
        if lead:
            save_pytree(whole, args.ckpt)
        del whole
        if sharded:
            C.barrier(mesh)
        say(f"saved -> {args.ckpt}")
    return {"losses": losses, "step_seconds": seconds, "cfg": cfg,
            "params": params, "opt_state": opt_state, "mesh": mesh,
            "shardings": psh}


if __name__ == "__main__":
    main()
