"""The zoo trainer: unpipelined training of any zoo arch on synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch pixtral-12b \
        --no-reduced --depth 4 --batch 4 --seq 1024 --steps 3 --bf16-compute

Counterpart of the JAX package's ``launch/train.py``, with its arguments,
optimizer (AdamW at ``--lr`` under a 10-step linear warm-up and a cosine
decay over ``--steps``, gradients clipped to global norm 1) and printed
lines. The reference's forward always computes in bf16, and so does this
one; ``--bf16-compute`` adds the bf16 weight copy (the matrices cast
once per step, gradients taken with respect to the copy, f32 masters
updated). Batches come from ``data.synthetic_stream`` (numpy draws, the
reference's values); a frontend config's rows are ``frontend_tokens``
feature positions then text. Weights are random, from seed 0.

Differences from the reference, each for a reason:
- it runs in one process on ``--device`` (``cuda`` by default, or
  ``cpu``); ``--data-par`` and ``--model-par`` (a 2 x 2 host mesh in the
  reference) default to 1, and above 1 are an argparse error, as the
  parameter sharding rules they need are not ported yet;
- the reference's ``--reduced`` cannot be turned off (``store_true`` with
  ``default=True``); here the reduced widths stay the default and
  ``--no-reduced`` runs the published widths, at ``--depth`` layers (the
  arch's block pattern tiled and cut to that depth).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.checkpoint.store import save_pytree
from repro_torch.data import synthetic_stream
from repro_torch.device import resolve_device
from repro_torch.launch.train_mhsl_rl import executed_config
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
    args = ap.parse_args(argv)
    if args.data_par != 1 or args.model_par != 1:
        ap.error("--data-par and --model-par above 1 need the parameter "
                 "sharding rules, which are not ported yet; the trainer runs "
                 "in one process")
    return args


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train ``--steps`` steps, print the reference's lines, and return
    the per-step losses and seconds with the executed config, the
    trained params and the optimizer state."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = executed_config(args.arch, args.depth, args.reduced)
    print(f"device: {dev}  model: {cfg.name}", flush=True)

    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    opt = adamw(linear_warmup_cosine(args.lr, 10, args.steps), max_grad_norm=1.0)
    opt_state = opt.init(params)
    step_fn = make_train_step(
        cfg, opt, compute_copy_dtype=torch.bfloat16 if args.bf16_compute else None)
    stream = synthetic_stream(cfg, args.batch, args.seq, device=dev)
    # the reference takes the first batch for its shardings and trains on
    # the ones after it; so does this loop, to see the same batches
    next(stream)

    losses, seconds = [], []
    t0 = time.time()
    for step in range(args.steps):
        batch = next(stream)
        t1 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        seconds.append(time.perf_counter() - t1)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({time.time() - t0:.1f}s)", flush=True)
    if args.ckpt:
        save_pytree(params, args.ckpt)
        print(f"saved -> {args.ckpt}")
    return {"losses": losses, "step_seconds": seconds, "cfg": cfg,
            "params": params, "opt_state": opt_state}


if __name__ == "__main__":
    main()
