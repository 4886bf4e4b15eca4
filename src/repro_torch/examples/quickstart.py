"""Quickstart: train a small LM for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--arch stablelm-1.6b] [--steps 300] [--d-model 512] [--device cpu]

The counterpart of the JAX package's ``examples/quickstart.py``, with its
arguments and steps, through the public API only (``repro_torch.api``):
config -> reduced-but-real model -> synthetic data stream -> AdamW under a
warm-up cosine -> ``save_pytree`` / ``load_pytree`` round trip. It runs
on the card unless ``--device cpu`` is given. Weights are random, from
seed 0; ``--ckpt`` defaults to a file under ``experiments/``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.api import (adamw, get_config, init_params,
                             linear_warmup_cosine, load_pytree,
                             make_train_step, save_pytree, synthetic_stream)
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="experiments/quickstart_ckpt.npz")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def quickstart_config(args):
    """The example's model: the arch's reduced config resized to
    ``--layers`` x ``--d-model`` with 64-wide heads and a 2 048-token
    vocabulary."""
    cfg = get_config(args.arch).reduced()
    return replace(cfg, num_layers=args.layers, d_model=args.d_model,
                   num_heads=max(cfg.num_heads, 4) or 4,
                   num_kv_heads=max(cfg.num_kv_heads, 2) or 2,
                   head_dim=64, vocab_size=2048,
                   name=f"{args.arch}-quickstart")


def main(argv: Optional[Sequence[str]] = None, params=None) -> Dict[str, Any]:
    """Train, print the example's lines, round-trip the checkpoint and
    return the per-step losses with the config and the trained params.
    ``params`` replaces the seeded initial weights (the tests carry the
    JAX package's)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = quickstart_config(args)
    if params is None:
        params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name}  params={n_params / 1e6:.1f}M  "
          f"layers={cfg.num_layers}  device={dev}", flush=True)

    opt = adamw(linear_warmup_cosine(3e-4, warmup=20, total_steps=args.steps),
                weight_decay=0.01, max_grad_norm=1.0)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=False)

    stream = synthetic_stream(cfg, args.batch, args.seq, device=dev)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        params, opt_state, m = step_fn(params, opt_state, next(stream))
        losses.append(float(m["loss"]))  # waits for the step
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({time.time() - t0:.1f}s)", flush=True)
    save_pytree(params, args.ckpt)
    restored = load_pytree(args.ckpt, params)
    if not all(torch.allclose(a.float(), b.float())
               for a, b in zip(tree_leaves(params), tree_leaves(restored))):
        raise AssertionError(f"the checkpoint {args.ckpt} did not round-trip")
    print(f"checkpoint round-trip ok -> {args.ckpt}", flush=True)
    return {"losses": losses, "cfg": cfg, "params": params}


if __name__ == "__main__":
    main()
