"""Config-driven serving launcher: the continuous-batching engine or
static batching.

Port of ``repro.launch.serve``::

    # continuous service on a Poisson trace, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \\
        --requests 32 --rate 8.0

    # split serving: a 2-stage plan with per-stage KV rings, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --set boundaries 1,2

    # everything from a JSON config (the JAX launcher reads the same
    # file), CLI keys override
    PYTHONPATH=src python -m repro_torch.launch.serve --config serve.json \\
        --set num_slots 16 --set decode_chunk 4

    # a 2-stage plan on 2 ranks, stage t on rank t (gloo on the CPU)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --device cpu --set boundaries 1,2

Every engine and scheduler knob is a :class:`repro_torch.serving.ServeConfig`
field. ``--mode static`` runs the same trace through the static-batch
baseline (``make_generate_fn``: batch, wait for ALL rows, next batch).
``--device`` is ``cuda`` by default.

Started by ``torchrun`` (``WORLD_SIZE`` set) with ``boundaries`` of as
many stages as ranks or fewer, the plan is served on a stage mesh of
``len(boundaries)`` ranks, stage ``t`` on rank ``t``, as the reference
serves it on ``make_stage_mesh(len(boundaries))``: NCCL when every rank
has a card of its own, else gloo (ranks sharing one card, host-staged).
Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def run_static(cfg, trace, *, warmup: bool = False, params=None,
               device: DeviceLike = None, mesh=None):
    """Static-batch baseline: admit in arrival order, N at a time, wait
    for the whole batch (every row pays the full ``max_new - 1`` decode
    steps, as the reference's scan). ``warmup=True`` runs one throwaway
    batch before the clock starts. ``params``: the model's weights (the
    whole tree), else drawn from ``cfg.seed`` as the service draws them.
    ``mesh``: a stage mesh for ``cfg.boundaries`` (by default
    ``serving.service.stage_mesh_for``'s), each rank serving its stage
    over its share of ``params``; every rank runs the same batches and
    returns the same completions."""
    from repro_torch.serving.batching import make_generate_fn
    from repro_torch.serving.service import (init_model_params, make_runner,
                                             stage_mesh_for)

    if mesh is None:
        mesh = stage_mesh_for(cfg, device)
    dev = resolve_device(mesh.device if device is None and mesh is not None
                         else device)
    model_cfg = cfg.model_config()
    if params is None:
        params = init_model_params(cfg, model_cfg, dev)
    runner = make_runner(cfg, model_cfg, dev, mesh)
    if mesh is not None:
        from repro_torch.core.pipeline import stage_params

        params = stage_params(params, model_cfg, cfg.boundaries,
                              mesh.axis_index(runner.stage_axis))
    n = cfg.num_slots
    gen = make_generate_fn(runner, max_new=cfg.max_new,
                           temperature=cfg.temperature)
    order = sorted(trace, key=lambda r: r.arrival_time)

    def batch_args(batch):
        ap = np.zeros((n, cfg.prompt_pad), np.int64)
        al = np.ones((n,), np.int64)
        ag = np.ones((n,), np.int64)
        ar = np.full((n,), -1, np.int64)
        for i, r in enumerate(batch):
            ap[i, :r.plen] = r.prompt
            al[i] = r.plen
            ag[i] = r.gen_target
            ar[i] = r.rid
        return [torch.from_numpy(a).to(dev) for a in (ap, al, ag, ar)]

    if warmup and order:
        with torch.inference_mode():
            gen(params, runner.init_caches(n, cfg.prompt_pad + cfg.max_new),
                *batch_args([]), cfg.seed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done, lats = {}, {}
    num_batches = 0
    for lo in range(0, len(order), n):
        batch = order[lo:lo + n]
        # a batch cannot start before its members arrive; waiting while
        # idle jumps the clock instead of burning wall time
        ready_at = max(r.arrival_time for r in batch)
        now = time.perf_counter() - t0
        if now < ready_at:
            t0 -= ready_at - now
        caches = runner.init_caches(n, cfg.prompt_pad + cfg.max_new)
        with torch.inference_mode():
            buf, n_gen = gen(params, caches, *batch_args(batch), cfg.seed)
        buf, n_gen = buf.cpu().numpy(), n_gen.cpu().numpy()
        num_batches += 1
        now = time.perf_counter() - t0
        for i, r in enumerate(batch):
            done[r.rid] = buf[i, :int(n_gen[i])].astype(np.int32)
            lats[r.rid] = now - r.arrival_time
    wall = time.perf_counter() - t0
    ls = sorted(lats.values())
    pct = (lambda q: ls[min(int(q * len(ls)), len(ls) - 1)]) if ls else (lambda q: 0.0)
    return {
        "completions": done,
        "num_requests": len(done),
        "wall_seconds": wall,
        "requests_per_sec": len(done) / wall if wall else 0.0,
        "tokens_per_sec": sum(len(t) for t in done.values()) / wall
        if wall else 0.0,
        "p50_latency_s": pct(0.50),
        "p99_latency_s": pct(0.99),
        # useful decode-slot-steps over executed ones: every batch runs
        # all n rows for max_new tokens, drained and padded rows included
        "slot_occupancy": sum(len(t) for t in done.values())
        / (num_batches * n * cfg.max_new) if num_batches else 0.0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None, help="ServeConfig JSON file")
    ap.add_argument("--set", nargs=2, action="append", default=[],
                    metavar=("KEY", "VALUE"),
                    help="override a ServeConfig field")
    ap.add_argument("--mode", choices=("engine", "static"), default="engine")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="emit metrics as one JSON line")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run without a card)")
    args = ap.parse_args(argv)

    from repro_torch.launch.train_mhsl_rl import init_ranks
    from repro_torch.serving import ServeConfig

    overrides = {k: ServeConfig.parse_override(k, v) for k, v in args.set}
    cfg = ServeConfig.load(args.config, overrides)
    owns_group = init_ranks(args.device) if cfg.boundaries else False
    try:
        return _serve(args, cfg)
    finally:
        if owns_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(args, cfg):
    from repro_torch.serving import ServingService, poisson_trace
    from repro_torch.serving.service import stage_mesh_for

    mesh = stage_mesh_for(cfg, args.device)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    model_cfg = cfg.model_config()
    trace = poisson_trace(
        n_requests=args.requests, rate_per_sec=args.rate,
        vocab_size=model_cfg.vocab_size,
        plen_range=(4, cfg.prompt_pad), gen_range=(4, cfg.max_new),
        seed=args.trace_seed)

    if args.mode == "static":
        res = run_static(cfg, trace, device=dev, mesh=mesh)
    else:
        res = ServingService(cfg, device=dev, mesh=mesh).run(trace)
    if mesh is not None and mesh.rank != 0:  # rank 0 prints
        return res

    metrics = {k: v for k, v in res.items()
               if k not in ("completions", "latencies", "replans")}
    if args.json:
        print(json.dumps(metrics, default=float))
    else:
        print(f"{args.mode}: {res['num_requests']} requests in "
              f"{res['wall_seconds']:.2f}s")
        print(f"  requests/sec {res['requests_per_sec']:.2f}  "
              f"tokens/sec {res['tokens_per_sec']:.1f}")
        print(f"  p50 {res['p50_latency_s']*1e3:.0f} ms  "
              f"p99 {res['p99_latency_s']*1e3:.0f} ms  "
              f"slot occupancy {res['slot_occupancy']:.2f}")
    return res


if __name__ == "__main__":
    main()
