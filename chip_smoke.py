#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100::

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

1. card: name and power limit (``nvidia-smi``), TF32 off for matmuls and
   cuDNN so f32 means f32;
2. build: every hand-written kernel of the main path, compiled from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per
   source, all started together);
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, forward and backward, f32 and bf16/fp16;
4. the slice: ``train_sac`` through two updating chunks and
   ``evaluate_sac`` at the repo's SAC configuration on the ResNet-101
   MHSL env, with the launch counters reset just before and read just
   after, checked against the count the path must give;
5. timings: seconds per training chunk and env-steps/s; a
   ``torch.profiler`` trace of single gradient steps (device busy share,
   kernels per step); each kernel and its plain version at the main
   path's shapes (CUDA events, device time by CUDA-graph replay).

The second-to-last line of output is the per-kernel JSON record, the
last line ``{"ok": true, "device": {...}}``. The script imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the slice's configuration (SACConfig defaults, ResNet-101 MHSL env)
NUM_ENVS = 32
EPISODES = 96
WARMUP = 32
EVAL_EPISODES = 32


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[card] torch.cuda.get_device_name: {name}; count "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log("[card] TF32 disabled for matmul and cuDNN")
    log(smi)
    return name, smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

KERNELS = ("ca_attention",)


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        paths = list(pool.map(_build.build, KERNELS))
    wall = time.perf_counter() - t0
    for name, path in zip(KERNELS, paths):
        log(f"[build] {name}: {_build.BUILD_SECONDS.get(name, 0.0):.2f} s "
            f"nvcc -> {path.relative_to(ROOT)}")
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels built in {wall:.2f} s")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------


def _ca_inputs(torch, b, i, dtype, seed, obs_dim=28, pair_dim=52, c=64):
    """Main-path CA inputs (ResNet-101 env: obs_dim 28, pair_dim 52,
    C = 64) drawn on the CPU from a seed, row 0 fully masked."""
    from repro_torch.core.agents.attention import init_cross_attention

    g = torch.Generator().manual_seed(seed)
    params = init_cross_attention(g, obs_dim, pair_dim, c, device="cuda")
    obs = torch.randn(b, obs_dim, generator=g)
    hist = torch.randn(b, i, pair_dim, generator=g)
    mask = (torch.rand(b, i, generator=g) > 0.3).float()
    mask[0] = 0.0
    tgt = torch.randn(b, obs_dim + c, generator=g)
    cast = {k: v.to(dtype) for k, v in params.items()}
    return (cast, obs.cuda().to(dtype), hist.cuda().to(dtype),
            mask.cuda().to(dtype), tgt.cuda())


# stated tolerances: forward max |err| <= atol; backward max |err| <=
# atol + rtol * max |ref grad| (gradients are sums over the batch)
CA_FWD_ATOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}
CA_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 5e-2),
              "float16": (2e-2, 5e-2)}


def phase_ca_checks(torch):
    """ca_attention kernel vs ca_attention_ref on the card. Low-precision
    runs are compared with the plain version run in f32 on the same
    rounded inputs. Returns the worst f32 forward error."""
    from repro_torch.kernels import ca_attention as CA

    worst_f32 = 0.0
    for b in (128, 32, 130):
        for i in (4, 8):
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                dn = str(dtype).split(".")[-1]
                params, obs, hist, mask, tgt = _ca_inputs(torch, b, i, dtype,
                                                          seed=b * 10 + i)
                p32 = {k: v.float() for k, v in params.items()}
                ref = CA.ca_attention_ref(obs.float(), hist.float(),
                                          mask.float(), p32["wq_s"],
                                          p32["wk"], p32["wv"])
                out = CA.ca_attention(params, obs, hist, mask)
                torch.cuda.synchronize()
                if out.dtype != dtype or tuple(out.shape) != tuple(ref.shape):
                    raise AssertionError(f"ca_attention out {out.dtype} "
                                         f"{tuple(out.shape)}")
                if not torch.isfinite(out.float()).all():
                    raise AssertionError(f"non-finite ca_attention output {b} {i} {dn}")
                if out[0, obs.shape[1]:].float().abs().max() != 0:
                    raise AssertionError("all-masked row is not exactly zero")
                fwd_err = float((out.float() - ref).abs().max())
                if fwd_err > CA_FWD_ATOL[dn]:
                    raise AssertionError(f"ca_attention fwd B={b} I={i} {dn}: "
                                         f"{fwd_err} > {CA_FWD_ATOL[dn]}")

                # backward: kernel path (autograd.Function) vs autograd of
                # the plain version in f32
                names = ("wq_s", "wq_h", "wk", "wv")
                pk = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                ok_, hk = obs.detach().requires_grad_(True), hist.detach().requires_grad_(True)
                lk = (CA.ca_attention(pk, ok_, hk, mask).float() * tgt).sum()
                gk = torch.autograd.grad(lk, [pk[n] for n in names] + [ok_, hk])
                pr = {k: v.detach().requires_grad_(True) for k, v in p32.items()}
                orf = obs.float().requires_grad_(True)
                hrf = hist.float().requires_grad_(True)
                lr = (CA.ca_attention_ref(orf, hrf, mask.float(), pr["wq_s"],
                                          pr["wk"], pr["wv"]) * tgt).sum()
                gr = torch.autograd.grad(lr, [pr[n] for n in ("wq_s", "wk", "wv")]
                                         + [orf, hrf])
                if gk[1].float().abs().max() != 0:
                    raise AssertionError("wq_h gradient is not exactly zero")
                atol, rtol = CA_BWD_TOL[dn]
                bwd_err = 0.0
                for name, a, r in zip(("wq_s", "wk", "wv", "obs", "hist"),
                                      (gk[0], gk[2], gk[3], gk[4], gk[5]), gr):
                    if not torch.isfinite(a.float()).all():
                        raise AssertionError(f"non-finite grad {name}")
                    err = float((a.float() - r).abs().max())
                    lim = atol + rtol * float(r.abs().max())
                    if err > lim:
                        raise AssertionError(f"ca_attention bwd {name} B={b} "
                                             f"I={i} {dn}: {err} > {lim}")
                    bwd_err = max(bwd_err, err)
                if dtype == torch.float32:
                    worst_f32 = max(worst_f32, fwd_err)
                log(f"[check] ca_attention B={b:3d} I={i} {dn:8s} fwd max|err| "
                    f"{fwd_err:.3e} (atol {CA_FWD_ATOL[dn]:g}), bwd max|err| "
                    f"{bwd_err:.3e} (atol {atol:g} + rtol {rtol:g}*max|ref|)")
    return worst_f32


# ---------------------------------------------------------------------------
# 5. timings
# ---------------------------------------------------------------------------


def _time_ms(torch, fn, iters=200, reps=7):
    """Eager: median over ``reps`` of CUDA-event time per call over
    ``iters`` back-to-back Python calls (host launch cost included)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _time_graph_ms(torch, fn, iters=100, reps=7):
    """Device time: ``iters`` calls captured in one CUDA graph, replayed
    ``reps`` times; median CUDA-event time per call. Host launch cost is
    out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def ca_flops(b, i, obs_dim=28, pair_dim=52, c=64):
    """Least f32 FLOPs of one ca_attention call (2 per multiply-add; the
    O(B*I) softmax is left out). The products reassociate: q.K_i =
    (wk q).h_i and sum_i w_i V_i = (sum_i w_i h_i) wv, and wq_s wk^T can
    be formed once per call, so the cheaper of the two orders counts:
    per row  q = obs wq_s, u = wk q            | once  M = wq_s wk^T
             I dots h_i.u, hbar = sum w_i h_i  | per row u = obs M,
             s' = hbar wv                      |   I dots, hbar, hbar wv."""
    per_row = 2 * i * pair_dim + pair_dim * c
    macs = min(b * (obs_dim * c + pair_dim * c + per_row),
               obs_dim * pair_dim * c + b * (obs_dim * pair_dim + per_row))
    return 2 * macs


def ca_bound(b, i, obs_dim=28, pair_dim=52, c=64, elt=4):
    """Least time (ms) for one f32 ca_attention call on an H100: bytes
    (each input read once, the output written once) over HBM rate vs
    the least f32 work (:func:`ca_flops`) over the non-tensor-core f32
    peak; the larger wins."""
    nbytes = elt * (b * obs_dim + b * i * pair_dim + b * i
                    + (obs_dim + 2 * pair_dim) * c + b * (obs_dim + c))
    flops = ca_flops(b, i, obs_dim, pair_dim, c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def phase_ca_timing(torch, card):
    """Kernel vs plain version at the main path's two shapes (B = 128 in
    updates, B = 32 in the rollout; I = 4, f32): device time from CUDA
    graph replay, and eager per-call time. Launches made here are not
    main-path launches and leave the counter as it was."""
    from repro_torch.kernels import ca_attention as CA

    out = {}
    saved = CA.launches
    for b in (128, 32):
        params, obs, hist, mask, _ = _ca_inputs(torch, b, 4, torch.float32,
                                                seed=7)

        def kernel():
            return CA.ca_attention(params, obs, hist, mask)

        def plain():
            return CA.ca_attention_ref(obs, hist, mask, params["wq_s"],
                                       params["wk"], params["wv"])

        # alternate plain, kernel, kernel, plain; report the medians
        g = [_time_graph_ms(torch, f) for f in (plain, kernel, kernel, plain)]
        e = [_time_ms(torch, f) for f in (plain, kernel, kernel, plain)]
        ms, plain_ms = statistics.median(g[1:3]), statistics.median([g[0], g[3]])
        eager, plain_eager = statistics.median(e[1:3]), statistics.median([e[0], e[3]])
        bound, by, nbytes, flops = ca_bound(b, 4)
        out[b] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        log(f"[time] ca_attention B={b} I=4 f32 device (graph replay): "
            f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms; eager per call: "
            f"kernel {eager:.6f} ms, plain {plain_eager:.6f} ms; bound "
            f"{bound:.6f} ms ({by}; {nbytes} B, {flops} FLOP) [{card}]")
    CA.launches = saved
    return out


# ---------------------------------------------------------------------------
# 4. the slice
# ---------------------------------------------------------------------------


def phase_slice(torch, card):
    from repro_torch.core.agents import loops as LP
    from repro_torch.core.agents import sac as SAC
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile
    from repro_torch.kernels import ca_attention as CA
    from repro_torch.tree import tree_leaves

    env = MHSLEnv(profile=resnet101_profile(batch=1))  # cuda by default
    cfg = SAC.SACConfig()
    log(f"[slice] env obs_dim {env.obs_dim}, action heads "
        f"{sum(env.action_dims.values()) + env.action_dims['decoys']}, "
        f"episode_len {env.episode_len}; {cfg}")

    CA.launches = 0
    t0 = time.perf_counter()
    res = LP.train_sac(env, cfg, episodes=EPISODES, seed=0,
                       warmup_episodes=WARMUP, num_envs=NUM_ENVS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = CA.launches

    chunks = math.ceil(EPISODES / NUM_ENVS)
    upd_chunks = sum(1 for c in range(chunks) if c * NUM_ENVS >= WARMUP)
    n_updates = cfg.updates_per_step * env.episode_len * NUM_ENVS
    expect = upd_chunks * (n_updates + env.episode_len)
    if len(res.metrics) != upd_chunks or upd_chunks < 2:
        raise AssertionError(f"{len(res.metrics)} updating chunks, expected "
                             f"{upd_chunks} (>= 2)")
    if train_launches != expect:
        raise AssertionError(f"ca_attention launched {train_launches} times "
                             f"in train_sac, expected {expect}")
    for leaf in tree_leaves(res.params):
        if leaf.device.type != "cuda":
            raise AssertionError(f"parameter on {leaf.device}")
        if not torch.isfinite(leaf).all():
            raise AssertionError("non-finite parameter after training")
    vals = [v for m in res.metrics for v in m.values()]
    vals += res.episode_reward + res.episode_leak
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError("non-finite training metric")
    if len(res.episode_reward) != EPISODES:
        raise AssertionError("episode count")
    log(f"[slice] train_sac: {EPISODES} episodes, {upd_chunks} updating "
        f"chunks x {n_updates} gradient steps, ca_attention launches "
        f"{train_launches} (expected {expect}); last update metrics "
        f"{res.metrics[-1]}")

    t1 = time.perf_counter()
    ev = LP.evaluate_sac(env, res.params, cfg, episodes=EVAL_EPISODES)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    eval_launches = CA.launches - train_launches
    if eval_launches != env.episode_len:
        raise AssertionError(f"evaluate_sac launched ca_attention "
                             f"{eval_launches} times, expected "
                             f"{env.episode_len}")
    if not all(math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"non-finite evaluation {ev}")
    log(f"[slice] evaluate_sac({EVAL_EPISODES}): {ev}")

    upd_secs = [s for s, m in zip(res.chunk_seconds, res.chunk_updated) if m]
    steps = EPISODES * env.episode_len
    log(f"[time] train_sac total {train_s:.3f} s (first chunk includes "
        f"warm-up); per chunk {['%.3f' % s for s in res.chunk_seconds]} s; "
        f"updating chunk median {statistics.median(upd_secs):.3f} s "
        f"[{card}]")
    log(f"[time] env-steps/s over train_sac {steps / train_s:.1f}; "
        f"evaluate_sac {EVAL_EPISODES * env.episode_len / eval_s:.1f} "
        f"[{card}]")
    return CA.launches, env, cfg, res.params


# ---------------------------------------------------------------------------
# 5b. where the time of a chunk goes
# ---------------------------------------------------------------------------


def phase_trace(torch, card, env, cfg, params, steps=20):
    """Host time of one batched rollout episode and of single gradient
    steps, and a torch.profiler trace of ``steps`` gradient steps: device
    busy share, kernels per step, top kernels and host ops. Launches here
    do not count for the main path."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.agents import loops as LP
    from repro_torch.core.agents import rollout as R
    from repro_torch.core.agents import sac as SAC
    from repro_torch.kernels import ca_attention as CA

    saved = CA.launches
    gen = torch.Generator(device="cuda").manual_seed(5)
    update, init_opt = SAC.make_update(env.action_dims, cfg)
    opt = init_opt(params)
    buf = R.buffer_init(cfg.buffer_size, LP.sac_example(env, cfg))
    policy = R.sac_policy(env.action_dims, cfg)
    st0 = env.reset(env.sample_positions(gen, NUM_ENVS))
    R.rollout_episode(env, policy, params, st0, gen, cfg.hist_len)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, traj = R.rollout_episode(env, policy, params, st0, gen, cfg.hist_len)
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    R.buffer_add(buf, R.flatten_transitions(traj, LP.SAC_FIELDS))
    idx = torch.randint(0, buf.size, (steps + 3, cfg.batch), generator=gen,
                        device="cuda")
    for row in idx[:3]:  # warm
        params, opt, _ = update(params, opt, R.buffer_gather(buf, row))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for row in idx[3:]:
            params, opt, _ = update(params, opt, R.buffer_gather(buf, row))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
    CA.launches = saved
    log(f"[trace] one rollout episode ({NUM_ENVS} envs x "
        f"{env.episode_len} steps): {roll_s * 1e3:.3f} ms host; one gradient "
        f"step (profiled): {step_s * 1e3:.3f} ms host [{card}]")
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in events if e.device_type == cuda]
    dev_us = sum(e.self_device_time_total for e in kern)
    n_kern = sum(e.count for e in kern)
    if dev_us == 0:
        log("[trace] the profiler saw no device time")
        return
    log(f"[trace] per gradient step: {n_kern / steps:.0f} kernels, "
        f"{dev_us / steps / 1e3:.3f} ms device busy, busy share "
        f"{dev_us / 1e6 / (step_s * steps):.3f} of host time [{card}]")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[trace]   kernel {e.key[:70]}: {e.count // steps}/step, "
            f"{e.self_device_time_total / steps:.1f} us/step device")
    host = [e for e in events if e.device_type != cuda]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"[trace]   host op {e.key[:50]}: {e.count / steps:.1f}/step, "
            f"{e.self_cpu_time_total / steps:.1f} us/step self CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is missing under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    name, card = phase_card(torch)
    phase_build()
    worst = phase_ca_checks(torch)
    launches, env, cfg, params = phase_slice(torch, card)
    phase_trace(torch, card, env, cfg, params)
    timing = phase_ca_timing(torch, card)
    t = timing[128]
    kernels = [{
        "name": "ca_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ca_attention.cu",
        "replaces": "src/repro/kernels/ca_attention.py:41",
        "launches": launches,
        "max_abs_err": worst,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
