#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100::

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

1. card: name and power limit (``nvidia-smi``), TF32 off for matmuls and
   cuDNN so f32 means f32;
2. build: every hand-written kernel (``ca_attention``,
   ``stage_mlp_block``, ``flash_attention``, ``ssd_scan``,
   ``grouped_moe_ffn``), compiled from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (one process per source, all started together); where
   ``cuobjdump`` is found, the tensor-core instructions of each
   tensor-core kernel are counted (HGMMA for ``wgmma``, HMMA for the TF32
   ``mma.sync`` of the scan and of ``ca_attention``) and a kernel with
   none fails, as does a retired kernel still in its library (the scan's
   FMA kernel, the PR 11 ``ca_attention`` kernel);
3. each kernel against its plain PyTorch version on the card, at its
   paths' shapes and at ragged and other-arch shapes, forward (and
   backward through autograd where the kernel has one), f32, bf16 and
   f16; among them the shapes the kernels once refused: ``ca_attention``
   at I 16, pair_dim 132 and C 256 (weights and history streamed),
   ``flash_attention`` at head dims 80 (padded), 96, 192 and 256,
   ``ssd_scan`` at chunk 128 and d_state 256;
4. the SAC slice: ``train_sac`` through two updating chunks and
   ``evaluate_sac`` at the repo's SAC configuration on the ResNet-101
   MHSL env, with the launch counter reset just before and read just
   after, checked against the count the path must give;
   then a 7-step single-env plan rollout through ``select_action`` (the
   kernel at B = 1, held to its plain version, and each action equal to
   the plain route's under the same Gumbel draws); a short ``train_sac``
   at ``NetworkConfig(num_devices=22)`` with ``hist_len`` 16 (obs_dim 76,
   pair_dim 132), its launches checked; ``train_sac`` with the sequential
   update (``joint_update=False``) through one updating chunk, its
   launches checked and its gradient steps traced; ``train_dqn`` and
   ``train_ppo`` at fig 4's configuration for four chunks (host and
   device seconds per chunk);
4a. the planner and the scenario sweep: ``evaluate_population`` of the
   SAC slice's agent over fig 5's q grid (``ca_attention`` launches 5 x 7,
   leak non-decreasing in q under shared draws, a batch-of-1 sweep equal
   to ``evaluate_sac``) and the fig 9 placement (7 launches at B = 1);
   (T3) the same sweep under an ``EmpiricalLeakage`` trained on the card
   (``train_empirical_model(steps=120)``; the env's reward table equal to
   its ``layer_values``; 35 launches);
   the batched plan scorer over the full S = 4 enumerations of
   Qwen2.5-3B, Qwen3-MoE-30B-A3B, Mamba2-370m, Jamba-v0.1-52B and
   Nemotron-4-340B at seq 2048 (4 495 to 138 415 plans), state pricing
   off and on, held to its CPU evaluation and 64 plans each to
   ``plan_cost``, CUDA kernels per scorer call equal at 4 495 and
   138 415 plans, ms per call; ``make_split_oracle`` on the ResNet-101
   env with and without a device mask, and ``simulate_1f1b`` (sync,
   M = 1) equal to ``plan_cost``;
4b. the split slice, through ``launch.train_mhsl_rl.main``: a plan
   learned on the 36-layer Qwen2.5-3B profile, 1F1B pipelined training
   of Qwen2.5-3B at full width and depth 8 (stage MLP halves through
   ``stage_mlp_block``) and a held-out loss (attention through
   ``flash_attention``), every counter reset just before and read just
   after; the flash kernel against its plain version on the q, k, v of
   every attention call of one held-out loss call; traces of one step
   (the stage calls on the tensor-core GEMMs, no FMA grid) and of one
   held-out call (the 8 attention calls on ``flash_fwd_tc``); then one
   f32 pipelined step at depth 2 against ``make_train_step``;
4c. (A) Mamba2-370m through the launcher at full width, depth 24 of 48
   (a cut for the smoke's time): plan, 1F1B training through
   ``ssd_chunked``, and a held-out loss whose 24 scans run on
   ``ssd_scan``; the kernel against
   its plain version on every scan of one held-out call, and that loss
   against the ``ssd_chunked`` route's; a trace of one held-out call (the
   24 scans on the 3xTF32 kernel ``ssd_scan_tc``);
4d. (B) one Qwen3-MoE-30B-A3B MoE layer at full width on 8 x 256 bf16
   tokens: the dropless dispatch through ``grouped_moe_ffn``, held to the
   reference route; the capacity dispatch beside them; a trace of one
   kernel-route call (the ``wgmma`` GEMMs ``grouped_gemm_tc``, no FMA
   grid);
4e. (C) Qwen3-MoE-30B-A3B through the launcher at full width, depth 2 on
   2 stages (MoE halves through the dropless reference route, the
   held-out attention through ``flash_attention`` at GQA 32/4);
4e2. (H) Jamba-v0.1-52B at published widths, depth 2 (its first two
   layers, ``"MM"``: Mamba + MoE, then Mamba + dense MLP, a period of 2)
   on 2 stages: reduced Jamba as ``AMAM`` at (1, 4), f32, pipelined vs
   unpipelined; one pipelined bf16 ``(loss, grads)`` step held to the
   unpipelined ``loss_and_grads``; three timed steps through
   ``stage_mlp_block`` and a held-out loss through ``ssd_scan`` (held to
   the ``ssd_chunked`` route), launches counted; a traced step; peak
   memory. (F)
   Pixtral-12B at published widths, depth 4, through the zoo trainer
   ``launch.train`` (bf16 weight copy, rows of 256 image feature
   positions + 768 text tokens, 3 AdamW steps), then a held-out loss with
   frontend features through ``flash_attention`` (4 launches, each held
   to its plain version) held to ``impl="dense"``;
4f. the fig-3 band: the six arms of ``figures.band.CARD_BAND`` (ICM-CA,
   no ICM, no CA, neither, PPO, DQN at full width on the ResNet-101 env)
   trained on the port and held to the JAX runs committed in
   ``tests/data/torch_band_reference.json``; the negative control (ICM-CA
   never leaving warmup) must fall outside the ICM-CA band;
4g. population training and checkpoints: fig 8's two-scenario ICM-CA
   ``train_population`` at full width for 2 chunks of 16 envs, its
   ``ca_attention`` launches exactly twice ``train_sac``'s at the same
   episodes, envs and config, host seconds per chunk beside
   ``train_sac``'s; the kernel against its plain version at fig 6's
   shapes (obs 30, pair 54, I 4, B 16 and 128); save / restore seconds
   and bytes of a population's checkpoint; ``train_sac`` and a
   two-scenario ``train_population`` stopped after 2 of 4 chunks and
   resumed, held bit-identical to uninterrupted runs (two of which must
   agree bit for bit first); the population band: fig 8's population
   (``figures.band.POP_CARD_BAND``) on 3 seeds against the JAX runs
   committed in ``tests/data/torch_population_reference.json``, every
   metric inside, the population never leaving warmup outside;
4h. serving: (S1) Qwen2.5-3B at published widths, depth 18 of 36 (a
   cut for the smoke's time), f32, through the continuous-batching engine on a 32-request
   Poisson trace (16 slots): every greedy completion bitwise equal to
   ``generate_reference``'s; at temperature 0.7 every completion bitwise
   equal to static batching's (``run_static``) and the 4 longest to
   ``generate_reference``'s; the decode logits of those 4 against a
   teacher-forced full forward; greedy static batching serving the same
   tokens; the serve example (``repro_torch.examples.serve``) on the same
   weights, each row's greedy tokens equal to ``generate_reference``'s,
   its tokens/s; a traced decode tick (kernels, device-busy share, beside the
   weight-read bound). (S2) the same model on the pipelined runner, 4
   stages (the plan of 4b when it has 4 stages, else 9/18/27/36): f32
   tokens equal to S1's; bf16 with ``stage_impl="pallas"`` and a bf16
   wire, every ``stage_mlp_block`` call of one prefill and one decode
   step held to its plain version, 36 launches a pass, and the prefill's
   and the decode step's logits held to the f32 runner's on the same
   prompts and tokens (``SERVE_BF16_REL``). (S3) Mamba2-370m at full width
   and depth, a cached prefill (8 x 128) whose 48 scans run on
   ``ssd_scan`` (each held to its plain version), then 31 decode steps:
   tokens against an ``impl="auto"`` prefill's, logits against a
   teacher-forced forward. (S4) Qwen3-MoE-30B-A3B at published widths,
   depth 4, dropless, 8 slots: the engine against its reference in
   tokens and logits. The stage kernel at the decode (16 rows) and
   prefill (2 048 rows) shapes and the scan at S3's shape are timed.
   (K1, after S2) S2's f32 pipelined engine on S1's trace under
   ``reference_schedule`` (device 0 down for ticks [4, 9) of a 0.02 s
   fault clock): every completion bitwise S1's, the outage seen;
4i. the attacker population and chaos (before 4h): (T1) fig 10 at the
   reference's probe (depth 8, cuts 1-7, q 0.3 / 0.8: 14 attackers, 600
   steps) through ``figures.fig10_leakage_attack``: the MSE gate, the
   torch ops a training step dispatches equal at populations 1 and 14
   (CUDA kernels per step equal at 2 and 14), and the band: every (cut, q) mean score of 16 seeds held to the 32 JAX seeds of
   ``tests/data/torch_attack_reference.json``, the 60-step population
   outside; (T2) 46 attackers on StableLM-2-1.6B at published widths and
   full depth (cuts 1-23 x 2 scenarios, d 2048, 600 steps): the MSE gate,
   ops per step equal to T1's, peak memory, the live-activation
   scorer against a loop of ``attack_scores``; (K2) ``python -m
   repro_torch.launch.chaos --device cuda`` as a subprocess: SIGKILL after
   the first checkpoint, resume, bit-identical to an uninterrupted run;
4j. meshes over ``torch.distributed`` ranks (after 4i), child processes
   of ``tests/_torch_ranks.py``'s card workers, each under a timeout:
   (M1) one NCCL rank: ``train_sac`` and a two-scenario
   ``train_population`` on a 1-rank population mesh bit for bit
   ``mesh=None``, and a 1-rank stage mesh's step against the in-process
   step; (M2) two gloo ranks sharing the card, beside M1: four scenarios
   split over them bit for bit the 1-rank population, ``train_sac`` with
   its envs split against one rank (its difference recorded); (M3) four
   gloo ranks, run beside 4g's population band (host-bound, one
   process) and checked here: Qwen2.5-3B at published widths, depth 8 on 4 stages, M =
   4, 8 x 256 tokens, bf16 through ``stage_mlp_block`` with host-staged
   hops, the gradients assembled on rank 0 and held to the in-process
   step (seconds per step beside it, peak memory per rank; each timed
   step's collectives recorded, every step the same), one step of
   the launcher's ``make_pipeline_train_step(mesh=)`` (AdamW on the
   shares, the clip's norm summed over the ranks, the tied embedding
   once) against the one-process launcher step's norm and updated
   parameters on the same inputs, then a (2 x 2) stage x env step at depth
   4 in f32 against the in-process step at the JAX package's gate; the
   children's launches join the kernels line;
4k. the (data x model) mesh, four gloo ranks sharing the card (children
   that launch no kernel: (M4a) and (M4b) beside the kernels' build,
   (M4c) beside 4j's M1 and M2): (M4a) the zoo trainer with ``--data-par 2 --model-par
   2`` on StableLM-2-1.6B at published widths, depth 8, 3 bf16 steps,
   against one process (losses, updated params, seconds per step, peak
   memory per rank); (M4b) one (2 x 2) f32 step of Qwen3-MoE-30B-A3B at
   published widths, depth 2, through ``moe_a2a``, against the
   one-process dropless step (no copy dropped); (M4c) a (1 x 4) f32
   32-token prefill and greedy decode of Qwen2.5-3B at full depth on a
   cache split by length (the prefill through the gathered cache, every
   decode step's layers through ``flash_decode``), its greedy tokens
   equal to one process's, each pass's collectives recorded (every decode
   step the same counts); and Mamba2-370m at full depth on the same (1 x 4) mesh,
   each Mamba block on its SSM heads and conv channels, its greedy tokens
   equal to one process's. No kernel route: the children launch none;
4l. (M5a, beside 4f's band) serving on four gloo stage ranks sharing the
   card: Qwen2.5-3B at published widths and full depth on stages 9/18/27/36,
   bf16 with ``stage_impl="pallas"``, ``ServingService(mesh=)`` over an
   8-request Poisson trace, every rank's completions bit for bit the
   one-process service's, each rank launching ``stage_mlp_block`` for its
   own 9 layers once per ring pass (added to the kernels line), ms per
   decode step and peak memory per rank;
4m. the power-allocation example (``repro_torch.examples.power_allocation``)
   on the card, every value equal to the CPU run's (``rtol 1e-6``);
5. timings: seconds per training chunk and env-steps/s; a
   ``torch.profiler`` trace of single SAC gradient steps (device busy
   share, kernels per step); seconds per pipelined step and tokens/s and
   a trace of one step for each launcher run; each kernel, its plain
   version and, where one exists, the one PyTorch call computing the
   same function, at the paths' shapes (device time by CUDA-graph
   replay), beside each kernel's bound; the launch floor (an empty
   kernel) and ``ca_attention``'s cycles per phase (a ``-DCA_STAMPS``
   build); flash at head dim 192 beside SDPA.

The second-to-last line of output is the per-kernel JSON record, the
last line ``{"ok": true, "device": {...}}``. The script imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # dense TF32 tensor-core peak

# the slice's configuration (SACConfig defaults, ResNet-101 MHSL env)
NUM_ENVS = 32
EPISODES = 96
WARMUP = 32
EVAL_EPISODES = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def _reset_counts(counts=None):
    """Set every kernel wrapper's launch count to 0 (or to ``counts``)."""
    from repro_torch.launch import train_mhsl_rl as RUN

    for name, mod in RUN.KERNEL_MODULES.items():
        mod.launches = 0 if counts is None else counts[name]


def _counts():
    from repro_torch.launch import train_mhsl_rl as RUN

    return RUN.kernel_launches()


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

def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    wall = time.perf_counter() - t0
    for name, path in zip(_build.KERNELS, paths):
        log(f"[build] {name}: {_build.BUILD_SECONDS.get(name, 0.0):.2f} s "
            f"nvcc -> {path.relative_to(ROOT)}")
        entry = None
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else None
            elif "registers" in line or "spill" in line:
                log(f"[build]   {entry}: {line.strip()}")
    log(f"[build] all kernels built in {wall:.2f} s")
    _count_tc(dict(zip(_build.KERNELS, paths)))
    _log_tc_smem()


def _log_tc_smem():
    """Dynamic shared memory of the tensor-core bodies, as they launch."""
    import torch

    from repro_torch.kernels import ca_attention as CA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_dispatch as MD
    from repro_torch.kernels import ssd_scan as SK
    from repro_torch.kernels import stage_block as SB

    flib, slib, mlib = FA._library(), SB._library(), MD._library()
    for label, shape in (("SAC B 128 I 4", (28, 52, 4, 64)),
                         ("U 22 I 16", (76, 132, 16, 64)), ("C 256", (28, 52, 16, 256)),
                         ("U 22 I 16 C 256", (76, 132, 16, 256))):
        log(f"[build] ca_attention_tc plan, {label} obs/pair/I/C {shape}: " + ", ".join(
            f"{n} {CA.plan(dt, *shape)}" for n, dt in (("f32", torch.float32),
                                                    ("bf16", torch.bfloat16))))
    log("[build] flash_fwd_tc dynamic shared memory: " + ", ".join(
        f"hd {hd} {flib.flash_attention_wgmma_smem(hd)} B" for hd in FA.HEAD_DIMS))
    names = {0: "f32", 1: "f16", 2: "bf16"}
    log("[build] gemm_tc dynamic shared memory: " + ", ".join(
        f"x {names[x]} w {names[w]} {slib.stage_mlp_block_wgmma_smem(x, w)} B"
        for x in (2, 1) for w in (0, 1, 2)))
    log("[build] grouped_gemm_tc dynamic shared memory: " + ", ".join(
        f"x {names[x]} w {names[w]} {mlib.grouped_moe_ffn_wgmma_smem(x, w)} B"
        for x in (2, 1) for w in (0, x)))
    log(f"[build] ssd_scan_tc dynamic shared memory: "
        f"{SK._library().ssd_scan_smem()} B (ssd_cb_tc: none)")


# the tensor-core kernels (substrings of their mangled names) by library,
# and their tensor-core instruction: HGMMA for wgmma, HMMA for mma.sync
TC_KERNELS = {"ca_attention": (("ca_attention_tc",), "HMMA"),
              "flash_attention": (("flash_fwd_tc",), "HGMMA"),
              "stage_mlp_block": (("gemm_tc",), "HGMMA"),
              "grouped_moe_ffn": (("grouped_gemm_tc",), "HGMMA"),
              "ssd_scan": (("ssd_scan_tc", "ssd_cb_tc"), "HMMA")}
# kernels that a redesign retired: they must no longer be built
RETIRED = {"ssd_scan": ("ssd_scan_fwd",), "ca_attention": ("ca_attention_kernel",)}


def _cuobjdump():
    import shutil

    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = [Path("/usr/local/cuda/bin/cuobjdump")]
    try:
        import triton

        cands.append(Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
                     / "cuobjdump")
    except ImportError:
        pass
    return next((str(c) for c in cands if c.is_file()), None)


def _count_tc(paths):
    """Tensor-core instructions in each tensor-core kernel's SASS
    (cuobjdump), so that a body that compiled without them cannot pass
    unseen; and no retired kernel left in its library."""
    tool = _cuobjdump()
    if tool is None:
        log("[build] cuobjdump not found (PATH, /usr/local/cuda/bin, triton's "
            "backends/nvidia/bin): tensor-core instruction counts not taken")
        return
    for lib, (subs, instr) in TC_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(paths[lib])], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        counts, fn, functions = {}, None, []
        for line in sass.splitlines():
            if "Function : " in line:
                fn = line.split("Function : ", 1)[1].strip()
                functions.append(fn)
                if any(s in fn for s in subs):
                    counts[fn] = 0
                else:
                    fn = None
            elif fn is not None and instr in line:
                counts[fn] += 1
        missing = [s for s in subs if not any(s in f for f in counts)]
        if missing or min(counts.values()) == 0:
            raise AssertionError(f"{lib}: tensor-core kernels without {instr}: "
                                 f"{[f for f, n in counts.items() if n == 0] or missing}")
        retired = [f for f in functions for r in RETIRED.get(lib, ()) if r in f]
        if retired:
            raise AssertionError(f"{lib}: retired kernels still built: {retired}")
        for fn, n in sorted(counts.items()):
            log(f"[build] {lib}: {n:4d} {instr} in {fn}")


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


# (obs_dim, pair_dim, C) of the checks: the SAC env's, the U 22 env's
# (NetworkConfig(num_devices=22)) and wide attentions; at I 16 in f32 the
# last streams its weights in 5 stages and its history in chunks of 8
CA_WIDTHS = ((28, 52, 64), (76, 132, 64), (28, 52, 256), (76, 132, 256))


def phase_ca_checks(torch):
    """ca_attention kernel vs ca_attention_ref on the card: B 32, 128 and
    130, I 4, 8 and 16, the CA_WIDTHS (streamed weights and history among
    them), f32, bf16 and f16, forward and
    backward, row 0 all masked. Low-precision runs are compared with the
    plain version run in f32 on the same rounded inputs. Returns the worst
    f32 forward error at the SAC widths."""
    from repro_torch.kernels import ca_attention as CA

    worst_f32 = 0.0
    for b in (128, 32, 130):
        for i in (4, 8, 16):
            for obs_dim, pair_dim, c in CA_WIDTHS:
                worst = _ca_check_case(torch, CA, b, i, obs_dim, pair_dim, c)
                if (obs_dim, pair_dim, c) == CA_WIDTHS[0]:
                    worst_f32 = max(worst_f32, worst)
    return worst_f32


def _ca_check_case(torch, CA, b, i, obs_dim, pair_dim, c):
    worst_f32 = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dn = str(dtype).split(".")[-1]
        params, obs, hist, mask, tgt = _ca_inputs(torch, b, i, dtype, seed=b * 10 + i,
                                                  obs_dim=obs_dim, pair_dim=pair_dim, c=c)
        p32 = {k: v.float() for k, v in params.items()}
        ref = CA.ca_attention_ref(obs.float(), hist.float(), mask.float(),
                                  p32["wq_s"], p32["wk"], p32["wv"])
        before = CA.launches
        out = CA.ca_attention(params, obs, hist, mask)
        torch.cuda.synchronize()
        if CA.launches != before + 1:
            raise AssertionError("ca_attention did not count its launch")
        what = f"B={b} I={i} {obs_dim}/{pair_dim}/{c} {dn}"
        if out.dtype != dtype or tuple(out.shape) != tuple(ref.shape):
            raise AssertionError(f"ca_attention out {out.dtype} {tuple(out.shape)}")
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"non-finite ca_attention output {what}")
        if out[0, obs.shape[1]:].float().abs().max() != 0:
            raise AssertionError(f"all-masked row is not exactly zero ({what})")
        fwd_err = float((out.float() - ref).abs().max())
        if fwd_err > CA_FWD_ATOL[dn]:
            raise AssertionError(f"ca_attention fwd {what}: {fwd_err} > {CA_FWD_ATOL[dn]}")

        # backward: kernel path (autograd.Function) vs autograd of the
        # plain version in f32
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
        gr = torch.autograd.grad(lr, [pr[n] for n in ("wq_s", "wk", "wv")] + [orf, hrf])
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
                raise AssertionError(f"ca_attention bwd {name} {what}: {err} > {lim}")
            bwd_err = max(bwd_err, err)
        if dtype == torch.float32:
            worst_f32 = max(worst_f32, fwd_err)
        log(f"[check] ca_attention B={b:3d} I={i:2d} {obs_dim}/{pair_dim}/{c} {dn:8s} fwd "
            f"max|err| {fwd_err:.3e} (atol {CA_FWD_ATOL[dn]:g}), bwd max|err| {bwd_err:.3e} "
            f"(atol {atol:g} + rtol {rtol:g}*max|ref|)")
    return worst_f32


# ---------------------------------------------------------------------------
# 5. timings
# ---------------------------------------------------------------------------


# Every torch.profiler trace pads the traced work with idle host time on
# both sides, so that no kernel of it runs near an edge of the profiler's
# capture window (kineto maps the device clock onto the host's and drops
# records it places outside the window).
TRACE_PAD_S = 0.05
# A trace held to an exact launch count that comes up short of it, with no
# kernel it must not see, is retaken up to this many times in all; each
# short trace is logged. A trace with a kernel it must not see, or with
# more launches than expected, fails at once.
TRACE_ATTEMPTS = 3


@contextmanager
def _traced(torch):
    """``torch.profiler.profile`` of the device and the host around the
    body, padded by ``TRACE_PAD_S`` of idle time on each side."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


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


# the phases between the kernel's CA_STAMP marks
CA_PHASES = ("stage (bulk copies, one round trip)", "obs to f32", "q = obs wq_s",
             "u = q wk^T", "attention", "s' = hbar wv", "write [obs, s']")


def phase_ca_timing(torch, card):
    """Kernel vs plain version at the main path's two shapes (B = 128 in
    updates, B = 32 in the rollout; I = 4, f32) and at the U 22 shape (B
    128, I 16, obs 76, pair 132): device time from CUDA graph replay, and
    eager per-call time; the launch floor (an empty kernel by the same
    replay); and, from a build with -DCA_STAMPS, the cycles of CTA 0
    between the kernel's phase marks. Launches made here are not main-path
    launches and leave the counter as it was."""
    from repro_torch.kernels import ca_attention as CA

    out = {}
    saved = CA.launches
    floor = _time_graph_ms(torch, CA.launch_floor)
    out["floor_ms"] = floor
    log(f"[time] launch floor: an empty kernel by graph replay {floor:.6f} ms [{card}]")
    for b, i, dims in ((128, 4, (28, 52, 64)), (32, 4, (28, 52, 64)),
                       (128, 16, (76, 132, 64))):
        params, obs, hist, mask, _ = _ca_inputs(torch, b, i, torch.float32, seed=7,
                                                obs_dim=dims[0], pair_dim=dims[1], c=dims[2])

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
        bound, by, nbytes, flops = ca_bound(b, i, *dims)
        out[(b, i, dims)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        log(f"[time] ca_attention B={b} I={i} obs/pair/C {dims} f32 device (graph replay): "
            f"kernel {ms:.6f} ms ({ms / floor:.1f}x the launch floor), plain {plain_ms:.6f} "
            f"ms; eager per call: kernel {eager:.6f} ms, plain {plain_eager:.6f} ms; bound "
            f"{bound:.6f} ms ({by}; {nbytes} B, {flops} FLOP); plan "
            f"{CA.plan(torch.float32, *dims[:2], i, dims[2])} [{card}]")
    _ca_stamps(torch, card)
    CA.launches = saved
    return out


def _ca_stamps(torch, card):
    """Cycles of CTA 0 between the kernel's CA_STAMP marks at the SAC
    update shape, from a library built with -DCA_STAMPS (the last of 20
    back-to-back launches)."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import ca_attention as CA

    lib = ctypes.CDLL(str(_build.build("ca_attention", defines=("CA_STAMPS",))))
    lib.ca_attention_launch.restype = ctypes.c_int
    lib.ca_attention_launch.argtypes = CA._library().ca_attention_launch.argtypes
    lib.ca_attention_stamps.argtypes = [ctypes.c_void_p]
    params, obs, hist, mask, _ = _ca_inputs(torch, 128, 4, torch.float32, seed=7)
    out = torch.empty(128, 28 + 64, device="cuda")
    for _ in range(20):
        err = lib.ca_attention_launch(
            0, obs.data_ptr(), hist.data_ptr(), mask.data_ptr(), params["wq_s"].data_ptr(),
            params["wk"].data_ptr(), params["wv"].data_ptr(), out.data_ptr(), 128, 28, 52,
            4, 64, 0.125, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"stamped ca_attention launch failed: cudaError {err}")
    torch.cuda.synchronize()
    ref = CA.ca_attention_ref(obs, hist, mask, params["wq_s"], params["wk"], params["wv"])
    if float((out - ref).abs().max()) > CA_FWD_ATOL["float32"]:
        raise AssertionError("the stamped ca_attention build disagrees with the plain version")
    st = (ctypes.c_longlong * 8)()
    lib.ca_attention_stamps(st)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[time] ca_attention B=128 I=4 f32, cycles of CTA 0 by phase (-DCA_STAMPS build; SM "
        f"clock {clocks} when read): " + ", ".join(
            f"{name} {st[k + 1] - st[k]}" for k, name in enumerate(CA_PHASES))
        + f"; total {st[7] - st[0]} [{card}]")


# ---------------------------------------------------------------------------
# 4. the slice
# ---------------------------------------------------------------------------


def _finite_run(res, what):
    vals = [v for m in res.metrics for v in m.values()]
    vals += res.episode_reward + res.episode_leak
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"non-finite {what} metric")


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

    _reset_counts()
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
    _finite_run(res, "training")
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
    others = {k: v for k, v in _counts().items() if k != "ca_attention"}
    if any(others.values()):
        raise AssertionError(f"the SAC slice launched {others}")
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
# 4a. the split planner and the scenario sweep
# ---------------------------------------------------------------------------

# the zoo plan-scoring configs (figures/zoo_plan_scoring.py) and
# Nemotron-4-340B, the deepest zoo config: full S = 4 enumerations at seq
# 2048, 4 495 (Jamba) to 138 415 (Nemotron) plans
PLAN_CONFIGS = ("qwen2.5-3b", "qwen3-moe-30b-a3b", "mamba2-370m",
                "jamba-v0.1-52b", "nemotron-4-340b")
PLAN_STAGES = 4
PLAN_CHECKS = 64  # plans held to plan_cost per config and pricing
# card scorer vs the same scorer on the CPU, and vs plan_cost (float64
# stage sums); the scorer is f32 with the cumulative tables cast to f32.
# Measured on an H100 over the five enumerations: 1.8e-7 vs the CPU,
# 2.5e-7 vs plan_cost (at Nemotron's 96 layers); the gates leave ~8x
PLAN_CPU_RTOL = 2e-6
PLAN_HOST_RTOL = 2e-6
# feasibility may differ only for plans this close to a budget
PLAN_EDGE_RTOL = 2e-6


def _rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def phase_plan(torch, card):
    """The batched plan scorer on the card over the full S = 4 cut
    enumerations of ``PLAN_CONFIGS`` at seq 2048, with state pricing off
    and on: delay and energy against the same scorer on the CPU, 64 plans
    (first, last, the best, 61 drawn) against ``plan_cost`` on the host,
    the best delay against the CPU's; CUDA kernels per scorer call at
    4 495 and at 138 415 plans (equal: no per-plan work); ms per call.
    Then ``make_split_oracle`` on the ResNet-101 env, with and without a
    device mask, its feasibility against ``plan_cost`` at the budget; and
    the synchronous 1F1B transport model at M = 1 against ``plan_cost``.
    Returns the measured numbers."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import splitting as SP
    from repro_torch.core.channel import NetworkConfig
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile, transformer_profile
    from repro_torch.core.scenario import replace_param
    from repro_torch.core.transport import plan_transport_model, simulate_1f1b
    from repro_torch.figures import zoo_plan_scoring as Z

    t_phase = time.perf_counter()
    net0 = NetworkConfig(max_split=PLAN_STAGES)
    net1 = replace(net0, state_cycles_per_bit=Z.STATE_CYCLES_PER_BIT)
    pos, devices, p_tx, decoy = Z.plan_inputs(PLAN_STAGES, net0, seed=0)
    rng = np.random.default_rng(0)
    out = {"cpu_err": 0.0, "host_err": 0.0, "best_err": 0.0, "rows": {}}
    calls = {}
    for name in PLAN_CONFIGS:
        prof = transformer_profile(get_config(name), batch=1, seq=Z.SEQ)
        bounds_np = SP.stack_boundaries(prof.num_layers, PLAN_STAGES)
        n = len(bounds_np)
        bounds = torch.as_tensor(bounds_np, device="cuda")
        scorer = SP.make_plan_scorer(prof, "cuda")
        cpu_scorer = SP.make_plan_scorer(prof, "cpu")
        row = {"plans": n}
        for label, net in (("off", net0), ("on", net1)):
            t, e = (x.cpu().numpy() for x in scorer(bounds, devices, pos, p_tx,
                                                    decoy, net))
            tc, ec = (x.numpy() for x in cpu_scorer(bounds_np, devices, pos,
                                                    p_tx, decoy, net))
            cpu_err = max(_rel(t, tc), _rel(e, ec))
            best = int(np.argmin(t))
            idx = [0, n - 1, best] + rng.choice(n, PLAN_CHECKS - 3,
                                                replace=False).tolist()
            t0 = time.perf_counter()
            ref = np.asarray([SP.plan_cost(
                prof, SP.SplitPlan(tuple(int(x) for x in bounds_np[i]),
                                   tuple(int(d) for d in devices)),
                pos, p_tx, decoy, net) for i in idx])
            loop_s = (time.perf_counter() - t0) / len(idx)
            host_err = max(_rel(t[idx], ref[:, 0]), _rel(e[idx], ref[:, 1]))
            best_err = _rel(t.min(), tc.min())
            if (cpu_err > PLAN_CPU_RTOL or host_err > PLAN_HOST_RTOL
                    or best_err > PLAN_CPU_RTOL):
                raise AssertionError(
                    f"plan scorer on {name} (state pricing {label}): card vs "
                    f"CPU {cpu_err:.3e}, vs plan_cost {host_err:.3e}, best delay "
                    f"{best_err:.3e} (rtol {PLAN_CPU_RTOL:.0e} / "
                    f"{PLAN_HOST_RTOL:.0e})")
            out["cpu_err"] = max(out["cpu_err"], cpu_err)
            out["host_err"] = max(out["host_err"], host_err)
            out["best_err"] = max(out["best_err"], best_err)
            row[label] = {"best": bounds_np[best].tolist(),
                          "cpu_best": bounds_np[int(np.argmin(tc))].tolist(),
                          "best_delay_s": float(t[best]),
                          "cpu_err": cpu_err, "host_err": host_err,
                          "plan_cost_ms_per_plan": loop_s * 1e3}

        def call(scorer=scorer, bounds=bounds):
            return scorer(bounds, devices, pos, p_tx, decoy, net1)

        calls[n] = call
        row["ms"] = Z.time_call_s(call, torch.device("cuda")) * 1e3
        row["plans_per_s"] = n / row["ms"] * 1e3
        out["rows"][name] = row
        log(f"[plan] {name}: {n} plans, {row['ms']:.3f} ms per scorer call "
            f"({row['plans_per_s']:.0f} plans/s, CUDA events after warm-up); "
            f"card vs CPU max rel {max(row['off']['cpu_err'], row['on']['cpu_err']):.3e}, "
            f"vs plan_cost {max(row['off']['host_err'], row['on']['host_err']):.3e}; "
            f"best off {row['off']['best']} (CPU {row['off']['cpu_best']}), on "
            f"{row['on']['best']} (CPU {row['on']['cpu_best']}), "
            f"{row['on']['best_delay_s']:.6g} s; plan_cost "
            f"{row['on']['plan_cost_ms_per_plan']:.3f} ms per plan [{card}]")

    # kernels per scorer call, independent of the number of plans
    small, large = min(calls), max(calls)
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        k_small, c_small = Z.device_ops_per_call(calls[small])
        k_large, c_large = Z.device_ops_per_call(calls[large])
        if k_small == k_large and k_small == int(k_small) and k_small > 0:
            break
        log(f"[plan] kernel counts per call differ on attempt {attempt}: "
            f"{k_small} at {small} plans, {k_large} at {large}")
    else:
        raise AssertionError(f"kernels per scorer call: {k_small} at {small} "
                             f"plans, {k_large} at {large}")
    out.update(kernels_per_call=int(k_small), copies_per_call=(c_small, c_large))
    log(f"[plan] CUDA kernels per scorer call: {int(k_small)} at {small} plans "
        f"and at {large} plans; memory copies/sets {c_small:g} and {c_large:g}")

    # the oracle on the ResNet-101 env, budgets set inside the delay range
    env = MHSLEnv(profile=resnet101_profile(batch=1))
    gen = torch.Generator(device="cuda").manual_seed(3)
    st = env.reset(env.sample_positions(gen, 1))
    dev_pos = st.dev_pos[0]
    o_dev = (0, 1, 2, env.U)
    o_p = np.asarray([0.5, 1.0, 0.2])
    o_dec = np.zeros((env.S - 1, env.U + 1))
    o_dec[:, 4] = 0.2
    oracle = env.make_split_oracle()
    base = oracle(dev_pos, o_dev, o_p, o_dec)
    # the delay budget between the two distinct delays around the median,
    # the energy budget likewise among the plans within it: both verdicts
    # occur, each budget binds on some plans, and no plan's cost equals a
    # budget (many plans tie: they differ only in where equal-cost layers
    # fall)
    def between_median(x):
        v = torch.unique(x)
        k = max(len(v) // 2, 1)
        return float((v[k - 1] + v[k]) / 2)

    gamma_t = between_median(base["delay"])
    gamma_e = between_median(base["energy"][base["delay"] <= gamma_t])
    sp = replace_param(replace_param(env.scenario(), "gamma_t", gamma_t),
                       "gamma_e", gamma_e)
    gamma_t, gamma_e = float(sp.gamma_t), float(sp.gamma_e)
    res = oracle(dev_pos, o_dev, o_p, o_dec, sp)
    feas = res["feasible"].cpu().numpy()
    n_o = len(feas)
    idx = [0, n_o - 1] + rng.choice(n_o, PLAN_CHECKS - 2, replace=False).tolist()
    pos_h = dev_pos.cpu().numpy()
    bounds_o = res["boundaries"].cpu().numpy()
    edge = 0
    for i in idx:
        t_ref, e_ref = SP.plan_cost(env.profile, SP.SplitPlan(
            tuple(int(x) for x in bounds_o[i]), o_dev), pos_h, o_p, o_dec, env.net)
        want = t_ref <= gamma_t and e_ref <= gamma_e
        if bool(feas[i]) != want:
            if (abs(t_ref - gamma_t) <= PLAN_EDGE_RTOL * gamma_t
                    or abs(e_ref - gamma_e) <= PLAN_EDGE_RTOL * gamma_e):
                edge += 1
            else:
                raise AssertionError(f"oracle plan {bounds_o[i].tolist()}: "
                                     f"feasible {bool(feas[i])}, plan_cost "
                                     f"{t_ref:.6g} s / {e_ref:.6g} J")
    down = torch.ones(env.U + 1, dtype=torch.bool, device="cuda")
    down[o_dev[1]] = False
    idle = torch.ones_like(down)
    idle[5] = False
    if bool(oracle(dev_pos, o_dev, o_p, o_dec, sp, device_mask=down)["feasible"].any()):
        raise AssertionError("a plan on a down device is feasible")
    if not torch.equal(oracle(dev_pos, o_dev, o_p, o_dec, sp,
                              device_mask=idle)["feasible"], res["feasible"]):
        raise AssertionError("an idle device's outage changed the oracle")
    n_feas = int(feas.sum())
    if not 0 < n_feas < n_o:
        raise AssertionError(f"{n_feas} of {n_o} plans feasible at the median")
    out.update(oracle_plans=n_o, oracle_feasible=n_feas, edge_excused=edge)

    # the transport model at M = 1 (sync) is plan_cost's delay
    best = res["boundaries"][int(torch.argmin(res["delay"]))].tolist()
    plan = SP.SplitPlan(tuple(best), o_dev)
    t_ref, _ = SP.plan_cost(env.profile, plan, pos_h, o_p, o_dec, env.net)
    model = plan_transport_model(env.profile, plan, pos_h, o_p, o_dec, env.net)
    sim = simulate_1f1b(model, 1, transport="sync")
    if not math.isclose(sim["total_s"], t_ref, rel_tol=1e-12):
        raise AssertionError(f"simulate_1f1b sync M = 1: {sim['total_s']!r} vs "
                             f"plan_cost {t_ref!r}")
    ovl = simulate_1f1b(model, 4, transport="overlap")
    log(f"[plan] oracle on the ResNet-101 env: {n_o} plans, {n_feas} feasible "
        f"at gamma_t {gamma_t:.6g} s, gamma_e {gamma_e:.6g} J (between the "
        f"distinct values around the medians); "
        f"{len(idx)} plans vs "
        f"plan_cost, {edge} excused within rtol {PLAN_EDGE_RTOL:.0e} of a "
        f"budget; device mask: assignment device down -> none feasible, idle "
        f"device down -> unchanged; best plan {best}: simulate_1f1b sync M = 1 "
        f"{sim['total_s']!r} s = plan_cost {t_ref!r} s; overlap M = 4 "
        f"{ovl['total_s']:.6g} s, bubble {ovl['bubble_fraction']:.4f}")
    log(f"[plan] gates: card vs CPU scorer max rel {out['cpu_err']:.3e} (rtol "
        f"{PLAN_CPU_RTOL:.0e}), vs plan_cost {out['host_err']:.3e} (rtol "
        f"{PLAN_HOST_RTOL:.0e}), best delay {out['best_err']:.3e}; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


# fig 5's q grid, evaluated with the SAC slice's trained params
POP_QS = (0.3, 0.45, 0.6, 0.75, 0.9)


def phase_population(torch, card, env, cfg, params):
    """``evaluate_population`` of the SAC slice's agent over fig 5's q grid
    (``EVAL_EPISODES`` episodes a scenario), ``ca_attention`` launches
    counted (one per step per scenario); leak non-decreasing in q, exactly
    (shared draws); a batch-of-1 sweep equal to ``evaluate_sac``; then the
    fig 9 placement example on the same params (7 launches at B = 1).
    Returns (sweep launches, fig 9 launches, the sweep's leak)."""
    import numpy as np

    from repro_torch.core import scenario as SC
    from repro_torch.core.agents import loops as LP
    from repro_torch.core.agents import rollout as R
    from repro_torch.figures.fig9_example import placement_example

    t_phase = time.perf_counter()
    policy = R.sac_policy(env.action_dims, cfg)
    scenarios = SC.stack_scenarios(SC.scenario_grid(env.scenario(),
                                                    monitor_prob=list(POP_QS)))
    _reset_counts()
    t0 = time.perf_counter()
    out = SC.evaluate_population(env, policy, params, scenarios,
                                 episodes=EVAL_EPISODES, hist_len=cfg.hist_len)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    launches = counts.pop("ca_attention")
    expect = len(POP_QS) * env.episode_len
    if launches != expect or any(counts.values()):
        raise AssertionError(f"the q sweep launched ca_attention {launches} "
                             f"times (expected {expect}), others {counts}")
    for k, v in out.items():
        if v.shape != (len(POP_QS),) or not np.isfinite(v).all():
            raise AssertionError(f"q sweep {k}: {v}")
    if not np.all(np.diff(out["leak"]) >= 0.0):
        raise AssertionError(f"leak falls as q rises: {out['leak'].tolist()}")
    one = SC.evaluate_population(env, policy, params,
                                 SC.stack_scenarios([env.scenario()]),
                                 episodes=EVAL_EPISODES, hist_len=cfg.hist_len)
    ev = LP.evaluate_sac(env, params, cfg, episodes=EVAL_EPISODES)
    if one["reward"][0] != ev["reward"] or one["leak"][0] != ev["leak"]:
        raise AssertionError(f"batch-of-1 sweep {one} vs evaluate_sac {ev}")
    log(f"[population] q sweep {list(POP_QS)} x {EVAL_EPISODES} episodes: leak "
        f"{[round(float(x), 6) for x in out['leak']]}, reward "
        f"{[round(float(x), 4) for x in out['reward']]}; ca_attention launches "
        f"{launches} (expected {expect}); {secs:.3f} s host; a batch-of-1 "
        f"sweep equals evaluate_sac ({ev}) [{card}]")

    _reset_counts()
    fig9 = placement_example(env, params, cfg)
    torch.cuda.synchronize()
    counts = _counts()
    fig9_launches = counts.pop("ca_attention")
    if fig9_launches != env.episode_len or any(counts.values()):
        raise AssertionError(f"the fig 9 rollout launched ca_attention "
                             f"{fig9_launches} times, others {counts}")
    log(f"[population] fig 9 placement: plan {fig9['boundaries']} on devices "
        f"{fig9['stage_devices']}, trainers {fig9['mean_trainer_dist_to_eave']:.1f} m "
        f"and decoys {fig9['mean_decoy_dist_to_eave']:.1f} m from the nearest "
        f"eavesdropper, leaked {fig9['leaked']:.4f}; ca_attention launches "
        f"{fig9_launches} (B = 1); phase {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return launches, fig9_launches, out["leak"]


# a short SAC run at U = 22 trainer devices and a history of 16 pairs:
# obs_dim 76 and pair_dim 132 (5U + E + 20), the shapes the earlier kernel
# refused; 20 envs so that the warm-up chunk fills a batch of 128
U22_NUM_ENVS = 20
U22_EPISODES = 40
U22_HIST = 16


def phase_sac_u22(torch, card):
    """train_sac on MHSLEnv(NetworkConfig(num_devices=22)) with hist_len
    16 through the ca_attention kernel: one warm-up chunk and one updating
    chunk, the launch count checked against the path's, every output
    finite. Returns the launch count."""
    from dataclasses import replace

    from repro_torch.core.agents import loops as LP
    from repro_torch.core.agents import sac as SAC
    from repro_torch.core.channel import NetworkConfig
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile
    from repro_torch.kernels import ca_attention as CA
    from repro_torch.tree import tree_leaves

    env = MHSLEnv(profile=resnet101_profile(batch=1), net=NetworkConfig(num_devices=22))
    cfg = replace(SAC.SACConfig(), hist_len=U22_HIST)
    _reset_counts()
    t0 = time.perf_counter()
    res = LP.train_sac(env, cfg, episodes=U22_EPISODES, seed=1,
                       warmup_episodes=U22_NUM_ENVS, num_envs=U22_NUM_ENVS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_updates = cfg.updates_per_step * env.episode_len * U22_NUM_ENVS
    expect = n_updates + env.episode_len  # one updating chunk
    if len(res.metrics) != 1:
        raise AssertionError(f"{len(res.metrics)} updating chunks at U 22, expected 1")
    if CA.launches != expect:
        raise AssertionError(f"ca_attention launched {CA.launches} times at U 22, "
                             f"expected {expect}")
    others = {k: v for k, v in _counts().items() if k != "ca_attention"}
    if any(others.values()):
        raise AssertionError(f"the U 22 SAC run launched {others}")
    for leaf in tree_leaves(res.params):
        if not torch.isfinite(leaf).all():
            raise AssertionError("non-finite parameter after the U 22 run")
    _finite_run(res, "U 22 training")
    log(f"[slice] U 22: obs_dim {env.obs_dim}, hist_len {cfg.hist_len}; train_sac "
        f"{U22_EPISODES} episodes x {U22_NUM_ENVS} envs, {n_updates} gradient steps, "
        f"ca_attention launches {CA.launches} (expected {expect}), {secs:.3f} s; last "
        f"update metrics {res.metrics[-1]} [{card}]")
    return CA.launches


# ---------------------------------------------------------------------------
# 4f. the algorithm comparison: baselines, the sequential update,
#     select_action, the fig-3 band
# ---------------------------------------------------------------------------

# fig 4's baselines (DQNConfig(eps_decay_episodes=160 // 2), PPOConfig()),
# a few chunks of 16 envs: DQN updates from its second chunk (a batch of
# 128 needs two chunks of 112 transitions), PPO on every chunk
BASELINE_NUM_ENVS = 16
BASELINE_EPISODES = 64
# the sequential update: one warm-up chunk of 20 envs (140 transitions fill
# a batch of 128) and one updating chunk of 280 gradient steps
SEQ_NUM_ENVS = 20
SEQ_EPISODES = 40


def _device_seconds(torch, run):
    """Device busy seconds and kernel count of ``run()`` (a short training
    run) by torch.profiler: the sum of its kernels' device time."""
    with _traced(torch) as prof:
        run()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    dev_s = sum(e.self_device_time_total for e in kern) / 1e6
    if dev_s == 0:
        raise AssertionError("the profiler saw no device time")
    return dev_s, sum(e.count for e in kern)


def phase_baselines(torch, card):
    """train_dqn and train_ppo at the fig-4 configuration on the card,
    every counter reset just before and read just after (neither reaches a
    kernel); then a 2-chunk run of each under torch.profiler for the
    device time per chunk."""
    from repro_torch.core.agents import dqn as DQ
    from repro_torch.core.agents import ppo as PP
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile

    env = MHSLEnv(profile=resnet101_profile(batch=1))
    runs = {
        "dqn": lambda episodes: DQ.train_dqn(
            env, DQ.DQNConfig(eps_decay_episodes=80), episodes=episodes, seed=3,
            num_envs=BASELINE_NUM_ENVS),
        "ppo": lambda episodes: PP.train_ppo(
            env, PP.PPOConfig(), episodes=episodes, seed=3,
            num_envs=BASELINE_NUM_ENVS),
    }
    for name, run in runs.items():
        _reset_counts()
        res = run(BASELINE_EPISODES)
        torch.cuda.synchronize()
        if any(_counts().values()):
            raise AssertionError(f"train_{name} launched {_counts()}")
        chunks = BASELINE_EPISODES // BASELINE_NUM_ENVS
        want = [name == "ppo" or c > 0 for c in range(chunks)]
        if res.chunk_updated != want or len(res.episode_reward) != BASELINE_EPISODES:
            raise AssertionError(f"train_{name}: chunks updated {res.chunk_updated}, "
                                 f"expected {want}")
        _finite_run(res, f"train_{name}")
        host = [s for s, u in zip(res.chunk_seconds, res.chunk_updated) if u][1:]
        dev_s, n_kern = _device_seconds(torch, lambda: run(2 * BASELINE_NUM_ENVS))
        _reset_counts()
        log(f"[baselines] train_{name}: {BASELINE_EPISODES} episodes x "
            f"{BASELINE_NUM_ENVS} envs, chunks updated {res.chunk_updated}; last "
            f"update {res.metrics[-1]}; host s per updating chunk (after the first) "
            f"{['%.3f' % s for s in host]}, median {statistics.median(host):.3f} s; a profiled "
            f"2-chunk run: {dev_s:.4f} s device busy, {n_kern} kernels "
            f"({dev_s / 2:.4f} s device per chunk) [{card}]")


def phase_sequential(torch, card):
    """train_sac with the sequential three-backward update
    (``joint_update=False``) through one updating chunk, ca_attention's
    launches held to the path's count (one per gradient step: the actor
    loss's forward, and one per rollout step); then a trace of its
    gradient steps. Returns the launch count."""
    from dataclasses import replace

    from repro_torch.core.agents import loops as LP
    from repro_torch.core.agents import sac as SAC
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile
    from repro_torch.kernels import ca_attention as CA

    env = MHSLEnv(profile=resnet101_profile(batch=1))
    cfg = replace(SAC.SACConfig(), joint_update=False)
    _reset_counts()
    t0 = time.perf_counter()
    res = LP.train_sac(env, cfg, episodes=SEQ_EPISODES, seed=2,
                       warmup_episodes=SEQ_NUM_ENVS, num_envs=SEQ_NUM_ENVS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = CA.launches
    n_updates = cfg.updates_per_step * env.episode_len * SEQ_NUM_ENVS
    expect = n_updates + env.episode_len
    if res.chunk_updated != [False, True]:
        raise AssertionError(f"sequential run: chunks updated {res.chunk_updated}")
    if launches != expect:
        raise AssertionError(f"ca_attention launched {launches} times in the "
                             f"sequential run, expected {expect}")
    others = {k: v for k, v in _counts().items() if k != "ca_attention"}
    if any(others.values()):
        raise AssertionError(f"the sequential run launched {others}")
    _finite_run(res, "sequential SAC")
    if set(res.metrics[-1]) != {"critic_loss", "actor_loss", "r_c", "icm_inv_loss",
                                "icm_fwd_loss"}:
        raise AssertionError(f"sequential update metrics {res.metrics[-1]}")
    log(f"[sequential] train_sac(joint_update=False): {SEQ_EPISODES} episodes x "
        f"{SEQ_NUM_ENVS} envs, {n_updates} gradient steps, ca_attention launches "
        f"{launches} (expected {expect}); chunk seconds "
        f"{['%.3f' % s for s in res.chunk_seconds]} (updating {res.chunk_seconds[1]:.3f} s, "
        f"{res.chunk_seconds[1] / n_updates * 1e3:.2f} ms per gradient step), "
        f"{secs:.3f} s in all; last update {res.metrics[-1]} [{card}]")
    phase_trace(torch, card, env, cfg, res.params, steps=10, label=" sequential")
    return launches


def phase_select_action(torch, card, env, cfg, params):
    """A 7-step single-env plan rollout through ``select_action`` (the
    actor at B = 1 through the ca_attention kernel), its launches counted;
    then, launches not counted, the kernel at each step's B = 1 inputs
    against its plain version, and each action against the plain route's
    (the plain version's s', the same heads, the same Gumbel draws).
    Returns (launches, max abs error)."""
    from repro_torch.core.agents import action_space as A
    from repro_torch.core.agents import sac as SAC
    from repro_torch.kernels import ca_attention as CA

    dims, dev = env.action_dims, env.device
    gen = torch.Generator(device=dev).manual_seed(11)
    st = env.reset(env.sample_positions(gen, 1))
    pair_dim = env.obs_dim + A.flat_dim(dims)
    hist = torch.zeros((cfg.hist_len, pair_dim), device=dev)
    hmask = torch.zeros((cfg.hist_len,), device=dev)
    steps = []
    _reset_counts()
    for _ in range(env.episode_len):
        obs = env.observe(st)[0]
        masks = {k: v[0] for k, v in env.action_masks(st).items()}
        g = A.gumbel(A.head_shapes(dims), gen, dev)
        a = SAC.select_action(params, g, obs, hist, hmask, masks, dims, cfg)
        steps.append((obs, hist, hmask, masks, g, a))
        st, _, _, info = env.step(st, {k: v[None] for k, v in a.items()},
                                  env.draw(gen, 1))
        pair = torch.cat([obs, A.onehot(a, dims)])
        hist = torch.cat([hist[1:], pair[None]])
        hmask = torch.cat([hmask[1:], torch.ones_like(hmask[:1])])
    torch.cuda.synchronize()
    counts = _counts()
    launches = counts.pop("ca_attention")
    if launches != env.episode_len or any(counts.values()):
        raise AssertionError(f"select_action rollout launched ca_attention "
                             f"{launches} times (expected {env.episode_len}), "
                             f"others {counts}")
    saved = _counts()
    worst = 0.0
    ca = params["actor"]["ca"]
    with torch.no_grad():
        for t, (obs, hist, hmask, masks, g, a) in enumerate(steps):
            one = (obs[None], hist[None], hmask[None])
            x = CA.ca_attention(ca, *one)
            ref = CA.ca_attention_ref(*one, ca["wq_s"], ca["wk"], ca["wv"])
            worst = max(worst, float((x - ref).abs().max()))
            logits = SAC._head_logits(params, ref, {k: v[None] for k, v in masks.items()},
                                      dims)
            plain = A.sample(logits, {k: v[None] for k, v in g.items()})
            for h in A.HEADS:
                if not torch.equal(plain[h][0], a[h]):
                    raise AssertionError(f"select_action step {t} head {h}: kernel "
                                         f"route {a[h].tolist()}, plain route "
                                         f"{plain[h][0].tolist()}")
    _reset_counts(saved)
    if worst > CA_FWD_ATOL["float32"]:
        raise AssertionError(f"ca_attention at B = 1: max|err| {worst:.3e}")
    plan = (tuple(int(b) for b in st.boundaries[0].tolist()),
            tuple(int(d) for d in st.stage_dev[0].tolist()))
    log(f"[select_action] 7-step single-env plan rollout: ca_attention launches "
        f"{launches} (B = 1), kernel vs plain max|err| {worst:.3e} (atol "
        f"{CA_FWD_ATOL['float32']:.0e}), actions equal to the plain route's under "
        f"the same Gumbel draws; plan boundaries {plan[0]}, devices {plan[1]}, "
        f"leaked {float(st.leaked[0]):.4f}")
    return launches, worst


def band_config():
    """The configuration the band phase trains (``band.CARD_BAND``);
    ``tests/data/torch_band_reference.json`` must hold it."""
    from repro_torch.figures import band as B

    return B.CARD_BAND


def phase_band(torch, card):
    """The fig-3 band on the card: every arm of the card band (ICM-CA, no
    ICM, no CA, neither, PPO, DQN) trained on the port on the band's first
    ``CARD_TORCH_SEEDS`` seeds, held per metric to the JAX runs of
    ``tests/data/torch_band_reference.json`` by ``band.compare``; the
    counters reset before and read after each arm (the CA arms launch
    ca_attention once per rollout and gradient step). Then the negative
    control (ICM-CA never leaving warmup) must fall outside the ICM-CA
    band. Any arm outside its band fails the phase, after all are logged."""
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile
    from repro_torch.figures import band as B

    cfg = band_config()
    ref = B.load_reference(ROOT / "tests" / "data" / "torch_band_reference.json")["card"]
    if ref["config"] != json.loads(json.dumps(cfg)):
        raise AssertionError("torch_band_reference.json was made at another "
                             "configuration than band.CARD_BAND")
    env = MHSLEnv(profile=resnet101_profile(batch=1))
    seeds = cfg["seeds"][:B.CARD_TORCH_SEEDS]
    chunks = math.ceil(cfg["episodes"] / cfg["num_envs"])
    upd_chunks = sum(1 for c in range(chunks) if c * cfg["num_envs"] >= cfg["warmup"])
    per_run = upd_chunks * (2 * env.episode_len * cfg["num_envs"] + env.episode_len)
    log(f"[band] card band: {cfg['episodes']} episodes x {cfg['num_envs']} envs, "
        f"warmup {cfg['warmup']}, last {cfg['last_k']} episodes; torch seeds "
        f"{seeds} against {len(ref['arms']['icm_ca'])} JAX seeds; rule |mean_t - "
        f"mean_j| <= {B.K_SIGMA} s sqrt(1/n_j + 1/n_t) + {B.FLOOR} |mean_j| [{card}]")
    outside = []
    summary = {}
    for arm in cfg["arms"]:
        _reset_counts()
        t0 = time.perf_counter()
        rows = [B.run_metrics(B.run_arm(env, arm, cfg, s), cfg["last_k"]) for s in seeds]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
        want_ca = per_run * len(seeds) if B.SAC_ARMS.get(arm, {}).get("use_ca") else 0
        if counts.pop("ca_attention") != want_ca or any(counts.values()):
            raise AssertionError(f"band arm {arm} launched {_counts()}, expected "
                                 f"ca_attention {want_ca}")
        res = B.compare(ref["arms"][arm], rows)
        summary[arm] = dict(seconds=secs, runs=rows, **res)
        if not B.inside(res):
            outside.append(arm)
        log(f"[band] {arm}: {'inside' if B.inside(res) else 'OUTSIDE'}; " + "; ".join(
            f"{m} torch {r['torch_mean']:.4f}+-{r['torch_std']:.4f} jax "
            f"{r['jax_mean']:.4f}+-{r['jax_std']:.4f} |d| {r['distance']:.4f} "
            f"margin {r['margin']:.4f}" for m, r in res.items())
            + f"; {secs:.1f} s for {len(seeds)} runs, ca_attention {want_ca} [{card}]")
    _reset_counts()
    rows = [B.run_metrics(B.run_arm(env, "icm_ca", cfg, s, warmup=cfg["episodes"]),
                          cfg["last_k"]) for s in seeds]
    ctrl = B.compare(ref["arms"]["icm_ca"], rows)
    summary["control"] = dict(runs=rows, **ctrl)
    log("[band] negative control (ICM-CA, uniform policy throughout) vs the ICM-CA "
        f"band: {'inside' if B.inside(ctrl) else 'outside'}; " + "; ".join(
            f"{m} |d| {r['distance']:.4f} margin {r['margin']:.4f} "
            f"({r['distance'] / r['margin']:.2f}x)" for m, r in ctrl.items()))
    out = ROOT / "chiprun_out"
    if out.is_dir():
        (out / "band.json").write_text(json.dumps(summary, indent=1))
    if outside:
        raise AssertionError(f"arms outside the band: {outside}")
    if B.inside(ctrl):
        raise AssertionError("the negative control is inside the ICM-CA band")


# ---------------------------------------------------------------------------
# 4g. population training and checkpoints
# ---------------------------------------------------------------------------

# fig 8's stack (know_eave_locations 1, 0) at full width: 2 chunks of 16
# envs, the second updating
POP_TRAIN_NUM_ENVS = 16
POP_TRAIN_EPISODES = 32
POP_TRAIN_WARMUP = 16
# fig 6's padded env (num_eaves 4): obs 30, pair 54, I 4; B 16 in the
# rollout of 16 envs, B 128 in the update
FIG6_CA_WIDTHS = (30, 54, 64)
FIG6_CA_BATCHES = (16, 128)


def _host_chunk_s(res):
    """The median host seconds of a run's updating chunks."""
    return statistics.median(s for s, u in zip(res.chunk_seconds, res.chunk_updated) if u)


def phase_population_train(torch, card):
    """fig 8's two-scenario ICM-CA population at full width for 2 chunks of
    16 envs, beside ``train_sac`` at the same episodes, envs and config,
    the counters reset before and read after each: the population launches
    ca_attention exactly twice as often (its scenarios run in turn), host
    seconds per chunk of both; every curve and parameter finite. Then the
    kernel against its plain version at fig 6's shapes (obs 30, pair 54,
    I 4, B 16 and 128), and the save / restore seconds and archive bytes
    of the population's whole training state. Returns (launches, worst
    f32 error at fig 6's shapes, checkpoint numbers)."""
    from repro_torch.core import scenario as SC
    from repro_torch.core.agents import action_space as A
    from repro_torch.core.agents import loops as LP
    from repro_torch.core.agents import sac as SAC
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile
    from repro_torch.figures import band as B
    from repro_torch.kernels import ca_attention as CA
    from repro_torch.tree import tree_leaves

    env = MHSLEnv(profile=resnet101_profile(batch=1))
    cfg = SAC.SACConfig()
    scens = B.pop_scenarios(env, B.POP_CARD_BAND)  # fig 8's stack
    kw = dict(episodes=POP_TRAIN_EPISODES, seed=0, warmup_episodes=POP_TRAIN_WARMUP,
              num_envs=POP_TRAIN_NUM_ENVS)
    _reset_counts()
    t0 = time.perf_counter()
    res = LP.train_sac(env, cfg, **kw)
    torch.cuda.synchronize()
    sac_s = time.perf_counter() - t0
    sac_counts = _counts()
    _reset_counts()
    t0 = time.perf_counter()
    pop = SC.train_population(env, cfg, scens, **kw)
    torch.cuda.synchronize()
    pop_s = time.perf_counter() - t0
    counts = _counts()
    launches = counts.pop("ca_attention")
    per_run = env.episode_len + cfg.updates_per_step * env.episode_len * POP_TRAIN_NUM_ENVS
    if (launches != 2 * sac_counts["ca_attention"] or launches != 2 * per_run
            or any(counts.values())):
        raise AssertionError(f"the population launched ca_attention {launches} times "
                             f"(train_sac {sac_counts['ca_attention']}, expected 2 x "
                             f"{per_run}), others {counts}")
    for r in pop.results:
        if len(r.episode_reward) != POP_TRAIN_EPISODES or len(r.metrics) != 1:
            raise AssertionError("population curve lengths")
        _finite_run(r, "population")
    for leaf in tree_leaves(pop.params):
        if leaf.shape[0] != 2 or leaf.device.type != "cuda" or not torch.isfinite(leaf).all():
            raise AssertionError("population params")
    pop_chunk, sac_chunk = _host_chunk_s(pop.results[0]), _host_chunk_s(res)
    log(f"[population] train_population (fig 8's stack, SACConfig()) {POP_TRAIN_EPISODES} "
        f"episodes x {POP_TRAIN_NUM_ENVS} envs: ca_attention launches {launches} = 2 x "
        f"train_sac's {sac_counts['ca_attention']}; host s per chunk "
        f"{['%.3f' % x for x in pop.results[0].chunk_seconds]} vs train_sac "
        f"{['%.3f' % x for x in res.chunk_seconds]}: updating chunk {pop_chunk:.3f} s vs "
        f"{sac_chunk:.3f} s ({pop_chunk / sac_chunk:.2f}x); runs {pop_s:.3f} / {sac_s:.3f} s; "
        f"last rewards {[round(r.episode_reward[-1], 3) for r in pop.results]} [{card}]")

    env6 = B.pop_env(B.POP_CPU_BAND)
    obs_dim, pair_dim, c = FIG6_CA_WIDTHS
    if (env6.obs_dim, env6.obs_dim + A.flat_dim(env6.action_dims)) != (obs_dim, pair_dim):
        raise AssertionError(f"fig 6's env: obs {env6.obs_dim}")
    worst = max(_ca_check_case(torch, CA, b, 4, obs_dim, pair_dim, c)
                for b in FIG6_CA_BATCHES)
    return launches, worst, _checkpoint_cost(torch, card, env, cfg, pop)


def _checkpoint_cost(torch, card, env, cfg, pop):
    """Save and restore seconds and archive bytes of a two-scenario
    population's training state at ``cfg`` (the trained params, fresh
    AdamW states, two full replay buffers, the generators), as
    ``train_population`` saves it."""
    import shutil

    from repro_torch.checkpoint import train_state as TS
    from repro_torch.core.agents import loops as LP
    from repro_torch.core.agents import rollout as R
    from repro_torch.core.agents import sac as SAC
    from repro_torch.tree import tree_index, tree_leaves, tree_stack

    _, init_opt = SAC.make_update(env.action_dims, cfg)
    state = dict(
        params=pop.params,
        opt_state=tree_stack([init_opt(tree_index(pop.params, s)) for s in range(2)]),
        buf=tree_stack([R.buffer_init(cfg.buffer_size, LP.sac_example(env, cfg)).data
                        for _ in range(2)]),
        run_gen=TS.generator_leaf(torch.Generator()),
        replay_gens=torch.stack([TS.generator_leaf(torch.Generator(device="cuda"))
                                 for _ in range(2)]))
    d = ROOT / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = TS.save_train_checkpoint(str(d), 0, state, {"ep": 0})
    save_s = time.perf_counter() - t0
    size = Path(path).stat().st_size
    t0 = time.perf_counter()
    _, back, _ = TS.load_train_checkpoint(str(d), state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(state))):
        raise AssertionError("checkpoint round trip differs")
    shutil.rmtree(d, ignore_errors=True)
    log(f"[checkpoint] a two-scenario population's state (buffer_size {cfg.buffer_size}): "
        f"{size} bytes, save {save_s:.3f} s, restore {load_s:.3f} s [{card}]")
    return dict(bytes=size, save_s=save_s, load_s=load_s)


# stop/resume: 4 chunks of 2 envs at full width with a batch of 16 and one
# update per env step (chunks 2-4 update), stopped after chunk 2
RESUME_CFG = dict(batch=16, buffer_size=2000, updates_per_step=1)
RESUME_KW = dict(seed=3, warmup_episodes=2, num_envs=2)
RESUME_EPISODES = 8
RESUME_STOP = 4


def _run_diff(a, b):
    """Largest difference between two runs' curves and final params
    (a ``TrainResult`` or a ``PopulationResult`` each)."""
    from repro_torch.tree import tree_leaves

    ra = getattr(a, "results", [a])
    rb = getattr(b, "results", [b])
    worst = 0.0
    for x, y in zip(ra, rb):
        for k in ("episode_reward", "episode_leak", "episode_violation",
                  "states_explored"):
            u, v = getattr(x, k), getattr(y, k)
            if len(u) != len(v):
                return math.inf
            worst = max([worst] + [abs(p - q) for p, q in zip(u, v)])
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        worst = max(worst, float((p - q).abs().max()))
    return worst


def phase_resume(torch, card):
    """``train_sac`` and fig 8's two-scenario ``train_population`` on the
    card for 4 chunks, twice, then stopped after 2 chunks (a checkpoint)
    and resumed to 4. The two uninterrupted runs must be bit-identical;
    the resumed run must then be bit-identical to them too (where two
    reruns differ, the resume is held to their difference, never more).
    Returns {run: (rerun difference, resume difference)}."""
    import shutil

    from repro_torch.checkpoint import train_state as TS
    from repro_torch.core import scenario as SC
    from repro_torch.core.agents import loops as LP
    from repro_torch.core.agents import sac as SAC
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile
    from repro_torch.figures import band as B

    env = MHSLEnv(profile=resnet101_profile(batch=1))
    cfg = SAC.SACConfig(**RESUME_CFG)
    scens = B.pop_scenarios(env, B.POP_CARD_BAND)  # fig 8's stack
    base = ROOT / "build" / "chip_smoke_resume"
    shutil.rmtree(base, ignore_errors=True)
    runs = {
        "train_sac": lambda **k: LP.train_sac(env, cfg, **RESUME_KW, **k),
        "train_population": lambda **k: SC.train_population(env, cfg, scens,
                                                            **RESUME_KW, **k),
    }
    out = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        a = run(episodes=RESUME_EPISODES)
        b = run(episodes=RESUME_EPISODES)
        ck = str(base / name)
        run(episodes=RESUME_STOP, checkpoint_dir=ck, checkpoint_every=RESUME_STOP)
        if TS.latest_checkpoint_step(ck) != RESUME_STOP:
            raise AssertionError(f"{name}: no checkpoint at episode {RESUME_STOP}")
        c = run(episodes=RESUME_EPISODES, checkpoint_dir=ck,
                checkpoint_every=RESUME_STOP)
        torch.cuda.synchronize()
        rerun, resumed = _run_diff(a, b), _run_diff(a, c)
        out[name] = (rerun, resumed)
        log(f"[resume] {name}: {RESUME_EPISODES} episodes x {RESUME_KW['num_envs']} envs, "
            f"stopped at {RESUME_STOP} and resumed: rerun max|diff| {rerun:.3e}, resumed "
            f"vs uninterrupted {resumed:.3e} "
            f"({'bit-identical' if resumed == 0 else 'NOT bit-identical'}); "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        if resumed > rerun:
            raise AssertionError(f"{name}: the resumed run differs by {resumed}, two "
                                 f"uninterrupted runs by {rerun}")
    shutil.rmtree(base, ignore_errors=True)
    return out


def pop_band_config():
    """The configuration the population band phase trains
    (``band.POP_CARD_BAND``); ``tests/data/torch_population_reference.json``
    must hold it."""
    from repro_torch.figures import band as B

    return B.POP_CARD_BAND


def phase_population_band(torch, card):
    """The population band on the card: fig 8's two-scenario ICM-CA
    population (``band.POP_CARD_BAND``) trained on the port on the band's
    first ``POP_CARD_TORCH_SEEDS`` seeds, every metric (per scenario
    reward, leak, states; the paired reward difference) held to the JAX
    ``train_population`` runs of ``tests/data/torch_population_reference.json``
    by ``band.compare``; the counters reset before and read after. The
    negative control (never leaving warmup) must fall outside."""
    from repro_torch.figures import band as B

    cfg = pop_band_config()
    ref = B.load_reference(ROOT / "tests" / "data" / "torch_population_reference.json")["card"]
    if ref["config"] != json.loads(json.dumps(cfg)):
        raise AssertionError("torch_population_reference.json was made at another "
                             "configuration than band.POP_CARD_BAND")
    env = B.pop_env(cfg)
    names = B.pop_metric_names(cfg)
    seeds = cfg["seeds"][:B.POP_CARD_TORCH_SEEDS]
    chunks = math.ceil(cfg["episodes"] / cfg["num_envs"])
    upd_chunks = sum(1 for c in range(chunks) if c * cfg["num_envs"] >= cfg["warmup"])
    per_run = 2 * upd_chunks * (2 * env.episode_len * cfg["num_envs"] + env.episode_len)
    _reset_counts()
    t0 = time.perf_counter()
    rows = [B.pop_metrics(B.run_population(env, cfg, s), cfg["last_k"]) for s in seeds]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    if counts.pop("ca_attention") != per_run * len(seeds) or any(counts.values()):
        raise AssertionError(f"the population band launched {_counts()}, expected "
                             f"ca_attention {per_run * len(seeds)}")
    res = B.compare(ref["runs"], rows, names)
    log(f"[pop band] fig 8's population x {len(seeds)} torch seeds vs "
        f"{len(ref['runs'])} JAX seeds: {'inside' if B.inside(res) else 'OUTSIDE'}; "
        + "; ".join(f"{m} torch {r['torch_mean']:.4f}+-{r['torch_std']:.4f} jax "
                    f"{r['jax_mean']:.4f}+-{r['jax_std']:.4f} |d| {r['distance']:.4f} "
                    f"margin {r['margin']:.4f}" for m, r in res.items())
        + f"; {secs:.1f} s, ca_attention {per_run * len(seeds)} [{card}]")
    ctrl_rows = [B.pop_metrics(B.run_population(env, cfg, s, warmup=cfg["episodes"]),
                               cfg["last_k"]) for s in seeds]
    ctrl = B.compare(ref["runs"], ctrl_rows, names)
    log("[pop band] negative control (never leaving warmup): "
        f"{'inside' if B.inside(ctrl) else 'outside'}; " + "; ".join(
            f"{m} |d| {r['distance']:.4f} margin {r['margin']:.4f} "
            f"({r['distance'] / r['margin']:.2f}x)" for m, r in ctrl.items()))
    if not B.inside(res):
        raise AssertionError("the population is outside its band")
    if B.inside(ctrl):
        raise AssertionError("the negative control is inside the population band")
    return res


# ---------------------------------------------------------------------------
# 4i. the attacker population, EmpiricalLeakage and the chaos harness
# ---------------------------------------------------------------------------

# (T2) the attacker population at published widths: StableLM-2-1.6B at full
# depth, one attacker per (cut 1..23, q), fig 10's two capture scenarios
ATTACK_LM = "stablelm-1.6b"
ATTACK_LM_STEPS = 600
# scorer on live activations vs a per-attacker loop of attack_scores
ATTACK_SCORER_ATOL = 1e-5
# (K2) the chaos harness as a subprocess: tests/test_chaos.py's arguments
CHAOS_ARGV = ["--device", "cuda", "--seeds", "0", "--episodes", "8", "--warmup",
              "4", "--num-envs", "2", "--checkpoint-every", "2", "--kill-after", "2"]
CHAOS_TIMEOUT_S = 300


def attack_band_config():
    """The configuration the attack band phase trains
    (``fig10_leakage_attack.BAND``); ``tests/data/torch_attack_reference.json``
    must hold it."""
    from repro_torch.figures import fig10_leakage_attack as FIG10

    return FIG10.BAND


def _mse_falls(q):
    """The reference's fig-10 gate on the training MSE's step quarters:
    at least two quarter-on-quarter drops and the last below the first."""
    return sum(b < a for a, b in zip(q, q[1:])) >= 2 and q[-1] < q[0]


def _score_rows(tables, cuts, qs):
    return [{f"cut{c}_q{q}": float(t[k][s]) for k, c in enumerate(cuts)
             for s, q in enumerate(qs)} for t in tables]


def phase_attack_band(torch, card):
    """(T1) fig 10 at the reference's probe (depth 8, cuts 1-7, q 0.3 and
    0.8: 14 attackers, 600 steps) through its driver: the MSE gate; the
    torch ops a training step dispatches equal at populations 1 and 14;
    CUDA kernels per step from ``torch.profiler`` at populations 1, 2 and
    14, equal at 2 and 14 (at 1 cuBLAS takes its unbatched GEMMs); no
    hand-written kernel launched. Then the band: every (cut, q) mean
    held-out score of ``TORCH_SEEDS`` seeds (one stacked population of
    16 x 14 attackers, each seed's draws its own) held to the JAX runs of
    ``tests/data/torch_attack_reference.json`` by ``band.compare``, and the
    same population at ``control_steps`` outside in at least one cell.
    Returns (ops per step, CUDA kernels per step at 14)."""
    import numpy as np

    from repro_torch.attack import AttackConfig, tiny_attack_model_cfg
    from repro_torch.attack.population import (count_ops_per_step,
                                               profile_kernel_names)
    from repro_torch.figures import band as B
    from repro_torch.figures import fig10_leakage_attack as FIG10

    cfg = attack_band_config()
    ref = B.load_reference(ROOT / "tests" / "data" / "torch_attack_reference.json")
    if ref["config"] != json.loads(json.dumps(cfg)):
        raise AssertionError("torch_attack_reference.json was made at another "
                             "configuration than fig10_leakage_attack.BAND")
    mcfg = tiny_attack_model_cfg(depth=FIG10.DEPTH)
    n = len(cfg["cuts"]) * len(cfg["qs"])
    _reset_counts()
    t0 = time.perf_counter()
    fig = FIG10.main(seed=0, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"the attacker population launched {counts}")
    scores = np.asarray(fig["scores"])
    if not (np.isfinite(scores).all() and (scores >= 0).all() and (scores <= 1).all()):
        raise AssertionError(f"fig 10 scores {scores.tolist()}")
    q = fig["mse_quarters"]
    if not _mse_falls(q):
        raise AssertionError(f"fig 10: the high-capture MSE does not fall: {q}")
    acfg = AttackConfig(d_data=mcfg.d_model, d_smash=mcfg.d_model)
    ops1, ops_n = count_ops_per_step(acfg, 1), fig["ops_per_step"]
    names = {m: profile_kernel_names(acfg, m) for m in (1, 2, n)}
    k1, k2, kn = (sum(names[m].values()) / 10 for m in (1, 2, n))
    out_dir = ROOT / "chiprun_out"
    if out_dir.is_dir():
        (out_dir / "t1_names.json").write_text(json.dumps(
            {str(m): v for m, v in names.items()}, indent=1))
    moved = {k[:100]: (names[2].get(k, 0), names[n].get(k, 0))
             for k in set(names[2]) | set(names[n]) if names[2].get(k) != names[n].get(k)}
    log(f"[attack T1] CUDA events per 10-step chunk by name: {len(names[2])} names at "
        f"2, {len(names[n])} at {n}; fig 10's own count {fig['kernels_per_step']:.1f} "
        f"a step; names whose counts differ between 2 and {n}: {moved}")
    if ops1 != ops_n or k2 != kn:
        raise AssertionError(f"per step: ops {ops1} at population 1, {ops_n} at {n}; "
                             f"CUDA kernels {k2} at 2, {kn} at {n}")
    log(f"[attack T1] fig 10 (depth {FIG10.DEPTH}, d {mcfg.d_model}, {n} attackers x "
        f"{fig['steps']} steps): pools {fig['pool_seconds']:.3f} s, training "
        f"{fig['train_seconds']:.3f} s, {fig['attacker_steps_per_s']:.1f} "
        f"attacker-steps/s; driver {secs:.1f} s; MSE quarters "
        f"{[round(x, 4) for x in q]}; per training step: torch ops {ops1:.1f} at "
        f"population 1 and {ops_n:.1f} at {n}; CUDA kernels {k1:.1f} at 1 (cuBLAS's "
        f"unbatched GEMMs), {k2:.1f} at 2 and {kn:.1f} at {n}; hand-written kernels "
        f"launched {counts} [{card}]")
    log(f"[attack T1] scores (cut x q {cfg['qs']}): "
        f"{[[round(x, 4) for x in row] for row in scores.tolist()]} [{card}]")

    names = tuple(_score_rows([scores], cfg["cuts"], cfg["qs"])[0])
    ref_rows = _score_rows([r["scores"] for r in ref["runs"]], cfg["cuts"], cfg["qs"])
    seeds = cfg["seeds"][:FIG10.TORCH_SEEDS]
    t0 = time.perf_counter()
    rows = _score_rows(FIG10.band_scores(seeds, cfg["steps"], "cuda"),
                       cfg["cuts"], cfg["qs"])
    band_s = time.perf_counter() - t0
    res = B.compare(ref_rows, rows, names)
    t0 = time.perf_counter()
    ctrl_rows = _score_rows(FIG10.band_scores(seeds, cfg["control_steps"], "cuda"),
                            cfg["cuts"], cfg["qs"])
    ctrl_s = time.perf_counter() - t0
    ctrl = B.compare(ref_rows, ctrl_rows, names)
    log(f"[attack band] {len(seeds)} torch seeds vs {len(ref_rows)} JAX seeds at "
        f"{cfg['steps']} steps: {'inside' if B.inside(res) else 'OUTSIDE'}; " + "; ".join(
            f"{m} torch {r['torch_mean']:.4f}+-{r['torch_std']:.4f} jax "
            f"{r['jax_mean']:.4f}+-{r['jax_std']:.4f} |d| {r['distance']:.4f} margin "
            f"{r['margin']:.4f}" for m, r in res.items())
        + f"; {band_s:.1f} s [{card}]")
    out = [m for m, r in ctrl.items() if not r["inside"]]
    log(f"[attack band] control ({cfg['control_steps']} steps): outside in {len(out)} "
        f"of {len(ctrl)} cells {out}; " + "; ".join(
            f"{m} |d| {r['distance']:.4f} margin {r['margin']:.4f}"
            for m, r in ctrl.items()) + f"; {ctrl_s:.1f} s [{card}]")
    if not B.inside(res):
        raise AssertionError("the attacker population is outside its band: "
                             f"{[m for m, r in res.items() if not r['inside']]}")
    if B.inside(ctrl):
        raise AssertionError("the 60-step control is inside the attack band")
    return ops1, kn


def phase_attack_lm(torch, card, small):
    """(T2) the attacker population at published widths: StableLM-2-1.6B
    at full depth (24 layers, d 2048), one attacker per (cut 1..23, q 0.3
    and 0.8), 46 attackers x 600 steps on 32 x 64 train and 8 x 64
    held-out tokens. Gates: finite scores in [0, 1], the high-capture MSE
    falls; the torch ops per step equal T1's (``small``: T1's ops and
    CUDA kernels per step; the kernels are logged beside them, cuBLAS
    choosing other GEMMs at d 2048); the trained high-capture column
    scored through ``make_activation_scorer`` on the held-out activations
    against a per-attacker loop of ``attack_scores``."""
    import numpy as np

    from repro_torch.attack import (AttackConfig, attack_scores, capture_weight,
                                    make_activation_scorer,
                                    train_attacker_population)
    from repro_torch.attack.population import (count_ops_per_step,
                                               profile_kernels_per_step)
    from repro_torch.configs import get_config
    from repro_torch.figures import fig10_leakage_attack as FIG10
    from repro_torch.tree import tree_index, tree_map

    mcfg = get_config(ATTACK_LM)
    cuts = list(range(1, mcfg.num_layers))
    qs = FIG10.QS
    cw = [capture_weight(q) for q in qs]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = train_attacker_population(mcfg, cuts=cuts, capture_weights=cw,
                                    steps=ATTACK_LM_STEPS, seed=0, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"the attacker population launched {counts}")
    scores = res.scores
    if not (np.isfinite(scores).all() and (scores >= 0).all() and (scores <= 1).all()):
        raise AssertionError(f"T2 scores {scores.tolist()}")
    hi = int(np.argmax(cw))
    q = res.recon_mse[:, hi, :].mean(axis=0).reshape(4, -1).mean(axis=1).tolist()
    if not _mse_falls(q):
        raise AssertionError(f"T2: the high-capture MSE does not fall: {q}")
    acfg = AttackConfig(d_data=mcfg.d_model, d_smash=mcfg.d_model)
    ops = count_ops_per_step(acfg, res.population)
    kps = profile_kernels_per_step(acfg, res.population)
    if ops != small[0]:
        raise AssertionError(f"T2 ops per step {ops}, T1's {small[0]}")
    col = tree_map(lambda a: a[hi::len(qs)], res.params)
    z, x = res.held_out["z"], res.held_out["x"]
    live = make_activation_scorer(col)({"z": z, "x": x.expand(len(cuts), *x.shape)})
    with torch.no_grad():
        loop = torch.stack([attack_scores(tree_index(col, k), z[k], x)[0]
                            for k in range(len(cuts))])
    err = float((live - loop).abs().max())
    err_table = float(np.abs(live.cpu().numpy() - scores[:, hi]).max())
    if err > ATTACK_SCORER_ATOL or err_table > ATTACK_SCORER_ATOL:
        raise AssertionError(f"T2 scorer vs loop {err}, vs the table {err_table}")
    log(f"[attack T2] {mcfg.name} at published widths, full depth ({mcfg.num_layers} "
        f"layers, d {mcfg.d_model}): {res.population} attackers (cuts 1-{cuts[-1]} x q "
        f"{list(qs)}) x {res.steps} steps; pools {res.pool_seconds:.3f} s, training "
        f"{res.seconds:.3f} s, {res.population * res.steps / res.seconds:.1f} "
        f"attacker-steps/s, whole call {total:.1f} s; per step torch ops {ops:.1f} "
        f"(T1: {small[0]:.1f}), CUDA kernels {kps:.1f} (T1: {small[1]:.1f}); peak "
        f"memory {peak / 2**30:.2f} GiB; MSE "
        f"quarters {[round(x, 4) for x in q]} [{card}]")
    log(f"[attack T2] scores (cut x q {list(qs)}): "
        f"{[[round(x, 4) for x in row] for row in scores.tolist()]} [{card}]")
    log(f"[attack T2] make_activation_scorer on the held-out activations (q "
        f"{qs[hi]} column) vs a loop of attack_scores: max|diff| {err:.3e}, vs the "
        f"trained table {err_table:.3e} (limit {ATTACK_SCORER_ATOL:g}) [{card}]")
    del res, col, live, z, x
    torch.cuda.empty_cache()
    return kps


def phase_empirical_env(torch, card, params, cfg):
    """(T3) ``EmpiricalLeakage`` in the env: ``train_empirical_model(steps=
    120)`` on the card, ``MHSLEnv(resnet101_profile(batch=1),
    leakage_model=...)`` whose reward table must equal the model's
    ``layer_values``, and fig 5's q sweep (``evaluate_population``) of the
    SAC slice's agent under it, ``ca_attention`` launches counted.
    Returns the launches."""
    import numpy as np

    from repro_torch.attack import train_empirical_model
    from repro_torch.core import scenario as SC
    from repro_torch.core.agents import rollout as R
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import profile_table, resnet101_profile

    t0 = time.perf_counter()
    emp = train_empirical_model(steps=120, device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    prof = resnet101_profile(batch=1)
    env = MHSLEnv(profile=prof, leakage_model=emp)
    want = emp.layer_values(profile_table(prof).leak_norm)
    table = env._consts[2].cpu().numpy()
    if not np.array_equal(table, want):
        raise AssertionError("the env's reward table is not the model's layer_values")
    scenarios = SC.stack_scenarios(SC.scenario_grid(env.scenario(),
                                                    monitor_prob=list(POP_QS)))
    _reset_counts()
    t0 = time.perf_counter()
    out = SC.evaluate_population(env, R.sac_policy(env.action_dims, cfg), params,
                                 scenarios, episodes=EVAL_EPISODES,
                                 hist_len=cfg.hist_len)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    launches = counts.pop("ca_attention")
    expect = len(POP_QS) * env.episode_len
    if launches != expect or any(counts.values()):
        raise AssertionError(f"the empirical q sweep launched ca_attention {launches} "
                             f"(expected {expect}), others {counts}")
    for k, v in out.items():
        if v.shape != (len(POP_QS),) or not np.isfinite(v).all():
            raise AssertionError(f"empirical q sweep {k}: {v}")
    if not np.all(np.diff(out["leak"]) >= 0.0):
        raise AssertionError(f"leak falls as q rises: {out['leak'].tolist()}")
    log(f"[attack T3] train_empirical_model(steps=120): {fit_s:.1f} s; measured scores "
        f"{[round(float(x), 4) for x in emp.scores]} at depths "
        f"{[round(float(x), 3) for x in emp.depths]}; the env's table = layer_values "
        f"({len(table)} layers); q sweep {list(POP_QS)}: leak "
        f"{[round(float(x), 6) for x in out['leak']]}; ca_attention launches "
        f"{launches} (expected {expect}); {secs:.3f} s [{card}]")
    return launches


def phase_chaos(torch, card):
    """(K2) the kill-and-resume harness on the card as a subprocess:
    ``python -m repro_torch.launch.chaos`` with ``CHAOS_ARGV``; exit 0 =
    the resumed run bit-identical to the uninterrupted one. Returns the
    ``ca_attention`` launches of the resumed child and of the reference
    run."""
    import os
    import re

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC)] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.chaos"]
                          + CHAOS_ARGV, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=CHAOS_TIMEOUT_S)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith(("[chaos]", "  ")):
            log(f"[chaos K2] {line.strip()}")
    if proc.returncode != 0:
        raise AssertionError(f"the chaos harness exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    killed = re.search(r"kill landed before the child finished: (\w+)", proc.stdout)
    child = re.search(r"resumed child's kernel launches (\{.*\})", proc.stdout)
    ref = re.search(r"reference kernel launches (\{.*\})", proc.stdout)
    if not (killed and child and ref):
        raise AssertionError(f"the chaos harness printed no launch counts:\n{proc.stdout}")
    child, ref = json.loads(child.group(1)), json.loads(ref.group(1))
    if not ref["ca_attention"] or any(v for k, v in ref.items() if k != "ca_attention"):
        raise AssertionError(f"the chaos reference run launched {ref}")
    log(f"[chaos K2] {' '.join(CHAOS_ARGV)}: exit 0 (resumed run bit-identical); "
        f"{secs:.1f} s wall; kill landed before the child finished: "
        f"{killed.group(1)}; ca_attention launches: resumed child "
        f"{child['ca_attention']}, uninterrupted reference {ref['ca_attention']} "
        f"[{card}]")
    return child["ca_attention"] + ref["ca_attention"]


# ---------------------------------------------------------------------------
# 4j. meshes: population and stage meshes over torch.distributed ranks
# ---------------------------------------------------------------------------

# (M1) one rank over NCCL: SACConfig() on the ResNet-101 env, 3 chunks of
# 8 envs, the last updating (its 128-row batch needs 3 chunks' 168
# transitions); fig 5's q ends as a 2-scenario population; a 1-stage step
# of Qwen2.5-3B at published widths, depth 2
MESH_M1 = dict(sac_kw=dict(episodes=24, warmup_episodes=8, seed=5, num_envs=8),
               qs=[0.3, 0.8], depth=2)
# (M2) two gloo ranks sharing the card: full widths, a batch of 16 so that
# 4 envs update from the second chunk; four scenarios over the two ranks
MESH_M2 = dict(sac_kw=dict(episodes=16, warmup_episodes=4, seed=5, num_envs=4),
               pop_kw=dict(episodes=8, warmup_episodes=2, seed=5, num_envs=2),
               qs=[0.3, 0.5, 0.7, 0.9], small=dict(batch=16, buffer_size=2000))
# (M3) four gloo ranks sharing the card: the Split cell (Qwen2.5-3B at
# published widths, depth 8 on 4 stages, M = 4, 8 x 256 tokens, bf16 over
# f32 masters through the stage kernel), then the (2 x 2) stage x env
# step at depth 4 in f32
MESH_M3 = dict(arch="qwen2.5-3b", depth=8, bounds=[2, 4, 6, 8], micro=4, rows=8,
               seq=256, steps=2, env_depth=4, env_bounds=[2, 4])
MESH_TIMEOUT_S = 420
# a stage-mesh step against the in-process step on the same weights and
# tokens (the same kernels on the same shapes; the embedding gradient's
# index_add_ sums in atomic order): loss rtol 1e-6, every gradient leaf
# max|diff| <= 1e-4 max|ref|; the (stage x env) step against the 1-D one
# at the JAX package's gate (loss 1e-6 relative, gradients 1e-5 of
# max|ref| per leaf)
MESH_LOSS_RTOL = 1e-6
MESH_GRAD_REL = 1e-4
# (M3)'s launcher step on the stage ranks: the clip's norm (per-rank
# partial sums of f32 squares, summed over the ranks) against the
# one-process launcher step's norm on the same inputs, and the updated
# parameters against its updated parameters at the step's gate
MESH_NORM_RTOL = 1e-6
ENV_LOSS_RTOL = 1e-6
ENV_GRAD_REL = 1e-5


def _mesh_stage_launches(micro, bounds, steps):
    """``stage_mlp_block`` launches per stage of ``steps`` 1F1B steps: the
    forward slot and the rematerialized backward of a non-last stage, the
    loss VJP of the last."""
    lens = [b - a for a, b in zip([0] + list(bounds[:-1]), bounds)]
    return [steps * micro * (n if k == len(lens) - 1 else 2 * n)
            for k, n in enumerate(lens)]


def _mesh_step_check(what, res, loss_rtol, grad_rel, card):
    loss, ref = res["loss"], res["ref_loss"]
    log(f"[mesh {what}] loss {loss:.6f} vs in-process {ref:.6f}; gradients "
        f"max|diff| {res['grad_rel']:.3e} of max|ref| per leaf at most; "
        f"{'bit for bit' if res['bitwise'] else 'not bit for bit'} [{card}]")
    if not (abs(loss - ref) <= loss_rtol * abs(ref) and res["grad_rel"] <= grad_rel):
        raise AssertionError(f"{what}: the mesh step is off the in-process step: {res}")


def start_stage_mesh():
    """4j. Start (M3) on four gloo ranks sharing this card, a child process
    each (``tests/_torch_ranks.py``'s ``card_stage``), to run beside the
    population band (host-bound, one process);
    :func:`finish_stage_mesh` waits and :func:`phase_mesh` checks."""
    import shutil

    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_ranks as TR

    base = ROOT / "build" / "chip_smoke_m3"
    shutil.rmtree(base, ignore_errors=True)
    return time.perf_counter(), TR.start("card_stage", 4, base, backend="gloo",
                                         **MESH_M3)


def finish_stage_mesh(started):
    """(M3)'s ranks' results under ``MESH_TIMEOUT_S`` and its wall time."""
    import _torch_ranks as TR

    t0, handle = started
    return TR.finish(handle, MESH_TIMEOUT_S), time.perf_counter() - t0


def phase_mesh(torch, card, m3):
    """4j. (M1) one NCCL rank, (M2) two gloo ranks and 4k's (M4c) four gloo
    ranks, side by side, all on this card, as child processes
    (``tests/_torch_ranks.py``'s card workers) under a timeout, then the
    checks of (M3) (four gloo ranks, run beside the population band:
    ``m3`` is :func:`finish_stage_mesh`'s result). Each child reports the
    kernel launches of its mesh runs. Returns the launches to add to the
    kernels line."""
    import shutil

    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_ranks as TR

    base = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    m1 = TR.start("card_one_rank", 1, base / "m1", backend="nccl", **MESH_M1)
    m2 = TR.start("card_two_ranks", 2, base / "m2", backend="gloo", **MESH_M2)
    # 4k's (M4c) beside them: it launches no kernel
    m4c = TR.start("card_tensor_parallel", 4, base / "m4c", backend="gloo",
                   parts=["M4c", "M4c_mamba"], m4c=MESH_M4C,
                   m4c_mamba=MESH_M4C_MAMBA)
    try:
        (r1,), r2 = TR.finish(m1, MESH_TIMEOUT_S), TR.finish(m2, MESH_TIMEOUT_S)
    except BaseException:
        for h in (m2, m4c):
            _kill(h)
        raise
    t12 = time.perf_counter() - t0
    ca = 0
    for name in ("train_sac", "train_population"):
        res, n = r1[name], r1["launches"][name]["ca_attention"]
        ca += n
        log(f"[mesh M1] {name} on a 1-rank population mesh ({r1['backend']} group, "
            f"transport {r1['transport']}, {r1['device']}) vs mesh=None: max|diff| "
            f"{res['diff']:.3e}; {res['seconds']:.2f} s (mesh=None {res['ref_seconds']:.2f} s); "
            f"ca_attention {n} [{card}]")
        if res["diff"] != 0.0 or not n:
            raise AssertionError(f"M1 {name}: not bit for bit, or no kernel: {res}, {n}")
    _mesh_step_check("M1 1-rank stage mesh", r1["stage"], MESH_LOSS_RTOL,
                     MESH_GRAD_REL, card)
    m1_stage = r1["launches"]["stage"]["stage_mlp_block"]
    if m1_stage != _mesh_stage_launches(4, [MESH_M1["depth"]], 1)[0]:
        raise AssertionError(f"M1 stage step launched stage_mlp_block {m1_stage} times")
    lead, other = r2
    n2 = [r["launches"]["ca_attention"] for r in r2]
    log(f"[mesh M2] 2 ranks ({lead['transport']}, {lead['device']}): train_sac "
        f"({MESH_M2['sac_kw']['num_envs']} envs split) vs 1 rank: first chunk "
        f"max|diff| {lead['sac_first_chunk_diff']:.3e}, whole run max|diff| "
        f"{lead['sac_diff']:.3e} ({'bit for bit' if lead['sac_diff'] == 0 else 'not bit for bit'}, "
        f"updated {lead['sac_updated']}); {lead['sac_seconds']:.2f} s on 2 ranks, "
        f"{lead['ref_seconds']:.2f} s on 1; train_population ({len(MESH_M2['qs'])} "
        f"scenarios split) vs 1 rank: max|diff| {other['pop_diff']:.3e} "
        f"(updated {other['pop_updated']}); {other['pop_seconds']:.2f} s on 2 ranks, "
        f"{other['ref_seconds']:.2f} s on 1; ca_attention {n2}; peak "
        f"{[round(r['peak_gib'], 3) for r in r2]} GiB a rank [{card}]")
    if other["pop_diff"] != 0.0 or not other["pop_updated"] or not all(n2):
        raise AssertionError(f"M2: the sharded population is not the 1-rank run "
                             f"({other['pop_diff']}) or a rank launched no kernel {n2}")
    if not math.isfinite(lead["sac_diff"]) or not lead["sac_updated"]:
        raise AssertionError(f"M2: train_sac on 2 ranks: {lead}")
    ca += sum(n2)
    log(f"[mesh] M1 and M2 side by side: {t12:.1f} s wall [{card}]")
    _log_m4c(torch, card, TR.finish(m4c, MESH_TIMEOUT_S), time.perf_counter() - t0)

    r3, m3_wall = m3
    stage = [r["launches"]["stage"]["stage_mlp_block"] for r in r3]
    env = [r["launches"]["stage_env"]["stage_mlp_block"] for r in r3]
    # the timed steps and the launcher's step
    want = _mesh_stage_launches(MESH_M3["micro"], MESH_M3["bounds"], MESH_M3["steps"] + 1)
    want_env = [n for n in _mesh_stage_launches(MESH_M3["micro"], MESH_M3["env_bounds"], 1)
                for _ in range(2)]
    first = r3[0]["stage"]
    log(f"[mesh M3] {MESH_M3['arch']} at published widths, depth {MESH_M3['depth']} "
        f"on {len(MESH_M3['bounds'])} ranks {tuple(MESH_M3['bounds'])}, M = "
        f"{MESH_M3['micro']}, {MESH_M3['rows']} x {MESH_M3['seq']} tokens, bf16 over f32 "
        f"masters, stage_impl 'pallas', hops host-staged ({first['transport']}): "
        f"seconds per step {[round(x, 3) for x in first['seconds']]} (the first warms) "
        f"against {first['ref_seconds']:.3f} s in one process; peak memory per rank "
        f"{[round(r['stage']['peak_gib'], 2) for r in r3]} GiB; stage_mlp_block per "
        f"rank {stage} [{card}]")
    _mesh_step_check("M3 4-stage mesh", first, MESH_LOSS_RTOL, MESH_GRAD_REL, card)
    for r in r3:
        _steady_records("M3 timed steps", r["stage"]["collectives"])
    log(f"[mesh M3] recorded collectives a timed step (count, wire bytes), by rank: "
        f"{[_collective_line(r['stage']['collectives'][0]) for r in r3]} (every timed "
        f"step alike) [{card}]")
    log(f"[mesh M3] the launcher's step (make_pipeline_train_step(mesh=), "
        f"{first['update_seconds']:.3f} s) on the 4 stage ranks: clip norm "
        f"{first['norm']:.9g} summed over the ranks vs {first['ref_norm']:.9g} in "
        f"the one-process launcher step (relative "
        f"{abs(first['norm'] - first['ref_norm']) / first['ref_norm']:.3e}); updated "
        f"params max|diff| {first['update_rel']:.3e} of max|ref| per leaf at most "
        f"[{card}]")
    if (abs(first["norm"] - first["ref_norm"]) > MESH_NORM_RTOL * first["ref_norm"]
            or first["update_rel"] > MESH_GRAD_REL):
        raise AssertionError(f"M3: the stage-rank update is off the one-process update: "
                             f"{first}")
    if stage != want or env != want_env:
        raise AssertionError(f"M3 stage_mlp_block launches {stage} / {env}, want "
                             f"{want} / {want_env}")
    _mesh_step_check("M3 (2 x 2) stage x env, f32, depth "
                     f"{MESH_M3['env_depth']}", r3[0]["stage_env"], ENV_LOSS_RTOL,
                     ENV_GRAD_REL, card)
    log(f"[mesh] M3 {m3_wall:.1f} s wall beside the population band [{card}]")
    shutil.rmtree(base, ignore_errors=True)
    shutil.rmtree(ROOT / "build" / "chip_smoke_m3", ignore_errors=True)
    return {"ca_attention": ca,
            "stage_mlp_block": m1_stage + sum(stage) + sum(env)}


# ---------------------------------------------------------------------------
# 4k. the (data x model) mesh: FSDP over data, tensor parallelism over model
# ---------------------------------------------------------------------------

# (M4) four gloo ranks sharing the card (NCCL refuses two ranks on one GPU,
# so the seconds measure host staging, not a link), each part against the
# one-process run on rank 0:
# (M4a) the zoo trainer (launch.train) on a (2 x 2) mesh: StableLM-2-1.6B at
# published widths, depth 8 of 24 (a cut for the phase's time), the
# trainer's batch 8 x 128, 3 steps, bf16 compute over f32 masters
MESH_M4A = dict(argv=["--arch", "stablelm-1.6b", "--no-reduced", "--depth", "8",
                      "--batch", "8", "--seq", "128", "--steps", "3",
                      "--bf16-compute"])
# (M4b) one (2 x 2) step of Qwen3-MoE-30B-A3B at published widths, depth 2,
# every MoE layer through moe_a2a (128 experts: 64 a model rank), f32, at
# the capacity factor E / top_k = 16 (512 slots an expert for 512 tokens
# a data rank: no copy can overflow; at 4, 4x the mean load, the second
# layer dropped 38-41 copies a rank, its router's load being skewed) and
# without the Switch loss (whose value differs by design between the
# all-to-all path and the dropless one), against the one-process
# dropless step; without rematerialization on both sides (the value is
# the same; the recomputation would gather the f32 experts through the
# host a third time; (M4a) runs the rematerialized path)
MESH_M4B = dict(arch="qwen3-moe-30b-a3b", depth=2, rows=8, seq=128,
                capacity_factor=16.0, remat=False)
# (M4c) Qwen2.5-3B at published widths and full depth (36 layers), f32, on a
# (1 x 4) mesh: 2 KV heads do not split over 4 ranks, so the 1 024-entry
# cache is split by length (256 entries a rank); batch 4, a 32-token prefill
# from position 0 (on rank 0: each layer gathers the cache, updates and
# attends to it whole, and keeps its entries), then 8 greedy steps, every
# layer through flash_decode, each row from its own position (32, 250, 506,
# 900: row 1 crosses into rank 1, row 2 into rank 2, row 3 decodes on rank
# 3, so every rank holds live entries and the rows' positions differ);
# every step runs the same path and records the same collectives, so
# more steps would add time, not coverage
MESH_M4C = dict(arch="qwen2.5-3b", cache=1024, starts=[32, 250, 506, 900], prefill=32,
                steps=8)
# (M4c, its SSM part) Mamba2-370m at published widths and full depth (48
# layers), f32, on the same (1 x 4) mesh: each Mamba block on its 8 of 32
# SSM heads and 576 of 2 304 conv channels (1 096 of in_proj's 4 384
# columns, 512 of out_proj's 2 048 rows); batch 4, one prompt token, then
# 8 greedy steps (the state carries no positions; the cache length is
# unused)
MESH_M4C_MAMBA = dict(arch="mamba2-370m", cache=32, starts=[0, 1, 2, 3], prompt=1,
                      steps=8)
# gates: (M4a) bf16 partial sums round on each rank, so the losses are held
# at rtol 2e-3 and the updated params at 1e-2 relative Frobenius norm per
# leaf (the CPU test's bf16 gates measured at most 1.7e-4 and 5.2e-3);
# (M4b) f32: loss rtol 1e-5 and the first moment (0.1 x the clipped
# gradient) 1e-4 relative per leaf (the CPU test: 1e-5, measured 1.3e-6);
# (M4c) the greedy tokens equal, logits max|diff| 1e-3 (the reference's gate)
M4A_LOSS_RTOL, M4A_PARAM_REL = 2e-3, 1e-2
M4B_LOSS_RTOL, M4B_MU_REL = 1e-5, 1e-4
M4C_LOGIT_ATOL = 1e-3


# (M5a) serving on 4 gloo stage ranks sharing the card: Qwen2.5-3B at
# published widths and full depth (36 layers, stages 9/18/27/36), bf16
# compute and wire with stage_impl "pallas" (each rank's dense MLP halves
# through stage_mlp_block), ServingService(mesh=) over a short Poisson trace
# (8 requests, up to 16 new tokens, 8 slots), against the same service in
# one process on rank 0; it runs beside the host-bound band phase
MESH_M5A = dict(arch="qwen2_5_3b", bounds=[9, 18, 27, 36],
                serve=dict(num_slots=8, arrival_slots=4, prompt_pad=32, max_new=16,
                           decode_chunk=8),
                trace=dict(n_requests=8, rate_per_sec=64.0, plen_range=(4, 32),
                           gen_range=(4, 16), seed=0))


def start_serve_stage():
    """4h2. Start (M5a) on four gloo ranks sharing this card, a child
    process each (``tests/_torch_ranks.py``'s ``card_serve_stage``), to
    run beside the band phase; :func:`phase_serve_stage` waits."""
    import shutil

    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_ranks as TR

    base = ROOT / "build" / "chip_smoke_m5a"
    shutil.rmtree(base, ignore_errors=True)
    return time.perf_counter(), TR.start("card_serve_stage", 4, base, backend="gloo",
                                         **MESH_M5A)


def phase_serve_stage(torch, card, started):
    """4h2. (M5a): wait for the children under ``MESH_TIMEOUT_S``; every
    rank's completions bit for bit the one-process service's, each rank's
    ``stage_mlp_block`` launches its own layers' (one per layer per ring
    pass, no other kernel). Returns the stage kernel's launches."""
    import numpy as np

    import _torch_ranks as TR

    t0, handle = started
    ranks = TR.finish(handle, MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lead = ranks[0]
    ref = lead["ref_completions"]
    if len(ref) != MESH_M5A["trace"]["n_requests"]:
        raise AssertionError(f"M5a: the one-process service completed {len(ref)} requests")
    stage = []
    for k, r in enumerate(ranks):
        got = r["completions"]
        if got.keys() != ref.keys() or not all(np.array_equal(got[q], v)
                                               for q, v in ref.items()):
            raise AssertionError(f"M5a: rank {k}'s completions differ from one process")
        n = r["launches"]["stage_mlp_block"]
        want = (r["passes"]["prefill"] + r["passes"]["decode"]) * r["stage_layers"]
        others = {q: v for q, v in r["launches"].items() if q != "stage_mlp_block" and v}
        if n != want or others or r["passes"] != lead["passes"]:
            raise AssertionError(f"M5a rank {k}: launches {r['launches']}, passes "
                                 f"{r['passes']}, want stage_mlp_block {want}")
        stage.append(n)
    ms = [statistics.median(r["decode_ms"]) for r in ranks]
    log(f"[mesh M5a] {MESH_M5A['arch']} at published widths, {lead['layers']} layers "
        f"on {len(ranks)} stage ranks {tuple(MESH_M5A['bounds'])} ({lead['transport']}), "
        f"bf16, stage_impl 'pallas': {len(ref)} completions bit for bit the one-process "
        f"service's on every rank; ring passes {lead['passes']}; stage_mlp_block per "
        f"rank {stage}; decode step median ms per rank {[round(x, 3) for x in ms]}; "
        f"{lead['seconds']:.3f} s ({lead['tokens_per_sec']:.1f} tokens/s, "
        f"{lead['ticks']} ticks) vs {lead['ref_seconds']:.3f} s in one process "
        f"({lead['ref_tokens_per_sec']:.1f} tokens/s); peak "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB a rank; {wall:.1f} s wall "
        f"beside the band [{card}]")
    return sum(stage)


def start_tensor_parallel():
    """4k. Start (M4a) and (M4b) on four gloo ranks sharing this card, a
    child process each (``tests/_torch_ranks.py``'s
    ``card_tensor_parallel``). They launch no kernel, so they run beside
    the kernels' build (host compilers only: the card's memory is theirs),
    which keeps the smoke test within its time limit;
    :func:`phase_tensor_parallel` waits for them."""
    import shutil

    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_ranks as TR

    base = ROOT / "build" / "chip_smoke_tp"
    shutil.rmtree(base, ignore_errors=True)
    return time.perf_counter(), TR.start(
        "card_tensor_parallel", 4, base, backend="gloo", parts=["M4a", "M4b"],
        m4a=MESH_M4A, m4b=MESH_M4B)


def _kill(handle):
    """Stop a group of children that is still running (a phase failed
    before it waited for them)."""
    for p in handle[2]:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _tp_launches(ranks, what):
    launched = {k: v for r in ranks for part in r["launches"].values()
                for k, v in part.items() if v}
    if launched:
        raise AssertionError(f"{what}: the sharded paths launched kernels {launched}")


def phase_tensor_parallel(torch, card, started):
    """4k. (M4a) and (M4b) (:func:`start_tensor_parallel`): wait for the
    children under ``MESH_TIMEOUT_S``, log and hold each part to the
    one-process run. The sharded paths take no kernel route; each child
    reports its launches, which must be none."""
    import _torch_ranks as TR

    t0, handle = started
    ranks = TR.finish(handle, MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    _tp_launches(ranks, "M4a/M4b")
    a, b = ranks[0]["M4a"], ranks[0]["M4b"]

    rel = [abs(x - y) / abs(y) for x, y in zip(a["losses"], a["ref_losses"])]
    log(f"[mesh M4a] launch.train {' '.join(MESH_M4A['argv'])} on a (2 x 2) mesh "
        f"({a['transport']}), {a['n_params']} parameters: losses "
        f"{[round(x, 6) for x in a['losses']]} vs one process "
        f"{[round(x, 6) for x in a['ref_losses']]} (relative {max(rel):.3e}); updated "
        f"params {a['param_rel']:.3e} relative per leaf at most, the updates "
        f"themselves {a['update_rel']:.3e}; seconds per step "
        f"{[round(x, 3) for x in a['seconds']]} (the first warms) vs one process "
        f"{[round(x, 3) for x in a['ref_seconds']]}; params + moments resident "
        f"{[round(r['M4a']['resident_gib'], 3) for r in ranks]} GiB a rank; peak "
        f"{[round(r['M4a']['peak_gib'], 2) for r in ranks]} GiB a rank (one "
        f"process {a['ref_peak_gib']:.2f} GiB) [{card}]")
    if max(rel) > M4A_LOSS_RTOL or a["param_rel"] > M4A_PARAM_REL:
        raise AssertionError(f"M4a: the (2 x 2) trainer is off the one-process run: {a}")

    dropped = [r["M4b"]["dropped"] for r in ranks]
    log(f"[mesh M4b] {MESH_M4B['arch']} at published widths, depth "
        f"{MESH_M4B['depth']}, {MESH_M4B['rows']} x {MESH_M4B['seq']} tokens, f32, "
        f"moe_a2a on a (2 x 2) mesh ({b['experts_per_rank']} experts a model rank): "
        f"loss {b['loss']:.6f} vs the one-process dropless step {b['ref_loss']:.6f}; "
        f"first moment {b['mu_rel']:.3e} relative per leaf at most; copies dropped "
        f"per moe_apply_a2a call per rank {dropped}; step {b['seconds']:.3f} s "
        f"vs {b['ref_seconds']:.3f} s in one process; peak "
        f"{[round(r['M4b']['peak_gib'], 2) for r in ranks]} GiB a rank (one process "
        f"{b['ref_peak_gib']:.2f} GiB) [{card}]")
    if (any(any(d) for d in dropped) or not all(len(d) for d in dropped)
            or abs(b["loss"] - b["ref_loss"]) > M4B_LOSS_RTOL * abs(b["ref_loss"])
            or b["mu_rel"] > M4B_MU_REL):
        raise AssertionError(f"M4b: the moe_a2a step is off the dropless step: {b}")
    laps = {k: round(v, 1) for k, v in ranks[0]["laps"].items()}
    log(f"[mesh] M4a and M4b {wall:.1f} s wall, beside the kernels' build; "
        f"rank 0's parts (s) {laps} [{card}]")


def _collective_line(rec):
    """One pass's recorded collectives: count and wire bytes per kind."""
    return {k: (rec["counts"][k], round(rec["wire_bytes"][k])) for k in sorted(rec["counts"])}


def _steady_records(what, records):
    """Hold every record of ``records`` (one a step) to the first's counts
    and wire bytes."""
    for i, rec in enumerate(records):
        if (rec["counts"], rec["wire_bytes"]) != (records[0]["counts"],
                                                   records[0]["wire_bytes"]):
            raise AssertionError(f"{what}: step {i} recorded {_collective_line(rec)}, "
                                 f"step 0 {_collective_line(records[0])}")


def _log_m4c(torch, card, ranks, wall):
    """(M4c) and its SSM part, run beside (M1) and (M2): log and hold each
    to one process; log each rank's recorded collectives of the prompt's
    pass and of a decode step, every decode step holding the same."""
    _tp_launches(ranks, "M4c")
    laps = {k: round(v, 1) for k, v in ranks[0]["laps"].items()}
    for part, m in (("M4c", MESH_M4C), ("M4c_mamba", MESH_M4C_MAMBA)):
        c = ranks[0][part]
        err = float((c["logits"] - c["ref_logits"]).abs().max())
        same = bool(torch.equal(c["tokens"], c["ref_tokens"]))
        calls = [r[part]["flash_calls"] for r in ranks]
        prompt = m.get("prefill") or m["prompt"]
        passes = (1 if m.get("prefill") else prompt) + m["steps"]
        want = c["layers"] * (passes - 1 if m.get("prefill") else passes) \
            if part == "M4c" else 0
        log(f"[mesh {part}] {m['arch']} at published widths, {c['layers']} layers, "
            f"f32, (1 x 4) mesh, caches placed {c['cache_spec']}: a {prompt}-token "
            f"prompt ({'one prefill pass' if m.get('prefill') else 'teacher-forced'}), "
            f"{m['steps']} greedy tokens {'equal' if same else 'NOT equal'} to one "
            f"process; logits max|diff| {err:.3e}; flash_decode calls per rank {calls} "
            f"(want {want}); {c['seconds']:.3f} s for {passes} passes vs "
            f"{c['ref_seconds']:.3f} s in one process; peak "
            f"{[round(r[part]['peak_gib'], 2) for r in ranks]} GiB a rank [{card}]")
        if not same or err > M4C_LOGIT_ATOL or calls != [want] * 4:
            raise AssertionError(f"{part}: the sharded decode is off the one-process decode")
        first = 1 if m.get("prefill") else prompt
        for r in ranks:
            _steady_records(f"{part} decode", r[part]["collectives"][first:])
        log(f"[mesh {part}] recorded collectives a rank (count, wire bytes) of the "
            f"prompt's first pass {_collective_line(c['collectives'][0])}, of each "
            f"decode step {_collective_line(c['collectives'][first])} (every step "
            f"alike on every rank) [{card}]")
    log(f"[mesh M4c] {wall:.1f} s wall beside M1 and M2; rank 0's parts (s) {laps} "
        f"[{card}]")


# ---------------------------------------------------------------------------
# 5b. where the time of a chunk goes
# ---------------------------------------------------------------------------


def phase_trace(torch, card, env, cfg, params, steps=20, label=""):
    """Host time of one batched rollout episode and of single gradient
    steps, and a torch.profiler trace of ``steps`` gradient steps: device
    busy share, kernels per step, top kernels and host ops. Launches here
    do not count for the main path. ``label`` tags the log lines."""
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
    with _traced(torch) as prof:
        t0 = time.perf_counter()
        for row in idx[3:]:
            params, opt, _ = update(params, opt, R.buffer_gather(buf, row))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
    CA.launches = saved
    log(f"[trace{label}] one rollout episode ({NUM_ENVS} envs x "
        f"{env.episode_len} steps): {roll_s * 1e3:.3f} ms host; one gradient "
        f"step (profiled): {step_s * 1e3:.3f} ms host [{card}]")
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in events if e.device_type == cuda]
    dev_us = sum(e.self_device_time_total for e in kern)
    n_kern = sum(e.count for e in kern)
    if dev_us == 0:
        raise AssertionError("the profiler saw no device time in the "
                             "gradient steps")
    log(f"[trace{label}] per gradient step: {n_kern / steps:.0f} kernels, "
        f"{dev_us / steps / 1e3:.3f} ms device busy, busy share "
        f"{dev_us / 1e6 / (step_s * steps):.3f} of host time [{card}]")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[trace{label}]   kernel {e.key[:70]}: {e.count // steps}/step, "
            f"{e.self_device_time_total / steps:.1f} us/step device")
    host = [e for e in events if e.device_type != cuda]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"[trace{label}]   host op {e.key[:50]}: {e.count / steps:.1f}/step, "
            f"{e.self_cpu_time_total / steps:.1f} us/step self CPU")


# ---------------------------------------------------------------------------
# 3b. the split executor's kernels against their plain versions
# ---------------------------------------------------------------------------

BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak

# (label, (B, S), D, F, activation, x dtype); weights are f32 master
# weights, as on the split executor's path. The first case is the main
# path's call (a 2x256-token microbatch of Qwen2.5-3B). f16 and bf16 take
# the tensor-core body, f32 the FMA body.
STAGE_CASES = [
    ("qwen2.5-3b", (2, 256), 2048, 11008, "swiglu", "bfloat16"),
    ("jamba-v0.1-52b", (2, 256), 4096, 14336, "swiglu", "bfloat16"),
    ("qwen2.5-3b", (2, 256), 2048, 11008, "swiglu", "float32"),
    ("qwen2.5-3b", (2, 256), 2048, 11008, "swiglu", "float16"),
    ("minitron-4b ragged", (1, 130), 3072, 9216, "relu2", "bfloat16"),
    ("minitron-4b ragged", (1, 130), 3072, 9216, "relu2", "float16"),
    ("gelu", (1, 37), 256, 512, "gelu", "float32"),
    ("gelu", (1, 37), 256, 512, "gelu", "bfloat16"),
    ("silu", (1, 37), 256, 512, "silu", "float32"),
    ("silu", (1, 37), 256, 512, "silu", "bfloat16"),
]
# stated tolerances, forward: f32 max|err| <= 1e-4 (f32 sums of up to
# 11008 terms taken in another order than cuBLAS's); bf16 max|err| <=
# 2^-6 max|ref|, two bf16 ulps at the largest output (a reordered f32 sum
# can land on the other side of a bf16 rounding of h, hc or the output);
# f16 max|err| <= 2^-9 max|ref|, the same two ulps of f16's 3 more bits.
# Backward: the wrapper's backward is autograd of mlp_block, the same code
# the plain route differentiates, so max|err| <= 1e-5 max|ref| per leaf.
STAGE_FWD_F32_ATOL = 1e-4
STAGE_FWD_REL = {"bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}
STAGE_BWD_REL = 1e-5

# (label, B, Sq, Skv, H, KH, hd, window, q_offset); each in f32 (FMA
# body), bf16 and f16 (tensor-core body). The first case has the shapes
# of the held-out evaluation's calls.
FLASH_CASES = [
    ("qwen2.5-3b", 8, 1024, 1024, 16, 2, 128, None, 0),
    ("ragged S=200", 2, 200, 200, 16, 2, 128, None, 0),
    ("window 64", 2, 512, 512, 16, 2, 128, 64, 0),
    ("Sq=32 at q_offset 96", 2, 32, 128, 16, 2, 128, None, 96),
    ("stablelm-1.6b MHA hd=64", 2, 512, 512, 32, 32, 64, None, 0),
    ("nemotron-4-340b hd=192 GQA 96/8", 1, 256, 256, 96, 8, 192, None, 0),
    ("hd=192 ragged, window 64", 1, 200, 200, 8, 2, 192, 64, 0),
    ("hd=96", 2, 256, 256, 8, 2, 96, None, 0),
    ("hd=256", 1, 256, 256, 8, 2, 256, None, 0),
    ("hd=80 padded to 96", 2, 200, 200, 8, 2, 80, None, 0),
]
# forward max|err|: f32 1e-5, bf16 2e-2 (one bf16 ulp of outputs below
# 4), as the CPU parity tests hold the plain version to the JAX kernel;
# f16 4e-3 (two f16 ulps of outputs below 4). The tensor-core body feeds
# the probabilities to p @ v as two terms in the input dtype, which keeps
# it to the f32 sums' order, inside these gates.
FLASH_ATOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 4e-3}


def _stage_inputs(torch, rows, d, f, activation, dtype, seed):
    from repro_torch.models import layers as L

    g = torch.Generator(device="cuda").manual_seed(seed)
    params = L.init_mlp(g, d, f, activation, device="cuda")  # f32
    nw = 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")
    x = torch.randn((*rows, d), generator=g, device="cuda").to(dtype)
    return nw, params, x


def phase_stage_checks(torch):
    """stage_mlp_block kernel vs stage_mlp_block_ref on the card, forward,
    and gradients through the wrapper's autograd against autograd of
    mlp_block. Returns the max forward error of the main-path case."""
    from repro_torch.kernels import stage_block as SB
    from repro_torch.models import layers as L

    saved = SB.launches
    main_err = None
    for n, (label, rows, d, f, act, dn) in enumerate(STAGE_CASES):
        dtype = getattr(torch, dn)
        nw, params, x = _stage_inputs(torch, rows, d, f, act, dtype, seed=20 + n)
        with torch.no_grad():
            ref = SB.stage_mlp_block_ref(nw, params, x, activation=act)
            before = SB.launches
            out = SB.stage_mlp_block(nw, params, x, activation=act)
        torch.cuda.synchronize()
        if SB.launches != before + 1:
            raise AssertionError("stage_mlp_block did not count its launch")
        if out.dtype != dtype or out.shape != x.shape:
            raise AssertionError(f"stage_mlp_block out {out.dtype} {tuple(out.shape)}")
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"non-finite stage_mlp_block output ({label})")
        err = float((out.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        lim = STAGE_FWD_F32_ATOL if dn == "float32" else STAGE_FWD_REL[dn] * top
        if err > lim:
            raise AssertionError(f"stage_mlp_block fwd {label} {dn}: {err} > {lim}")
        if n == 0:
            main_err = err

        # backward: kernel forward + autograd of mlp_block vs plain autograd
        gy = torch.randn(x.shape, generator=torch.Generator(device="cuda")
                         .manual_seed(n), device="cuda").to(dtype)
        names = sorted(params)

        def grads(fn):
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            nr = nw.detach().requires_grad_(True)
            xr = x.detach().requires_grad_(True)
            out_ = fn(nr, p, xr)
            return torch.autograd.grad(out_, [nr, xr] + [p[k] for k in names], gy)

        gk = grads(lambda nr, p, xr: SB.stage_mlp_block(nr, p, xr, activation=act))
        gr = grads(lambda nr, p, xr: L.mlp_block(nr, p, xr, act))
        bwd = 0.0
        for name, a, r in zip(["norm_w", "x"] + names, gk, gr):
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f"non-finite stage_mlp_block grad {name}")
            e = float((a.float() - r.float()).abs().max())
            lim_b = STAGE_BWD_REL * float(r.float().abs().max())
            if e > lim_b:
                raise AssertionError(f"stage_mlp_block bwd {label} {dn} {name}: "
                                     f"{e} > {lim_b}")
            bwd = max(bwd, e / max(float(r.float().abs().max()), 1e-30))
        log(f"[check] stage_mlp_block {label:18s} rows {rows[0] * rows[1]:4d} "
            f"D {d} F {f} {act:6s} {dn:8s}: fwd max|err| {err:.3e} (limit "
            f"{lim:.3e}, max|ref| {top:.3f}); bwd max|err|/max|ref| {bwd:.3e} "
            f"(limit {STAGE_BWD_REL:g})")
    SB.launches = saved
    return main_err


def phase_flash_checks(torch):
    """flash_attention kernel vs flash_attention_ref on the card, forward
    (the kernel has no backward)."""
    from repro_torch.kernels import flash_attention as FA

    saved = FA.launches
    for n, (label, b, sq, skv, h, kh, hd, win, off) in enumerate(FLASH_CASES):
        g = torch.Generator(device="cuda").manual_seed(40 + n)
        q32 = torch.randn(b, sq, h, hd, generator=g, device="cuda")
        k32 = torch.randn(b, skv, kh, hd, generator=g, device="cuda")
        v32 = torch.randn(b, skv, kh, hd, generator=g, device="cuda")
        for dn in ("float32", "bfloat16", "float16"):
            dtype = getattr(torch, dn)
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            with torch.no_grad():
                ref = FA.flash_attention_ref(q, k, v, window=win, q_offset=off)
                before = FA.launches
                out = FA.flash_attention(q, k, v, window=win, q_offset=off)
            torch.cuda.synchronize()
            if FA.launches != before + 1:
                raise AssertionError("flash_attention did not count its launch")
            if out.dtype != dtype or out.shape != q.shape:
                raise AssertionError(f"flash_attention out {out.dtype} {tuple(out.shape)}")
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"non-finite flash_attention output ({label})")
            err = float((out.float() - ref.float()).abs().max())
            if err > FLASH_ATOL[dn]:
                raise AssertionError(f"flash_attention {label} {dn}: {err} > "
                                     f"{FLASH_ATOL[dn]}")
            log(f"[check] flash_attention {label:24s} B {b} Sq {sq} Skv {skv} "
                f"H {h}/{kh} hd {hd} {dn:8s}: max|err| {err:.3e} (atol "
                f"{FLASH_ATOL[dn]:g})")
    FA.launches = saved


# ---------------------------------------------------------------------------
# 4b. the split slice: plan -> pipelined training -> held-out loss
# ---------------------------------------------------------------------------

# the launcher's arguments: Qwen2.5-3B at its published widths, depth cut
# to 8 layers; a short SAC run on the full 36-layer profile; 4 stages,
# M = 4 microbatches of 2 x 256 tokens; 8 x 1024 held-out tokens
SPLIT_ARGV = ["--arch", "qwen2.5-3b", "--episodes", "24", "--num-envs", "8",
              "--pipeline-steps", "4", "--stages", "4", "--depth", "8",
              "--microbatches", "4", "--batch", "8", "--seq", "256",
              "--eval-batch", "8", "--eval-seq", "1024", "--seed", "0"]
# held-out loss through the flash kernel vs impl="dense" on the same
# tokens, a secondary check (the kernel is held to its plain version on
# the eval call's own q, k, v): bf16 compute, and dense rounds the softmax
# weights to bf16 where the kernel carries them as two bf16 terms;
# |difference| <= 1e-4 nats, about 7x the 1.3e-5 to 1.5e-5 read on an
# H100 80GB HBM3 at 700 W
EVAL_ATOL = 1e-4
# f32 depth-2 pipelined step vs make_train_step on the card: loss rtol
# 1e-5; gradients max|err| <= 1e-4 max|ref| per leaf (f32 sums over up
# to 11008 terms in the kernel's order vs cuBLAS's, through two layers)
PARITY_LOSS_RTOL = 1e-5
PARITY_GRAD_REL = 1e-4


def phase_split(torch, card):
    """The split executor's path through ``launch.train_mhsl_rl.main``,
    with every launch counter at 0 just before and read just after."""
    from repro_torch.core.pipeline import stage_lengths
    from repro_torch.launch import train_mhsl_rl as RUN
    from repro_torch.models import model as M

    args = RUN.parse_args(SPLIT_ARGV)
    counts, res, wall = _run_launcher(torch, SPLIT_ARGV)
    cfg = res["cfg"]
    lens = stage_lengths(res["boundaries"])
    per_step = args.microbatches * (2 * (cfg.num_layers - lens[-1]) + lens[-1])
    expect = {"ca_attention": _expected_ca(res, args),
              "stage_mlp_block": args.pipeline_steps * per_step,
              "flash_attention": cfg.num_layers, "ssd_scan": 0,
              "grouped_moe_ffn": 0}
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    _expect_config(cfg, args)
    _check_launcher_result(torch, res, args)

    flash_err = _eval_flash_check(torch, res)
    with torch.no_grad():
        _, (dense, _) = M.loss_fn(res["params"], res["eval_batch"], cfg,
                                  impl="dense", compute_dtype=torch.bfloat16)
    dense = float(dense)
    gap = abs(res["eval_loss"] - dense)
    if gap > EVAL_ATOL:
        raise AssertionError(f"held-out loss pallas {res['eval_loss']} vs dense "
                             f"{dense}: |diff| {gap} > {EVAL_ATOL}")

    # bf16 stage calls take the tensor-core body: its GEMMs and no FMA grid
    _step_trace(torch, card, res, args, "split",
                must_see=("rms_norm_rows", "gemm_tc", "split_k_sum"),
                must_not_see=("up_act", "down_residual"))
    # the held-out call's 8 attention calls on the tensor-core body
    _eval_trace(torch, card, res, "split", "flash_fwd_tc",
                count=cfg.num_layers, must_not_see=("flash_fwd<",))

    secs, losses = res["step_seconds"], res["losses"]
    med = statistics.median(secs[1:])
    tokens = args.batch * args.seq
    log(f"[split] plan on the 36-layer profile: boundaries {res['plan_full']} "
        f"devices {res['devices']}; executed at depth {cfg.num_layers}: "
        f"{res['boundaries']} (stage lengths {lens})")
    log(f"[split] launches in the run: {counts} (expected {expect}; "
        f"stage_mlp_block {per_step} per step = M x (2 x (L - len_last) + "
        f"len_last))")
    log(f"[split] held-out loss {res['eval_loss']:.6f} (flash kernel) vs "
        f"{dense:.6f} (dense), |diff| {gap:.3e} (limit {EVAL_ATOL:g})")
    log(f"[time] pipelined step (bf16 compute, f32 master weights, {tokens} "
        f"tokens): {['%.3f' % s for s in secs]} s; median after warm-up "
        f"{med:.3f} s, {tokens / med:.1f} tokens/s; loss first {losses[0]:.4f} "
        f"last {losses[-1]:.4f}; held-out loss call {res['eval_seconds']:.3f} s; "
        f"whole launcher run {wall:.3f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return counts, flash_err, res["plan_full"]


def _eval_flash_check(torch, res):
    """The flash kernel against flash_attention_ref on the q, k, v of every
    attention call of one held-out loss call (the main path's shapes and
    data). The calls are recorded by wrapping the kernel's entry point for
    one more ``impl="pallas"`` loss call; its launches do not count for
    the main path. Returns the largest error."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M

    saved, entry = FA.launches, FA.flash_attention
    calls = []

    def recording(q, k, v, **kw):
        out = entry(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    FA.flash_attention = recording
    try:
        with torch.no_grad():
            M.loss_fn(res["params"], res["eval_batch"], res["cfg"],
                      impl="pallas", compute_dtype=torch.bfloat16)
    finally:
        FA.flash_attention = entry
        FA.launches = saved
    cfg, batch = res["cfg"], res["eval_batch"]
    if len(calls) != cfg.num_layers:
        raise AssertionError(f"{len(calls)} flash calls in one loss call")
    rows, seq = batch["tokens"].shape
    if "frontend" in batch:  # the features are a prefix of the sequence
        seq += batch["frontend"].shape[1]
    shape = (rows, seq, cfg.num_heads, cfg.head_dim)
    worst, atol = 0.0, FLASH_ATOL["bfloat16"]
    for n, (q, k, v, kw, out) in enumerate(calls):
        if q.dtype != torch.bfloat16 or tuple(q.shape) != shape:
            raise AssertionError(f"eval attention call {n}: q {q.dtype} "
                                 f"{tuple(q.shape)}")
        with torch.no_grad():
            ref = FA.flash_attention_ref(q, k, v, **kw)
        err = float((out.float() - ref.float()).abs().max())
        if not torch.isfinite(out.float()).all() or err > atol:
            raise AssertionError(f"flash_attention on eval call {n}: max|err| "
                                 f"{err} > {atol}")
        worst = max(worst, err)
    log(f"[check] flash_attention on the {len(calls)} attention calls of one "
        f"held-out loss call (q {tuple(calls[0][0].shape)}, k "
        f"{tuple(calls[0][1].shape)}, bf16): max|err| {worst:.3e} (atol {atol:g})")
    return worst


def _run_launcher(torch, argv):
    """``launch.train_mhsl_rl.main(argv)`` with every kernel's launch count
    set to 0 just before and read just after. Returns the counts, the
    launcher's result and the run's wall seconds."""
    from repro_torch.launch import train_mhsl_rl as RUN

    _reset_counts()
    t0 = time.perf_counter()
    res = RUN.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = RUN.kernel_launches()
    if counts != res["launches"]:
        raise AssertionError(f"counters {counts} vs the launcher's "
                             f"{res['launches']}")
    return counts, res, wall


def _expected_ca(res, args):
    """ca_attention launches of a launcher run's plan phase: the batched
    rollouts and gradient steps of ``train_sac`` and one planning episode."""
    from repro_torch.core.agents.sac import SACConfig
    from repro_torch.launch import train_mhsl_rl as RUN

    env, train = res["env"], res["train"]
    chunks = math.ceil(args.episodes / args.num_envs)
    upd_chunks = sum(1 for c in range(chunks)
                     if c * args.num_envs >= RUN.WARMUP_EPISODES)
    if upd_chunks < 1 or len(train.metrics) != upd_chunks:
        raise AssertionError(f"{len(train.metrics)} updating chunks, expected "
                             f"{upd_chunks} (>= 1)")
    n_updates = SACConfig().updates_per_step * env.episode_len * args.num_envs
    return upd_chunks * (n_updates + env.episode_len) + env.episode_len


def _expect_config(cfg, args, full_depth=False):
    """The executed config is the arch's published one (every width) at
    the run's depth, or at its full depth."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train_mhsl_rl as RUN

    depth = get_config(args.arch).num_layers if full_depth else args.depth
    if args.reduced or cfg != RUN.executed_config(args.arch, depth, reduced=False):
        raise AssertionError(f"executed {cfg}, not {args.arch} at published "
                             f"widths and depth {depth}")


def _check_launcher_result(torch, res, args):
    """The plan covers the executed depth; every step's loss, the held-out
    loss and every trained parameter are finite, and the parameters live
    on the card."""
    from repro_torch.tree import tree_leaves

    cfg = res["cfg"]
    if res["boundaries"][-1] != cfg.num_layers:
        raise AssertionError(f"executed {cfg.name} {res['boundaries']}")
    losses = res["losses"]
    if len(losses) != args.pipeline_steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"pipeline losses {losses}")
    if not math.isfinite(res["eval_loss"]):
        raise AssertionError(f"held-out loss {res['eval_loss']}")
    for leaf in tree_leaves(res["params"]):
        if leaf.device.type != "cuda" or not torch.isfinite(leaf).all():
            raise AssertionError("trained parameter off the card or non-finite")


def _log_kernels(torch, prof, label, n=8):
    """Log the top device kernels of a profile by self device time; return
    every device kernel's record."""
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:n]:
        log(f"[trace]   {label} kernel {e.key[:70]}: {e.count}x, "
            f"{e.self_device_time_total / 1e3:.3f} ms device")
    return kern


def _step_trace(torch, card, res, args, label, must_see=(), must_not_see=()):
    """A torch.profiler trace of one pipelined train step (pipeline and
    AdamW) on the trained state: device busy share, kernels per step and
    the share of the kernels named in ``must_see`` (each must appear;
    none named in ``must_not_see`` may). Launches here do not count for
    the main path."""
    from repro_torch.launch import train_mhsl_rl as RUN

    saved = _counts()
    cfg = res["cfg"]
    step = RUN.make_pipeline_train_step(cfg, res["boundaries"], args.microbatches,
                                        res["pipe"], res["opt"])
    gen = torch.Generator(device="cuda").manual_seed(9)
    toks, labs = (torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                                generator=gen, device="cuda") for _ in range(2))
    params, opt_state = res["params"], res["opt_state"]
    res["params"] = res["opt_state"] = None
    with _traced(torch) as prof:
        t0 = time.perf_counter()
        params, opt_state, loss, _ = step(params, opt_state, toks, labs)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    res["params"], res["opt_state"] = params, opt_state
    _reset_counts(saved)
    kern = _log_kernels(torch, prof, label)
    dev_us = sum(e.self_device_time_total for e in kern)
    seen_us = sum(e.self_device_time_total for e in kern
                  if any(n in e.key for n in must_see))
    missing = [n for n in must_see if not any(n in e.key for e in kern)]
    banned = sorted({e.key for e in kern if any(n in e.key for n in must_not_see)})
    if dev_us == 0 or missing or banned:
        raise AssertionError(f"the profiler saw {dev_us} us of device time in "
                             f"the pipelined step; missing {missing}, present "
                             f"but not allowed {banned}")
    named = (f"; {'/'.join(must_see)} {seen_us / 1e3:.3f} ms "
             f"({seen_us / dev_us:.3f} of device time)" if must_see else "")
    log(f"[trace] {label}: one pipelined train step (profiled, loss "
        f"{float(loss):.4f}): {host_s * 1e3:.3f} ms host, {dev_us / 1e3:.3f} ms "
        f"device busy, busy share {dev_us / 1e6 / host_s:.3f}; "
        f"{sum(e.count for e in kern)} kernels{named} [{card}]")


def phase_split_parity(torch):
    """One f32 pipelined step (stage kernel route, 2 stages of one layer)
    against the loss and the gradients ``make_train_step`` hands its
    optimizer, at Qwen2.5-3B widths and depth 2."""
    import numpy as np

    from repro_torch.core.pipeline import PipelineConfig, pipeline_step_fn
    from repro_torch.kernels import stage_block as SB
    from repro_torch.launch import train_mhsl_rl as RUN
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map

    saved = SB.launches
    cfg = RUN.executed_config("qwen2.5-3b", 2, reduced=False)
    params = M.init_params(torch.Generator(device="cuda").manual_seed(3), cfg,
                           device="cuda")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 128))).cuda()
             for k in ("tokens", "labels")}
    step = pipeline_step_fn(cfg, (1, 2), 2, pipe=PipelineConfig(
        stage_impl="pallas", compute_dtype="float32"))
    loss, grads = step(params, batch["tokens"], batch["labels"])

    seen = []

    class Capture:
        """An optimizer that keeps the gradients and updates nothing."""

        def update(self, g, state, params_):
            seen.append(g)
            return tree_map(torch.zeros_like, g), state

    _, _, metrics = M.make_train_step(cfg, Capture(),
                                      compute_dtype=torch.float32)(params, None, batch)
    ref_loss = float(metrics["loss"])
    worst = _hold_grads(torch, float(loss), ref_loss, grads, seen[0],
                        PARITY_LOSS_RTOL, PARITY_GRAD_REL, "pipelined f32 step")
    SB.launches = saved
    log(f"[check] pipelined f32 step (depth 2, stages (1, 2), M = 2) vs "
        f"make_train_step: loss {float(loss):.7f} vs {ref_loss:.7f}; grads "
        f"max|err|/max|ref| {worst:.3e} over {len(tree_leaves(grads))} leaves "
        f"(limit {PARITY_GRAD_REL:g})")


# ---------------------------------------------------------------------------
# 5b. timings of the split executor's kernels
# ---------------------------------------------------------------------------


def stage_bound(rows, d, f, gated, x_elt, w_elt, flops_per_s):
    """Least time (ms) of one stage_mlp_block call: bytes (x and norm
    weight read once, the weights read once in their stored type, the
    output written once) over the HBM rate vs the three (two ungated)
    products over the operands' peak; the larger wins."""
    mats = 3 if gated else 2
    nbytes = 2 * rows * d * x_elt + d * w_elt + mats * d * f * w_elt
    flops = 2 * rows * d * f * mats
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def flash_bound(b, sq, skv, h, kh, hd, elt, flops_per_s, window=None,
                q_offset=0):
    """Least time (ms) of one flash_attention call: q, k, v read and o
    written once over the HBM rate vs 4 hd FLOPs (q.k and p v) for each
    (query, key) pair the causal window lets through; the larger wins."""
    pairs = 0
    for i in range(sq):
        hi = min(skv, q_offset + i + 1)
        lo = 0 if window is None else max(0, q_offset + i - window + 1)
        pairs += max(0, hi - lo)
    nbytes = elt * (2 * b * sq * h * hd + 2 * b * skv * kh * hd)
    flops = 4 * hd * pairs * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def _compare(torch, fns, iters, reps):
    """Graph-replay device time of each of ``fns`` in the order plain,
    kernel, kernel, plain (and any others after); medians per name."""
    order = ["plain", "kernel", "kernel", "plain"] + [n for n in fns
                                                      if n not in ("plain", "kernel")]
    times = {}
    with torch.no_grad():
        for name in order:
            times.setdefault(name, []).append(
                _time_graph_ms(torch, fns[name], iters=iters, reps=reps))
    return {k: statistics.median(v) for k, v in times.items()}


def phase_split_timing(torch, card):
    """Kernel, plain version and (for attention) the library yardstick at
    the split path's shapes. Launches here leave the counters as they
    were."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import stage_block as SB

    saved = (SB.launches, FA.launches)
    out = {}
    nw, params, x = _stage_inputs(torch, (2, 256), 2048, 11008, "swiglu",
                                  torch.bfloat16, seed=60)
    t = _compare(torch, {
        "kernel": lambda: SB.stage_mlp_block(nw, params, x, activation="swiglu"),
        "plain": lambda: SB.stage_mlp_block_ref(nw, params, x, activation="swiglu"),
    }, iters=10, reps=5)
    bound, by, nbytes, flops = stage_bound(512, 2048, 11008, True, 2, 4,
                                           BF16_FLOPS_PER_S)
    out["stage_mlp_block"] = dict(ms=t["kernel"], plain_ms=t["plain"],
                                  bound_ms=bound, bound_by=by, library_ms=None)
    log(f"[time] stage_mlp_block 512 rows D 2048 F 11008 swiglu, bf16 x, f32 "
        f"weights, device (graph replay): kernel {t['kernel']:.6f} ms "
        f"({flops / t['kernel'] / 1e9:.1f} TFLOP/s, {bound / t['kernel']:.3f} of "
        f"the bound), plain {t['plain']:.6f} ms; bound {bound:.6f} ms ({by}; "
        f"{nbytes} B, {flops} FLOP at bf16 peak) [{card}]")

    g = torch.Generator(device="cuda").manual_seed(61)
    q = torch.randn(8, 1024, 16, 128, generator=g, device="cuda").bfloat16()
    k = torch.randn(8, 1024, 2, 128, generator=g, device="cuda").bfloat16()
    v = torch.randn(8, 1024, 2, 128, generator=g, device="cuda").bfloat16()
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        lib_out = library()
        ref = FA.flash_attention_ref(q, k, v)
    lib_err = float((lib_out.transpose(1, 2).float() - ref.float()).abs().max())
    # SDPA rounds the probabilities to bf16 before p @ v, so it is held to
    # the same function only loosely: a yardstick, off the port's path
    if lib_err > 5e-2:
        raise AssertionError(f"the SDPA yardstick computes another function "
                             f"({lib_err})")
    t = _compare(torch, {
        "kernel": lambda: FA.flash_attention(q, k, v),
        "plain": lambda: FA.flash_attention_ref(q, k, v),
        "library": library,
    }, iters=10, reps=5)
    bound, by, nbytes, flops = flash_bound(8, 1024, 1024, 16, 2, 128, 2,
                                           BF16_FLOPS_PER_S)
    out["flash_attention"] = dict(ms=t["kernel"], plain_ms=t["plain"],
                                  bound_ms=bound, bound_by=by,
                                  library_ms=t["library"])
    log(f"[time] flash_attention B 8 S 1024 H 16/2 hd 128 causal bf16, device "
        f"(graph replay): kernel {t['kernel']:.6f} ms ({flops / t['kernel'] / 1e9:.1f} "
        f"TFLOP/s, {bound / t['kernel']:.3f} of the bound, "
        f"{t['kernel'] / t['library']:.2f}x SDPA), plain {t['plain']:.6f} ms, "
        f"SDPA {t['library']:.6f} ms (enable_gqa, max|diff| to plain "
        f"{lib_err:.3e}); bound {bound:.6f} ms ({by}; {nbytes} B, {flops} FLOP "
        f"at bf16 peak) [{card}]")
    # Nemotron-4-340B's head dim (192, GQA 96/8) on 1 x 1024 tokens: a
    # logged number beside SDPA, off the path's kernel record
    g = torch.Generator(device="cuda").manual_seed(62)
    q = torch.randn(1, 1024, 96, 192, generator=g, device="cuda").bfloat16()
    k = torch.randn(1, 1024, 8, 192, generator=g, device="cuda").bfloat16()
    v = torch.randn(1, 1024, 8, 192, generator=g, device="cuda").bfloat16()
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    t = _compare(torch, {
        "kernel": lambda: FA.flash_attention(q, k, v),
        "plain": lambda: FA.flash_attention_ref(q, k, v),
        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True),
    }, iters=10, reps=5)
    bound, by, nbytes, flops = flash_bound(1, 1024, 1024, 96, 8, 192, 2, BF16_FLOPS_PER_S)
    out["flash_attention_hd192"] = dict(ms=t["kernel"], library_ms=t["library"])
    log(f"[time] flash_attention B 1 S 1024 H 96/8 hd 192 causal bf16 (Nemotron-4-340B), "
        f"device (graph replay): kernel {t['kernel']:.6f} ms ({flops / t['kernel'] / 1e9:.1f} "
        f"TFLOP/s, {bound / t['kernel']:.3f} of the bound, {t['kernel'] / t['library']:.2f}x "
        f"SDPA), plain {t['plain']:.6f} ms, SDPA {t['library']:.6f} ms; bound {bound:.6f} ms "
        f"({by}; {nbytes} B, {flops} FLOP at bf16 peak) [{card}]")
    SB.launches, FA.launches = saved
    return out


# ---------------------------------------------------------------------------
# 3c. the SSM and MoE kernels against their plain versions
# ---------------------------------------------------------------------------

# (label, B, S, H, P, N, chunk). The first case has the shapes of the
# held-out evaluation's scans (Mamba2-370m, 8 x 1024 tokens).
SSD_CASES = [
    ("mamba2-370m", 8, 1024, 32, 64, 128, 64),
    ("ragged S=1000", 2, 1000, 32, 64, 128, 64),
    ("one chunk S=50", 2, 50, 32, 64, 128, 64),
    ("reduced widths", 2, 80, 16, 32, 16, 64),
    ("P=96 over 2 tiles", 1, 96, 2, 96, 8, 32),
    ("chunk 128 (runs at 64)", 2, 512, 8, 64, 128, 128),
    ("N 256 (two state tiles)", 2, 256, 8, 64, 256, 64),
]
# y and h_last each within SSD_REL * max|ref|. Both versions decay by
# exp(cum_i - cum_j) with cum the in-chunk cumulative sum of dt * a, which
# reaches ~-800 at these rates (a down to -16): the f32 rounding of cum,
# taken by a shuffle scan here and by torch.cumsum there, is ~5e-5
# absolute and enters the decays exponentially. Measured on an H100 80GB
# HBM3 at 700 W: up to 2.1e-5 of max|ref| (h_last of the one-chunk case)
SSD_REL = 1e-4

# (label, tokens, D, F, E, top-k, blk, activation, dtype). The first case
# is path (B)'s call (Qwen3-MoE-30B-A3B, 8 x 256 tokens, blocks of 128).
MOE_CASES = [
    ("qwen3-moe-30b-a3b", 2048, 2048, 768, 128, 8, 128, "swiglu", "bfloat16"),
    ("qwen3-moe-30b-a3b", 2048, 2048, 768, 128, 8, 128, "swiglu", "float32"),
    ("qwen3-moe-30b-a3b blk 32", 2048, 2048, 768, 128, 8, 32, "swiglu", "bfloat16"),
    ("relu2", 96, 256, 384, 8, 2, 32, "relu2", "bfloat16"),
    ("relu2", 96, 256, 384, 8, 2, 32, "relu2", "float32"),
    ("gelu", 96, 256, 384, 8, 2, 8, "gelu", "bfloat16"),
    ("gelu", 96, 256, 384, 8, 2, 8, "gelu", "float32"),
    ("silu", 96, 256, 384, 8, 2, 128, "silu", "bfloat16"),
    ("silu", 96, 256, 384, 8, 2, 128, "silu", "float32"),
    ("gelu f16", 96, 256, 384, 8, 2, 32, "gelu", "float16"),
    ("swiglu f16", 96, 256, 384, 8, 2, 8, "swiglu", "float16"),
]
# forward within MOE_REL[dtype] * max|ref|. f32: sums over D = 2048 then
# F = 768 terms in another order. bf16: g, u, h and the output round to
# bf16 at the Pallas points, and the kernel takes the activation in f32
# and rounds once where the plain version rounds per operation, so an
# element may sit one or two bf16 ulps (2^-8 relative) away; f16 the same
# in f16 ulps (2^-11).
MOE_REL = {"float32": 1e-5, "bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}
# gradients through the wrapper: its backward is autograd of the plain
# version, the code the reference differentiates, so 1e-5 per leaf
MOE_BWD_REL = 1e-5


def _ssd_inputs(torch, b, s, h, p, n, seed):
    """Scan inputs as a Mamba block makes them: dt = softplus(N(0, 1)),
    a = -linspace(1, 16, H) (``init_mamba``'s rates), x, b, c ~ N(0, 1)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g, device="cuda")
    dt = F.softplus(torch.randn(b, s, h, generator=g, device="cuda"))
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    bm = torch.randn(b, s, n, generator=g, device="cuda")
    cm = torch.randn(b, s, n, generator=g, device="cuda")
    return x, dt, a, bm, cm


def _ssd_compare(torch, out, ref, what):
    """Max |err| of the kernel's (y, h_last) against the plain version's,
    each held to SSD_REL of its largest entry."""
    worst = 0.0
    for name, a, r in zip(("y", "h_last"), out, ref):
        if a.shape != r.shape or a.dtype != torch.float32:
            raise AssertionError(f"ssd_scan {what} {name}: {a.dtype} "
                                 f"{tuple(a.shape)}")
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite ssd_scan {name} ({what})")
        err = float((a - r).abs().max())
        lim = SSD_REL * float(r.abs().max())
        if err > lim:
            raise AssertionError(f"ssd_scan {what} {name}: {err} > {lim}")
        worst = max(worst, err)
    return worst


def phase_ssd_checks(torch):
    """ssd_scan kernel vs ssd_scan_ref on the card (forward only; the
    wrapper raises under autograd). Returns the main case's max error."""
    from repro_torch.kernels import ssd_scan as SK

    saved = SK.launches
    main_err = None
    for n, (label, b, s, h, p, nst, chunk) in enumerate(SSD_CASES):
        x, dt, a, bm, cm = _ssd_inputs(torch, b, s, h, p, nst, seed=70 + n)
        with torch.no_grad():
            before = SK.launches
            out = SK.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
            ref = SK.ssd_scan_ref(x, dt, a, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        if SK.launches != before + -(-nst // SK.MAX_STATE):
            raise AssertionError("ssd_scan did not count its launches (one per state tile)")
        err = _ssd_compare(torch, out, ref, label)
        main_err = err if main_err is None else main_err
        log(f"[check] ssd_scan {label:18s} B {b} S {s} H {h} P {p} N {nst} "
            f"chunk {chunk}: max|err| y/h {err:.3e} (limit {SSD_REL:g} x "
            f"max|ref|; max|y| {float(ref[0].abs().max()):.3f}, max|h| "
            f"{float(ref[1].abs().max()):.3f})")
    x = x.requires_grad_(True)
    try:
        SK.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    except RuntimeError:
        pass
    else:
        raise AssertionError("ssd_scan ran under autograd")
    SK.launches = saved
    return main_err


def _moe_case_config(d, f, e, k, activation):
    from dataclasses import replace

    from repro_torch.configs import get_config

    base = get_config("qwen3-moe-30b-a3b")
    return replace(base, d_model=d, activation=activation,
                   moe=replace(base.moe, num_experts=e, top_k=k, expert_d_ff=f))


def _dropless_buffer(torch, params, x, cfg, blk):
    """The dropless dispatch's block-padded buffer of ``x`` (T, D) under
    ``params``' router: ``(buf, block_eid, routed rows, experts used)``."""
    from repro_torch.models import layers as L

    _, ids, _ = L._moe_route(params, x, cfg)
    order, dest, p_rows, block_eid = L.dropless_layout(ids, cfg.moe.num_experts,
                                                       blk)
    buf = x.new_zeros((p_rows, x.shape[1])).index_copy(
        0, dest, x[order // cfg.moe.top_k])
    return buf, block_eid, ids.numel(), int(torch.unique(ids).numel())


def phase_moe_checks(torch):
    """grouped_moe_ffn kernel vs grouped_ffn_reference on the card, on
    buffers laid out by a random router's routing, forward; and gradients
    through the wrapper against autograd of the plain version. Returns the
    main case's max error."""
    from repro_torch.kernels import moe_dispatch as MD
    from repro_torch.models import layers as L

    saved = MD.launches
    main_err = None
    for n, (label, t, d, f, e, k, blk, act, dn) in enumerate(MOE_CASES):
        dtype = getattr(torch, dn)
        cfg = _moe_case_config(d, f, e, k, act)
        g = torch.Generator(device="cuda").manual_seed(80 + n)
        params = L.init_moe(g, cfg, device="cuda")  # f32 weights
        x = torch.randn(t, d, generator=g, device="cuda").to(dtype)
        buf, eid, rows, used = _dropless_buffer(torch, params, x, cfg, blk)
        wg = params.get("w_gate")
        with torch.no_grad():
            before = MD.launches
            out = MD.grouped_moe_ffn(buf, eid, params, activation=act)
            ref = MD.grouped_ffn_reference(buf, eid, wg, params["w_up"],
                                           params["w_down"], act)
        torch.cuda.synchronize()
        if MD.launches != before + 1:
            raise AssertionError("grouped_moe_ffn did not count its launch")
        if out.dtype != dtype or out.shape != buf.shape:
            raise AssertionError(f"grouped_moe_ffn out {out.dtype} {tuple(out.shape)}")
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"non-finite grouped_moe_ffn output ({label})")
        pad = buf.float().abs().sum(-1) == 0
        if float(out[pad].float().abs().max()) != 0.0:
            raise AssertionError("a zero (padding) row gave a non-zero output")
        err = float((out.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        lim = MOE_REL[dn] * top
        if err > lim:
            raise AssertionError(f"grouped_moe_ffn {label} {dn}: {err} > {lim}")
        main_err = err if main_err is None else main_err
        bwd = ""
        if d <= 256:
            bwd = _moe_grad_check(torch, MD, buf, eid, params, act)
        log(f"[check] grouped_moe_ffn {label:24s} {rows} routed rows in "
            f"{buf.shape[0]} (blk {blk}, {used}/{e} experts) D {d} F {f} "
            f"{act:6s} {dn:8s}: fwd max|err| {err:.3e} (limit {lim:.3e}, "
            f"max|ref| {top:.3f}){bwd}")
        del params, x, buf, out, ref
    MD.launches = saved
    return main_err


def _moe_grad_check(torch, MD, buf, eid, params, act):
    gy = torch.randn(buf.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(5), device="cuda").to(buf.dtype)
    names = sorted(params.keys() - {"router"})

    def grads(fn):
        p = {k: params[k].detach().requires_grad_(True) for k in names}
        b = buf.detach().requires_grad_(True)
        return torch.autograd.grad(fn(b, p), [b] + [p[k] for k in names], gy)

    gk = grads(lambda b, p: MD.grouped_moe_ffn(b, eid, p, activation=act))
    gr = grads(lambda b, p: MD.grouped_ffn_reference(
        b, eid, p.get("w_gate"), p["w_up"], p["w_down"], act))
    worst = 0.0
    for name, a, r in zip(["buf"] + names, gk, gr):
        top = float(r.float().abs().max())
        e = float((a.float() - r.float()).abs().max())
        if not torch.isfinite(a.float()).all() or e > MOE_BWD_REL * top:
            raise AssertionError(f"grouped_moe_ffn grad {name} ({act}): {e} > "
                                 f"{MOE_BWD_REL} x {top}")
        worst = max(worst, e / max(top, 1e-30))
    return f"; bwd max|err|/max|ref| {worst:.3e} (limit {MOE_BWD_REL:g})"


# ---------------------------------------------------------------------------
# 4c. (A) Mamba2-370m through the launcher, depth 24 of 48
# ---------------------------------------------------------------------------

# the launcher's arguments: Mamba2-370m at its published widths, depth 24
# of its 48 layers (a cut for the smoke's time; (M4c) and S3 run all 48);
# a short SAC run on its 48-layer profile; 4 stages,
# M = 4 microbatches of 2 x 256 tokens, 4 steps; 8 x 1024 held-out tokens
MAMBA_ARGV = ["--arch", "mamba2-370m", "--episodes", "24", "--num-envs", "8",
              "--pipeline-steps", "4", "--stages", "4", "--depth", "24",
              "--microbatches", "4", "--batch", "8", "--seq", "256",
              "--eval-batch", "8", "--eval-seq", "1024", "--seed", "0"]
# held-out loss through the scan kernel vs the ssd_chunked route
# (impl="auto") on the same params and tokens, bf16 compute. The two
# scans are different f32 formulas (exp of a difference of cumulative
# sums vs exp of segment sums), and every block rounds its scan output
# to bf16, so an ulp-level difference flips bf16 roundings that the
# layers carry on: measured 3.64e-4 nats apart (of 11.04) at 48 layers on
# an H100 80GB HBM3 at 700 W; held at 2e-3. The kernel itself is held to
# its plain version on each of the scans (SSD_REL).
MAMBA_EVAL_ATOL = 2e-3


def phase_mamba(torch, card):
    """(A): the launcher on Mamba2-370m at depth 24, counters at 0 just
    before and read just after; the scan kernel held to its plain version
    on every scan of one held-out call; the loss held to the ssd_chunked
    route's."""
    from repro_torch.launch import train_mhsl_rl as RUN
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    args = RUN.parse_args(MAMBA_ARGV)
    torch.cuda.reset_peak_memory_stats()
    counts, res, wall = _run_launcher(torch, MAMBA_ARGV)
    cfg = res["cfg"]
    expect = {"ca_attention": _expected_ca(res, args), "stage_mlp_block": 0,
              "flash_attention": 0, "ssd_scan": cfg.num_layers,
              "grouped_moe_ffn": 0}
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    _expect_config(cfg, args)
    _check_launcher_result(torch, res, args)
    n_params = sum(t.numel() for t in tree_leaves(res["params"]))
    peak = torch.cuda.max_memory_allocated() / 2**30

    ssd_err = _eval_ssd_check(torch, res)
    with torch.no_grad():
        _, (chunked, _) = M.loss_fn(res["params"], res["eval_batch"], cfg,
                                    impl="auto", compute_dtype=torch.bfloat16)
    chunked = float(chunked)
    gap = abs(res["eval_loss"] - chunked)
    if gap > MAMBA_EVAL_ATOL:
        raise AssertionError(f"held-out loss ssd_scan {res['eval_loss']} vs "
                             f"ssd_chunked {chunked}: |diff| {gap} > "
                             f"{MAMBA_EVAL_ATOL}")
    _eval_trace(torch, card, res, "mamba", "ssd_scan_tc", count=cfg.num_layers,
                must_not_see=RETIRED["ssd_scan"])
    _step_trace(torch, card, res, args, "mamba")

    secs = res["step_seconds"]
    med = statistics.median(secs[1:])
    tokens = args.batch * args.seq
    log(f"[mamba] plan on the 48-layer profile: boundaries {res['plan_full']} "
        f"devices {res['devices']}; executed {res['boundaries']} of "
        f"{cfg.num_layers} layers, {n_params} parameters")
    log(f"[mamba] launches in the run: {counts} (expected {expect}: ssd_scan "
        f"once per layer in the held-out loss; the pipelined steps train "
        f"through ssd_chunked, and Mamba blocks have no MLP, so "
        f"stage_mlp_block launches 0 times)")
    log(f"[mamba] held-out loss {res['eval_loss']:.6f} (ssd_scan) vs "
        f"{chunked:.6f} (ssd_chunked), |diff| {gap:.3e} (limit "
        f"{MAMBA_EVAL_ATOL:g})")
    log(f"[time] mamba pipelined step (bf16 compute, f32 master weights, "
        f"{tokens} tokens): {['%.3f' % s for s in secs]} s; median after "
        f"warm-up {med:.3f} s, {tokens / med:.1f} tokens/s; loss first "
        f"{res['losses'][0]:.4f} last {res['losses'][-1]:.4f}; held-out loss "
        f"call {res['eval_seconds']:.3f} s; whole launcher run {wall:.3f} s; "
        f"peak memory {peak:.2f} GiB [{card}]")
    return counts, ssd_err


def _eval_ssd_check(torch, res):
    """The scan kernel against ssd_scan_ref on the inputs of every scan of
    one held-out loss call (the main path's shapes and data), recorded by
    wrapping the kernel's entry point for one more ``impl="pallas"`` loss
    call; its launches do not count for the main path. Returns the
    largest error."""
    from repro_torch.kernels import ssd_scan as SK
    from repro_torch.models import model as M

    saved, entry = SK.launches, SK.ssd_scan
    calls = []

    def recording(x, dt, a, b, c, **kw):
        out = entry(x, dt, a, b, c, **kw)
        calls.append(((x, dt, a, b, c), kw, out))
        return out

    SK.ssd_scan = recording
    try:
        with torch.no_grad():
            M.loss_fn(res["params"], res["eval_batch"], res["cfg"],
                      impl="pallas", compute_dtype=torch.bfloat16)
    finally:
        SK.ssd_scan = entry
        SK.launches = saved
    cfg = res["cfg"]
    if len(calls) != cfg.num_layers:
        raise AssertionError(f"{len(calls)} scans in one loss call")
    shape = (*res["eval_batch"]["tokens"].shape, cfg.ssm.num_heads(cfg.d_model),
             cfg.ssm.head_dim)
    worst = 0.0
    for n, (inputs, kw, out) in enumerate(calls):
        if (tuple(inputs[0].shape) != shape or kw != {"chunk": cfg.ssm.chunk}
                or inputs[0].dtype != torch.float32):
            raise AssertionError(f"eval scan {n}: x {inputs[0].dtype} "
                                 f"{tuple(inputs[0].shape)} {kw}")
        with torch.no_grad():
            ref = SK.ssd_scan_ref(*inputs, **kw)
        worst = max(worst, _ssd_compare(torch, out, ref, f"eval scan {n}"))
    log(f"[check] ssd_scan on the {len(calls)} scans of one held-out loss call "
        f"(x {tuple(calls[0][0][0].shape)}, N {calls[0][0][3].shape[-1]}, f32): "
        f"max|err| {worst:.3e} (limit {SSD_REL:g} x max|ref|)")
    return worst


def _eval_trace(torch, card, res, label, kernel, count=None, must_not_see=()):
    """A torch.profiler trace of one held-out loss call: device busy share
    and the named kernel's share of the device time; with ``count``, the
    number of its launches must be that, and no kernel named in
    ``must_not_see`` may run. Launches here do not count for the main
path. A trace short of ``count`` is retaken (``TRACE_ATTEMPTS``)."""
    from repro_torch.models import model as M

    saved = _counts()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with _traced(torch) as prof:
            t0 = time.perf_counter()
            with torch.no_grad():
                M.loss_fn(res["params"], res["eval_batch"], res["cfg"],
                          impl="pallas", compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        kern = _log_kernels(torch, prof, f"{label} eval")
        dev_us = sum(e.self_device_time_total for e in kern)
        k_us = sum(e.self_device_time_total for e in kern if kernel in e.key)
        k_n = sum(e.count for e in kern if kernel in e.key)
        banned = sorted({e.key for e in kern if any(n in e.key for n in must_not_see)})
        short = count is not None and k_n < count and not banned
        if not short or attempt == TRACE_ATTEMPTS:
            break
        log(f"[trace] {label}: attempt {attempt} saw {k_n} of {count} {kernel} "
            f"launches, {dev_us / 1e3:.3f} ms device busy in "
            f"{sum(e.count for e in kern)} kernels; retaking the trace")
    _reset_counts(saved)
    if dev_us == 0 or k_us == 0 or (count is not None and k_n != count) or banned:
        raise AssertionError(f"the profiler saw {dev_us} us of device time, "
                             f"{k_us} us of it in {k_n} launches of {kernel} "
                             f"(expected {count}), not allowed: {banned}, in the "
                             f"held-out call")
    log(f"[trace] {label}: one held-out loss call (profiled, attempt {attempt}): "
        f"{host_s * 1e3:.3f} ms host, {dev_us / 1e3:.3f} ms device busy, busy share "
        f"{dev_us / 1e6 / host_s:.3f}; {sum(e.count for e in kern)} kernels; "
        f"{kernel} {k_n}x, {k_us / 1e3:.3f} ms ({k_us / dev_us:.3f} of device "
        f"time) [{card}]")


# ---------------------------------------------------------------------------
# 4d. (B) one Qwen3-MoE-30B-A3B MoE layer at full width
# ---------------------------------------------------------------------------

MOE_LAYER_TOKENS = (8, 256)
# the two dropless routes' layer outputs (bf16) within
# MOE_LAYER_REL * max|reference|: the grouped outputs differ by an ulp or
# two (MOE_REL) and the combine sums 8 gated choices
MOE_LAYER_REL = 2.0 ** -6


def _moe_layer_inputs(torch):
    """Path (B)'s layer: the published config, f32 expert weights and
    router from a seed, 8 x 256 bf16 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config("qwen3-moe-30b-a3b")
    g = torch.Generator(device="cuda").manual_seed(90)
    params = L.init_moe(g, cfg, device="cuda")
    x = torch.randn(*MOE_LAYER_TOKENS, cfg.d_model, generator=g,
                    device="cuda").bfloat16()
    return cfg, params, x


def phase_moe_layer(torch, card):
    """(B): ``moe_apply_dropless(impl="pallas")`` with every counter at 0
    just before and read just after; the reference route and the capacity
    dispatch on the same tokens, and each route's time per call."""
    from repro_torch.models import layers as L

    cfg, params, x = _moe_layer_inputs(torch)
    _reset_counts()
    with torch.no_grad():
        y_k, aux_k = L.moe_apply_dropless(params, x, cfg, impl="pallas")
    torch.cuda.synchronize()
    counts = _counts()
    expect = {"ca_attention": 0, "stage_mlp_block": 0, "flash_attention": 0,
              "ssd_scan": 0, "grouped_moe_ffn": 1}
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    with torch.no_grad():
        y_r, aux_r = L.moe_apply_dropless(params, x, cfg, impl="reference")
        y_c, aux_c = L.moe_apply(params, x, cfg)
    for name, y in (("pallas", y_k), ("reference", y_r), ("capacity", y_c)):
        if y.dtype != torch.bfloat16 or y.shape != x.shape:
            raise AssertionError(f"MoE layer {name}: {y.dtype} {tuple(y.shape)}")
        if not torch.isfinite(y.float()).all():
            raise AssertionError(f"non-finite MoE layer output ({name})")
    if float(aux_k) != float(aux_r) or not math.isfinite(float(aux_c)):
        raise AssertionError(f"router aux {float(aux_k)} / {float(aux_r)} / "
                             f"{float(aux_c)}")
    top = float(y_r.float().abs().max())
    err = float((y_k.float() - y_r.float()).abs().max())
    lim = MOE_LAYER_REL * top
    if err > lim:
        raise AssertionError(f"dropless kernel route vs reference: {err} > {lim}")
    cap = float((y_c.float() - y_r.float()).abs().max())
    saved = _counts()
    t = {name: _time_ms(torch, lambda impl=impl: L.moe_apply_dropless(
        params, x, cfg, impl=impl), iters=5, reps=3)
        for name, impl in (("pallas", "pallas"), ("reference", "reference"))}
    t["capacity"] = _time_ms(torch, lambda: L.moe_apply(params, x, cfg),
                             iters=5, reps=3)
    _reset_counts(saved)
    tokens = MOE_LAYER_TOKENS[0] * MOE_LAYER_TOKENS[1]
    log(f"[moe-layer] Qwen3-MoE-30B-A3B layer (E {cfg.moe.num_experts}, top-"
        f"{cfg.moe.top_k}, D {cfg.d_model}, F {cfg.moe.expert_d_ff}), {tokens} "
        f"bf16 tokens: launches {counts} (expected {expect})")
    log(f"[moe-layer] dropless kernel route vs reference route: max|diff| "
        f"{err:.3e} (limit {lim:.3e}, max|ref| {top:.3f}); capacity "
        f"(factor {cfg.moe.capacity_factor}) vs dropless: max|diff| {cap:.3e} "
        f"(dropped choices; printed, not held); aux {float(aux_r):.6f}")
    log(f"[time] MoE layer per call (CUDA events over back-to-back eager "
        f"calls): dropless kernel route {t['pallas']:.3f} ms, dropless "
        f"reference route {t['reference']:.3f} ms, capacity {t['capacity']:.3f} "
        f"ms [{card}]")
    _moe_layer_trace(torch, card, params, x, cfg)
    return counts, err


def _moe_layer_trace(torch, card, params, x, cfg):
    """A torch.profiler trace of one kernel-route layer call: the grouped
    FFN runs as the two ``wgmma`` GEMM grids (up + activation, down) and
    none of the FMA body's grids. Launches here do not count for the main
    path. A trace short of the two grids is retaken (``TRACE_ATTEMPTS``)."""
    from repro_torch.models import layers as L

    saved = _counts()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with _traced(torch) as prof:
            t0 = time.perf_counter()
            with torch.no_grad():
                L.moe_apply_dropless(params, x, cfg, impl="pallas")
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        kern = _log_kernels(torch, prof, "moe-layer")
        dev_us = sum(e.self_device_time_total for e in kern)
        tc = [e for e in kern if "grouped_gemm_tc" in e.key]
        tc_us = sum(e.self_device_time_total for e in tc)
        fma = sorted({e.key for e in kern if "::up_act<" in e.key or "::down<" in e.key})
        if sum(e.count for e in tc) >= 2 or fma or attempt == TRACE_ATTEMPTS:
            break
        log(f"[trace] moe-layer: attempt {attempt} saw {sum(e.count for e in tc)} "
            f"of 2 grouped_gemm_tc launches, {dev_us / 1e3:.3f} ms device busy in "
            f"{sum(e.count for e in kern)} kernels; retaking the trace")
    _reset_counts(saved)
    if dev_us == 0 or sum(e.count for e in tc) != 2 or fma:
        raise AssertionError(f"the profiler saw {dev_us} us of device time, "
                             f"{sum(e.count for e in tc)} grouped_gemm_tc launches "
                             f"(expected 2), FMA grids {fma}, in the (B) call")
    log(f"[trace] moe-layer: one dropless kernel-route call (profiled, attempt "
        f"{attempt}): "
        f"{host_s * 1e3:.3f} ms host, {dev_us / 1e3:.3f} ms device busy; "
        f"{sum(e.count for e in kern)} kernels; grouped_gemm_tc 2x, "
        f"{tc_us / 1e3:.3f} ms ({tc_us / dev_us:.3f} of device time); no "
        f"up_act/down grid [{card}]")


# ---------------------------------------------------------------------------
# 4e. (C) Qwen3-MoE-30B-A3B through the launcher, depth 2
# ---------------------------------------------------------------------------

# Qwen3-MoE-30B-A3B at its published widths, depth cut to 2 layers on 2
# stages: each layer holds 623 M parameters and the untied embedding and
# head 0.62 B, and the AdamW step holds the f32 params, gradients, clipped
# gradients, old and new moments and the updates at once (8 copies), so
# depth 4 would need ~99 GB; depth 2 needs ~60 GB
# (2 stages make a 3-step MHSL episode, so the plan phase takes 64 episodes
# in chunks of 32 for its replay buffer to hold a SAC batch of 128 when
# updates start)
MOE_ARGV = ["--arch", "qwen3-moe-30b-a3b", "--episodes", "64", "--num-envs", "32",
            "--pipeline-steps", "4", "--stages", "2", "--depth", "2",
            "--microbatches", "4", "--batch", "8", "--seq", "256",
            "--eval-batch", "8", "--eval-seq", "1024", "--seed", "0"]


def phase_moe_model(torch, card):
    """(C): the launcher on Qwen3-MoE-30B-A3B, counters at 0 just before
    and read just after. Training and the held-out loss take the dropless
    reference route (the model's default), so grouped_moe_ffn launches 0
    times; flash_attention once per layer of the held-out loss."""
    from repro_torch.launch import train_mhsl_rl as RUN
    from repro_torch.tree import tree_leaves

    args = RUN.parse_args(MOE_ARGV)
    torch.cuda.reset_peak_memory_stats()
    counts, res, wall = _run_launcher(torch, MOE_ARGV)
    cfg = res["cfg"]
    expect = {"ca_attention": _expected_ca(res, args), "stage_mlp_block": 0,
              "flash_attention": cfg.num_layers, "ssd_scan": 0,
              "grouped_moe_ffn": 0}
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    _expect_config(cfg, args)
    _check_launcher_result(torch, res, args)
    n_params = sum(t.numel() for t in tree_leaves(res["params"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    _step_trace(torch, card, res, args, "moe")
    secs = res["step_seconds"]
    med = statistics.median(secs[1:])
    tokens = args.batch * args.seq
    log(f"[moe] plan on the 48-layer profile: boundaries {res['plan_full']} "
        f"devices {res['devices']}; executed {res['boundaries']} of "
        f"{cfg.num_layers} layers, {n_params} parameters")
    log(f"[moe] launches in the run: {counts} (expected {expect}: the MoE "
        f"halves take moe_apply_dropless's default reference route, so "
        f"grouped_moe_ffn launches 0 times and the stage kernel, which only "
        f"dense MLP halves take, 0 times)")
    log(f"[time] moe pipelined step (bf16 compute, f32 master weights, "
        f"{tokens} tokens): {['%.3f' % s for s in secs]} s; median after "
        f"warm-up {med:.3f} s, {tokens / med:.1f} tokens/s; loss first "
        f"{res['losses'][0]:.4f} last {res['losses'][-1]:.4f}; held-out loss "
        f"{res['eval_loss']:.4f} in {res['eval_seconds']:.3f} s; whole "
        f"launcher run {wall:.3f} s; peak memory {peak:.2f} GiB [{card}]")
    return counts



# ---------------------------------------------------------------------------
# 4e2. (H) Jamba-v0.1-52B at published widths, and (F) Pixtral-12B
# ---------------------------------------------------------------------------

# (H): depth 2 is Jamba's first two layers, "MM": Mamba + MoE (16
# experts, top-2), then Mamba + dense swiglu MLP, a period of 2; 2 stages
# of one layer, M = 4, 8 x 256 tokens, bf16 compute over f32 masters
JAMBA_DEPTH = 2
JAMBA_BOUNDS = (1, 2)
JAMBA_MICRO = 4
JAMBA_ROWS, JAMBA_SEQ = 8, 256
JAMBA_STEPS = 3
JAMBA_EVAL = (1, 1024)
# the pipelined (loss, grads) vs the unpipelined loss_and_grads, both bf16
# compute (the MoE router's aux weighted 0 on the unpipelined side, since
# the stage loss drops it): the pipeline's weight gradients are four bf16
# microbatch products summed in f32 where the unpipelined one is a
# single bf16 product over all 2 048 tokens, so they differ by bf16
# roundings
JAMBA_LOSS_RTOL = 1e-3
JAMBA_GRAD_REL = 2e-2
# the held-out loss through ssd_scan vs the ssd_chunked route, bf16
# compute: the (A) gate, set there for 48 layers
JAMBA_EVAL_ATOL = MAMBA_EVAL_ATOL


def _jamba_amam_parity(torch):
    """Reduced Jamba as ``AMAM`` at the uneven split (1, 4), f32, on the
    card: the pipelined step against the unpipelined loss_and_grads (the
    attention/Mamba mix on CUDA). The CPU parity case of
    tests/test_torch_mixed_pipeline.py."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import PipelineConfig, pipeline_step_fn
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                              num_layers=4, block_pattern="AMAM")
    params = M.init_params(torch.Generator(device="cuda").manual_seed(4), cfg,
                           device="cuda")
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))).cuda()
             for k in ("tokens", "labels")}
    loss, grads = pipeline_step_fn(cfg, (1, 4), 2, pipe=PipelineConfig(
        compute_dtype="float32"))(params, batch["tokens"], batch["labels"])
    (_, (ref_loss, _)), ref = M.loss_and_grads(params, batch, _no_aux(cfg),
                                               compute_dtype=torch.float32)
    worst = _hold_grads(torch, float(loss), float(ref_loss), grads, ref,
                        PARITY_LOSS_RTOL, PARITY_GRAD_REL, "reduced Jamba AMAM")
    log(f"[jamba] reduced AMAM at (1, 4), f32, on the card: pipelined loss "
        f"{float(loss):.7f} vs unpipelined {float(ref_loss):.7f}; grads "
        f"max|err|/max|ref| {worst:.3e} (limit {PARITY_GRAD_REL:g})")


def _no_aux(cfg):
    """``cfg`` with the MoE router's aux weighted 0: the pipelined stage
    loss drops aux, so its unpipelined reference must too."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            router_aux_weight=0.0))


def _hold_grads(torch, loss, ref_loss, grads, ref, loss_rtol, grad_rel, what):
    """Loss within ``loss_rtol`` and every gradient leaf's max|err| within
    ``grad_rel`` of its max|ref| (leaves on the card or the host). Returns
    the largest ratio."""
    from repro_torch.tree import tree_leaves

    if abs(loss - ref_loss) > loss_rtol * abs(ref_loss):
        raise AssertionError(f"{what}: pipelined loss {loss} vs {ref_loss}")
    worst = 0.0
    for a, r in zip(tree_leaves(grads), tree_leaves(ref)):
        a = a.to(r.device)
        if a.shape != r.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{what}: grad {tuple(a.shape)} vs {tuple(r.shape)}")
        top = float(r.abs().max())
        e = float((a - r).abs().max())
        if e > grad_rel * top:
            raise AssertionError(f"{what}: grad {tuple(r.shape)} max|err| {e} > "
                                 f"{grad_rel} x {top}")
        worst = max(worst, e / max(top, 1e-30))
    return worst


def phase_jamba(torch, card):
    """(H): Jamba-v0.1-52B at published widths, depth 2, on 2 stages. One
    pipelined (loss, grads) step (stage_impl "reference") held to the
    unpipelined loss_and_grads; three timed steps through the stage
    kernel and a held-out loss through the scan kernel, with every
    counter at 0 just before and read just after; peak memory. The
    optimizer is not run: its state does not fit beside the gradients."""
    import numpy as np

    from repro_torch.core.pipeline import PipelineConfig, pipeline_step_fn
    from repro_torch.launch import train_mhsl_rl as RUN
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    _jamba_amam_parity(torch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = RUN.executed_config("jamba-v0.1-52b", JAMBA_DEPTH, reduced=False)
    sig = M.signature(cfg)
    if cfg.block_pattern != "MM" or M.find_period(sig) != 2 or not sig[0][1]:
        raise AssertionError(f"Jamba at depth {JAMBA_DEPTH}: {cfg.block_pattern} {sig}")
    params = M.init_params(torch.Generator(device="cuda").manual_seed(5), cfg,
                           device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(5)
    tokens, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (JAMBA_ROWS, JAMBA_SEQ))).cuda() for _ in range(2))

    # 1. the pipelined step against the unpipelined one, bf16 compute
    saved = _counts()
    t0 = time.perf_counter()
    loss, grads = pipeline_step_fn(cfg, JAMBA_BOUNDS, JAMBA_MICRO, pipe=PipelineConfig(
        stage_impl="reference"))(params, tokens, labels)
    loss = float(loss)
    ref_s = time.perf_counter() - t0
    step_peak = torch.cuda.max_memory_allocated()
    grads = [g.cpu() for g in tree_leaves(grads)]  # room for the reference
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (_, (ref_loss, aux)), ref = M.loss_and_grads(
        params, {"tokens": tokens, "labels": labels}, _no_aux(cfg))
    ref_peak = torch.cuda.max_memory_allocated()
    ref = [r.cpu() for r in tree_leaves(ref)]
    torch.cuda.empty_cache()
    worst = _hold_grads(torch, loss, float(ref_loss), grads, ref, JAMBA_LOSS_RTOL,
                        JAMBA_GRAD_REL, "Jamba depth 2")
    rel = max(float(torch.linalg.vector_norm(a - r) / torch.linalg.vector_norm(r))
              for a, r in zip(grads, ref))
    del grads, ref
    _reset_counts(saved)

    # 2.-3. the path: three steps through the stage kernel, then a held-out
    # loss through the scan kernel
    step = pipeline_step_fn(cfg, JAMBA_BOUNDS, JAMBA_MICRO,
                            pipe=PipelineConfig(stage_impl="pallas"))
    eval_batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, JAMBA_EVAL)).cuda()
                  for k in ("tokens", "labels")}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    secs, losses = [], []
    for _ in range(JAMBA_STEPS):
        t0 = time.perf_counter()
        out = step(params, tokens, labels)
        losses.append(float(out[0]))  # waits for the step
        secs.append(time.perf_counter() - t0)
        del out
    t0 = time.perf_counter()
    with torch.no_grad():
        _, (eval_loss, _) = M.loss_fn(params, eval_batch, cfg, impl="pallas",
                                      compute_dtype=torch.bfloat16)
    eval_loss = float(eval_loss)
    eval_s = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    expect = {"ca_attention": 0, "stage_mlp_block": JAMBA_STEPS * JAMBA_MICRO,
              "flash_attention": 0, "ssd_scan": cfg.num_layers, "grouped_moe_ffn": 0}
    if counts != expect:
        raise AssertionError(f"Jamba launches {counts}, expected {expect}")
    if not all(map(math.isfinite, losses + [eval_loss])):
        raise AssertionError(f"Jamba losses {losses}, held-out {eval_loss}")
    res = {"params": params, "eval_batch": eval_batch, "cfg": cfg}
    _jamba_trace(torch, card, step, params, tokens, labels)
    ssd_err = _eval_ssd_check(torch, res)
    with torch.no_grad():
        _, (chunked, _) = M.loss_fn(params, eval_batch, cfg, impl="auto",
                                    compute_dtype=torch.bfloat16)
    gap = abs(eval_loss - float(chunked))
    if gap > JAMBA_EVAL_ATOL:
        raise AssertionError(f"Jamba held-out loss ssd_scan {eval_loss} vs "
                             f"ssd_chunked {float(chunked)}: |diff| {gap}")
    del params, res
    torch.cuda.empty_cache()

    tokens_n = JAMBA_ROWS * JAMBA_SEQ
    med = statistics.median(secs[1:])
    log(f"[jamba] Jamba-v0.1-52B at published widths, depth {cfg.num_layers} "
        f"(pattern {cfg.block_pattern}: Mamba + MoE {cfg.moe.num_experts} experts "
        f"top-{cfg.moe.top_k}, then Mamba + dense MLP), {n_params} parameters, "
        f"stages {JAMBA_BOUNDS}, M = {JAMBA_MICRO}, {JAMBA_ROWS} x {JAMBA_SEQ} tokens")
    log(f"[jamba] pipelined step (stage_impl reference, bf16) vs unpipelined "
        f"loss_and_grads: loss {loss:.6f} vs {float(ref_loss):.6f} (rtol limit "
        f"{JAMBA_LOSS_RTOL:g}); grads max|err|/max|ref| {worst:.3e} (limit "
        f"{JAMBA_GRAD_REL:g}), largest relative Frobenius norm {rel:.3e}; "
        f"the step {ref_s:.3f} s")
    log(f"[jamba] launches in the run: {counts} (expected {expect}: the stage "
        f"kernel once per microbatch in the last stage's backward slot, the "
        f"MoE half on the dropless reference route, a scan per layer in the "
        f"held-out loss); held-out loss ({JAMBA_EVAL[0]} x {JAMBA_EVAL[1]}) "
        f"{eval_loss:.6f} (ssd_scan) vs {float(chunked):.6f} (ssd_chunked), "
        f"|diff| {gap:.3e} (limit {JAMBA_EVAL_ATOL:g})")
    log(f"[time] jamba pipelined step (stage_impl pallas, bf16 compute, f32 "
        f"masters, no optimizer, {tokens_n} tokens): {['%.3f' % s for s in secs]} s; "
        f"median after warm-up {med:.3f} s, {tokens_n / med:.1f} tokens/s; losses "
        f"{['%.4f' % v for v in losses]}; held-out loss call {eval_s:.3f} s")
    log(f"[memory] jamba peak: pipelined step (params + grads) "
        f"{step_peak / 2**30:.2f} GiB, unpipelined loss_and_grads "
        f"{ref_peak / 2**30:.2f} GiB, the timed steps and held-out loss "
        f"{peak / 2**30:.2f} GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB; "
        f"phase wall time {time.perf_counter() - t_phase:.1f} s [{card}]")
    return counts, ssd_err


def _jamba_trace(torch, card, step, params, tokens, labels):
    """A torch.profiler trace of one (H) pipelined step: device busy share,
    kernels per step and the top kernels. Launches here do not count for
    the main path."""
    saved = _counts()
    with _traced(torch) as prof:
        t0 = time.perf_counter()
        out = step(params, tokens, labels)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    del out
    _reset_counts(saved)
    kern = _log_kernels(torch, prof, "jamba")
    dev_us = sum(e.self_device_time_total for e in kern)
    if dev_us == 0:
        raise AssertionError("the profiler saw no device time in the Jamba step")
    log(f"[trace] jamba: one pipelined step (profiled, no optimizer): "
        f"{host_s * 1e3:.3f} ms host, {dev_us / 1e3:.3f} ms device busy, busy "
        f"share {dev_us / 1e6 / host_s:.3f}; {sum(e.count for e in kern)} "
        f"kernels [{card}]")


PIXTRAL_ARGV = ["--arch", "pixtral-12b", "--no-reduced", "--depth", "4",
                "--batch", "4", "--seq", "1024", "--steps", "3", "--bf16-compute"]
PIXTRAL_EVAL_SEED = 1000
# held-out loss through the flash kernel vs impl="dense", bf16 compute:
# dense rounds the softmax weights to bf16 where the kernel carries them
# as two bf16 terms; with 256 image feature positions in front of the
# text, measured 1.335e-4 nats apart (of 12.26) on an H100 80GB HBM3 at
# 700 W, above the split run's EVAL_ATOL; held at 1e-3. The kernel itself
# is held to its plain version on each of the 4 calls (FLASH_ATOL).
PIXTRAL_EVAL_ATOL = 1e-3


def phase_pixtral(torch, card):
    """(F): Pixtral-12B at published widths, depth 4, through the zoo
    trainer (``launch.train.main``, bf16 weight copy): rows of 256 image
    feature positions then 768 text tokens; then a held-out loss with
    frontend features through the flash kernel, held to ``impl="dense"``,
    the kernel to its plain version on each call. Counters at 0 just
    before and read just after."""
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    args = TRAIN.parse_args(PIXTRAL_ARGV)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = TRAIN.main(PIXTRAL_ARGV)
    cfg = res["cfg"]
    eval_batch = synthetic_batch(cfg, args.batch, args.seq, seed=PIXTRAL_EVAL_SEED)
    t1 = time.perf_counter()
    with torch.no_grad():
        _, (eval_loss, _) = M.loss_fn(res["params"], eval_batch, cfg, impl="pallas")
    eval_loss = float(eval_loss)
    eval_s = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    expect = {"ca_attention": 0, "stage_mlp_block": 0,
              "flash_attention": cfg.num_layers, "ssd_scan": 0, "grouped_moe_ffn": 0}
    if counts != expect:
        raise AssertionError(f"Pixtral launches {counts}, expected {expect}")
    if (args.reduced or cfg != TRAIN.executed_config(args.arch, args.depth, False)
            or cfg.frontend != "vision"):
        raise AssertionError(f"executed {cfg}")
    losses = res["losses"]
    if len(losses) != args.steps or not all(map(math.isfinite, losses + [eval_loss])):
        raise AssertionError(f"Pixtral losses {losses}, held-out {eval_loss}")
    for leaf in tree_leaves(res["params"]):
        if leaf.device.type != "cuda" or not torch.isfinite(leaf).all():
            raise AssertionError("trained parameter off the card or non-finite")
    res["eval_batch"] = eval_batch
    flash_err = _eval_flash_check(torch, res)
    with torch.no_grad():
        _, (dense, _) = M.loss_fn(res["params"], eval_batch, cfg, impl="dense")
    gap = abs(eval_loss - float(dense))
    if gap > PIXTRAL_EVAL_ATOL:
        raise AssertionError(f"Pixtral held-out loss pallas {eval_loss} vs dense "
                             f"{float(dense)}: |diff| {gap} > {PIXTRAL_EVAL_ATOL}")
    n_params = sum(t.numel() for t in tree_leaves(res["params"]))
    secs = res["step_seconds"]
    del res
    torch.cuda.empty_cache()
    text = args.seq - cfg.frontend_tokens
    log(f"[pixtral] Pixtral-12B at published widths, depth {cfg.num_layers}, "
        f"{n_params} parameters, through launch.train ({' '.join(PIXTRAL_ARGV)}): "
        f"rows of {cfg.frontend_tokens} image feature positions + {text} text tokens")
    log(f"[pixtral] launches in the run: {counts} (expected {expect}); held-out "
        f"loss with frontend features ({args.batch} x {args.seq}) {eval_loss:.6f} "
        f"(flash kernel) vs {float(dense):.6f} (dense), |diff| {gap:.3e} (limit "
        f"{PIXTRAL_EVAL_ATOL:g})")
    log(f"[time] pixtral train steps (bf16 weight copy, f32 masters, AdamW, "
        f"{args.batch} x {args.seq} positions): {['%.3f' % v for v in secs]} s, "
        f"losses {['%.4f' % v for v in losses]}; held-out loss call {eval_s:.3f} s; "
        f"whole run {wall:.3f} s; peak memory {peak / 2**30:.2f} GiB [{card}]")
    return counts, flash_err

# ---------------------------------------------------------------------------
# 5c. timings of the SSM and MoE kernels
# ---------------------------------------------------------------------------


def ssd_bound(b, s, h, p, n, chunk):
    """Least time (ms) of one ssd_scan call on its fastest route: x, dt, a,
    b, c read and y, h_last written once over the HBM rate vs the least
    work, C.B^T once per (batch row, chunk) and, per head, the score tile
    times x, C.h and the state update, over causal pairs only, taken as
    3xTF32 (three TF32 products per product: one pass would miss the f32
    gate) over the TF32 tensor-core peak; the larger wins. Also returns the
    same work's time at the f32 FMA peak (the earlier body's bound)."""
    macs = 0
    for s0 in range(0, s, chunk):
        rows = min(chunk, s - s0)
        tri = rows * (rows + 1) // 2
        macs += b * tri * n + b * h * (tri * p + 2 * rows * n * p)
    nbytes = 4 * (2 * b * s * h * p + 2 * b * s * n + b * s * h + h
                  + b * h * p * n)
    flops = 2 * macs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS_PER_S * 1e3
    t_fma = max(t_bytes, flops / F32_FLOPS_PER_S * 1e3)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops, t_fma)


def moe_bound(routed, p_rows, nb, d, f, used, gated, x_elt, w_elt, flops_per_s):
    """Least time (ms) of one grouped_moe_ffn call: the used experts'
    weights (in their stored type), the buffer and block ids read and the
    output written once, over the HBM rate, vs the products of the routed
    rows (padding rows need none) over the operands' peak; the larger
    wins."""
    mats = 3 if gated else 2
    nbytes = used * mats * d * f * w_elt + 2 * p_rows * d * x_elt + 4 * nb
    flops = 2 * routed * d * f * mats
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def phase_ssm_moe_timing(torch, card):
    """Kernel and plain version at the paths' shapes: ssd_scan at the
    held-out evaluation's scan, grouped_moe_ffn at path (B)'s call. No
    single PyTorch call computes either function, so there is no library
    yardstick. Launches here leave the counters as they were."""
    from repro_torch.kernels import moe_dispatch as MD
    from repro_torch.kernels import ssd_scan as SK

    saved = _counts()
    out = {}
    _, b, s, h, p, n, chunk = SSD_CASES[0]
    x, dt, a, bm, cm = _ssd_inputs(torch, b, s, h, p, n, seed=95)
    t = _compare(torch, {
        "kernel": lambda: SK.ssd_scan(x, dt, a, bm, cm, chunk=chunk),
        "plain": lambda: SK.ssd_scan_ref(x, dt, a, bm, cm, chunk=chunk),
    }, iters=10, reps=5)
    bound, by, nbytes, flops, t_fma = ssd_bound(b, s, h, p, n, chunk)
    out["ssd_scan"] = dict(ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound,
                           bound_by=by, library_ms=None)
    log(f"[time] ssd_scan B {b} S {s} H {h} P {p} N {n} chunk {chunk} f32, "
        f"device (graph replay): kernel {t['kernel']:.6f} ms "
        f"({3 * flops / t['kernel'] / 1e9:.1f} TFLOP/s of 3xTF32 work), plain "
        f"{t['plain']:.6f} ms; bound {bound:.6f} ms ({by}; {nbytes} B, 3 x "
        f"{flops} FLOP at the TF32 tensor-core peak; the same work at the f32 "
        f"FMA peak {t_fma:.6f} ms) [{card}]")
    del x, dt, a, bm, cm

    cfg, params, xl = _moe_layer_inputs(torch)
    buf, eid, routed, used = _dropless_buffer(
        torch, params, xl.reshape(-1, cfg.d_model), cfg, 128)
    act = cfg.activation
    t = _compare(torch, {
        "kernel": lambda: MD.grouped_moe_ffn(buf, eid, params, activation=act),
        "plain": lambda: MD.grouped_ffn_reference(
            buf, eid, params.get("w_gate"), params["w_up"], params["w_down"], act),
    }, iters=3, reps=3)
    bound, by, nbytes, flops = moe_bound(
        routed, buf.shape[0], eid.numel(), cfg.d_model, cfg.moe.expert_d_ff,
        used, act == "swiglu", 2, 4, BF16_FLOPS_PER_S)
    out["grouped_moe_ffn"] = dict(ms=t["kernel"], plain_ms=t["plain"],
                                  bound_ms=bound, bound_by=by, library_ms=None)
    sched = MD.device_tile_schedule(buf, eid, 128, cfg.moe.num_experts)
    tiles = int((sched[:, 1] < sched[:, 2]).sum())
    live = int(sched[:, 3].sum())
    log(f"[time] grouped_moe_ffn {routed} routed rows in {buf.shape[0]} "
        f"({eid.numel()} blocks of 128, {used} experts) D {cfg.d_model} F "
        f"{cfg.moe.expert_d_ff} {act}, bf16 rows, f32 weights, device (graph "
        f"replay): kernel {t['kernel']:.6f} ms ({flops / t['kernel'] / 1e9:.1f} "
        f"TFLOP/s of routed-row work; {live} of {tiles} row tiles live, the "
        f"rest all zero and skipped), plain {t['plain']:.6f} ms; bound "
        f"{bound:.6f} ms ({by}; {nbytes} B, {flops} FLOP at bf16 peak) [{card}]")
    _reset_counts(saved)
    return out


# ---------------------------------------------------------------------------
# 4h. serving
# ---------------------------------------------------------------------------

# (S1) Qwen2.5-3B at published widths, depth 18 of 36 (a cut for the
# smoke's time: the 32 greedy references alone took 58 s at full depth),
# f32, one card
SERVE_S1 = dict(arch="qwen2_5_3b", reduced=False, num_layers=18, num_slots=16,
                arrival_slots=8, prompt_pad=128, max_new=64, decode_chunk=8)
SERVE_TRACE = dict(n_requests=32, rate_per_sec=64.0, plen_range=(4, 128),
                   gen_range=(4, 64), seed=0)
SERVE_TEMPERATURE = 0.7
# the serve example (repro_torch.examples.serve) on S1's weights: the JAX
# example's batch, a 32-token prompt and 16 new tokens
SERVE_EXAMPLE = dict(batch=4, prompt_len=32, gen=16)
SERVE_DEVICE = "cuda"
SERVE_TF_REQUESTS = 4  # requests whose decode logits meet a teacher-forced forward
# decode logits (engine, through the KV cache) against a teacher-forced
# full forward at the same positions, f32, as a share of max|forward|: the
# two take every product at other shapes, so cuBLAS sums in other orders
SERVE_TF_REL = 1e-3
SERVE_DEFAULT_BOUNDS = (5, 9, 14, 18)
# stage kernel calls on the bf16 pipelined runner against
# stage_mlp_block_ref on their own inputs: two bf16 ulps of max|ref|
SERVE_STAGE_REL = 2.0 ** -6
# the bf16 pipelined runner's logits (bf16 activations and wire through 36
# layers) against the f32 single-device runner's, as a share of max|f32|
SERVE_BF16_REL = 0.05
# (S3) Mamba2-370m at full width and depth: batch, prompt, decode steps
SERVE_MAMBA = (8, 128, 32)
# (S4) Qwen3-MoE-30B-A3B at published widths, depth 4 of 48
SERVE_S4 = dict(arch="qwen3_moe_30b_a3b", reduced=False, num_layers=4,
                num_slots=8, arrival_slots=8, prompt_pad=64, max_new=32,
                decode_chunk=8)
SERVE_S4_TRACE = dict(n_requests=8, rate_per_sec=64.0, plen_range=(4, 64),
                      gen_range=(4, 32), seed=1)
# two implementations (kernel vs plain scan route; the MoE engine vs its
# reference, whose grouped products may take other shapes): a token
# mismatch passes only where the reference's top-2 logit gap is under
# SERVE_TIE_ATOL, and the logits agree within SERVE_MOE_REL of max|ref|
SERVE_TIE_ATOL = 1e-3
SERVE_MOE_REL = 1e-4


@contextmanager
def _recorded_samples(torch, rids):
    """Record the f32 logits row every sampling call of the engine and of
    the reference sees for the requests ``rids``, keyed ``(rid, token
    index)``; the first occurrence of a key wins (later prefills re-sample
    token 0 of slots they did not admit)."""
    from repro_torch.serving import batching as SBAT
    from repro_torch.serving import engine as SENG

    rec = {}
    orig = SBAT._row_sample
    want = torch.tensor(sorted(rids), device=SERVE_DEVICE)

    def recording(logits, base_key, req_id, token_idx, temperature):
        tok = orig(logits, base_key, req_id, token_idx, temperature)
        idx = torch.as_tensor(token_idx, device=logits.device).expand(req_id.shape)
        rows = torch.isin(req_id, want).nonzero().flatten()
        if rows.numel():
            lg = logits[rows].float().cpu()
            for j, (r, k) in enumerate(zip(req_id[rows].tolist(), idx[rows].tolist())):
                rec.setdefault((r, k), lg[j])
        return tok

    SBAT._row_sample = SENG._row_sample = recording
    try:
        yield rec
    finally:
        SBAT._row_sample = SENG._row_sample = orig


def _first_mismatch(a, b):
    """Index of the first differing token of two sequences (None if equal)."""
    a, b = list(a), list(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _top2_gap(row):
    top = row.float().topk(2).values
    return float(top[0] - top[1])


def _serve_trace(torch, svc, trace, label):
    """One engine tick of decode (no arrivals, all slots busy) under the
    profiler: kernels and device time per decode step, busy share."""
    saved = _counts()
    with _traced(torch) as prof:
        t0 = time.perf_counter()
        svc.state, _ = svc.step(svc.params, svc.state, *trace, 0, free_slots=0)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    _reset_counts(saved)
    steps = svc.cfg.decode_chunk
    kern = _log_kernels(torch, prof, f"serving {label} decode tick")
    dev_us = sum(e.self_device_time_total for e in kern)
    n_kern = sum(e.count for e in kern)
    if dev_us == 0:
        raise AssertionError("the profiler saw no device time in a decode tick")
    return host_s, dev_us / 1e3, n_kern, steps


def _fill_slots(svc, rng, vocab):
    """Admit a request into every slot (prompt_pad tokens, max_new
    wanted), one arrival buffer at a time."""
    import numpy as np

    cfg = svc.cfg
    a, p = cfg.arrival_slots, cfg.prompt_pad
    admitted = 0
    while admitted < cfg.num_slots:
        k = min(a, cfg.num_slots - admitted)
        ap = rng.integers(0, vocab, (a, p))
        args = (ap, [p] * a, [cfg.max_new] * a,
                [5000 + admitted + i for i in range(a)])
        svc.state, _ = svc.step(svc.params, svc.state, *args, k,
                                free_slots=cfg.num_slots - admitted)
        admitted += k
    return (np.zeros((a, p), np.int64), [1] * a, [1] * a, [-1] * a)


def _serve_s1(torch, card, out):
    """(S1): the engine, its references, the teacher-forced forward and
    static batching on Qwen2.5-3B at depth 18, f32, one card."""
    import numpy as np

    from repro_torch.launch.serve import run_static
    from repro_torch.models import model as M
    from repro_torch.serving import (Request, ServeConfig, ServingService,
                                     generate_reference, init_engine_state,
                                     poisson_trace)
    from repro_torch.serving.service import init_model_params
    from repro_torch.tree import tree_leaves

    cfg = ServeConfig(**SERVE_S1)
    mcfg = cfg.model_config()
    t0 = time.perf_counter()
    params = init_model_params(cfg, mcfg, SERVE_DEVICE)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"[serve S1] {mcfg.name}: {mcfg.num_layers} layers, D {mcfg.d_model}, "
        f"vocab {mcfg.vocab_size}, {nbytes} B of f32 weights, drawn in "
        f"{time.perf_counter() - t0:.3f} s")
    trace = poisson_trace(vocab_size=mcfg.vocab_size, **SERVE_TRACE)
    svc = ServingService(cfg, params, device=SERVE_DEVICE)
    # warm-up (cuBLAS handles, allocator) on two requests outside the trace
    svc.run([Request(rid=1000 + i, prompt=np.arange(1, 9, dtype=np.int32),
                     gen_target=4) for i in range(2)])
    svc.state = init_engine_state(svc.runner, cfg.num_slots, cfg.prompt_pad,
                                  cfg.max_new)
    _reset_counts()
    res = svc.run(list(trace))
    torch.cuda.synchronize()
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"the f32 single-device engine launched {counts}")
    if res["num_requests"] != len(trace):
        raise AssertionError(f"{res['num_requests']} of {len(trace)} requests served")
    log(f"[serve S1] engine (greedy, f32): {res['num_requests']} requests, "
        f"{res['ticks']} ticks, {res['wall_seconds']:.3f} s; "
        f"{res['requests_per_sec']:.3f} requests/s, {res['tokens_per_sec']:.1f} "
        f"tokens/s, p50 {res['p50_latency_s']:.3f} s, p99 "
        f"{res['p99_latency_s']:.3f} s, slot occupancy {res['slot_occupancy']:.4f}; "
        f"kernel launches {counts} [{card}]")
    out["s1_engine"] = res

    t0 = time.perf_counter()
    for r in trace:
        ref = generate_reference(svc.runner, params, r.prompt,
                                 gen_target=r.gen_target, max_new=cfg.max_new,
                                 prompt_pad=cfg.prompt_pad, slots=cfg.num_slots,
                                 base_key=svc.base_key, req_id=r.rid)
        got = res["completions"][r.rid]
        if not np.array_equal(ref.cpu().numpy(), got):
            raise AssertionError(f"S1 greedy request {r.rid}: engine {got.tolist()} "
                                 f"!= reference {ref.tolist()}")
    log(f"[serve S1] every greedy completion bitwise equal to generate_reference "
        f"({len(trace)} requests, {time.perf_counter() - t0:.3f} s)")

    # temperature: the engine once more (recording the logits of the 4
    # longest requests); every completion against static batching at the
    # same temperature (each row draws by its own request and token, and
    # a row of a fixed-shape batch does not depend on the other rows), the
    # 4 longest against generate_reference, then the teacher-forced forward
    hot_cfg = dataclasses.replace(cfg, temperature=SERVE_TEMPERATURE)
    hot = ServingService(hot_cfg, params, device=SERVE_DEVICE)
    longest = sorted(trace, key=lambda r: -r.gen_target)[:SERVE_TF_REQUESTS]
    with _recorded_samples(torch, [r.rid for r in longest]) as rec:
        res_t = hot.run(list(trace))
    t0 = time.perf_counter()
    st_t = run_static(hot_cfg, list(trace), params=params, device=SERVE_DEVICE)
    same = 0
    for r in trace:
        got = res_t["completions"][r.rid]
        if not np.array_equal(st_t["completions"][r.rid], got):
            raise AssertionError(f"S1 T={SERVE_TEMPERATURE} request {r.rid}: engine "
                                 f"{got.tolist()} != static batching "
                                 f"{st_t['completions'][r.rid].tolist()}")
        same += np.array_equal(got, res["completions"][r.rid])
    for r in longest:
        ref = generate_reference(hot.runner, params, r.prompt,
                                 gen_target=r.gen_target, max_new=cfg.max_new,
                                 prompt_pad=cfg.prompt_pad, slots=cfg.num_slots,
                                 temperature=SERVE_TEMPERATURE,
                                 base_key=hot.base_key, req_id=r.rid)
        got = res_t["completions"][r.rid]
        if not np.array_equal(ref.cpu().numpy(), got):
            raise AssertionError(f"S1 T={SERVE_TEMPERATURE} request {r.rid}: engine "
                                 f"{got.tolist()} != reference {ref.tolist()}")
    log(f"[serve S1] at temperature {SERVE_TEMPERATURE}: every completion bitwise "
        f"equal to static batching's ({len(trace)} requests), the {len(longest)} "
        f"longest to generate_reference ({time.perf_counter() - t0:.3f} s; {same} "
        f"equal to the greedy ones)")
    worst, top = 0.0, 0.0
    for r in longest:
        toks = res_t["completions"][r.rid]
        seq = np.concatenate([r.prompt, toks[:-1]]).astype(np.int64)
        with torch.no_grad():
            full, _, _ = M.forward(params, torch.from_numpy(seq[None]).to(SERVE_DEVICE), mcfg,
                                   compute_dtype=torch.float32)
        full = full[0].float().cpu()
        for k in range(len(toks)):
            want = full[r.plen - 1 + k]
            got = rec[(r.rid, k)]
            worst = max(worst, float((got - want).abs().max()))
            top = max(top, float(want.abs().max()))
    if not worst <= SERVE_TF_REL * top:
        raise AssertionError(f"S1 decode logits vs teacher-forced forward: "
                             f"{worst} > {SERVE_TF_REL} x {top}")
    log(f"[serve S1] decode logits of {len(longest)} requests "
        f"({sum(len(res_t['completions'][r.rid]) for r in longest)} tokens) vs a "
        f"teacher-forced full forward at the same positions: max|diff| {worst:.3e} "
        f"(max|logit| {top:.3e}, limit {SERVE_TF_REL:g} x max) [{card}]")
    del rec, hot

    st = run_static(cfg, list(trace), params=params, device=SERVE_DEVICE)
    for r in trace:
        if not np.array_equal(st["completions"][r.rid], res["completions"][r.rid]):
            raise AssertionError(f"S1 static batching request {r.rid} differs")
    log(f"[serve S1] static batching (run_static) serves the engine's tokens; "
        f"{st['wall_seconds']:.3f} s, {st['requests_per_sec']:.3f} requests/s, "
        f"{st['tokens_per_sec']:.1f} tokens/s, p50 {st['p50_latency_s']:.3f} s, "
        f"p99 {st['p99_latency_s']:.3f} s, slot occupancy "
        f"{st['slot_occupancy']:.4f} [{card}]")
    out["s1_static"] = st

    # the serve example (repro_torch.examples.serve) on S1's weights and
    # depth: its greedy tokens against generate_reference's, row by row
    from repro_torch.examples import serve as SERVE_EX

    b, plen, gen = SERVE_EXAMPLE["batch"], SERVE_EXAMPLE["prompt_len"], SERVE_EXAMPLE["gen"]
    prompts = SERVE_EX.example_prompts(mcfg, b, plen)
    ex = SERVE_EX.serve(mcfg, params, prompts=prompts, gen=gen, device=SERVE_DEVICE)
    for row in range(b):
        ref = generate_reference(svc.runner, params, prompts[row], gen_target=gen,
                                 max_new=gen, prompt_pad=plen, slots=b, req_id=row)
        if not np.array_equal(ref.cpu().numpy(), ex["tokens"][row].numpy()):
            raise AssertionError(f"serve example row {row}: {ex['tokens'][row].tolist()} "
                                 f"!= generate_reference {ref.tolist()}")
    log(f"[serve example] repro_torch.examples.serve on S1's weights ({mcfg.num_layers} "
        f"layers, f32): {b} x {plen} + {gen} in {ex['seconds']:.3f} s, "
        f"{ex['tokens_per_s']:.1f} tokens/s (prefill included) on {ex['device']}; "
        f"every row's greedy tokens equal to generate_reference's [{card}]")
    out["serve_example"] = ex

    # one decode tick with every slot busy, traced
    svc.state = init_engine_state(svc.runner, cfg.num_slots, cfg.prompt_pad,
                                  cfg.max_new)
    idle = _fill_slots(svc, np.random.default_rng(7), mcfg.vocab_size)
    host_s, dev_ms, n_kern, steps = _serve_trace(torch, svc, idle, "S1")
    kv = sum(t.numel() * t.element_size() for t in tree_leaves(svc.state.caches))
    bound = (nbytes + kv) / HBM_BYTES_PER_S * 1e3
    log(f"[serve S1] one decode tick ({steps} steps x {cfg.num_slots} slots, "
        f"profiled): {host_s * 1e3:.3f} ms host, {dev_ms:.3f} ms device busy, busy "
        f"share {dev_ms / 1e3 / host_s:.3f}; per decode step {n_kern / steps:.0f} "
        f"kernels, {dev_ms / steps:.3f} ms device, {host_s * 1e3 / steps:.3f} ms "
        f"host; weight-read bound {bound:.3f} ms a step ({nbytes} B of weights + "
        f"{kv} B of KV at {HBM_BYTES_PER_S / 1e12:.2f} TB/s) [{card}]")
    out["s1_tick"] = dict(host_ms=host_s * 1e3 / steps, dev_ms=dev_ms / steps,
                          kernels=n_kern / steps, bound_ms=bound,
                          busy=dev_ms / 1e3 / host_s)
    del svc
    return cfg, mcfg, params, trace, res


def _serve_s2(torch, card, out, cfg, mcfg, params, trace, res, plan_full):
    """(S2): the same model on the pipelined runner, 4 stages: f32 tokens
    equal to S1's; bf16 through the stage kernel, its calls held to the
    plain version, launches counted."""
    import numpy as np

    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.kernels import stage_block as SB
    from repro_torch.serving import PipelineRunner, ServingService
    from repro_torch.serving.service import make_runner

    from repro_torch.launch.train_mhsl_rl import rescale_boundaries

    if plan_full is not None and len(plan_full) == 4:
        bounds = rescale_boundaries(plan_full, mcfg.num_layers, 4)
        which = f"the plan learned in 4b, {tuple(plan_full)}, rescaled to the depth"
    else:
        bounds, which = SERVE_DEFAULT_BOUNDS, "the default (no 4-stage plan from 4b)"
    log(f"[serve S2] boundaries {bounds}: {which}")
    svc = ServingService(dataclasses.replace(cfg, boundaries=bounds), params,
                         device=SERVE_DEVICE)
    if not isinstance(svc.runner, PipelineRunner):
        raise AssertionError(f"S2 runs on {type(svc.runner).__name__}")
    _reset_counts()
    res_p = svc.run(list(trace))
    torch.cuda.synchronize()
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"the f32 pipelined engine launched {counts}")
    for r in trace:
        if not np.array_equal(res_p["completions"][r.rid], res["completions"][r.rid]):
            raise AssertionError(f"S2 f32 pipelined request {r.rid} differs from S1")
    log(f"[serve S2] f32 pipelined engine ({len(bounds)} stages, stage_impl "
        f"reference): every completion equal to S1's; {res_p['wall_seconds']:.3f} s, "
        f"{res_p['tokens_per_sec']:.1f} tokens/s, p50 {res_p['p50_latency_s']:.3f} s, "
        f"p99 {res_p['p99_latency_s']:.3f} s [{card}]")
    del svc
    _serve_faulted(torch, card, out, cfg, params, trace, res, res_p, bounds)

    pr16 = PipelineRunner(mcfg, bounds, pipe=PipelineConfig(
        stage_impl="pallas", compute_dtype="bfloat16", wire_dtype="bfloat16"),
        device=SERVE_DEVICE)
    n, p = cfg.num_slots, cfg.prompt_pad
    prompts = np.zeros((n, p), np.int64)
    for i, r in enumerate(trace[:n]):
        prompts[i, :r.plen] = r.prompt
    prompts = torch.from_numpy(prompts).to(SERVE_DEVICE)
    plen = torch.tensor([r.plen for r in trace[:n]], device=SERVE_DEVICE)
    rows_n = torch.arange(n, device=SERVE_DEVICE)
    # the f32 single-device runner on the same prompts: the last prompt
    # position's logits, then one decode step on its greedy tokens
    f32r = make_runner(cfg, mcfg, SERVE_DEVICE)
    with torch.no_grad():
        caches = f32r.init_caches(n, p + cfg.max_new)
        logits, caches = f32r.prefill(params, caches, prompts)
        ref_last = logits[rows_n, plen - 1].float()
        del logits
        tok = ref_last.argmax(-1)
        ref_dec, _ = f32r.decode(params, tok[:, None], caches, plen)
        ref_dec = ref_dec.float()
    del caches, f32r
    calls = []
    entry = SB.stage_mlp_block

    def recording(norm_w, mlp, x, **kw):
        y = entry(norm_w, mlp, x, **kw)
        calls.append((norm_w, mlp, x, kw, y))
        return y

    caches = pr16.init_caches(n, p + cfg.max_new)
    torch.cuda.synchronize()
    SB.stage_mlp_block = recording
    _reset_counts()
    try:
        t0 = time.perf_counter()
        logits, caches = pr16.prefill(params, caches, prompts)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        last = logits[rows_n, plen - 1].float()
        t0 = time.perf_counter()
        dl, caches = pr16.decode(params, tok[:, None], caches, plen)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    finally:
        SB.stage_mlp_block = entry
    counts = _counts()
    expect = {k: 0 for k in counts}
    expect["stage_mlp_block"] = 2 * mcfg.num_layers
    if counts != expect:
        raise AssertionError(f"S2 bf16 launches {counts}, expected {expect}")
    rows = sorted({c[2].shape[:-1] for c in calls})
    worst, worst_rel = 0.0, 0.0
    for i, (norm_w, mlp, x, kw, y) in enumerate(calls):
        with torch.no_grad():
            ref = SB.stage_mlp_block_ref(norm_w, mlp, x, **kw)
        if y.dtype != torch.bfloat16 or not torch.isfinite(y).all():
            raise AssertionError(f"S2 stage call {i}: {y.dtype}, finite "
                                 f"{bool(torch.isfinite(y).all())}")
        err = float((y.float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        if rel > SERVE_STAGE_REL:
            raise AssertionError(f"S2 stage call {i} (x {tuple(x.shape)}): {err}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    del calls
    # the bf16 runner's logits against the f32 runner's: a share of
    # max|f32|; a token split passes only where the f32 top-2 gap is under
    # twice that share (each of the two logits may move by it)
    top = max(float(ref_last.abs().max()), float(ref_dec.abs().max()))
    errs, splits = [], []
    for what, got, ref in (("prefill", last, ref_last), ("decode", dl, ref_dec)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"S2 bf16 {what} logits not finite")
        err = float((got - ref).abs().max())
        if not err <= SERVE_BF16_REL * top:
            raise AssertionError(f"S2 bf16 {what} logits vs f32: {err} > "
                                 f"{SERVE_BF16_REL} x {top}")
        errs.append(err)
        for row in (got.argmax(-1) != ref.argmax(-1)).nonzero().flatten().tolist():
            gap = _top2_gap(ref[row])
            if gap >= 2 * SERVE_BF16_REL * top:
                raise AssertionError(f"S2 bf16 {what} row {row}: token differs from "
                                     f"f32 with an f32 top-2 gap {gap}")
            splits.append((what, row, gap))
    log(f"[serve S2] bf16 pipelined runner (stage_impl pallas, bf16 wire): one "
        f"prefill ({n} x {p}) {pre_s:.3f} s and one decode step {dec_s * 1e3:.3f} ms "
        f"host; launches {counts} ({mcfg.num_layers} a pass); the "
        f"{counts['stage_mlp_block']} stage_mlp_block calls (x shapes {rows}) vs "
        f"stage_mlp_block_ref: max|err| {worst:.3e}, {worst_rel:.3e} of max|ref| "
        f"(limit {SERVE_STAGE_REL:g}) [{card}]")
    log(f"[serve S2] bf16 pipelined logits vs the f32 single-device runner's on the "
        f"same prompts and tokens: prefill (last prompt position) max|diff| "
        f"{errs[0]:.3e}, decode step {errs[1]:.3e} (max|f32 logit| {top:.3e}, limit "
        f"{SERVE_BF16_REL:g} x max); greedy tokens {2 * n - len(splits)} of {2 * n} "
        f"equal, splits (pass, row, f32 top-2 gap) {splits} [{card}]")
    del caches, logits, dl
    out["stage_launches"] = counts["stage_mlp_block"]
    out["stage_err"] = worst
    out["stage_rel"] = worst_rel


def _serve_kernel_timing(torch, card, out):
    """The stage kernel at the serving shapes (decode: 16 rows; prefill:
    16 x 128 rows), bf16 x, f32 weights, and the scan at S3's prefill
    shape, each beside its plain version and its bound; launches here do
    not count."""
    from repro_torch.kernels import stage_block as SB

    saved = SB.launches
    for label, rows in (("decode", (16, 1)), ("prefill", (16, 128))):
        nw, params, x = _stage_inputs(torch, rows, 2048, 11008, "swiglu",
                                      torch.bfloat16, seed=70 + rows[1])
        t = _compare(torch, {
            "kernel": lambda: SB.stage_mlp_block(nw, params, x, activation="swiglu"),
            "plain": lambda: SB.stage_mlp_block_ref(nw, params, x, activation="swiglu"),
        }, iters=10, reps=5)
        n_rows = rows[0] * rows[1]
        bound, by, nbytes, flops = stage_bound(n_rows, 2048, 11008, True, 2, 4,
                                               BF16_FLOPS_PER_S)
        out[f"stage_{label}"] = dict(rows=n_rows, ms=t["kernel"], plain_ms=t["plain"],
                                     bound_ms=bound, bound_by=by)
        log(f"[time] stage_mlp_block at the serving {label} shape ({n_rows} rows, "
            f"D 2048, F 11008, swiglu, bf16 x, f32 weights), device (graph "
            f"replay): kernel {t['kernel']:.6f} ms ({bound / t['kernel']:.3f} of "
            f"the bound), plain {t['plain']:.6f} ms; bound {bound:.6f} ms ({by}; "
            f"{nbytes} B, {flops} FLOP at bf16 peak) [{card}]")
        del nw, params, x
    SB.launches = saved
    # the scan at S3's prefill shape (Mamba2-370m, batch 8 x 128 tokens)
    from repro_torch.kernels import ssd_scan as SK

    saved = SK.launches
    b, p = SERVE_MAMBA[:2]
    x, dt, a, bm, cm = _ssd_inputs(torch, b, p, 32, 64, 128, seed=72)
    t = _compare(torch, {
        "kernel": lambda: SK.ssd_scan(x, dt, a, bm, cm, chunk=64),
        "plain": lambda: SK.ssd_scan_ref(x, dt, a, bm, cm, chunk=64),
    }, iters=20, reps=5)
    bound, by, nbytes, flops, _ = ssd_bound(b, p, 32, 64, 128, 64)
    out["ssd_prefill"] = dict(ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound,
                              bound_by=by)
    log(f"[time] ssd_scan at the serving prefill shape (B {b}, S {p}, H 32, P 64, "
        f"N 128, chunk 64, f32), device (graph replay): kernel {t['kernel']:.6f} ms "
        f"({bound / t['kernel']:.3f} of the bound), plain {t['plain']:.6f} ms; bound "
        f"{bound:.6f} ms ({by}; {nbytes} B, {flops} FLOP as 3xTF32) [{card}]")
    SK.launches = saved


def _serve_s3(torch, card, out):
    """(S3): Mamba2-370m at full width and depth: a cached prefill through
    the scan kernel (each scan held to its plain version), 32 greedy
    decode steps, against the ``impl="auto"`` prefill's tokens and a
    teacher-forced forward's logits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as SK
    from repro_torch.models import model as M

    b, p, steps = SERVE_MAMBA
    mcfg = get_config("mamba2-370m")
    g = torch.Generator(device=SERVE_DEVICE).manual_seed(3)
    params = M.init_params(g, mcfg, device=SERVE_DEVICE)
    prompts = torch.randint(0, mcfg.vocab_size, (b, p), generator=g,
                            device=SERVE_DEVICE)
    f32 = torch.float32
    dec = M.make_decode_step(mcfg, compute_dtype=f32)

    def serve(impl):
        pre = M.make_prefill_step(mcfg, impl=impl, compute_dtype=f32)
        caches = M.init_caches(mcfg, b, p + steps, dtype=f32, device=SERVE_DEVICE)
        with torch.no_grad():
            lg, caches = pre(params, prompts, caches)
            logits, toks = [lg], [lg.argmax(-1)]
            for i in range(steps - 1):
                lg, caches = dec(params, toks[-1][:, None], caches, p + i)
                logits.append(lg)
                toks.append(lg.argmax(-1))
        return torch.stack(logits, 1).cpu(), torch.stack(toks, 1).cpu()

    calls = []
    entry = SK.ssd_scan

    def recording(*a, **kw):
        y = entry(*a, **kw)
        calls.append((a, kw, y))
        return y

    SK.ssd_scan = recording
    _reset_counts()
    try:
        t0 = time.perf_counter()
        lk, tk = serve("pallas")
        wall = time.perf_counter() - t0
    finally:
        SK.ssd_scan = entry
    counts = _counts()
    expect = {k: 0 for k in counts}
    expect["ssd_scan"] = mcfg.num_layers
    if counts != expect:
        raise AssertionError(f"S3 launches {counts}, expected {expect}")
    worst = 0.0
    for i, (a, kw, y) in enumerate(calls):
        with torch.no_grad():
            ref = SK.ssd_scan_ref(*a, **kw)
        worst = max(worst, _ssd_compare(torch, y, ref, f"S3 prefill scan {i}"))
    del calls
    la, ta = serve("auto")
    mism, gaps = 0, []
    for row in range(b):
        k = _first_mismatch(tk[row].tolist(), ta[row].tolist())
        if k is not None:
            gap = _top2_gap(la[row, k])
            gaps.append(gap)
            if gap >= SERVE_TIE_ATOL:
                raise AssertionError(f"S3 row {row}: tokens split at step {k} with a "
                                     f"top-2 gap {gap}")
            mism += 1
    seq = torch.cat([prompts.cpu(), tk[:, :-1]], 1).to(SERVE_DEVICE)
    with torch.no_grad():
        full, _, _ = M.forward(params, seq, mcfg, compute_dtype=f32)
    full = full[:, p - 1:].float().cpu()
    err = float((full - lk).abs().max())
    top = float(full.abs().max())
    if not err <= SERVE_TF_REL * top:
        raise AssertionError(f"S3 decode logits vs teacher-forced: {err} > "
                             f"{SERVE_TF_REL} x {top}")
    log(f"[serve S3] {mcfg.name} ({mcfg.num_layers} layers, f32), batch {b}, prompt "
        f"{p}: prefill through ssd_scan ({counts['ssd_scan']} launches, each scan vs "
        f"ssd_scan_ref max|err| {worst:.3e}) + {steps - 1} decode steps in "
        f"{wall:.3f} s host; greedy tokens vs the impl=auto prefill's: {b - mism} "
        f"of {b} rows equal, {mism} split at near ties (top-2 gaps {gaps}); decode "
        f"logits vs a teacher-forced forward max|diff| {err:.3e} (max|logit| "
        f"{top:.3e}, limit {SERVE_TF_REL:g} x max) [{card}]")
    out["ssd_launches"] = counts["ssd_scan"]
    out["ssd_err"] = worst


def _serve_s4(torch, card, out):
    """(S4): Qwen3-MoE-30B-A3B at published widths, depth 4, dropless,
    8 slots: the engine against its reference in tokens (tie rule) and
    logits (tolerance)."""
    import numpy as np

    from repro_torch.serving import (ServeConfig, ServingService,
                                     generate_reference, poisson_trace)

    cfg = ServeConfig(**SERVE_S4)
    svc = ServingService(cfg, device=SERVE_DEVICE)
    mcfg = svc.model_cfg
    trace = poisson_trace(vocab_size=mcfg.vocab_size, **SERVE_S4_TRACE)
    rids = [r.rid for r in trace]
    _reset_counts()
    with _recorded_samples(torch, rids) as eng:
        res = svc.run(list(trace))
    torch.cuda.synchronize()
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"S4 launched {counts} (dropless reference route)")
    with _recorded_samples(torch, rids) as refl:
        refs = {r.rid: generate_reference(
            svc.runner, svc.params, r.prompt, gen_target=r.gen_target,
            max_new=cfg.max_new, prompt_pad=cfg.prompt_pad, slots=cfg.num_slots,
            base_key=svc.base_key, req_id=r.rid).cpu().numpy() for r in trace}
    equal, worst, top, splits = 0, 0.0, 0.0, []
    for r in trace:
        got, ref = res["completions"][r.rid], refs[r.rid]
        k = _first_mismatch(got, ref)
        upto = len(ref) if k is None else k + 1
        for i in range(upto):
            a, b = eng[(r.rid, i)], refl[(r.rid, i)]
            worst = max(worst, float((a - b).abs().max()))
            top = max(top, float(b.abs().max()))
        if k is None:
            equal += 1
            continue
        gap = _top2_gap(refl[(r.rid, k)])
        splits.append((r.rid, k, gap))
        if gap >= SERVE_TIE_ATOL:
            raise AssertionError(f"S4 request {r.rid}: tokens split at step {k}, "
                                 f"reference top-2 gap {gap}")
    if not worst <= SERVE_MOE_REL * top:
        raise AssertionError(f"S4 engine vs reference logits {worst} > "
                             f"{SERVE_MOE_REL} x {top}")
    log(f"[serve S4] {mcfg.name} at depth {mcfg.num_layers} (dropless, f32, "
        f"{cfg.num_slots} slots): {res['num_requests']} requests, "
        f"{res['tokens_per_sec']:.1f} tokens/s, p50 {res['p50_latency_s']:.3f} s; "
        f"{equal} of {len(trace)} completions equal to generate_reference, splits "
        f"(rid, step, reference top-2 gap) {splits}; logits max|diff| {worst:.3e} "
        f"(max|logit| {top:.3e}, limit {SERVE_MOE_REL:g} x max); launches {counts} "
        f"[{card}]")


SERVE_FAULT_TICK_S = 0.02


def _serve_faulted(torch, card, out, cfg, params, trace, res, res_p, bounds):
    """(K1) S2's f32 pipelined engine on S1's trace under the reference
    fault schedule (device 0 down for ticks [4, 9) of a 0.02 s fault
    clock, every hop at 80% bandwidth): every request completes, each
    completion bitwise S1's, at least one fault event."""
    import numpy as np

    from repro_torch.core.faults import reference_schedule
    from repro_torch.serving import ServingService

    fcfg = dataclasses.replace(cfg, boundaries=bounds,
                               fault_tick_s=SERVE_FAULT_TICK_S)
    svc = ServingService(fcfg, params, device=SERVE_DEVICE)
    sched = reference_schedule(max(len(bounds), 4), len(bounds) - 1,
                               tick_seconds=SERVE_FAULT_TICK_S)
    _reset_counts()
    t0 = time.perf_counter()
    got = svc.run(list(trace), faults=sched)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"the faulted f32 pipelined engine launched {counts}")
    if got["num_requests"] != len(trace) or got["fault_events"] < 1:
        raise AssertionError(f"K1: {got['num_requests']} of {len(trace)} requests, "
                             f"{got['fault_events']} fault events")
    for r in trace:
        if not np.array_equal(got["completions"][r.rid], res["completions"][r.rid]):
            raise AssertionError(f"K1: faulted request {r.rid} differs from S1")
    log(f"[serve K1] f32 pipelined engine ({len(bounds)} stages) under "
        f"reference_schedule({sched.num_devices}, {sched.num_hops}) at "
        f"{SERVE_FAULT_TICK_S} s a tick (device 0 down for ticks [4, 9)): "
        f"{got['num_requests']} of {len(trace)} completions, every one bitwise S1's; "
        f"fault events {got['fault_events']}, retries {got['retries']}, evictions "
        f"{got['evictions']}, recovery ticks {got['recovery_ticks']}, expired "
        f"{got['expired']}; {got['ticks']} ticks, {got['wall_seconds']:.3f} s, "
        f"{got['tokens_per_sec']:.1f} tokens/s (fault-free S2 in this call: "
        f"{res_p['ticks']} ticks, {res_p['wall_seconds']:.3f} s, "
        f"{res_p['tokens_per_sec']:.1f} tokens/s); {secs:.1f} s [{card}]")
    out["k1"] = got
    del svc


def phase_power_allocation(torch, card):
    """The power-allocation example (``repro_torch.examples.power_allocation``)
    on the card, every value equal to the CPU run's at ``rtol 1e-6``."""
    from repro_torch.examples import power_allocation as PA

    t0 = time.perf_counter()
    got = PA.power_allocation("cuda")
    secs = time.perf_counter() - t0
    want = PA.power_allocation("cpu")

    def flat(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in flat(v)]
        return [float(tree)]

    g, w = flat(got), flat(want)
    worst = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(g, w))
    c1 = got["corollary1"]
    log(f"[examples] power_allocation on the card: {len(g)} values, largest relative "
        f"difference from the CPU run {worst:.3e}; Corollary 1 p_s* {c1['p_s']:.4f} W, "
        f"p_d* {c1['p_d']:.4f} W, hop {c1['hop_time']:.4f} s; {secs:.3f} s [{card}]")
    if len(g) != len(w) or worst > 1e-6:
        raise AssertionError(f"power_allocation on the card is off the CPU run: {got} "
                             f"vs {want}")


def phase_serving(torch, card, plan_full):
    """4h. serving: (S1) Qwen2.5-3B at depth 18 on the engine, (S2) on
    the pipelined runner, (S3) Mamba2-370m's cached decode, (S4)
    Qwen3-MoE-30B-A3B at depth 4. Each path runs with every launch
    counter at 0 just before and read just after."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    cfg, mcfg, params, trace, res = _serve_s1(torch, card, out)
    _serve_s2(torch, card, out, cfg, mcfg, params, trace, res, plan_full)
    del params
    torch.cuda.empty_cache()
    _serve_kernel_timing(torch, card, out)
    _serve_s3(torch, card, out)
    torch.cuda.empty_cache()
    _serve_s4(torch, card, out)
    torch.cuda.empty_cache()
    log(f"[serve] phase wall time {time.perf_counter() - t_phase:.1f} s; the phase's "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return out


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

    t_start = time.perf_counter()
    name, card = phase_card(torch)
    tensor_parallel = start_tensor_parallel()
    try:
        phase_build()
    except BaseException:
        _kill(tensor_parallel[1])
        raise
    phase_tensor_parallel(torch, card, tensor_parallel)
    worst = phase_ca_checks(torch)
    stage_err = phase_stage_checks(torch)
    phase_flash_checks(torch)
    ssd_check_err = phase_ssd_checks(torch)
    moe_check_err = phase_moe_checks(torch)
    torch.cuda.empty_cache()
    launches, env, cfg, params = phase_slice(torch, card)
    phase_trace(torch, card, env, cfg, params)
    select_launches, select_err = phase_select_action(torch, card, env, cfg, params)
    pop_launches, fig9_launches, _ = phase_population(torch, card, env, cfg, params)
    emp_launches = phase_empirical_env(torch, card, params, cfg)
    del env, cfg, params
    plan = phase_plan(torch, card)
    u22_launches = phase_sac_u22(torch, card)
    seq_launches = phase_sequential(torch, card)
    phase_baselines(torch, card)
    split_launches, flash_err, plan_full = phase_split(torch, card)
    phase_split_parity(torch)
    torch.cuda.empty_cache()
    mamba_launches, ssd_err = phase_mamba(torch, card)
    torch.cuda.empty_cache()
    moe_layer_launches, moe_err = phase_moe_layer(torch, card)
    torch.cuda.empty_cache()
    moe_model_launches = phase_moe_model(torch, card)
    torch.cuda.empty_cache()
    jamba_launches, jamba_ssd_err = phase_jamba(torch, card)
    torch.cuda.empty_cache()
    pixtral_launches, pixtral_flash_err = phase_pixtral(torch, card)
    torch.cuda.empty_cache()
    serve_stage = start_serve_stage()
    try:
        phase_band(torch, card)
    except BaseException:
        _kill(serve_stage[1])
        raise
    m5a_launches = phase_serve_stage(torch, card, serve_stage)
    pop_train_launches, fig6_err, ckpt = phase_population_train(torch, card)
    resume = phase_resume(torch, card)
    stage_mesh = start_stage_mesh()
    try:
        phase_population_band(torch, card)
        m3 = finish_stage_mesh(stage_mesh)
    except BaseException:
        _kill(stage_mesh[1])
        raise
    torch.cuda.empty_cache()
    attack_small = phase_attack_band(torch, card)
    phase_attack_lm(torch, card, attack_small)
    chaos_launches = phase_chaos(torch, card)
    torch.cuda.empty_cache()
    mesh_launches = phase_mesh(torch, card, m3)
    serve = phase_serving(torch, card, plan_full)
    phase_power_allocation(torch, card)
    torch.cuda.empty_cache()
    timing = phase_ca_timing(torch, card)
    t = timing[(128, 4, (28, 52, 64))]
    split_timing = phase_split_timing(torch, card)
    split_timing.update(phase_ssm_moe_timing(torch, card))
    log(f"[runs] launches per path: SAC slice ca_attention {launches}; "
        f"select_action rollout ca_attention {select_launches} (B = 1, max|err| "
        f"{select_err:.3e}); q sweep ca_attention {pop_launches}; fig 9 placement "
        f"ca_attention {fig9_launches} (B = 1); U 22 SAC ca_attention "
        f"{u22_launches}; q sweep under EmpiricalLeakage ca_attention "
        f"{emp_launches}; chaos (resumed child + reference) ca_attention "
        f"{chaos_launches}; sequential SAC "
        f"ca_attention {seq_launches}; fig 8 population (2 chunks) ca_attention "
        f"{pop_train_launches}; split "
        f"(Qwen2.5-3B) {split_launches}; (A) Mamba2-370m {mamba_launches}; "
        f"(B) MoE layer {moe_layer_launches}; (C) Qwen3-MoE-30B-A3B "
        f"{moe_model_launches}; (H) Jamba-v0.1-52B {jamba_launches}; (F) "
        f"Pixtral-12B {pixtral_launches}; serving: S2 bf16 pipelined stage_mlp_block "
        f"{serve['stage_launches']}, S3 Mamba2-370m prefill ssd_scan "
        f"{serve['ssd_launches']}; mesh children (M1-M3) {mesh_launches}; (M5a) "
        f"stage-rank serving stage_mlp_block {m5a_launches}")
    log(f"[runs] plan scorer: {plan['kernels_per_call']} kernels per call at "
        f"every enumeration; card vs CPU {plan['cpu_err']:.3e}, vs plan_cost "
        f"{plan['host_err']:.3e}")
    log(f"[runs] ca_attention at fig 6's shapes (obs 30, pair 54) max|err| "
        f"{fig6_err:.3e}; checkpoint {ckpt['bytes']} bytes, save {ckpt['save_s']:.3f} s, "
        f"restore {ckpt['load_s']:.3f} s; resume (rerun, resumed) max|diff| {resume}")
    log(f"[runs] kernel max|err| on their main-path cases: ssd_scan checks "
        f"{ssd_check_err:.3e}, eval scans {ssd_err:.3e}, (H) Jamba's eval scans "
        f"{jamba_ssd_err:.3e}; flash_attention (split eval) {flash_err:.3e}, (F) "
        f"Pixtral's eval {pixtral_flash_err:.3e}; grouped_moe_ffn "
        f"checks {moe_check_err:.3e}, (B) layer {moe_err:.3e}")
    log(f"[runs] kernel max|err| on the serving paths (not in the kernels line, "
        f"whose max_abs_err stays the main-path case's): S2 stage_mlp_block "
        f"{serve['stage_err']:.3e} ({serve['stage_rel']:.3e} of max|ref|), S3 "
        f"ssd_scan {serve['ssd_err']:.3e}")
    kernels = [{
        "name": "ca_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ca_attention.cu",
        "replaces": "src/repro/kernels/ca_attention.py:41",
        "launches": launches + emp_launches + chaos_launches
        + mesh_launches["ca_attention"],
        "max_abs_err": worst,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }]
    for kname, replaces, err, n in (
            ("stage_mlp_block", "src/repro/kernels/stage_block.py:58",
             stage_err, split_launches["stage_mlp_block"] + serve["stage_launches"]
             + jamba_launches["stage_mlp_block"] + mesh_launches["stage_mlp_block"]
             + m5a_launches),
            ("flash_attention", "src/repro/kernels/flash_attention.py:30",
             flash_err, split_launches["flash_attention"]
             + pixtral_launches["flash_attention"]),
            ("ssd_scan", "src/repro/kernels/ssd_scan.py:26",
             ssd_err, mamba_launches["ssd_scan"] + serve["ssd_launches"]
             + jamba_launches["ssd_scan"]),
            ("grouped_moe_ffn", "src/repro/kernels/moe_dispatch.py:80",
             moe_check_err, moe_layer_launches["grouped_moe_ffn"])):
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": replaces,
            "launches": n,
            "max_abs_err": err,
            **split_timing[kname],
        })
    log(f"[runs] chip_smoke wall time {time.perf_counter() - t_start:.1f} s "
        f"[{card}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
