"""Shared helpers of the port's figure drivers, the counterpart of
``benchmarks/common.py``: per-variant seeds, the smoothed convergence
metric, the standard agents of figs 4-6 and JSON output.

The episode counts are the reference's quick ones (``BenchConfig(
quick=True)``: 160 episodes, 15 of warmup). The drivers run in one
process: the reference's ``shard_devices`` has no counterpart here (the
trainers themselves take ``mesh=``).
Curves go to ``experiments/torch_bench/`` under the working directory
(``TORCH_BENCH_OUT`` overrides it), each with the device it ran on.

Checkpoints, as the reference's ``BenchConfig.ckpt``: a driver given
``--checkpoint-dir DIR`` saves each SAC agent or population under
``ckpt(DIR, name)`` every ``--checkpoint-every`` episodes and resumes
from there when run again; ``--fresh`` ignores what is saved. Off
without a directory.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.core.agents.dqn import DQNConfig, train_dqn
from repro_torch.core.agents.loops import train_sac
from repro_torch.core.agents.ppo import PPOConfig, train_ppo
from repro_torch.core.agents.sac import SACConfig
from repro_torch.core.env import MHSLEnv
from repro_torch.core.profiles import resnet101_profile
from repro_torch.device import DeviceLike

OUT_DIR = os.environ.get("TORCH_BENCH_OUT", "experiments/torch_bench")
EPISODES = 160
WARMUP = 15


def derived_seed(seed: int, idx: int) -> int:
    """Per-variant seed: distinct streams so ablation deltas are not
    correlated noise, deterministic in the base seed; idx 0 keeps
    ``seed``."""
    return seed + 7919 * idx  # 7919: prime stride, no overlap for idx < stride


def smooth(xs, k: int = 10):
    xs = np.asarray(xs, dtype=np.float64)
    if len(xs) < k:
        return xs
    return np.convolve(xs, np.ones(k) / k, mode="valid")


def episodes_to_reach(rewards, threshold: float) -> int:
    """First episode whose smoothed reward crosses ``threshold`` (the
    paper's convergence-rate metric); ``len(rewards)`` if never."""
    sm = smooth(rewards)
    idx = np.argmax(sm >= threshold)
    if sm[idx] < threshold:
        return len(rewards)
    return int(idx)


def resnet_env(device: DeviceLike = None, leakage=None) -> MHSLEnv:
    """The figures' env: MHSL on the ResNet-101 profile at batch 1, priced
    by ``leakage`` (a LeakageModel; None: the analytic one)."""
    return MHSLEnv(profile=resnet101_profile(batch=1), leakage_model=leakage,
                   device=device)


def leakage_model(kind: str, seed: int = 0, smoke: bool = False,
                  device: DeviceLike = None):
    """The LeakageModel a figure prices hops with (``benchmarks/common.py``
    ``BenchConfig.leakage_model``): None for ``"analytic"`` (the env's
    built-in ``AnalyticLeakage``), or for ``"empirical"`` an
    ``EmpiricalLeakage`` measured by an attacker population trained on
    ``device`` (120 steps with ``smoke``, else 400)."""
    if kind == "analytic":
        return None
    if kind != "empirical":
        raise ValueError(f"unknown leakage model {kind!r}")
    from repro_torch.attack import train_empirical_model

    return train_empirical_model(seed=seed, steps=120 if smoke else 400,
                                 device=device)


def ckpt(checkpoint_dir, name: str):
    """The checkpoint directory of one agent or population (``None`` when
    checkpointing is off)."""
    if checkpoint_dir is None:
        return None
    return os.path.join(checkpoint_dir, name)


def train_standard_agents(env: MHSLEnv, seed: int = 0, *,
                          episodes: int = EPISODES, warmup: int = WARMUP,
                          algos=("icm_ca", "sac", "ppo"), scenario=None,
                          num_envs: int = 1, checkpoint_dir=None,
                          checkpoint_every: int = 0, resume: bool = True,
                          ckpt_ns=None):
    """The agent-training preamble of figs 4-6: ``{name: {"params",
    "cfg", "result", "seconds"}}`` for each of ``algos`` (``icm_ca``: full
    SAC; ``sac``: no ICM, no CA; ``ppo``; ``dqn``), all on one seed, at
    the reference's configurations.

    The SAC arms checkpoint under ``ckpt(checkpoint_dir, ckpt_ns/name)``
    (PPO and DQN have no checkpoints, as in the reference). Different
    figures train agents of the same names, so checkpointing is off
    unless the caller names a namespace ``ckpt_ns``."""
    out = {}
    for name in algos:
        t0 = time.perf_counter()
        if name in ("icm_ca", "sac"):
            cfg = (SACConfig() if name == "icm_ca"
                   else SACConfig(use_icm=False, use_ca=False))
            res = train_sac(env, cfg, episodes=episodes, warmup_episodes=warmup,
                            seed=seed, num_envs=num_envs, scenario=scenario,
                            checkpoint_dir=(ckpt(checkpoint_dir, f"{ckpt_ns}/{name}")
                                            if ckpt_ns else None),
                            checkpoint_every=checkpoint_every, resume=resume)
        elif name == "ppo":
            cfg = PPOConfig()
            res = train_ppo(env, cfg, episodes=episodes, seed=seed,
                            num_envs=num_envs, scenario=scenario)
        elif name == "dqn":
            cfg = DQNConfig(eps_decay_episodes=max(episodes // 2, 1))
            res = train_dqn(env, cfg, episodes=episodes, seed=seed,
                            num_envs=num_envs, scenario=scenario)
        else:
            raise ValueError(f"unknown algo {name!r}")
        out[name] = {"params": res.params, "cfg": cfg, "result": res,
                     "seconds": time.perf_counter() - t0}
    return out


def curve(res, seconds: float):
    return {"reward": res.episode_reward, "leak": res.episode_leak,
            "states": res.states_explored, "seconds": seconds,
            "chunk_seconds": res.chunk_seconds}


def device_name(where) -> str:
    """The card's name for an env or a device on ``cuda``, else the
    device."""
    dev = torch.device(getattr(where, "device", where))
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return str(dev)


def save_json(name: str, payload) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def emit_csv_row(name: str, us_per_call: float, derived: str) -> None:
    """``name,us_per_call,derived``, as the reference's drivers print."""
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def add_checkpoint_args(ap) -> None:
    """``--checkpoint-dir``, ``--checkpoint-every`` and ``--fresh``."""
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save (and resume) the SAC agents under this directory")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="episodes between checkpoints (0: only at the end)")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore saved checkpoints and train from scratch")


def parse_args(doc: str, argv=None, checkpoints: bool = False):
    """The drivers' flags: ``--num-envs``, the env population of a chunk,
    and with ``checkpoints`` those of :func:`add_checkpoint_args`."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--num-envs", type=int, default=1)
    if checkpoints:
        add_checkpoint_args(ap)
    return ap.parse_args(argv)


def ckpt_kwargs(args) -> dict:
    """The checkpoint keywords of a driver's ``main`` from its flags."""
    return dict(checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every, resume=not args.fresh)
