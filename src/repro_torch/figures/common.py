"""Shared helpers of the port's figure drivers, the counterpart of
``benchmarks/common.py``: per-variant seeds, the smoothed convergence
metric, the standard agents of figs 4-6 and JSON output.

The episode counts are the reference's quick ones (``BenchConfig(
quick=True)``: 160 episodes, 15 of warmup). There is no population mesh
and no checkpointing yet. Curves go to ``experiments/torch_bench/`` under
the working directory (``TORCH_BENCH_OUT`` overrides it), each with the
device it ran on.
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


def resnet_env(device: DeviceLike = None) -> MHSLEnv:
    """The figures' env: MHSL on the ResNet-101 profile at batch 1."""
    return MHSLEnv(profile=resnet101_profile(batch=1), device=device)


def train_standard_agents(env: MHSLEnv, seed: int = 0, *,
                          episodes: int = EPISODES, warmup: int = WARMUP,
                          algos=("icm_ca", "sac", "ppo"), scenario=None,
                          num_envs: int = 1):
    """The agent-training preamble of figs 4-6: ``{name: {"params",
    "cfg", "result", "seconds"}}`` for each of ``algos`` (``icm_ca``: full
    SAC; ``sac``: no ICM, no CA; ``ppo``; ``dqn``), all on one seed, at
    the reference's configurations."""
    out = {}
    for name in algos:
        t0 = time.perf_counter()
        if name in ("icm_ca", "sac"):
            cfg = (SACConfig() if name == "icm_ca"
                   else SACConfig(use_icm=False, use_ca=False))
            res = train_sac(env, cfg, episodes=episodes, warmup_episodes=warmup,
                            seed=seed, num_envs=num_envs, scenario=scenario)
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


def parse_args(doc: str):
    """The drivers' one flag: ``--num-envs``, the env population of a
    chunk."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--num-envs", type=int, default=1)
    return ap.parse_args()
