#!/usr/bin/env python3
"""Make the JAX side of the port's fig-3 band.

Trains every arm of each band of ``repro_torch.figures.band`` (``card``:
the full-width ``SACConfig()`` and the baselines on the ResNet-101 env;
``cpu``: two arms at tiny widths) with the JAX package on each of the
band's seeds, and writes the configuration and, per arm and seed, the
run's mean reward and mean leak over the last ``last_k`` episodes and its
distinct states explored at the end to
``tests/data/torch_band_reference.json``. The card's machine has no JAX,
so the file is made here, on the CPU, and committed. Run from the
repository root::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_band_reference.py

``--only card`` or ``--only cpu`` remakes one band and keeps the other's
entry from the existing file.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import jax

from repro.core.agents.dqn import DQNConfig, train_dqn
from repro.core.agents.loops import train_sac
from repro.core.agents.ppo import PPOConfig, train_ppo
from repro.core.agents.sac import SACConfig
from repro.core.env import MHSLEnv
from repro.core.profiles import resnet101_profile
from repro_torch.figures import band as B


def run_arm(env, arm, band, seed):
    kw = dict(episodes=band["episodes"], seed=seed, num_envs=band["num_envs"])
    if arm in B.SAC_ARMS:
        return train_sac(env, SACConfig(**band["sac"], **B.SAC_ARMS[arm]),
                         warmup_episodes=band["warmup"], **kw)
    if arm == "ppo":
        return train_ppo(env, PPOConfig(**band["ppo"]), **kw)
    return train_dqn(env, DQNConfig(**band["dqn"]), **kw)


def make_band(band):
    env = MHSLEnv(profile=resnet101_profile(batch=1))
    arms = {}
    for arm in band["arms"]:
        t0 = time.perf_counter()
        arms[arm] = []
        for seed in band["seeds"]:
            res = run_arm(env, arm, band, seed)
            arms[arm].append(dict(seed=seed, **B.run_metrics(res, band["last_k"])))
        print(f"{arm}: {len(band['seeds'])} seeds in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"config": band, "arms": arms}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", choices=("card", "cpu"))
    ap.add_argument("--out", default=str(B.REFERENCE))
    args = ap.parse_args()
    out = {}
    if args.only and os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    out["generator"] = "tools/jax_band_reference.py"
    out["jax"] = jax.__version__
    for name, band in (("card", B.CARD_BAND), ("cpu", B.CPU_BAND)):
        if args.only in (None, name):
            out[name] = make_band(band)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
