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

``--only population`` trains the population bands instead
(``POP_CARD_BAND``: fig 8's two-scenario ICM-CA population at full width;
``POP_CPU_BAND``: fig 6's four-scenario one on the env padded to four
eavesdroppers, at tiny widths) with the JAX package's
``train_population``, and writes, per band and seed, the population's
metrics (``band.pop_metrics``) to
``tests/data/torch_population_reference.json``. Without ``--only`` both
files are remade.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from dataclasses import replace

import jax

from repro.core.agents.dqn import DQNConfig, train_dqn
from repro.core.agents.loops import train_sac
from repro.core.agents.ppo import PPOConfig, train_ppo
from repro.core.agents.sac import SACConfig
from repro.core.channel import NetworkConfig
from repro.core.env import MHSLEnv
from repro.core.profiles import resnet101_profile
from repro.core.scenario import scenario_grid, stack_scenarios, train_population
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


def make_population_band(band):
    net = NetworkConfig()
    if band["num_eaves"] is not None:
        net = replace(net, num_eaves=band["num_eaves"])
    env = MHSLEnv(profile=resnet101_profile(batch=1), net=net)
    scenarios = stack_scenarios(scenario_grid(env.scenario(), **band["grid"]))
    t0 = time.perf_counter()
    runs = []
    for seed in band["seeds"]:
        pop = train_population(env, SACConfig(**band["sac"]), scenarios,
                               episodes=band["episodes"], seed=seed,
                               warmup_episodes=band["warmup"],
                               num_envs=band["num_envs"])
        runs.append(dict(seed=seed, **B.pop_metrics(pop, band["last_k"])))
    secs = time.perf_counter() - t0
    print(f"population {band['grid']}: {len(band['seeds'])} seeds in "
          f"{secs:.1f} s", flush=True)
    return {"config": band, "runs": runs, "seconds": secs}


def _write(path, bands):
    out = {"generator": "tools/jax_band_reference.py", "jax": jax.__version__}
    out.update(bands)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", choices=("card", "cpu", "population"))
    ap.add_argument("--out", default=str(B.REFERENCE))
    ap.add_argument("--pop-out", default=str(B.POP_REFERENCE))
    args = ap.parse_args()
    if args.only in (None, "card", "cpu"):
        out = {}
        if args.only and os.path.exists(args.out):
            with open(args.out) as f:
                out = json.load(f)
        for name, band in (("card", B.CARD_BAND), ("cpu", B.CPU_BAND)):
            if args.only in (None, name):
                out[name] = make_band(band)
        _write(args.out, out)
    if args.only in (None, "population"):
        _write(args.pop_out, {
            name: make_population_band(band)
            for name, band in (("card", B.POP_CARD_BAND), ("cpu", B.POP_CPU_BAND))})


if __name__ == "__main__":
    main()
