"""The fig-3 band: the port's training runs held to the JAX package's.

JAX's threefry streams cannot be reproduced in torch, so whole runs are
held statistically, never draw for draw. Each arm is trained on several
seeds on both sides at one configuration; per arm and metric the port's
mean across seeds must lie within a margin of the JAX mean:

    |mean_torch - mean_jax| <= K_SIGMA * s * sqrt(1/n_jax + 1/n_torch)
                               + FLOOR * |mean_jax|,

with ``s`` the larger of the two sides' spreads across seeds (sample
standard deviations). The metrics of a run are its mean reward and mean
leak over the last ``last_k`` episodes and the distinct states it explored
by the end (``states_explored[-1]``, fig 7's counter).

The JAX side cannot run where the card is, so its runs are made on the
CPU by ``tools/jax_band_reference.py`` and committed as
``tests/data/torch_band_reference.json``: per band (``card``, ``cpu``)
the configuration below and, per arm and seed, the three metrics.
:data:`CARD_BAND` is the full-width ``SACConfig()`` on the ResNet-101 env
with all six arms (``chip_smoke.py``); :data:`CPU_BAND` is two arms at
tiny widths (``tests/test_torch_band.py``).

The negative control is the ICM-CA arm never leaving warmup (the
uniform policy throughout): it must fall outside the ICM-CA band.

The population band holds ``train_population`` runs to the JAX package's
by the same rule. A run's metrics are, per scenario ``s``, ``reward_s``,
``leak_s`` and ``states_s`` (as above), and one paired metric,
``reward_diff`` = ``reward_0 - reward_1`` of the same run: the figure's
claim. Its spread across seeds depends on which draws the scenarios
share (the geometry and the rollout noise, not the initial weights). The
JAX runs are committed as ``tests/data/torch_population_reference.json``.
:data:`POP_CARD_BAND` is fig 8's two-scenario population at full width
(``chip_smoke.py``), :data:`POP_CPU_BAND` fig 6's four-scenario one on
the padded env at the CPU band's widths
(``tests/test_torch_population_band.py``). The negative control is the
population never leaving warmup.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from repro_torch.core.agents.dqn import DQNConfig, train_dqn
from repro_torch.core.agents.loops import train_sac
from repro_torch.core.agents.ppo import PPOConfig, train_ppo
from repro_torch.core.agents.sac import SACConfig
from repro_torch.figures.common import derived_seed

DATA = Path(__file__).resolve().parents[3] / "tests" / "data"
REFERENCE = DATA / "torch_band_reference.json"
POP_REFERENCE = DATA / "torch_population_reference.json"

# the arms of figs 3 and 7 (fig3_convergence.py:20-22, fig7_exploration.py:24)
# and the baselines of fig 4
SAC_ARMS = {
    "icm_ca": dict(use_icm=True, use_ca=True),
    "no_icm": dict(use_icm=False, use_ca=True),
    "no_ca": dict(use_icm=True, use_ca=False),
    "neither": dict(use_icm=False, use_ca=False),
}
METRICS = ("reward", "leak", "states")
K_SIGMA = 4.0
FLOOR = 0.02

CARD_BAND = {
    "env": "MHSLEnv(profile=resnet101_profile(batch=1))",
    "arms": list(SAC_ARMS) + ["ppo", "dqn"],
    "sac": {},  # SACConfig() defaults: the full width
    "ppo": {},
    "dqn": {"eps_decay_episodes": 32},  # episodes // 2, as train_standard_agents
    "episodes": 64,
    "warmup": 16,
    "num_envs": 16,
    "last_k": 16,
    "seeds": [derived_seed(0, i) for i in range(48)],
}

# at these widths the default actor rate (1e-4) moves the logits a
# quarter as fast as at the full width (an Adam step moves each weight by
# ~lr, and the logits sum over hidden inputs), and no learning shows in
# 64 episodes; 1e-3 restores it
CPU_BAND = dict(
    CARD_BAND,
    arms=["icm_ca", "neither"],
    sac={"hidden": 32, "feat_dim": 8, "attn_dim": 8, "batch": 32,
         "buffer_size": 2000, "eta_a": 1e-3},
    seeds=[derived_seed(0, i) for i in range(8)],
)
# the port's seeds per arm: the first of each band's seeds
CARD_TORCH_SEEDS = 3
CPU_TORCH_SEEDS = 4

# populations (one ICM-CA agent per scenario): fig 8's location grid at
# full width on the card band's schedule, and fig 6's eavesdropper grid
# on the env padded to 4 eavesdroppers at the CPU band's widths
POP_CARD_BAND = {
    "env": "MHSLEnv(profile=resnet101_profile(batch=1))",
    "num_eaves": None,  # the env's default (NetworkConfig().num_eaves)
    "grid": {"know_eave_locations": [1.0, 0.0]},
    "sac": {},
    "episodes": CARD_BAND["episodes"],
    "warmup": CARD_BAND["warmup"],
    "num_envs": CARD_BAND["num_envs"],
    "last_k": CARD_BAND["last_k"],
    "seeds": CARD_BAND["seeds"],
}
# (48 episodes, two updating chunks: four agents a run on one CPU thread)
POP_CPU_BAND = dict(
    POP_CARD_BAND,
    env="MHSLEnv(profile=resnet101_profile(batch=1), net=NetworkConfig(num_eaves=4))",
    num_eaves=4,
    grid={"active_eaves": [1, 2, 3, 4]},
    sac=CPU_BAND["sac"],
    episodes=48,
    seeds=[derived_seed(0, i) for i in range(16)],
)
POP_CARD_TORCH_SEEDS = 3
POP_CPU_TORCH_SEEDS = 2


def load_reference(path: Path = REFERENCE):
    with open(path) as f:
        return json.load(f)


def run_arm(env, arm: str, band: dict, seed: int, warmup=None):
    """Train one arm of ``band`` on the port at ``seed``; ``warmup``
    overrides the band's (the negative control passes the episode
    count)."""
    episodes, num_envs = band["episodes"], band["num_envs"]
    if arm in SAC_ARMS:
        cfg = SACConfig(**band["sac"], **SAC_ARMS[arm])
        return train_sac(env, cfg, episodes=episodes, seed=seed,
                         warmup_episodes=band["warmup"] if warmup is None else warmup,
                         num_envs=num_envs)
    if arm == "ppo":
        return train_ppo(env, PPOConfig(**band["ppo"]), episodes=episodes,
                         seed=seed, num_envs=num_envs)
    if arm == "dqn":
        return train_dqn(env, DQNConfig(**band["dqn"]), episodes=episodes,
                         seed=seed, num_envs=num_envs)
    raise ValueError(f"unknown arm {arm!r}")


def run_metrics(res, last_k: int) -> dict:
    """A run's band metrics."""
    return {"reward": float(np.mean(res.episode_reward[-last_k:])),
            "leak": float(np.mean(res.episode_leak[-last_k:])),
            "states": int(res.states_explored[-1])}


def pop_env(band: dict, device=None):
    """The env of a population band."""
    from dataclasses import replace

    from repro_torch.core.channel import NetworkConfig
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile

    net = NetworkConfig()
    if band["num_eaves"] is not None:
        net = replace(net, num_eaves=band["num_eaves"])
    return MHSLEnv(profile=resnet101_profile(batch=1), net=net, device=device)


def pop_scenarios(env, band: dict):
    """The stacked scenarios of a population band."""
    from repro_torch.core.scenario import scenario_grid, stack_scenarios

    return stack_scenarios(scenario_grid(env.scenario(), **band["grid"]))


def run_population(env, band: dict, seed: int, warmup=None):
    """Train the ICM-CA population of ``band`` on the port at ``seed``;
    ``warmup`` overrides the band's (the negative control passes the
    episode count)."""
    from repro_torch.core.scenario import train_population

    return train_population(
        env, SACConfig(**band["sac"]), pop_scenarios(env, band),
        episodes=band["episodes"], seed=seed, num_envs=band["num_envs"],
        warmup_episodes=band["warmup"] if warmup is None else warmup)


def pop_metrics(pop, last_k: int) -> dict:
    """A population run's band metrics: each scenario's :func:`run_metrics`
    under its index, and the paired ``reward_diff``."""
    out = {}
    for s, res in enumerate(pop.results):
        out.update({f"{m}_{s}": v for m, v in run_metrics(res, last_k).items()})
    out["reward_diff"] = out["reward_0"] - out["reward_1"]
    return out


def pop_metric_names(band: dict):
    n = len(next(iter(band["grid"].values())))
    return tuple(f"{m}_{s}" for s in range(n) for m in METRICS) + ("reward_diff",)


def compare(ref_rows, rows, metrics=METRICS) -> dict:
    """Per metric: both sides' means and spreads, the margin, the
    distance and whether it is inside the band."""
    out = {}
    for m in metrics:
        ref = np.array([r[m] for r in ref_rows], np.float64)
        got = np.array([r[m] for r in rows], np.float64)
        s = max(ref.std(ddof=1), got.std(ddof=1) if len(got) > 1 else 0.0)
        margin = (K_SIGMA * s * math.sqrt(1 / len(ref) + 1 / len(got))
                  + FLOOR * abs(ref.mean()))
        dist = abs(got.mean() - ref.mean())
        out[m] = {"jax_mean": float(ref.mean()), "jax_std": float(ref.std(ddof=1)),
                  "torch_mean": float(got.mean()),
                  "torch_std": float(got.std(ddof=1)) if len(got) > 1 else 0.0,
                  "margin": float(margin), "distance": float(dist),
                  "inside": bool(dist <= margin)}
    return out


def inside(result: dict) -> bool:
    return all(r["inside"] for r in result.values())


def _show(label, res, device) -> None:
    print(f"{label}: {'inside' if inside(res) else 'OUTSIDE'} " + "; ".join(
        f"{m} torch {r['torch_mean']:.4f}+-{r['torch_std']:.4f} jax "
        f"{r['jax_mean']:.4f}+-{r['jax_std']:.4f} |d| {r['distance']:.4f} "
        f"margin {r['margin']:.4f}" for m, r in res.items()) + f" [{device}]",
        flush=True)


def main(argv=None):
    """Train arms of the card band on the port over more seeds than
    ``chip_smoke.py`` takes, and hold them to the JAX runs::

        PYTHONPATH=src python -m repro_torch.figures.band --arms icm_ca,no_ca --seeds 16
        PYTHONPATH=src python -m repro_torch.figures.band --population --seeds 16

    ``--population`` trains fig 8's population of the population band
    (:data:`POP_CARD_BAND`) instead. Runs on the card (``--device cpu``:
    on the CPU), prints each run's metrics and each comparison, and writes
    them to ``--out`` (JSON) when given."""
    import argparse

    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile
    from repro_torch.figures.common import device_name

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--arms", default=",".join(CARD_BAND["arms"]))
    ap.add_argument("--population", action="store_true",
                    help="the population band (POP_CARD_BAND) instead of arms")
    ap.add_argument("--seeds", type=int, default=len(CARD_BAND["seeds"]))
    ap.add_argument("--device", default=None, help="cuda unless given")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.population:
        band = POP_CARD_BAND
        env = pop_env(band, device=args.device)
        out = {"device": device_name(env)}
        rows = []
        for seed in band["seeds"][:args.seeds]:
            rows.append(pop_metrics(run_population(env, band, seed), band["last_k"]))
            print(f"population seed {seed}: {rows[-1]}", flush=True)
        res = compare(load_reference(POP_REFERENCE)["card"]["runs"], rows,
                      pop_metric_names(band))
        out["population"] = dict(runs=rows, **res)
        _show("population", res, out["device"])
    else:
        env = MHSLEnv(profile=resnet101_profile(batch=1), device=args.device)
        ref = load_reference()["card"]["arms"]
        out = {"device": device_name(env), "arms": {}}
        for arm in args.arms.split(","):
            rows = []
            for seed in CARD_BAND["seeds"][:args.seeds]:
                rows.append(run_metrics(run_arm(env, arm, CARD_BAND, seed),
                                        CARD_BAND["last_k"]))
                print(f"{arm} seed {seed}: {rows[-1]}", flush=True)
            res = compare(ref[arm], rows)
            out["arms"][arm] = dict(runs=rows, **res)
            _show(arm, res, out["device"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out

if __name__ == "__main__":
    main()
