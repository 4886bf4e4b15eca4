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

REFERENCE = (Path(__file__).resolve().parents[3] / "tests" / "data"
             / "torch_band_reference.json")

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


def compare(ref_rows, rows) -> dict:
    """Per metric: both sides' means and spreads, the margin, the
    distance and whether it is inside the band."""
    out = {}
    for m in METRICS:
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


def main():
    """Train arms of the card band on the port over more seeds than
    ``chip_smoke.py`` takes, and hold them to the JAX runs::

        PYTHONPATH=src python -m repro_torch.figures.band --arms icm_ca,no_ca --seeds 16

    Runs on the card (``--device cpu``: on the CPU), prints each run's
    metrics and each arm's comparison, and writes them to ``--out``
    (JSON) when given."""
    import argparse

    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile
    from repro_torch.figures.common import device_name

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--arms", default=",".join(CARD_BAND["arms"]))
    ap.add_argument("--seeds", type=int, default=len(CARD_BAND["seeds"]))
    ap.add_argument("--device", default=None, help="cuda unless given")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
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
        print(f"{arm}: {'inside' if inside(res) else 'OUTSIDE'} " + "; ".join(
            f"{m} torch {r['torch_mean']:.4f}+-{r['torch_std']:.4f} jax "
            f"{r['jax_mean']:.4f}+-{r['jax_std']:.4f} |d| {r['distance']:.4f} "
            f"margin {r['margin']:.4f}" for m, r in res.items()) + f" [{out['device']}]",
            flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
