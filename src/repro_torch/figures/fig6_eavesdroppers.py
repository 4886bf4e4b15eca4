"""Fig. 6 on the port: information leaked vs the number of eavesdroppers,
E = 1..4 (the counterpart of ``benchmarks/fig6_eavesdroppers.py``).

The paper claims the gaps grow with E: up to 18% less leakage than SAC
and 30% less than PPO at E = 4. The sweep runs in one env padded to
E_max = 4, whose ``eave_mask`` activates 1..4 eavesdroppers
(``scenario_grid(active_eaves=...)``), so the observation is the same
for every point (obs 30, pair 54). ICM-CA and SAC without ICM or CA each
train as a four-scenario population in lockstep (``train_population``);
PPO has no population trainer and trains per point on the point's
scenario. ``--leakage empirical`` prices hops with attacker-measured
per-layer values (``figures.common.leakage_model``). Run on the card::

    PYTHONPATH=src python -m repro_torch.figures.fig6_eavesdroppers --num-envs 16
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np

from repro_torch.core.agents.sac import SACConfig
from repro_torch.core.channel import NetworkConfig
from repro_torch.core.env import MHSLEnv
from repro_torch.core.profiles import resnet101_profile
from repro_torch.core.scenario import scenario_grid, stack_scenarios, train_population
from repro_torch.figures.common import (
    EPISODES, WARMUP, add_checkpoint_args, ckpt, ckpt_kwargs, device_name,
    emit_csv_row, leakage_model, save_json, train_standard_agents,
)

ES = [1, 2, 3, 4]
E_MAX = 4


def main(num_envs: int = 1, seed: int = 0, device=None,
         episodes: int = max(EPISODES // 2, 40), warmup: int = WARMUP,
         leakage: str = "analytic", smoke: bool = False, checkpoint_dir=None,
         checkpoint_every: int = 0, resume: bool = True):
    env = MHSLEnv(profile=resnet101_profile(batch=1),
                  net=replace(NetworkConfig(), num_eaves=E_MAX),
                  leakage_model=leakage_model(leakage, seed, smoke, device),
                  device=device)
    scens = scenario_grid(env.scenario(), active_eaves=ES)
    stacked = stack_scenarios(scens)

    def last10(res):
        return float(np.mean(res.episode_leak[-10:]))

    pops = {
        name: train_population(
            env, cfg, stacked, episodes=episodes, warmup_episodes=warmup,
            seed=seed, num_envs=num_envs,
            checkpoint_dir=ckpt(checkpoint_dir, f"fig6/{name}"),
            checkpoint_every=checkpoint_every, resume=resume)
        for name, cfg in (("icm_ca", SACConfig()),
                          ("sac", SACConfig(use_icm=False, use_ca=False)))}
    rows = {e: {name: last10(pop.results[i]) for name, pop in pops.items()}
            for i, e in enumerate(ES)}
    for i, e in enumerate(ES):
        ppo = train_standard_agents(env, seed, episodes=episodes, warmup=warmup,
                                    algos=("ppo",), scenario=scens[i],
                                    num_envs=num_envs)
        rows[e]["ppo"] = last10(ppo["ppo"]["result"])
        emit_csv_row(f"fig6/E={e}", 0.0,
                     " ".join(f"{k}={v:.3f}" for k, v in rows[e].items()))

    last = rows[ES[-1]]
    derived = {
        "rows": rows,
        "leakage": leakage,
        "reduction_vs_sac_at_E4_pct": 100 * (last["sac"] - last["icm_ca"])
        / max(last["sac"], 1e-9),
        "reduction_vs_ppo_at_E4_pct": 100 * (last["ppo"] - last["icm_ca"])
        / max(last["ppo"], 1e-9),
    }
    save_json("fig6_eavesdroppers", {
        "device": device_name(env), "num_envs": num_envs, "episodes": episodes,
        "chunk_seconds": {k: p.results[0].chunk_seconds for k, p in pops.items()},
        **derived})
    emit_csv_row("fig6/summary", 0.0,
                 f"E4_reduction_vs_sac={derived['reduction_vs_sac_at_E4_pct']:.1f}% "
                 f"vs_ppo={derived['reduction_vs_ppo_at_E4_pct']:.1f}%")
    return derived


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-envs", type=int, default=1)
    ap.add_argument("--leakage", default="analytic",
                    choices=("analytic", "empirical"))
    ap.add_argument("--smoke", action="store_true",
                    help="the empirical model's 120-step training")
    add_checkpoint_args(ap)
    a = ap.parse_args()
    main(a.num_envs, leakage=a.leakage, smoke=a.smoke, **ckpt_kwargs(a))
