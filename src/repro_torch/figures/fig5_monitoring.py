"""Fig. 5 on the port: information leaked vs the eavesdroppers'
monitoring probability (the counterpart of
``benchmarks/fig5_monitoring.py``).

ICM-CA, plain SAC and PPO are trained at q = 0.8 (Table I) and evaluated
across q in {0.3 .. 0.9}: the five points are one stacked
``ScenarioParams`` batch through ``evaluate_population``, every point
replaying the same episode draws. The paper claims ICM-CA leaks ~13% less
than SAC and ~22% less than PPO. ``--leakage empirical`` prices hops with
per-layer values measured by a trained attacker population
(``figures.common.leakage_model``; ``smoke``: its 120-step version) in
place of the analytic table. Run on the card::

    PYTHONPATH=src python -m repro_torch.figures.fig5_monitoring --num-envs 16
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.agents import rollout as R
from repro_torch.core.agents.ppo import ppo_policy
from repro_torch.core.scenario import (
    evaluate_population, scenario_grid, stack_scenarios,
)
from repro_torch.figures.common import (
    EPISODES, WARMUP, add_checkpoint_args, ckpt_kwargs, device_name,
    emit_csv_row, leakage_model, resnet_env, save_json, train_standard_agents,
)

QS = [0.3, 0.45, 0.6, 0.75, 0.9]
EVAL_EPISODES = 15  # the reference's quick evaluation


def main(num_envs: int = 1, seed: int = 0, device=None,
         episodes: int = EPISODES, warmup: int = WARMUP,
         eval_episodes: int = EVAL_EPISODES, leakage: str = "analytic",
         smoke: bool = False, checkpoint_dir=None, checkpoint_every: int = 0,
         resume: bool = True):
    env = resnet_env(device, leakage_model(leakage, seed, smoke, device))
    adims = env.action_dims
    agents = train_standard_agents(env, seed, episodes=episodes, warmup=warmup,
                                   algos=("icm_ca", "sac", "ppo"),
                                   num_envs=num_envs, checkpoint_dir=checkpoint_dir,
                                   checkpoint_every=checkpoint_every,
                                   resume=resume, ckpt_ns="fig5")
    scenarios = stack_scenarios(scenario_grid(env.scenario(), monitor_prob=QS))

    leak = {}
    for name in ("icm_ca", "sac"):
        a = agents[name]
        leak[name] = evaluate_population(
            env, R.sac_policy(adims, a["cfg"]), a["params"], scenarios,
            episodes=eval_episodes, hist_len=a["cfg"].hist_len)["leak"]
    leak["ppo"] = evaluate_population(
        env, ppo_policy(adims), agents["ppo"]["params"], scenarios,
        episodes=eval_episodes, seed=500)["leak"]

    rows = {}
    for i, q in enumerate(QS):
        rows[q] = {name: float(leak[name][i]) for name in leak}
        emit_csv_row(f"fig5/q={q}", 0.0,
                     " ".join(f"{k}={v:.3f}" for k, v in rows[q].items()))
    mean = {k: float(np.mean([rows[q][k] for q in QS])) for k in rows[QS[0]]}
    derived = {
        "mean_leak": mean,
        "reduction_vs_sac_pct": 100 * (mean["sac"] - mean["icm_ca"])
        / max(mean["sac"], 1e-9),
        "reduction_vs_ppo_pct": 100 * (mean["ppo"] - mean["icm_ca"])
        / max(mean["ppo"], 1e-9),
    }
    save_json("fig5_monitoring", {"device": device_name(env),
                                  "num_envs": num_envs, "rows": rows,
                                  "derived": derived, "leakage": leakage})
    emit_csv_row("fig5/summary", 0.0,
                 f"leak_reduction_vs_sac={derived['reduction_vs_sac_pct']:.1f}% "
                 f"vs_ppo={derived['reduction_vs_ppo_pct']:.1f}%")
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
