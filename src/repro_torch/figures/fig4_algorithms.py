"""Fig. 4 on the port: ICM-CA (SAC) vs PPO vs DQN convergence (the
counterpart of ``benchmarks/fig4_algorithms.py``).

Paper claims ~2x convergence-rate gain over PPO/DQN and ~40% higher
reward than PPO. Run on the card::

    PYTHONPATH=src python -m repro_torch.figures.fig4_algorithms --num-envs 16
"""
from __future__ import annotations

import numpy as np

from repro_torch.figures.common import (
    EPISODES, WARMUP, ckpt_kwargs, curve, device_name, emit_csv_row,
    episodes_to_reach, parse_args, resnet_env, save_json, train_standard_agents,
)


def main(num_envs: int = 1, seed: int = 0, device=None,
         episodes: int = EPISODES, warmup: int = WARMUP, checkpoint_dir=None,
         checkpoint_every: int = 0, resume: bool = True):
    env = resnet_env(device)
    agents = train_standard_agents(env, seed, episodes=episodes, warmup=warmup,
                                   algos=("icm_ca", "ppo", "dqn"),
                                   num_envs=num_envs, checkpoint_dir=checkpoint_dir,
                                   checkpoint_every=checkpoint_every,
                                   resume=resume, ckpt_ns="fig4")
    curves = {name: curve(a["result"], a["seconds"]) for name, a in agents.items()}
    finals = {k: float(np.mean(v["reward"][-10:])) for k, v in curves.items()}
    thresh = 0.9 * finals["icm_ca"]
    conv = {k: episodes_to_reach(v["reward"], thresh) for k, v in curves.items()}
    derived = {
        "final_reward": finals,
        "convergence_speedup_vs_ppo": conv["ppo"] / max(conv["icm_ca"], 1),
        "convergence_speedup_vs_dqn": conv["dqn"] / max(conv["icm_ca"], 1),
        "reward_gain_vs_ppo_pct": 100 * (finals["icm_ca"] - finals["ppo"])
        / max(abs(finals["ppo"]), 1e-9),
    }
    for k, v in curves.items():
        emit_csv_row(f"fig4/{k}", v["seconds"] * 1e6 / episodes,
                     f"final_reward={finals[k]:.3f}")
    save_json("fig4_algorithms", {"device": device_name(env),
                                  "num_envs": num_envs, "curves": curves,
                                  "derived": derived})
    emit_csv_row("fig4/summary", 0.0,
                 f"speedup_vs_ppo={derived['convergence_speedup_vs_ppo']:.2f}x "
                 f"gain_vs_ppo={derived['reward_gain_vs_ppo_pct']:.1f}%")
    return derived


if __name__ == "__main__":
    args = parse_args(__doc__, checkpoints=True)
    main(args.num_envs, **ckpt_kwargs(args))
