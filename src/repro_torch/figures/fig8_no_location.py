"""Fig. 8 on the port: training without the eavesdroppers' locations (the
counterpart of ``benchmarks/fig8_no_location.py``).

The paper claims a similar convergence rate with ~12% lower accumulated
reward around epoch 25. Location knowledge is a scenario axis
(``know_eave_locations``), so both variants train as one two-scenario
population in lockstep (``train_population``): the same env, the same
geometry and rollout draws, one agent each; the runs differ by the
observation's blinding and their agents' initial weights. Run on the
card::

    PYTHONPATH=src python -m repro_torch.figures.fig8_no_location --num-envs 16
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.agents.sac import SACConfig
from repro_torch.core.scenario import scenario_grid, stack_scenarios, train_population
from repro_torch.figures.common import (
    EPISODES, WARMUP, ckpt, ckpt_kwargs, device_name, emit_csv_row, parse_args,
    resnet_env, save_json,
)


def main(num_envs: int = 1, seed: int = 0, device=None,
         episodes: int = EPISODES, warmup: int = WARMUP, checkpoint_dir=None,
         checkpoint_every: int = 0, resume: bool = True):
    env = resnet_env(device)
    scens = stack_scenarios(scenario_grid(env.scenario(),
                                          know_eave_locations=[1.0, 0.0]))
    pop = train_population(env, SACConfig(), scens, episodes=episodes,
                           warmup_episodes=warmup, seed=seed, num_envs=num_envs,
                           checkpoint_dir=ckpt(checkpoint_dir, "fig8/pop"),
                           checkpoint_every=checkpoint_every, resume=resume)
    res_known, res_blind = pop.results
    known = float(np.mean(res_known.episode_reward[-10:]))
    blind = float(np.mean(res_blind.episode_reward[-10:]))
    derived = {
        "known_curve": res_known.episode_reward,
        "blind_curve": res_blind.episode_reward,
        "final_known": known,
        "final_blind": blind,
        "reward_drop_pct": 100 * (known - blind) / max(abs(known), 1e-9),
    }
    save_json("fig8_no_location", {"device": device_name(env),
                                   "num_envs": num_envs,
                                   "chunk_seconds": res_known.chunk_seconds,
                                   **derived})
    emit_csv_row("fig8/summary", 0.0,
                 f"known={known:.2f} blind={blind:.2f} "
                 f"drop={derived['reward_drop_pct']:.1f}%")
    return derived


if __name__ == "__main__":
    args = parse_args(__doc__, checkpoints=True)
    main(args.num_envs, **ckpt_kwargs(args))
