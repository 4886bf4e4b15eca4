"""Fig. 7 on the port: state-exploration ability, distinct states visited
vs episodes (the counterpart of ``benchmarks/fig7_exploration.py``).

Paper claims ICM-CA explores ~2.5x more states than SAC within 20
epochs. Run on the card::

    PYTHONPATH=src python -m repro_torch.figures.fig7_exploration --num-envs 16
"""
from __future__ import annotations

import time

from repro_torch.core.agents.loops import train_sac
from repro_torch.core.agents.sac import SACConfig
from repro_torch.figures.common import (
    EPISODES, WARMUP, derived_seed, device_name, emit_csv_row, parse_args,
    resnet_env, save_json,
)


def main(num_envs: int = 1, seed: int = 0, device=None,
         episodes: int = EPISODES, warmup: int = WARMUP):
    env = resnet_env(device)
    t0 = time.perf_counter()
    # distinct derived seeds per arm, as in the reference
    res_full = train_sac(env, SACConfig(), episodes=episodes,
                         warmup_episodes=warmup, seed=derived_seed(seed, 0),
                         num_envs=num_envs)
    t1 = time.perf_counter()
    res_sac = train_sac(env, SACConfig(use_icm=False, use_ca=False),
                        episodes=episodes, warmup_episodes=warmup,
                        seed=derived_seed(seed, 1), num_envs=num_envs)
    t2 = time.perf_counter()
    at = min(warmup + 20, len(res_full.states_explored) - 1)
    ratio = res_full.states_explored[at] / max(res_sac.states_explored[at], 1)
    derived = {
        "icm_ca_states": res_full.states_explored,
        "sac_states": res_sac.states_explored,
        "exploration_ratio_at_20": ratio,
        "seconds": {"icm_ca": t1 - t0, "sac": t2 - t1},
    }
    save_json("fig7_exploration", dict(derived, device=device_name(env),
                                       num_envs=num_envs))
    emit_csv_row("fig7/summary", 0.0, f"exploration_ratio_at_20ep={ratio:.2f}x")
    return derived


if __name__ == "__main__":
    main(parse_args(__doc__).num_envs)
