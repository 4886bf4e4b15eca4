"""Fig. 3 on the port: convergence of ICM-CA vs SAC without ICM vs SAC
without CA (the counterpart of ``benchmarks/fig3_convergence.py``).

Paper claims: ICM improves the convergence rate up to 3x and the final
reward up to 30%; CA adds up to 9% reward. Run on the card::

    PYTHONPATH=src python -m repro_torch.figures.fig3_convergence --num-envs 16
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.agents.loops import train_sac
from repro_torch.core.agents.sac import SACConfig
from repro_torch.figures.common import (
    EPISODES, WARMUP, ckpt, ckpt_kwargs, curve, derived_seed, device_name,
    emit_csv_row, episodes_to_reach, parse_args, resnet_env, save_json,
)

VARIANTS = {
    "icm_ca": dict(use_icm=True, use_ca=True),
    "no_icm": dict(use_icm=False, use_ca=True),
    "no_ca": dict(use_icm=True, use_ca=False),
}


def main(num_envs: int = 1, seed: int = 0, device=None,
         episodes: int = EPISODES, warmup: int = WARMUP, checkpoint_dir=None,
         checkpoint_every: int = 0, resume: bool = True):
    env = resnet_env(device)
    curves = {}
    # each variant on its own derived seed, as in the reference
    for i, (name, flags) in enumerate(VARIANTS.items()):
        t0 = time.perf_counter()
        res = train_sac(env, SACConfig(**flags), episodes=episodes,
                        warmup_episodes=warmup, seed=derived_seed(seed, i),
                        num_envs=num_envs,
                        checkpoint_dir=ckpt(checkpoint_dir, f"fig3/{name}"),
                        checkpoint_every=checkpoint_every, resume=resume)
        curves[name] = curve(res, time.perf_counter() - t0)
        emit_csv_row(f"fig3/{name}", curves[name]["seconds"] * 1e6 / episodes,
                     f"final_reward={np.mean(res.episode_reward[-10:]):.3f}")

    full = float(np.mean(curves["icm_ca"]["reward"][-10:]))
    no_icm = float(np.mean(curves["no_icm"]["reward"][-10:]))
    no_ca = float(np.mean(curves["no_ca"]["reward"][-10:]))
    thresh = 0.9 * full  # reward is negative: within 10% of final
    conv_full = episodes_to_reach(curves["icm_ca"]["reward"], thresh)
    conv_noicm = episodes_to_reach(curves["no_icm"]["reward"], thresh)
    derived = {
        "final_reward": {"icm_ca": full, "no_icm": no_icm, "no_ca": no_ca},
        "reward_gain_vs_no_icm_pct": 100 * (full - no_icm) / max(abs(no_icm), 1e-9),
        "reward_gain_vs_no_ca_pct": 100 * (full - no_ca) / max(abs(no_ca), 1e-9),
        "convergence_speedup_vs_no_icm": conv_noicm / max(conv_full, 1),
        "episodes_to_threshold": {"icm_ca": conv_full, "no_icm": conv_noicm},
    }
    save_json("fig3_convergence", {"device": device_name(env),
                                   "num_envs": num_envs, "curves": curves,
                                   "derived": derived})
    emit_csv_row("fig3/summary", 0.0,
                 f"speedup_vs_no_icm={derived['convergence_speedup_vs_no_icm']:.2f}x "
                 f"gain_vs_no_icm={derived['reward_gain_vs_no_icm_pct']:.1f}%")
    return derived


if __name__ == "__main__":
    args = parse_args(__doc__, checkpoints=True)
    main(args.num_envs, **ckpt_kwargs(args))
