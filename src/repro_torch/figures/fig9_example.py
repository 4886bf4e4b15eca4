"""Fig. 9 on the port: a placement example - a trained policy's device
selection and split sizes on one geometry (the counterpart of
``benchmarks/fig9_example.py``).

A 7-step single-env rollout through ``select_action`` (the actor at
B = 1). The paper's qualitative claims: trainers sit far from the
eavesdroppers, decoys close to them, and larger sub-models go to safer
devices. Run on the card::

    PYTHONPATH=src python -m repro_torch.figures.fig9_example --num-envs 16
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.agents import action_space as A
from repro_torch.core.agents import sac as SAC
from repro_torch.core.agents.loops import train_sac
from repro_torch.core.env import MHSLEnv
from repro_torch.figures.common import (
    EPISODES, WARMUP, device_name, emit_csv_row, parse_args, resnet_env,
    save_json,
)


@torch.no_grad()
def placement_example(env: MHSLEnv, params, cfg: SAC.SACConfig,
                      seed: int = 99) -> dict:
    """One episode of one env through ``select_action``: a generator on
    the env's device seeded with ``seed`` draws the geometry, then each
    step's Gumbel noise and leakage draw. Returns the plan, the positions,
    each device's decoy use and the mean distance of the trainers and of
    the decoys to their nearest eavesdropper."""
    dims, dev = env.action_dims, env.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = env.reset(env.sample_positions(gen, 1))
    pair_dim = env.obs_dim + A.flat_dim(dims)
    hist = torch.zeros((cfg.hist_len, pair_dim), device=dev)
    hmask = torch.zeros((cfg.hist_len,), device=dev)
    decoy_usage = torch.zeros(env.U, device=dev)
    for _ in range(env.episode_len):
        obs = env.observe(st)[0]
        masks = {k: v[0] for k, v in env.action_masks(st).items()}
        a = SAC.select_action(params, A.gumbel(A.head_shapes(dims), gen, dev),
                              obs, hist, hmask, masks, dims, cfg)
        decoy_usage += a["decoys"] * masks["decoys"]
        pair = torch.cat([obs, A.onehot(a, dims)])
        hist = torch.cat([hist[1:], pair[None]])
        hmask = torch.cat([hmask[1:], torch.ones_like(hmask[:1])])
        st, *_ = env.step(st, {k: v[None] for k, v in a.items()},
                          env.draw(gen, 1))

    dev_pos = st.dev_pos[0].cpu().numpy()
    eav_pos = st.eav_pos[0].cpu().numpy()
    stage_dev = [int(d) for d in st.stage_dev[0].tolist()]
    boundaries = [int(b) for b in st.boundaries[0].tolist()]
    usage = decoy_usage.cpu().numpy()
    trainers = [d for d in stage_dev if d < env.U]
    decoys = [i for i in range(env.U) if usage[i] > 0 and i not in trainers]

    def min_dist_to_eave(i):
        return float(np.linalg.norm(eav_pos - dev_pos[i], axis=1).min())

    d_train = np.mean([min_dist_to_eave(i) for i in trainers]) if trainers else 0.0
    d_decoy = np.mean([min_dist_to_eave(i) for i in decoys]) if decoys else 0.0
    return {
        "dev_pos": dev_pos.tolist(),
        "eav_pos": eav_pos.tolist(),
        "stage_devices": stage_dev,
        "boundaries": boundaries,
        "decoy_usage": usage.tolist(),
        "leaked": float(st.leaked[0]),
        "mean_trainer_dist_to_eave": float(d_train),
        "mean_decoy_dist_to_eave": float(d_decoy),
    }


def main(num_envs: int = 1, seed: int = 0, device=None,
         episodes: int = EPISODES, warmup: int = WARMUP):
    env = resnet_env(device)
    cfg = SAC.SACConfig()
    res = train_sac(env, cfg, episodes=episodes, warmup_episodes=warmup,
                    seed=seed, num_envs=num_envs)
    payload = placement_example(env, res.params, cfg)
    save_json("fig9_example", dict(payload, device=device_name(env),
                                   num_envs=num_envs))
    emit_csv_row(
        "fig9/summary", 0.0,
        f"trainer_eave_dist={payload['mean_trainer_dist_to_eave']:.0f}m "
        f"decoy_eave_dist={payload['mean_decoy_dist_to_eave']:.0f}m "
        f"plan={payload['boundaries']} devices={payload['stage_devices']}")
    return payload


if __name__ == "__main__":
    main(parse_args(__doc__).num_envs)
