"""DQN baseline (paper baseline d, [35]), PyTorch port of
``repro.core.agents.dqn``.

Q-learning needs a FLAT discrete action space: the factored MHSL action
space is flattened over (u, size, p_tx, p_d) and the decoy subset is
fixed to the heuristic "all eligible devices", as in the reference.

Training runs on the port's batched rollout engine: epsilon-greedy
selection over the whole env population each step, transitions into the
device replay ring, and each chunk's gradient steps (with the periodic
target-network sync, counted over gradient steps across chunks) through
``rollout.make_fused_update``. The policy's noise is explicit: an
explore uniform and a masked categorical index per env
(:func:`epsilon_greedy` takes them; :func:`dqn_policy` draws them).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.agents import action_space as A
from repro_torch.core.agents import rollout as R
from repro_torch.core.agents.loops import TrainResult, check_run, traj_chunk_metrics
from repro_torch.core.env import NBINS, MHSLEnv
from repro_torch.device import DeviceLike
from repro_torch.nn import init_mlp, mlp_apply
from repro_torch.optim import adamw, apply_updates
from repro_torch.tree import tree_map, value_and_grad


@dataclass(frozen=True)
class DQNConfig:
    hidden: int = 128
    gamma: float = 0.95
    lr: float = 3e-4
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_episodes: int = 100
    batch: int = 128
    buffer_size: int = 50_000
    target_update: int = 200  # gradient steps between target syncs


def flat_dims(env: MHSLEnv):
    return (env.U, NBINS, env.num_power_levels, env.num_power_levels)


def unflatten_action(idx, env: MHSLEnv, masks):
    """Flat indices ``(...)`` -> the factored action, decoys on every
    eligible device."""
    _, s_n, p_n, _ = flat_dims(env)
    u = idx // (s_n * p_n * p_n)
    rem = idx % (s_n * p_n * p_n)
    size = rem // (p_n * p_n)
    rem = rem % (p_n * p_n)
    i32 = torch.int32
    return {
        "u": u.to(i32),
        "size": size.to(i32),
        "decoys": masks["decoys"].to(i32),  # heuristic: all eligible
        "p_tx": (rem // p_n).to(i32),
        "p_d": (rem % p_n).to(i32),
    }


def flat_mask(env: MHSLEnv, masks):
    """Per-head masks ``(..., n)`` -> the flat action mask ``(..., U *
    NBINS * P * P)``."""
    m = (masks["u"][..., :, None, None, None]
         & masks["size"][..., None, :, None, None]
         & masks["p_tx"][..., None, None, :, None]
         & masks["p_d"][..., None, None, None, :])
    return m.reshape(m.shape[:-4] + (-1,))


def epsilon_greedy(bundle, env: MHSLEnv, obs, masks, explore_u, rand_idx):
    """Epsilon-greedy over the flat masked action space. ``bundle`` is
    ``{"q": q-net params, "eps": epsilon}``; ``explore_u`` ``(N,)`` are
    uniforms in [0, 1) (explore where ``< eps``) and ``rand_idx`` ``(N,)``
    uniform draws among each env's valid flat actions. Returns the action
    and the extras ``{"a": flat index, "fm": flat mask}`` (``fm`` lets the
    trainer derive the next state's mask by shifting the trajectory)."""
    fm = flat_mask(env, masks)
    q = mlp_apply(bundle["q"], obs)
    greedy = torch.argmax(torch.where(fm, q, A.NEG), dim=-1)
    a = torch.where(explore_u < bundle["eps"], rand_idx, greedy).to(torch.int32)
    return unflatten_action(a, env, masks), {"a": a, "fm": fm.float()}


def dqn_policy(env: MHSLEnv) -> R.Policy:
    """:func:`epsilon_greedy` with its draws made from ``gen``."""

    def policy(bundle, gen, obs, hist, hist_mask, masks):
        fm = flat_mask(env, masks)
        explore_u = torch.rand(obs.shape[:-1], generator=gen, device=obs.device)
        rand_idx = torch.multinomial(fm.float(), 1, generator=gen)[..., 0]
        return epsilon_greedy(bundle, env, obs, masks, explore_u, rand_idx)

    return policy


DQN_FIELDS = ("obs", "obs_next", "a", "mask_next", "reward", "done")


def dqn_example(env: MHSLEnv, n_actions: int):
    """Single-transition tree defining the replay buffer layout."""
    d = env.device
    return dict(
        obs=torch.zeros((env.obs_dim,), device=d),
        obs_next=torch.zeros((env.obs_dim,), device=d),
        a=torch.zeros((), dtype=torch.int32, device=d),
        mask_next=torch.zeros((n_actions,), device=d),
        reward=torch.zeros((), device=d),
        done=torch.zeros((), device=d),
    )


def make_dqn_update(cfg: DQNConfig, opt):
    """One Q-learning step in the engine's ``update_fn`` signature. The
    "params" slot carries ``{"q", "target", "gs"}``: the target net is
    synced to the Q-net after every ``cfg.target_update``-th gradient step
    (``gs``, a host count over the whole run)."""

    def update_fn(bundle, opt_state, batch):
        params, target = bundle["q"], bundle["target"]
        with torch.no_grad():
            qn = mlp_apply(target, batch["obs_next"])
            qn = torch.where(batch["mask_next"] > 0, qn, A.NEG).max(-1).values
            tgt = batch["reward"] + cfg.gamma * (1 - batch["done"]) * qn

        def loss_fn(p):
            q = mlp_apply(p, batch["obs"])
            qa = torch.gather(q, 1, batch["a"][:, None].long())[:, 0]
            return torch.mean((qa - tgt) ** 2)

        loss, _, grads = value_and_grad(loss_fn, params)
        ups, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, ups)
        gs = bundle["gs"] + 1
        if gs % cfg.target_update == 0:
            target = params
        return {"q": params, "target": target, "gs": gs}, opt_state, loss

    return update_fn


def train_dqn(env: MHSLEnv, cfg: DQNConfig, episodes: int = 200, seed: int = 0,
              num_envs: int = 1, scenario=None,
              device: DeviceLike = None) -> TrainResult:
    """DQN on the batched engine, one fixed geometry per run. Each chunk
    rolls out ``num_envs`` episodes with epsilon decayed by the episode
    count, writes them to the replay ring, and, once it holds a batch,
    takes ``num_envs * episode_len`` gradient steps (one per env step).

    Randomness as ``train_sac``'s: weights from a CPU generator seeded
    with ``seed``; positions, draws and replay indices from a generator on
    the env's device seeded with ``seed + 1``."""
    check_run(env, num_envs, device, "train_dqn")
    n_actions = int(np.prod(flat_dims(env)))
    params = init_mlp(torch.Generator().manual_seed(seed),
                      [env.obs_dim, cfg.hidden, cfg.hidden, n_actions],
                      device=env.device)
    opt = adamw(cfg.lr)
    opt_state = opt.init(params)
    gen = torch.Generator(device=env.device).manual_seed(seed + 1)
    buf = R.buffer_init(cfg.buffer_size, dqn_example(env, n_actions))
    fused = R.make_fused_update(make_dqn_update(cfg, opt), cfg.batch,
                                env.episode_len * num_envs)
    learner = {"q": params, "target": tree_map(torch.clone, params), "gs": 0}
    policy = dqn_policy(env)
    positions = R.make_positions(env, gen, num_envs, False, scenario)

    result = TrainResult()
    seen: set = set()
    ep = 0
    while ep < episodes:
        t0 = time.perf_counter()
        eps = max(cfg.eps_end, cfg.eps_start - (cfg.eps_start - cfg.eps_end)
                  * ep / max(cfg.eps_decay_episodes, 1))
        st0 = env.reset(positions(), scenario)
        st_final, traj = R.rollout_episode(
            env, policy, {"q": learner["q"], "eps": eps}, st0, gen, 1, scenario)
        # mask_next[t] = fm[t+1]; only the final state needs a fresh mask
        final = flat_mask(env, env.action_masks(st_final)).float()
        traj["mask_next"] = torch.cat([traj["fm"][:, 1:], final[:, None]], 1)
        R.buffer_add(buf, R.flatten_transitions(traj, DQN_FIELDS))
        upd = None
        if buf.size >= cfg.batch:
            learner, opt_state, loss = fused(learner, opt_state, buf, gen)
            upd = {"loss": loss}
        traj_chunk_metrics(result, seen, traj, upd, ep, episodes, num_envs)
        result.chunk_seconds.append(time.perf_counter() - t0)
        result.chunk_updated.append(upd is not None)
        ep += num_envs

    result.params = learner["q"]
    return result
