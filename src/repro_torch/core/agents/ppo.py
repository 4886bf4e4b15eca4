"""PPO baseline (paper baseline c, [34]), PyTorch port of
``repro.core.agents.ppo``.

Clipped-objective PPO over the same factored masked action space, the
actor on the raw state (no CA, no ICM), a V critic with GAE. Rollouts run
on the port's batched engine, recording each step's log-prob and value;
GAE runs per env over the episode axis; batches gather across chunks
until ``episodes_per_batch`` episodes are in, their advantages are
normalised over the batch, and ``epochs`` passes update the policy
(``rollout.make_scan_updates``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.core.agents import action_space as A
from repro_torch.core.agents import rollout as R
from repro_torch.core.agents.icm import split_heads, sum_head_dims
from repro_torch.core.agents.loops import TrainResult, check_run, traj_chunk_metrics
from repro_torch.core.env import MHSLEnv
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import init_mlp, mlp_apply
from repro_torch.optim import adamw, apply_updates
from repro_torch.tree import tree_map, value_and_grad


@dataclass(frozen=True)
class PPOConfig:
    hidden: int = 128
    gamma: float = 0.95
    lam: float = 0.95
    clip: float = 0.2
    lr: float = 3e-4
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    episodes_per_batch: int = 8
    epochs: int = 4


def init_ppo(gen: torch.Generator, obs_dim: int, action_dims: Dict[str, int],
             cfg: PPOConfig, device: DeviceLike = None):
    """Fresh actor and critic on ``device`` (``cuda`` by default); ``gen``
    is a CPU generator."""
    device = resolve_device(device)
    h = cfg.hidden
    return {
        "actor": init_mlp(gen, [obs_dim, h, h, sum_head_dims(action_dims)],
                          device=device),
        "critic": init_mlp(gen, [obs_dim, h, h, 1], device=device),
    }


def ppo_logits(params, obs, masks, action_dims):
    raw = mlp_apply(params["actor"], obs)
    return A.masked_logits(split_heads(raw, action_dims), masks)


def ppo_policy(action_dims: Dict[str, int]) -> R.Policy:
    """Sampling policy that also records the log-prob and value of each
    step (extras ``logp``, ``v``)."""

    def policy(params, gen, obs, hist, hist_mask, masks):
        logits = ppo_logits(params, obs, masks, action_dims)
        action = A.sample(logits, A.gumbel_like(logits, gen))
        lp = A.log_prob(logits, action)
        v = mlp_apply(params["critic"], obs)[..., 0]
        return action, {"logp": lp, "v": v}

    return policy


def ppo_loss(params, batch, action_dims, cfg: PPOConfig):
    """``(loss, (pg, vloss, ent))``: the clipped surrogate, the value
    regression onto the GAE returns and the mean entropy."""
    logits = ppo_logits(params, batch["obs"], batch["masks"], action_dims)
    lp, ent = A.log_prob_entropy(logits, batch["action"])
    ratio = torch.exp(lp - batch["logp_old"])
    adv = batch["adv"]
    clipped = torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv
    pg = -torch.mean(torch.minimum(ratio * adv, clipped))
    v = mlp_apply(params["critic"], batch["obs"])[..., 0]
    vloss = torch.mean((batch["ret"] - v) ** 2)
    ent = torch.mean(ent)
    return pg + cfg.value_coef * vloss - cfg.entropy_coef * ent, (pg, vloss, ent)


def make_ppo_update(action_dims, cfg: PPOConfig):
    """``(update, init_opt)``: one AdamW step on :func:`ppo_loss`, with
    metrics ``{"loss", "pg", "v", "ent"}``."""
    opt = adamw(cfg.lr)

    def update(params, opt_state, batch):
        loss, (pg, vloss, ent), grads = value_and_grad(
            lambda p: ppo_loss(p, batch, action_dims, cfg), params)
        ups, opt_state = opt.update(grads, opt_state, params)
        return (apply_updates(params, ups), opt_state,
                {"loss": loss, "pg": pg, "v": vloss, "ent": ent})

    return update, opt.init


PPO_FIELDS = ("obs", "masks", "action", "logp", "adv", "ret")


def normalize_adv(adv):
    """Advantages normalised over the whole batch (population std)."""
    return (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-6)


def train_ppo(env: MHSLEnv, cfg: PPOConfig, episodes: int = 200, seed: int = 0,
              num_envs: int = 1, scenario=None,
              device: DeviceLike = None) -> TrainResult:
    """PPO on the batched engine, one fixed geometry per run. Chunks of
    ``num_envs`` episodes gather until ``cfg.episodes_per_batch`` are in
    (several chunks feed one update where ``num_envs`` is smaller), then
    ``cfg.epochs`` passes update on the whole batch. Randomness as
    ``train_sac``'s."""
    check_run(env, num_envs, device, "train_ppo")
    adims = env.action_dims
    params = init_ppo(torch.Generator().manual_seed(seed), env.obs_dim, adims,
                      cfg, device=env.device)
    update, init_opt = make_ppo_update(adims, cfg)
    opt_state = init_opt(params)
    run_epochs = R.make_scan_updates(update, cfg.epochs)
    gen = torch.Generator(device=env.device).manual_seed(seed + 1)
    policy = ppo_policy(adims)
    positions = R.make_positions(env, gen, num_envs, False, scenario)

    result = TrainResult()
    seen: set = set()
    pending = []  # flattened chunk batches awaiting a policy update
    pending_eps = 0
    ep = 0
    while ep < episodes:
        t0 = time.perf_counter()
        st0 = env.reset(positions(), scenario)
        _, traj = R.rollout_episode(env, policy, params, st0, gen, 1, scenario)
        adv, ret = R.gae(traj["reward"], traj["v"], cfg.gamma, cfg.lam)
        pending.append(R.flatten_transitions(dict(traj, adv=adv, ret=ret),
                                             PPO_FIELDS))
        pending_eps += num_envs
        upd = None
        if pending_eps >= cfg.episodes_per_batch:
            batch = tree_map(lambda *xs: torch.cat(xs), pending[0], *pending[1:])
            batch["logp_old"] = batch.pop("logp")
            batch["adv"] = normalize_adv(batch["adv"])
            params, opt_state, upd = run_epochs(params, opt_state, batch)
            pending, pending_eps = [], 0
        traj_chunk_metrics(result, seen, traj, upd, ep, episodes, num_envs)
        result.chunk_seconds.append(time.perf_counter() - t0)
        result.chunk_updated.append(upd is not None)
        ep += num_envs

    result.params = params
    return result
