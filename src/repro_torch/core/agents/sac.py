"""ICM-CA soft actor-critic (paper §III, Algorithm 1), PyTorch port.

Port of ``repro.core.agents.sac``: a V-network critic on TD targets
(Eq. 28), an entropy-regularized actor on the TD advantage (Eq. 29),
cross-attention state enhancement s'(n) (Eq. 24) and the ICM intrinsic
reward (Eq. 23), with both of the reference's updates: the single-backward
joint update (``joint_update=True``, the default) and the sequential
three-backward one (critic, then the actor against the *updated*
critic's advantage, then the ICM). Parameters are nested dicts of tensors
in the reference's layout; ``detach`` stands for ``stop_gradient``.

Every cross-attention of the actor (the actor forward, ``joint_loss``,
the sequential actor loss and ``select_action``) goes through the kernel
wrapper ``repro_torch.kernels.ca_attention``,
which launches the hand-written kernel for CUDA tensors and runs its plain
version only for CPU tensors; it takes a batch ``(B, obs_dim)`` and raises
on anything else. Unlike the JAX package, where the rollout policy runs
under ``vmap`` with ``obs.ndim == 1`` and so always takes the reference
path, the port's rollout is batched ``(num_envs, obs_dim)``, so the
rollout goes through the kernel too. The value is the same, because
``cross_attention`` and ``cross_attention_slim`` agree on the
current-state row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.agents import action_space as A
from repro_torch.core.agents import icm as ICM
from repro_torch.core.agents.attention import init_cross_attention
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ca_attention as CA
from repro_torch.nn import init_mlp, mlp_apply
from repro_torch.optim import adamw, apply_updates
from repro_torch.tree import tree_map, value_and_grad


@dataclass(frozen=True)
class SACConfig:
    hidden: int = 128
    feat_dim: int = 32
    attn_dim: int = 64
    hist_len: int = 4  # I in Eq. 24
    gamma: float = 0.95
    alpha: float = 0.03  # entropy weight (Eq. 29)
    zeta: float = 0.3  # intrinsic-reward weight (Table I)
    v_inv: float = 6.0  # v in Eq. 27 (Table I: 5-8)
    eta_a: float = 1e-4  # actor lr (Table I)
    eta_c: float = 3e-4  # critic lr (Table I)
    eta_icm: float = 3e-4
    batch: int = 128
    buffer_size: int = 50_000
    updates_per_step: int = 2
    use_icm: bool = True
    use_ca: bool = True
    joint_update: bool = True


def init_agent(gen: torch.Generator, obs_dim: int, action_dims: Dict[str, int],
               cfg: SACConfig, device: DeviceLike = None):
    """Fresh agent parameters on ``device`` (``cuda`` by default); ``gen``
    is a CPU generator (weights are drawn on the CPU and moved)."""
    device = resolve_device(device)
    pair_dim = obs_dim + A.flat_dim(action_dims)
    actor_in = obs_dim + (cfg.attn_dim if cfg.use_ca else 0)
    head_out = ICM.sum_head_dims(action_dims)
    params = {
        "actor": {
            "trunk": init_mlp(gen, [actor_in, cfg.hidden, cfg.hidden], device=device),
            "heads": init_mlp(gen, [cfg.hidden, head_out], device=device),
        },
        "critic": init_mlp(gen, [obs_dim, cfg.hidden, cfg.hidden, 1], device=device),
    }
    if cfg.use_ca:
        params["actor"]["ca"] = init_cross_attention(gen, obs_dim, pair_dim,
                                                     cfg.attn_dim, device=device)
    if cfg.use_icm:
        params["icm"] = ICM.init_icm(gen, obs_dim, action_dims, cfg.feat_dim,
                                     cfg.hidden, device=device)
    return params


def _head_logits(params, x, masks, action_dims):
    """Trunk -> heads -> masked factored logits."""
    h = mlp_apply(params["actor"]["trunk"], x, final_act=F.relu)
    raw = mlp_apply(params["actor"]["heads"], h)
    return A.masked_logits(ICM.split_heads(raw, action_dims), masks)


def actor_logits(params, obs, hist, hist_mask, masks, action_dims,
                 cfg: SACConfig):
    if cfg.use_ca:
        x = CA.ca_attention(params["actor"]["ca"], obs, hist, hist_mask)
    else:
        x = obs
    return _head_logits(params, x, masks, action_dims)


def critic_v(params, obs):
    return mlp_apply(params["critic"], obs)[..., 0]


def bounded_reward(reward, r_c, cfg: SACConfig):
    """r_total = reward + zeta tanh(R_C) (Eq. 23 with the bonus bounded)."""
    return reward + cfg.zeta * torch.tanh(r_c)


def intrinsic_reward(icm_params, batch, action_dims, cfg: SACConfig):
    """``(r_total, r_c, l_i, l_f)`` with one ICM forward (Eqs. 22-23,
    25-26); ``r_c``, and so ``r_total``, carries no gradient."""
    avec = A.onehot(batch["action"], action_dims)
    l_i, l_f, r_c = ICM.icm_losses(icm_params, batch["obs"], batch["obs_next"],
                                   batch["action"], avec, action_dims)
    return bounded_reward(batch["reward"], r_c, cfg), r_c, l_i, l_f


def joint_loss(params, batch, action_dims, cfg: SACConfig):
    """Single scalar whose one backward reproduces all three heads' grads
    (critic TD regression, actor policy gradient on the detached TD
    advantage plus entropy, ICM L_F + v L_I), with shared forwards:
    ``obs`` and ``obs_next`` ride one stacked ``(2B, ...)`` forward through
    the critic and the ICM feature extractor, and the CA actor scores only
    the current-state query row."""
    b = batch["obs"].shape[0]
    both = torch.cat([batch["obs"], batch["obs_next"]], dim=0)
    v_both = critic_v(params, both)
    v, v_next = v_both[:b], v_both[b:]

    if cfg.use_icm:
        avec = A.onehot(batch["action"], action_dims)
        phi_both = ICM.features(params["icm"], both)
        phi, phi_next = phi_both[:b], phi_both[b:]
        phi_hat = ICM.forward_model(params["icm"], phi, avec)
        l_f = 0.5 * torch.sum((phi_hat - phi_next.detach()) ** 2, -1).mean()
        inv = ICM.inverse_logits(params["icm"], phi, phi_next, action_dims)
        l_i = (-A.log_prob(inv, batch["action"])).mean()
        r_c = 0.5 * torch.sum((phi_hat.detach() - phi_next.detach()) ** 2, -1)
        r_total = bounded_reward(batch["reward"], r_c, cfg)
    else:
        r_c = torch.zeros_like(batch["reward"])
        r_total = batch["reward"]

    td = r_total + cfg.gamma * (1.0 - batch["done"]) * v_next
    lc = torch.mean((r_total + cfg.gamma * (1.0 - batch["done"])
                     * v_next.detach() - v) ** 2)

    if cfg.use_ca:
        x = CA.ca_attention(params["actor"]["ca"], batch["obs"],
                            batch["hist"], batch["hist_mask"])
    else:
        x = batch["obs"]
    logits = _head_logits(params, x, batch["masks"], action_dims)
    lp, ent = A.log_prob_entropy(logits, batch["action"])
    y = (td - v).detach()
    la = -torch.mean(lp * y + cfg.alpha * ent)

    total = lc + la
    metrics = {"critic_loss": lc, "actor_loss": la, "r_c": r_c.mean()}
    if cfg.use_icm:
        total = total + l_f + cfg.v_inv * l_i
        metrics.update(icm_inv_loss=l_i, icm_fwd_loss=l_f)
    return total, metrics


def loss_and_grads(params, batch, action_dims, cfg: SACConfig):
    """``(total, metrics, grads)`` of :func:`joint_loss`; parameters the
    loss does not touch (``wq_h``) get exact zero gradients, as JAX's AD
    gives them."""
    return value_and_grad(lambda p: joint_loss(p, batch, action_dims, cfg),
                          params)


def make_update(action_dims, cfg: SACConfig):
    """``update(params, opt_state, batch) -> (params, opt_state, metrics)``
    and ``init_opt(params)``; optimizer state is the reference's
    ``{actor, critic, icm}`` AdamW triple layout for both updates.
    ``cfg.joint_update`` picks the single-backward joint update; ``False``
    the sequential three-backward one, step for step the reference's."""
    opt_a = adamw(cfg.eta_a)
    opt_c = adamw(cfg.eta_c)
    opt_i = adamw(cfg.eta_icm)

    def init_opt(params):
        return {
            "actor": opt_a.init(params["actor"]),
            "critic": opt_c.init(params["critic"]),
            "icm": opt_i.init(params["icm"]) if cfg.use_icm else (),
        }

    def joint(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(params, batch, action_dims, cfg)
        new_params = dict(params)
        new_opt = dict(opt_state)
        heads = [("actor", opt_a), ("critic", opt_c)]
        if cfg.use_icm:
            heads.append(("icm", opt_i))
        for name, opt in heads:
            upd, new_opt[name] = opt.update(grads[name], opt_state[name],
                                            params[name])
            new_params[name] = apply_updates(params[name], upd)
        return new_params, new_opt, metrics

    def with_head(params, name, sub):
        p = dict(params)
        p[name] = sub
        return p

    def loss_critic(critic, params, batch, r_total):
        p = with_head(params, "critic", critic)
        v = critic_v(p, batch["obs"])
        v_next = critic_v(p, batch["obs_next"]).detach()
        target = r_total + cfg.gamma * (1.0 - batch["done"]) * v_next
        return torch.mean((target - v) ** 2)

    def loss_actor(actor, params, batch, r_total):
        p = with_head(params, "actor", actor)
        logits = actor_logits(p, batch["obs"], batch["hist"],
                              batch["hist_mask"], batch["masks"], action_dims,
                              cfg)
        lp = A.log_prob(logits, batch["action"])
        ent = A.entropy(logits)
        # the critic here is the one just updated; its values carry no
        # gradient into the actor
        with torch.no_grad():
            v = critic_v(p, batch["obs"])
            v_next = critic_v(p, batch["obs_next"])
            y = r_total + cfg.gamma * (1.0 - batch["done"]) * v_next - v
        return -torch.mean(lp * y + cfg.alpha * ent)

    def loss_icm(icm, batch):
        avec = A.onehot(batch["action"], action_dims)
        l_i, l_f, _ = ICM.icm_losses(icm, batch["obs"], batch["obs_next"],
                                     batch["action"], avec, action_dims)
        return l_f + cfg.v_inv * l_i, (l_i, l_f)

    def sequential(params, opt_state, batch):
        if cfg.use_icm:
            with torch.no_grad():
                r_total, r_c, _, _ = intrinsic_reward(params["icm"], batch,
                                                      action_dims, cfg)
        else:
            r_c = torch.zeros_like(batch["reward"])
            r_total = batch["reward"]
        params = dict(params)
        new_opt = dict(opt_state)

        def descend(name, opt, loss):
            """One AdamW step of head ``name`` on ``loss(head params)``,
            in place in ``params`` / ``new_opt``; returns (value, aux)."""
            value, aux, grads = value_and_grad(loss, params[name])
            upd, new_opt[name] = opt.update(grads, opt_state[name], params[name])
            params[name] = apply_updates(params[name], upd)
            return value, aux

        lc, _ = descend("critic", opt_c,
                        lambda c: loss_critic(c, params, batch, r_total))
        # params now holds the updated critic
        la, _ = descend("actor", opt_a,
                        lambda a: loss_actor(a, params, batch, r_total))
        metrics = {"critic_loss": lc, "actor_loss": la, "r_c": r_c.mean()}
        if cfg.use_icm:
            _, (l_i, l_f) = descend("icm", opt_i, lambda i: loss_icm(i, batch))
            metrics.update(icm_inv_loss=l_i, icm_fwd_loss=l_f)
        return params, new_opt, metrics

    return (joint if cfg.joint_update else sequential), init_opt


@torch.no_grad()
def select_action(params, gumbel, obs, hist, hist_mask, masks, action_dims,
                  cfg: SACConfig):
    """One env's action (the reference's ``select_action``): ``obs``
    (obs_dim,), ``hist`` (I, pair_dim), ``hist_mask`` (I,), ``masks`` per
    head without a batch axis, and ``gumbel`` the draw's noise shaped like
    one env's logits (``A.gumbel(A.head_shapes(action_dims), gen, dev)``).
    Runs the batched actor at B = 1, through the kernel wrapper like every
    other actor forward."""
    def one(x):
        return x[None]

    logits = actor_logits(params, one(obs), one(hist), one(hist_mask),
                          tree_map(one, masks), action_dims, cfg)
    action = A.sample(logits, tree_map(one, gumbel))
    return {k: v[0] for k, v in action.items()}
