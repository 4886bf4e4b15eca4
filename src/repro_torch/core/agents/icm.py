"""Intrinsic Curiosity Module (paper §III-A.4, Eqs. 17-19, 22, 25-27).

Port of ``repro.core.agents.icm``:
  * feature extractor  phi(s)           (Eq. 17), sigmoid output in [0,1]
  * forward dynamics   phi_hat(s') = f(phi(s), a)    (Eq. 18), MLP+residual
    encoder then a GRU cell
  * inverse dynamics   p_hat(a | phi(s), phi(s'))    (Eq. 19), factored
    over the action heads

Losses: L_I (Eq. 25) cross-entropy, L_F (Eq. 26) 0.5 L2; intrinsic reward
R_C (Eq. 22). ``detach`` stands for JAX's ``stop_gradient``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.agents import action_space as A
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import (
    gru_apply,
    init_gru,
    init_mlp,
    init_residual_mlp,
    mlp_apply,
    residual_mlp_apply,
)


def init_icm(gen: torch.Generator, obs_dim: int, action_dims: Dict[str, int],
             feat_dim: int = 32, hidden: int = 128,
             device: DeviceLike = None):
    device = resolve_device(device)
    adim = A.flat_dim(action_dims)
    return {
        "feat": init_residual_mlp(gen, obs_dim, hidden, 2, feat_dim, device=device),
        "fwd_in": init_residual_mlp(gen, feat_dim + adim, hidden, 1, hidden,
                                    device=device),
        "fwd_gru": init_gru(gen, hidden, feat_dim, device=device),
        "inv": init_mlp(gen, [2 * feat_dim, hidden, sum_head_dims(action_dims)],
                        device=device),
    }


def sum_head_dims(action_dims: Dict[str, int]) -> int:
    return (action_dims["u"] + action_dims["size"] + 2 * action_dims["decoys"]
            + action_dims["p_tx"] + action_dims["p_d"])


def split_heads(raw, action_dims: Dict[str, int]):
    """Flat head output -> per-head logits (decoys as (..., U, 2))."""
    sizes = [action_dims["u"], action_dims["size"], 2 * action_dims["decoys"],
             action_dims["p_tx"], action_dims["p_d"]]
    u, size, dec, p_tx, p_d = torch.split(raw, sizes, dim=-1)
    return {
        "u": u,
        "size": size,
        "decoys": dec.reshape(dec.shape[:-1] + (action_dims["decoys"], 2)),
        "p_tx": p_tx,
        "p_d": p_d,
    }


def features(params, obs):
    """phi(s) in [0,1]^feat (Eq. 17)."""
    return residual_mlp_apply(params["feat"], obs, final_act=torch.sigmoid)


def forward_model(params, phi, action_vec):
    """phi_hat(s') (Eq. 18): MLP+residual encoder, then a GRU cell with phi
    as the hidden state (output squashed to [0,1] like phi)."""
    h = residual_mlp_apply(params["fwd_in"], torch.cat([phi, action_vec], -1))
    return torch.sigmoid(gru_apply(params["fwd_gru"], phi, h))


def inverse_logits(params, phi, phi_next, action_dims):
    raw = mlp_apply(params["inv"], torch.cat([phi, phi_next], -1))
    return split_heads(raw, action_dims)


def icm_losses(params, obs, obs_next, action, action_vec, action_dims):
    """Returns (L_I, L_F, R_C) for a batch (Eqs. 22, 25, 26)."""
    phi = features(params, obs)
    phi_next = features(params, obs_next)
    phi_hat = forward_model(params, phi, action_vec)
    l_f = 0.5 * torch.sum((phi_hat - phi_next.detach()) ** 2, -1)
    inv = inverse_logits(params, phi, phi_next, action_dims)
    l_i = -A.log_prob(inv, action)  # cross-entropy with one-hot b(n)
    r_c = 0.5 * torch.sum((phi_hat.detach() - phi_next.detach()) ** 2, -1)
    return l_i.mean(), l_f.mean(), r_c
