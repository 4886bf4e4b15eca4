"""Cross-attention over historical state-action pairs (paper Eq. 24).

PyTorch port of ``repro.core.agents.attention``. H = the last I observed
(s, a) pairs; Q = W_Q [s(n); H], K = W_K H, V = W_V H;
s'(n) = softmax(QK^T / sqrt(C)) V. Returns the attended summary for the
current-state query row concatenated with s(n), which is what the actor
consumes. Masked scores take ``finfo(dtype).min`` (a ``-inf`` or ``-1e9``
fill would give NaN rows in fp16), and a row with no valid history
attends to nothing and returns zeros.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.layers import init_normal


def init_cross_attention(gen: torch.Generator, obs_dim: int, pair_dim: int,
                         attn_dim: int = 64, device: DeviceLike = None):
    device = resolve_device(device)
    s = 1.0 / math.sqrt(pair_dim)
    return {
        "wq_s": init_normal(gen, (obs_dim, attn_dim), 1.0 / math.sqrt(obs_dim), device),
        "wq_h": init_normal(gen, (pair_dim, attn_dim), s, device),
        "wk": init_normal(gen, (pair_dim, attn_dim), s, device),
        "wv": init_normal(gen, (pair_dim, attn_dim), s, device),
    }


def cross_attention(params, obs, history, hist_mask=None):
    """obs: (..., obs_dim); history: (..., I, pair_dim) newest-last.

    hist_mask: (..., I) 1 = valid pair. Returns (..., obs_dim + attn_dim).
    """
    q_s = obs @ params["wq_s"]  # (..., C) current-state query
    q_h = history @ params["wq_h"]  # (..., I, C) history queries (Eq. 24 Q)
    k = history @ params["wk"]
    v = history @ params["wv"]
    c = k.shape[-1]
    q = torch.cat([q_s.unsqueeze(-2), q_h], dim=-2)  # (..., I+1, C)
    scores = torch.einsum("...qc,...ic->...qi", q, k) / math.sqrt(c)
    if hist_mask is not None:
        scores = torch.where(hist_mask.unsqueeze(-2) > 0, scores,
                             torch.finfo(scores.dtype).min)
        any_valid = hist_mask.sum(-1, keepdim=True) > 0
    else:
        any_valid = torch.ones(scores.shape[:-2] + (1,), dtype=torch.bool,
                               device=scores.device)
    w = torch.softmax(scores, dim=-1)
    attended = torch.einsum("...qi,...ic->...qc", w, v)
    s_prime = attended[..., 0, :]  # the current-state row
    s_prime = torch.where(any_valid, s_prime, torch.zeros_like(s_prime))
    return torch.cat([obs, s_prime], dim=-1)


def cross_attention_slim(params, obs, history, hist_mask=None):
    """``cross_attention`` minus the dead work: only the current-state row.

    The ``W_Q H`` projection and the I history-query score rows never
    reach the output, so their gradients are exactly zero; this variant
    scores the single ``q_s`` row against K. Same values and gradients as
    the full version for everything that survives (autograd leaves
    ``wq_h`` unused, and the update step fills its gradient with zeros).
    """
    q_s = obs @ params["wq_s"]  # (..., C)
    k = history @ params["wk"]
    v = history @ params["wv"]
    c = k.shape[-1]
    scores = torch.einsum("...c,...ic->...i", q_s, k) / math.sqrt(c)
    if hist_mask is not None:
        scores = torch.where(hist_mask > 0, scores,
                             torch.finfo(scores.dtype).min)
        any_valid = hist_mask.sum(-1, keepdim=True) > 0
    else:
        any_valid = torch.ones(scores.shape[:-1] + (1,), dtype=torch.bool,
                               device=scores.device)
    w = torch.softmax(scores, dim=-1)
    s_prime = torch.einsum("...i,...ic->...c", w, v)
    s_prime = torch.where(any_valid, s_prime, torch.zeros_like(s_prime))
    return torch.cat([obs, s_prime], dim=-1)
