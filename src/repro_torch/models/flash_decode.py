"""Distributed flash-decoding over a length-sharded KV cache, the
counterpart of ``repro.models.flash_decode``.

When the model axis does not divide the GQA KV heads, the KV cache is
split by length over it (``distribution.sharding.cache_shardings``).
Each rank attends over its own part of the cache and the parts are
combined with softmax statistics: a max all-reduce of the row maxima,
then one sum all-reduce of the partial ``p @ v`` and ``sum(p)`` side by
side, all in f32. Per layer the cross-rank traffic is (B, H, hd)
partials and (B, H) statistics. Forward only, as the reference's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distribution import collectives as C
from repro_torch.distribution import context as ctx

Tensor = torch.Tensor

NEG = -1e30


def flash_decode(q: Tensor, ck: Tensor, cv: Tensor, cache_index, *,
                 window: Optional[int] = None) -> Tensor:
    """q (B, 1, H, hd), the same on every rank of the model axis; ck / cv
    (B, L_loc, KH, hd), this rank's part of the cache along its length
    (rank ``i`` of the model axis holds positions ``i * L_loc +
    arange(L_loc)``); ``cache_index`` the current position, a scalar or a
    (B,) vector of per-row positions. Returns (B, 1, H, hd) in q's dtype.
    Outside an activation-sharding context, or on a model axis of one
    rank, the cache is whole."""
    mesh = ctx.mesh()
    model_ax = ctx.model_axis()
    shard = 0
    if mesh is not None and model_ax in mesh.axis_names:
        shard = mesh.axis_index(model_ax)
    b, _, h, hd = q.shape
    l_loc, kh = ck.shape[1], ck.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    idx = torch.as_tensor(cache_index, device=q.device).to(torch.long)
    kpos = shard * l_loc + torch.arange(l_loc, device=q.device)
    if idx.dim() == 1:
        # per-row cache index: (B, L_loc) validity
        ok = kpos[None, :] <= idx[:, None]
        if window is not None:
            ok = ok & (kpos[None, :] > idx[:, None] - window)
        okb = ok[:, None, :]
    else:
        ok = kpos <= idx
        if window is not None:
            ok = ok & (kpos > idx - window)
        okb = ok[None, None, :]
    kr = ck.float().repeat_interleave(g, dim=2)
    vr = cv.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), kr) * scale  # (B, H, L_loc)
    s = torch.where(okb, s, NEG)
    m = s.amax(dim=-1)
    if mesh is not None:
        m = C.all_reduce(m, mesh, model_ax, op="max")
    p = torch.where(okb, torch.exp(s - m[..., None]), 0.0)
    # the partial p @ v and sum(p), summed over the axis in one transfer
    acc = torch.cat([torch.einsum("bhk,bkhd->bhd", p, vr), p.sum(dim=-1)[..., None]],
                    dim=-1)
    if mesh is not None:
        acc = C.all_reduce(acc, mesh, model_ax)
    out = acc[..., :hd] / torch.clamp(acc[..., hd:], min=1e-30)
    return out[:, None].to(q.dtype)
