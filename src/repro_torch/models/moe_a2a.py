"""Expert-parallel MoE through an all-to-all over the model axis, the
counterpart of ``repro.models.moe_a2a``.

Each rank routes the tokens of its batch rows (the same tokens on every
rank of a model line), packs every routed copy into a capacity buffer,
and exchanges it with the model line's other ranks (the GShard /
DeepSpeed schedule)::

    local tokens -(scatter)-> (tp, E_loc*C, D)
        -- all-to-all over the model axis -->
    (tp, E_loc*C, D) for this rank's experts -> expert FFN ->
        -- all-to-all back --> combine with the gates

The capacity ``C`` comes from the rank's LOCAL token count. The slot of
each ``(token, choice)`` is its expert's running count in flat ``(token,
choice)`` order; choices at or past the capacity are dropped, in the
reference's order. The Switch load-balance loss is averaged over the
batch axes. The backward runs through the differentiable all-to-all of
``distribution.collectives`` (an all-to-all back); every rank of a model
line holds the same tokens, so each copy's gradient is taken once
(:func:`~repro_torch.distribution.collectives.scale_grad`) and the
gradient of the tokens that enter the exchange is summed over the line.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import collectives as C
from repro_torch.distribution import context as ctx
from repro_torch.models.layers import activation_fn

Tensor = torch.Tensor


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    return max(int(math.ceil(tokens * m.top_k * m.capacity_factor / m.num_experts)), 1)


def _model_line():
    """``(mesh, model axis, tp, this rank's index on it)``."""
    mesh = ctx.mesh()
    ax = ctx.model_axis()
    tp = mesh.shape.get(ax, 1)
    return mesh, ax, tp, (mesh.axis_index(ax) if tp > 1 else 0)


def _route(xt: Tensor, router: Tensor, cfg: ModelConfig, c: int):
    """``(probs, gates, ids, pos, keep)`` of tokens xt (T, D): the f32
    router softmax, the renormalized top-k gates and their experts, each
    choice's slot within its expert (flat ``(token, choice)`` order) and
    whether it is within the capacity ``c``."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = ids.reshape(-1)
    pos = torch.cumsum(F.one_hot(flat, e), dim=0) - 1
    pos = torch.gather(pos, 1, flat[:, None])[:, 0].reshape(-1, k)
    return probs, gates, ids, pos, pos < c


def dropped_choices(params, x: Tensor, cfg: ModelConfig) -> int:
    """How many of this rank's routed ``(token, choice)`` copies
    :func:`moe_apply_a2a` drops at the config's capacity factor."""
    b, s, d = x.shape
    c = _capacity(b * s, cfg)
    *_, keep = _route(x.reshape(b * s, d), params["router"], cfg, c)
    return int((~keep).sum())


def moe_apply_a2a(params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Drop-in for ``layers.moe_apply`` under an activation-sharding
    context whose model axis divides the experts. x (B_loc, S, D): this
    rank's batch rows. The expert stacks are this rank's ``E / tp``
    experts, or all ``E`` (this rank takes its own)."""
    mesh, model_ax, tp, me = _model_line()
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    e_loc = e // tp
    dt = x.dtype
    wu, wd = params["w_up"], params["w_down"]
    wg = params.get("w_gate", wu)
    if wu.shape[0] == e and tp > 1:
        wg, wu, wd = (w[me * e_loc:(me + 1) * e_loc] for w in (wg, wu, wd))
    b, s, d = x.shape
    toks = b * s
    c = _capacity(toks, cfg)
    xt = x.reshape(toks, d)
    probs, gates, ids, pos, keep = _route(xt, params["router"], cfg, c)
    # destination: expert id's block of C rows, row = its slot
    slot = ids * c + torch.clamp(pos, max=c - 1)

    xe = C.enter_parallel(xt, mesh, model_ax)
    buf = xt.new_zeros((e * c, d))
    for j in range(k):
        buf = buf.index_add(0, slot[:, j], xe * keep[:, j, None].to(dt))
    buf = buf.reshape(tp, e_loc * c, d)
    # exchange: rank p receives every rank's block for ITS experts
    recv = C.all_to_all_ad(buf, mesh, model_ax, dim=0)
    recv = recv.reshape(tp, e_loc, c, d).transpose(0, 1).reshape(e_loc, tp * c, d)

    if cfg.activation == "swiglu":
        g = torch.einsum("ekd,edf->ekf", recv, wg.to(dt))
        u = torch.einsum("ekd,edf->ekf", recv, wu.to(dt))
        h = F.silu(g) * u
    else:
        h = activation_fn(cfg.activation)(torch.einsum("ekd,edf->ekf", recv, wu.to(dt)))
    out = torch.einsum("ekf,efd->ekd", h, wd.to(dt))

    out = out.reshape(e_loc, tp, c, d).transpose(0, 1).reshape(tp, e_loc * c, d)
    back = C.all_to_all_ad(out, mesh, model_ax, dim=0)
    # every rank of the line sent the same tokens: each copy's gradient once
    back = C.scale_grad(back, 1.0 / tp).reshape(e * c, d)

    got = back[slot.reshape(-1)].reshape(toks, k, d)
    w = (gates * keep).to(dt)
    y = torch.einsum("tkd,tk->td", got, w).reshape(b, s, d)

    # load-balance aux (Switch), averaged over the batch axes
    f_e = torch.mean(F.one_hot(ids[:, 0], e).float(), dim=0)
    p_e = torch.mean(probs, dim=0)
    aux = e * torch.sum(f_e * p_e) * m.router_aux_weight
    batch = ctx.batch_axes()
    if batch:
        n = math.prod(mesh.shape.get(a, 1) for a in batch)
        aux = C.leave_parallel(aux, mesh, batch) / n
    return y, aux


def a2a_applicable(cfg: ModelConfig) -> bool:
    if not ctx.active() or not cfg.moe.enabled:
        return False
    tp = ctx.mesh().shape.get(ctx.model_axis(), 1)
    return tp > 1 and cfg.moe.num_experts % tp == 0
