"""Decoder LM assembly: embedding -> layer stack -> logits.

Port of ``repro.models.model``, cache-free. The per-layer ``signature``
(block kind A/M, MoE flag, MLP presence) is derived from the config and
the layers are grouped into the smallest repeating period, as the
reference groups them for its ``lax.scan``. The param tree keeps the
reference's layout, so weights carry over leaf for leaf: ``{"embed":
(V, D), "final_norm": (D,), "slots": (slot_0, ..., slot_{p-1}),
["lm_head": (D, V)]}``, where slot ``i`` holds the tensors of layers
``i, i + p, i + 2p, ...`` stacked on a leading axis. The forward is a
Python loop over the layers. Modality frontends and caches (serving) are
not ported and raise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.optim.optimizers import apply_updates
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor

# the model-stack routes of block_apply's ``impl``
BLOCK_IMPLS = ("auto", "dense", "chunked", "pallas", "pallas_stage")


# ---------------------------------------------------------------------------
# layer signatures and period grouping
# ---------------------------------------------------------------------------


def signature(cfg: ModelConfig):
    """Per-layer (kind, is_moe, has_mlp)."""
    sig = []
    for i in range(cfg.num_layers):
        kind = cfg.pattern[i]
        is_moe = cfg.is_moe_block(i) and (kind == "A" or cfg.arch_type == "hybrid")
        has_mlp = kind == "A" or cfg.arch_type == "hybrid"
        sig.append((kind, is_moe, has_mlp))
    return tuple(sig)


def find_period(sig) -> int:
    n = len(sig)
    for p in range(1, n + 1):
        if n % p == 0 and all(sig[i] == sig[i % p] for i in range(n)):
            return p
    return n


def _no_frontend(cfg: ModelConfig) -> None:
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: modality frontends are not ported")


# ---------------------------------------------------------------------------
# per-slot block init / apply
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, slot_sig,
               dtype=torch.float32, device: DeviceLike = None):
    kind, is_moe, has_mlp = slot_sig
    dev = resolve_device(device)
    p: Dict[str, Any] = {"norm1": torch.ones((cfg.d_model,), dtype=dtype, device=dev)}
    if kind == "A":
        p["attn"] = L.init_attention(gen, cfg, dtype, device=dev)
    else:
        p["mamba"] = S.init_mamba(gen, cfg, dtype, device=dev)
    if has_mlp:
        p["norm2"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
        if is_moe:
            p["moe"] = L.init_moe(gen, cfg, dtype, device=dev)
        else:
            p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                                  dtype, device=dev)
    return p


def block_apply(p, x: Tensor, cfg: ModelConfig, slot_sig, *, positions,
                cache=None, cache_index=None, impl: str = "auto"):
    """One residual block. Returns ``(x, new_cache, aux)``.

    ``impl="pallas_stage"`` (the split executor's
    ``PipelineConfig.stage_impl="pallas"``) routes a dense MLP half-block
    through the hand-written stage kernel and leaves the attention or
    Mamba half on ``"auto"``; ``impl="pallas"`` takes the attention half
    through the flash kernel and the Mamba half through the scan kernel.
    An MoE half-block takes the config's dispatch whatever ``impl`` is:
    ``moe_apply_dropless`` with its default route, or ``moe_apply``."""
    kind, is_moe, has_mlp = slot_sig
    if cache is not None or cache_index is not None:
        raise NotImplementedError("cached blocks come with the serving slice")
    if impl not in BLOCK_IMPLS:
        raise ValueError(f"unknown block impl {impl!r}; have {BLOCK_IMPLS}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    half_impl = "auto" if impl == "pallas_stage" else impl
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "A":
        out, _ = L.attention_apply(p["attn"], h, cfg, positions=positions,
                                   impl=half_impl)
    else:
        out, _ = S.mamba_apply(p["mamba"], h, cfg,
                               use_pallas=half_impl == "pallas")
    x = x + out
    if has_mlp:
        if is_moe:
            h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
            if cfg.moe.dispatch == "dropless":
                y, aux = L.moe_apply_dropless(p["moe"], h2, cfg)
            else:
                y, aux = L.moe_apply(p["moe"], h2, cfg)
            x = x + y
        elif impl == "pallas_stage":
            from repro_torch.kernels.stage_block import stage_mlp_block

            x = stage_mlp_block(p["norm2"], p["mlp"], x,
                                activation=cfg.activation, eps=cfg.norm_eps)
        else:
            x = L.mlp_block(p["norm2"], p["mlp"], x, cfg.activation, cfg.norm_eps)
    return x, {}, aux


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device: DeviceLike = None):
    """Random weights from ``gen`` (a generator on ``device``), in the
    reference's layout: one slot per position in the period, each with
    its layers stacked on a leading axis."""
    _no_frontend(cfg)
    sig = signature(cfg)
    period = find_period(sig)
    repeats = cfg.num_layers // period
    dev = resolve_device(device)
    slots = []
    for si in range(period):
        blocks = [init_block(gen, cfg, sig[si], dtype, device=dev)
                  for _ in range(repeats)]
        slots.append(tree_map(lambda *xs: torch.stack(xs), blocks[0], *blocks[1:]))
        del blocks
    params = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "slots": tuple(slots),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                         generator=gen, device=dev)
                             / math.sqrt(cfg.d_model)).to(dtype)
    return params


def layer_params(slot, i: int):
    """Repeat ``i``'s block params: views into the stacked slot."""
    return tree_map(lambda a: a[i], slot)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(params, tokens: Tensor, cfg: ModelConfig, *, caches=None,
            cache_index=None, frontend_feats=None, impl: str = "auto",
            remat: bool = False, compute_dtype=torch.bfloat16):
    """tokens: (B, S) int. Returns ``(logits, None, aux)``, ``aux`` the sum
    of the MoE blocks' router losses.

    ``remat`` recomputes each period of blocks in the backward pass
    (``torch.utils.checkpoint``); the value is the same either way."""
    if caches is not None or cache_index is not None:
        raise NotImplementedError("cached forward comes with the serving slice")
    if frontend_feats is not None:
        raise NotImplementedError("modality frontends are not ported")
    _no_frontend(cfg)
    sig = signature(cfg)
    period = find_period(sig)
    x = params["embed"].to(compute_dtype)[tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(blocks, xact, aux):
        for si in range(period):
            xact, _, a = block_apply(blocks[si], xact, cfg, sig[si],
                                     positions=positions, impl=impl)
            aux = aux + a
        return xact, aux

    for r in range(cfg.num_layers // period):
        blocks = [layer_params(slot, r) for slot in params["slots"]]
        if remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            x, aux = checkpoint(run, blocks, x, aux, use_reentrant=False)
        else:
            x, aux = run(blocks, x, aux)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = x @ head.to(compute_dtype)
    return logits, None, aux


# ---------------------------------------------------------------------------
# losses and steps
# ---------------------------------------------------------------------------


def softmax_xent(logits: Tensor, labels: Tensor, mask: Optional[Tensor] = None):
    """logits: (B,S,V); labels: (B,S) int; mask: (B,S) 1 = count. f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, batch, cfg: ModelConfig, *, impl="auto", remat=True,
            compute_dtype=torch.bfloat16):
    """``(loss + aux, (loss, aux))`` of ``batch = {"tokens", "labels"[,
    "mask"]}``. ``compute_dtype`` is the reference's ``forward`` default
    (bf16); pass f32 for an f32 forward."""
    logits, _, aux = forward(params, batch["tokens"], cfg, impl=impl,
                             remat=remat,
                             compute_dtype=compute_dtype)
    loss = softmax_xent(logits, batch["labels"], batch.get("mask"))
    return loss + aux, (loss, aux)


def loss_and_grads(params, batch, cfg: ModelConfig, *, impl="auto", remat=True,
                   compute_dtype=torch.bfloat16):
    """``((total, (loss, aux)), grads)``: the value and gradient of
    :func:`loss_fn` with respect to every leaf, in the params layout."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        total, (loss, aux) = loss_fn(p, batch, cfg, impl=impl, remat=remat,
                                     compute_dtype=compute_dtype)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return ((total.detach(), (loss.detach(), aux.detach())),
            tree_unflatten(params, grads))


def make_train_step(cfg: ModelConfig, optimizer, *, impl="auto", remat=True,
                    compute_dtype=torch.bfloat16):
    """The unpipelined train step ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``: autograd of :func:`loss_fn`, then one optimizer
    update. The parity reference of the pipelined step on the card. The
    reference's mixed-precision weight copies under FSDP
    (``compute_copy_dtype``, ``param_shardings_tree``) are not ported."""

    def train_step(params, opt_state, batch):
        (total, (loss, aux)), grads = loss_and_grads(
            params, batch, cfg, impl=impl, remat=remat,
            compute_dtype=compute_dtype)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "aux": aux, "total": total}

    return train_step
