"""Decoder LM assembly: embedding -> layer stack -> logits.

Port of ``repro.models.model``, cache-free. The per-layer ``signature``
(block kind A/M, MoE flag, MLP presence) is derived from the config and
the layers are grouped into the smallest repeating period, as the
reference groups them for its ``lax.scan``. The param tree keeps the
reference's layout, so weights carry over leaf for leaf: ``{"embed":
(V, D), "final_norm": (D,), "slots": (slot_0, ..., slot_{p-1}),
["lm_head": (D, V)]}``, where slot ``i`` holds the tensors of layers
``i, i + p, i + 2p, ...`` stacked on a leading axis. The forward is a
Python loop over the layers; for serving it threads the KV and SSM
caches (:func:`init_caches`, the same stacked per-slot layout) through
the same loop. Modality frontends are not ported and raise.
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
                cache=None, cache_index=None, impl: str = "auto", plan=None):
    """One residual block. Returns ``(x, new_cache, aux)``.

    ``impl="pallas_stage"`` (the split executor's
    ``PipelineConfig.stage_impl="pallas"``) routes a dense MLP half-block
    through the hand-written stage kernel and leaves the attention or
    Mamba half on ``"auto"``; ``impl="pallas"`` takes the attention half
    through the flash kernel and the Mamba half through the scan kernel.
    An MoE half-block takes the config's dispatch whatever ``impl`` is:
    ``moe_apply_dropless`` with its default route, or ``moe_apply``.

    ``cache`` (serving): ``{"k", "v"}`` for an attention block, ``{"ssm",
    "conv"}`` for a Mamba block, with ``cache_index`` the entries already
    seen (a scalar or a (B,) vector); ``new_cache`` is the updated cache,
    ``{}`` without one. ``plan``: the forward's shared
    ``layers.CachePlan`` for an attention block (made per block when
    None)."""
    kind, is_moe, has_mlp = slot_sig
    if impl not in BLOCK_IMPLS:
        raise ValueError(f"unknown block impl {impl!r}; have {BLOCK_IMPLS}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    half_impl = "auto" if impl == "pallas_stage" else impl
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "A":
        out, new_kv = L.attention_apply(
            p["attn"], h, cfg, positions=positions,
            kv_cache=None if cache is None else {"k": cache["k"], "v": cache["v"]},
            cache_index=cache_index, impl=half_impl, plan=plan)
        new_cache = {} if new_kv is None else new_kv
    else:
        out, (new_ssm, new_conv) = S.mamba_apply(
            p["mamba"], h, cfg,
            ssm_state=None if cache is None else cache["ssm"],
            conv_state=None if cache is None else cache["conv"],
            use_pallas=half_impl == "pallas")
        new_cache = {} if cache is None else {"ssm": new_ssm, "conv": new_conv}
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
    return x, new_cache, aux


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
# caches
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                dtype=torch.bfloat16, device: DeviceLike = None):
    """Per-slot stacked caches (leading dim = repeats), zero-filled: an
    attention slot ``{"k", "v"}`` (R, B, kv_len, KH, hd) in ``dtype``
    (kv_len = ``min(cache_len, window)`` under a sliding window), a Mamba
    slot ``{"ssm"}`` (R, B, H, P, N) in f32 and ``{"conv"}`` (R, B, K-1,
    di + 2N) in ``dtype``.

    Zeros, never ``torch.empty``: the serving engine never clears a freed
    slot and leans on every cache entry being finite (a masked finite
    value weighs exactly 0; a NaN would poison the row max)."""
    sig = signature(cfg)
    period = find_period(sig)
    repeats = cfg.num_layers // period
    dev = resolve_device(device)
    kv_len = (min(cache_len, cfg.attention_window)
              if cfg.attention_window is not None else cache_len)
    caches = []
    for si in range(period):
        if sig[si][0] == "A":
            shape = (repeats, batch, kv_len, cfg.num_kv_heads, cfg.head_dim)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)})
        else:
            sc = cfg.ssm
            di = sc.d_inner(cfg.d_model)
            nh = sc.num_heads(cfg.d_model)
            caches.append({
                "ssm": torch.zeros((repeats, batch, nh, sc.head_dim, sc.d_state),
                                   dtype=torch.float32, device=dev),
                "conv": torch.zeros((repeats, batch, sc.d_conv - 1,
                                     di + 2 * sc.d_state), dtype=dtype, device=dev),
            })
    return tuple(caches)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(params, tokens: Tensor, cfg: ModelConfig, *, caches=None,
            cache_index=None, frontend_feats=None, impl: str = "auto",
            remat: bool = False, compute_dtype=torch.bfloat16):
    """tokens: (B, S) int. Returns ``(logits, new_caches, aux)``, ``aux``
    the sum of the MoE blocks' router losses.

    With ``caches`` (from :func:`init_caches`) the blocks read and write
    them at ``cache_index``: a scalar count of entries already seen (the
    inputs sit at ``cache_index + arange(S)``) or a (B,) vector of
    per-row counts (row ``b`` at ``cache_index[b] + arange(S)``, the
    serving engine's slots); ``new_caches`` has the same layout, None
    without caches. ``remat`` recomputes each period of blocks in the
    backward pass (``torch.utils.checkpoint``); the value is the same
    either way."""
    if frontend_feats is not None:
        raise NotImplementedError("modality frontends are not ported")
    _no_frontend(cfg)
    sig = signature(cfg)
    period = find_period(sig)
    x = params["embed"].to(compute_dtype)[tokens.long()]
    s = x.shape[1]
    steps = torch.arange(s, device=x.device)
    if cache_index is None:
        positions = steps
    else:
        idx = torch.as_tensor(cache_index, device=x.device).to(torch.long)
        # per-row positions (B, S) for a vector index, else (S,)
        positions = idx[:, None] + steps if idx.dim() == 1 else idx + steps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # the attention layers' shared rope angles, write rows and mask
    plan = None
    attn = [si for si in range(period) if sig[si][0] == "A"]
    if caches is not None and attn:
        plan = L.cache_plan(cfg, positions, cache_index, x.shape[0], s,
                            caches[attn[0]]["k"].shape[2])

    def run(blocks, layer_caches, xact, aux):
        new = []
        for si in range(period):
            xact, nc, a = block_apply(
                blocks[si], xact, cfg, sig[si], positions=positions,
                cache=None if layer_caches is None else layer_caches[si],
                cache_index=cache_index, impl=impl, plan=plan)
            new.append(nc)
            aux = aux + a
        return xact, aux, new

    per_layer = []
    for r in range(cfg.num_layers // period):
        blocks = [layer_params(slot, r) for slot in params["slots"]]
        layer_caches = None if caches is None else [
            layer_params(c, r) for c in caches]
        if remat and torch.is_grad_enabled() and caches is None:
            from torch.utils.checkpoint import checkpoint

            x, aux = checkpoint(lambda b, xx, a: run(b, None, xx, a)[:2],
                                blocks, x, aux, use_reentrant=False)
        else:
            x, aux, new = run(blocks, layer_caches, x, aux)
            per_layer.append(new)
    new_caches = None
    if caches is not None:
        new_caches = tuple(
            tree_map(lambda *xs: torch.stack(xs), *[nc[si] for nc in per_layer])
            for si in range(period))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = x @ head.to(compute_dtype)
    return logits, new_caches, aux


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


def make_prefill_step(cfg: ModelConfig, *, impl="auto",
                      compute_dtype=torch.bfloat16):
    """``prefill(params, tokens, caches) -> (last logits (B, V), caches)``:
    a fresh-sequence pass (scalar cache index 0) through ``caches``."""

    def prefill(params, tokens, caches, frontend_feats=None):
        logits, new_caches, _ = forward(
            params, tokens, cfg, caches=caches, cache_index=0,
            frontend_feats=frontend_feats, impl=impl,
            compute_dtype=compute_dtype)
        return logits[:, -1], new_caches

    return prefill


def make_decode_step(cfg: ModelConfig, *, impl="auto",
                     compute_dtype=torch.bfloat16):
    """``decode(params, tokens (B, 1), caches, cache_index) -> (logits
    (B, V), caches)``; ``cache_index`` is the tokens already seen, a
    scalar (a lockstep batch) or a (B,) vector (per-slot counts, the
    serving engine)."""

    def decode(params, tokens, caches, cache_index):
        logits, new_caches, _ = forward(
            params, tokens, cfg, caches=caches, cache_index=cache_index,
            impl=impl, compute_dtype=compute_dtype)
        return logits[:, -1], new_caches

    return decode
