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
the same loop. A modality frontend's projected features (vision patches,
audio frames: :mod:`repro_torch.models.frontends`) are prepended to the
token embeddings, and the loss counts only the text region.

Sharded (``shardings=``, the records of
:func:`repro_torch.distribution.sharding.param_shardings`): the params
are this rank's blocks and the batch its rows, under an
``activation_sharding`` context on the same mesh. Each layer's blocks are
gathered just before use as the rules say (inside the rematerialized
period, so the backward gathers them again), the layers run on this
rank's heads, FFN columns, experts and vocabulary, and each gradient
comes back as the whole gradient of the rank's block.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distribution import collectives as C
from repro_torch.distribution import context as ctx
from repro_torch.distribution import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.frontends import frontend_apply, init_frontend
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
                cache=None, cache_index=None, impl: str = "auto", plan=None,
                split=None):
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
            cache_index=cache_index, impl=half_impl, plan=plan, split=split)
        new_cache = {} if new_kv is None else new_kv
    else:
        out, (new_ssm, new_conv) = S.mamba_apply(
            p["mamba"], h, cfg,
            ssm_state=None if cache is None else cache["ssm"],
            conv_state=None if cache is None else cache["conv"],
            use_pallas=half_impl == "pallas",
            split=split if split is not None and split.ssm else None)
        new_cache = {} if cache is None else {"ssm": new_ssm, "conv": new_conv}
    x = x + out
    if has_mlp:
        if is_moe:
            from repro_torch.models.moe_a2a import a2a_applicable, moe_apply_a2a

            h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
            if ctx.moe_a2a_enabled() and a2a_applicable(cfg):
                y, aux = moe_apply_a2a(p["moe"], h2, cfg)
            elif cfg.moe.dispatch == "dropless":
                y, aux = L.moe_apply_dropless(p["moe"], h2, cfg, split=split)
            else:
                y, aux = L.moe_apply(p["moe"], h2, cfg, split=split)
            x = x + y
        elif impl == "pallas_stage":
            from repro_torch.kernels.stage_block import stage_mlp_block

            if split is not None and split.mlp:
                raise NotImplementedError(
                    "the stage kernel fuses a whole MLP half-block; it does not "
                    "run on FFN columns split over the model axis")
            x = stage_mlp_block(p["norm2"], p["mlp"], x,
                                activation=cfg.activation, eps=cfg.norm_eps)
        else:
            x = L.mlp_block(p["norm2"], p["mlp"], x, cfg.activation, cfg.norm_eps,
                            split=split)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device: DeviceLike = None):
    """Random weights from ``gen`` (a generator on ``device``), in the
    reference's layout: one slot per position in the period, each with
    its layers stacked on a leading axis, and ``"frontend"`` (the
    projector) for a config with a modality frontend."""
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
    if cfg.frontend != "none":
        params["frontend"] = init_frontend(gen, cfg, dtype, device=dev)
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


def model_split(cfg: ModelConfig, shardings, caches=None, cache_shardings=None):
    """The :class:`~repro_torch.distribution.sharding.ModelSplit` of a
    sharded forward: the mesh of the records, the batch axes of the active
    ``activation_sharding`` context (which must be on that mesh), and,
    with caches, the placement of the first attention slot's KV cache."""
    mesh = tree_leaves(shardings)[0].mesh
    if not ctx.active() or ctx.mesh().shape != mesh.shape:
        raise ValueError("a sharded step runs under activation_sharding on the "
                         f"mesh of its shardings ({mesh.shape})")
    cache_spec = cache_len = None
    if caches is not None:
        sig = signature(cfg)
        attn = [si for si in range(find_period(sig)) if sig[si][0] == "A"]
        if attn:
            rec = cache_shardings[attn[0]]["k"]
            cache_spec = rec.spec
            cache_len = rec.global_shape(caches[attn[0]]["k"].shape)[2]
    return SH.model_split(cfg, mesh, ctx.batch_axes(), ctx.model_axis(),
                          cache_spec=cache_spec, cache_len=cache_len,
                          decoding=caches is not None)


def _embed_lookup(embed: Tensor, tokens: Tensor, split) -> Tensor:
    """Rows of ``embed`` for ``tokens``; with the vocabulary split over the
    model axis, each rank looks up the tokens of its rows (zeros for the
    others) and the lookups are summed over the axis."""
    if split is None or not split.vocab:
        return embed[tokens.long()]
    vb = embed.shape[0]
    ids = tokens.long() - split.index * vb
    inside = (ids >= 0) & (ids < vb)
    x = embed[ids.clamp(0, vb - 1)] * inside[..., None].to(embed.dtype)
    return C.leave_parallel(x, split.mesh, split.axis)


def forward(params, tokens: Tensor, cfg: ModelConfig, *, caches=None,
            cache_index=None, frontend_feats=None, impl: str = "auto",
            remat: bool = False, compute_dtype=torch.bfloat16,
            shardings=None, cache_shardings=None):
    """tokens: (B, S) int. Returns ``(logits, new_caches, aux)``, ``aux``
    the sum of the MoE blocks' router losses.

    ``frontend_feats`` (B, F, d_in): stub modality features, projected by
    ``params["frontend"]`` and prepended, so the logits cover ``F + S``
    positions and the text's positions start at ``F``.

    With ``caches`` (from :func:`init_caches`) the blocks read and write
    them at ``cache_index``: a scalar count of entries already seen (the
    inputs sit at ``cache_index + arange(S)``) or a (B,) vector of
    per-row counts (row ``b`` at ``cache_index[b] + arange(S)``, the
    serving engine's slots); ``new_caches`` has the same layout, None
    without caches. ``remat`` recomputes each period of blocks in the
    backward pass (``torch.utils.checkpoint``); the value is the same
    either way.

    ``shardings`` (and ``cache_shardings`` with caches): a sharded forward
    on this rank's blocks and rows (see the module docstring). Its logits
    are this rank's part of the vocabulary when the model axis splits it
    (``model_split(...).vocab``)."""
    sig = signature(cfg)
    period = find_period(sig)
    split = None
    if shardings is not None:
        split = model_split(cfg, shardings, caches, cache_shardings)

    def top(name):  # a top-level leaf as the forward computes with it
        if split is None:
            return params[name]
        return SH.use_tree(params[name], shardings[name], split, name)

    embed = top("embed")
    x = _embed_lookup(embed.to(compute_dtype), tokens, split)
    if frontend_feats is not None:
        fe = frontend_apply(top("frontend"), frontend_feats.to(compute_dtype))
        x = torch.cat([fe, x], dim=1)
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
                            (split and split.kv_len) or caches[attn[0]]["k"].shape[2])
    layer_sh = None if split is None else [
        tree_map(lambda sh: sh.drop_leading(), slot) for slot in shardings["slots"]]

    def run(blocks, layer_caches, xact, aux):
        if split is not None:  # gathered here, so a recomputed period regathers
            blocks = [SH.use_tree(blk, layer_sh[si], split, f"slots/{si}")
                      for si, blk in enumerate(blocks)]
        new = []
        for si in range(period):
            xact, nc, a = block_apply(
                blocks[si], xact, cfg, sig[si], positions=positions,
                cache=None if layer_caches is None else layer_caches[si],
                cache_index=cache_index, impl=impl, plan=plan, split=split)
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
    x = L.rms_norm(x, top("final_norm"), cfg.norm_eps)
    head = embed.T if cfg.tie_embeddings else top("lm_head")
    if split is not None and split.vocab:  # each rank's x-gradient is a part
        x = C.enter_parallel(x, split.mesh, split.axis)
    logits = x @ head.to(compute_dtype)
    return logits, new_caches, aux


# ---------------------------------------------------------------------------
# losses and steps
# ---------------------------------------------------------------------------


def softmax_xent(logits: Tensor, labels: Tensor, mask: Optional[Tensor] = None,
                 split=None):
    """logits: (B,S,V); labels: (B,S) int; mask: (B,S) 1 = count. f32.

    ``split`` (a sharded forward's): the rows are this rank's, the mean is
    over the whole batch, and this rank's part of it comes back (their
    sum over the batch axes is the loss); with the vocabulary split over
    the model axis, ``logits`` are this rank's part of it and the
    log-softmax is taken across the axis."""
    logits = logits.float()
    if split is not None and split.vocab:
        mesh, ax = split.mesh, split.axis
        m = C.all_reduce(logits.detach().amax(dim=-1), mesh, ax, op="max")
        se = C.leave_parallel(torch.exp(logits - m[..., None]).sum(-1), mesh, ax)
        logz = m + torch.log(se)
        vb = logits.shape[-1]
        ids = labels.long() - split.index * vb
        inside = (ids >= 0) & (ids < vb)
        gold = torch.gather(logits, -1, ids.clamp(0, vb - 1)[..., None])[..., 0]
        gold = C.leave_parallel(gold * inside, mesh, ax)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if split is not None and split.batch:
        count = nll.new_tensor(float(nll.numel())) if mask is None else mask.float().sum()
        count = C.all_reduce(count, split.mesh, split.batch)
        num = nll.sum() if mask is None else (nll * mask.float()).sum()
        return num / torch.clamp(count, min=1.0)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, batch, cfg: ModelConfig, *, impl="auto", remat=True,
            compute_dtype=torch.bfloat16, shardings=None):
    """``(loss + aux, (loss, aux))`` of ``batch = {"tokens", "labels"[,
    "mask"][, "frontend"]}``; with frontend features the loss counts only
    the text region (the features are a prefix). ``compute_dtype`` is the
    reference's ``forward`` default (bf16); pass f32 for an f32 forward.
    ``shardings``: a sharded forward on this rank's blocks and rows;
    ``loss`` is then this rank's part of the batch mean (see
    :func:`softmax_xent`) and ``aux`` the whole batch's."""
    frontend = batch.get("frontend")
    logits, _, aux = forward(params, batch["tokens"], cfg,
                             frontend_feats=frontend, impl=impl, remat=remat,
                             compute_dtype=compute_dtype, shardings=shardings)
    if frontend is not None:
        logits = logits[:, logits.shape[1] - batch["labels"].shape[1]:]
    split = None if shardings is None else model_split(cfg, shardings)
    loss = softmax_xent(logits, batch["labels"], batch.get("mask"), split)
    return loss + aux, (loss, aux)


def loss_and_grads(params, batch, cfg: ModelConfig, *, impl="auto", remat=True,
                   compute_dtype=torch.bfloat16, shardings=None):
    """``((total, (loss, aux)), grads)``: the value and gradient of
    :func:`loss_fn` with respect to every leaf, in the params layout.
    ``shardings``: params are this rank's blocks and ``batch`` its rows;
    the loss is the whole batch's and each gradient the whole gradient of
    the rank's block."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        total, (loss, aux) = loss_fn(p, batch, cfg, impl=impl, remat=remat,
                                     compute_dtype=compute_dtype,
                                     shardings=shardings)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = tree_unflatten(params, [torch.zeros_like(t) if g is None else g
                                    for t, g in zip(leaves, grads)])
    loss, aux = loss.detach(), aux.detach()
    if shardings is not None:
        split = model_split(cfg, shardings)
        grads = SH.sync_grads(grads, shardings, split)
        loss = C.all_reduce(loss, split.mesh, split.batch)
        total = loss + aux
    return (total.detach(), (loss, aux)), grads


def compute_copy(params, dtype):
    """The step's low-precision weight copy: every f32 leaf of two or more
    dims cast to ``dtype``, the reference's rule. A slot stacks its layers
    on a leading axis, so every slot leaf is cast (the MoE router, the
    norms and Mamba's ``a_log``, ``dt_bias`` and ``d_skip`` too), as are
    the embedding and the head; the final norm and the frontend's bias
    stay f32."""
    return tree_map(lambda a: a.to(dtype)
                    if a.dtype == torch.float32 and a.dim() >= 2 else a, params)


def make_train_step(cfg: ModelConfig, optimizer, *, impl="auto", remat=True,
                    compute_dtype=torch.bfloat16, compute_copy_dtype=None,
                    param_shardings_tree=None):
    """The unpipelined train step ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``: autograd of :func:`loss_fn`, then one optimizer
    update. The parity reference of the pipelined step on the card.

    ``compute_copy_dtype`` (e.g. ``torch.bfloat16``): the matrix params
    are cast to it once per step (:func:`compute_copy`), the gradient is
    taken with respect to that copy and cast back to each master's dtype,
    and the optimizer updates the f32 masters (classic mixed precision).

    ``param_shardings_tree`` (:func:`~repro_torch.distribution.sharding.param_shardings`
    of the params): the sharded step. Under ``activation_sharding`` on the
    records' mesh, ``params`` and both AdamW moments are this rank's blocks
    and ``batch`` its rows (``batch_sharding``); the step computes what the
    one-process step computes on the whole tree and batch. The bf16 copy
    is cast on the blocks, never on a gathered tensor, and the optimizer
    clips by the mesh-wide global norm (``update(..., shardings=)``)."""
    psh = param_shardings_tree

    def train_step(params, opt_state, batch):
        src = (params if compute_copy_dtype is None
               else compute_copy(params, compute_copy_dtype))
        (total, (loss, aux)), grads = loss_and_grads(
            src, batch, cfg, impl=impl, remat=remat,
            compute_dtype=compute_dtype, shardings=psh)
        del src  # the copy is spent: free it before the optimizer's trees
        if compute_copy_dtype is not None:
            grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
        if psh is None:
            updates, opt_state = optimizer.update(grads, opt_state, params)
        else:
            updates, opt_state = optimizer.update(grads, opt_state, params,
                                                  shardings=psh)
        del grads
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "aux": aux, "total": total}

    return train_step


def _whole_last_logits(logits, cfg: ModelConfig, psh, caches, csh):
    """The last position's logits, gathered over the model axis where a
    sharded step's vocabulary is split over it."""
    logits = logits[:, -1]
    if psh is not None:
        split = model_split(cfg, psh, caches, csh)
        if split.vocab:
            logits = C.all_gather(logits, split.mesh, split.axis, dim=-1)
    return logits


def make_prefill_step(cfg: ModelConfig, *, impl="auto",
                      compute_dtype=torch.bfloat16, param_shardings_tree=None,
                      cache_shardings_tree=None):
    """``prefill(params, tokens, caches, frontend_feats=None) -> (last
    logits (B, V), caches)``: a fresh-sequence pass (scalar cache index 0)
    through ``caches``; frontend features, when given, are the prompt's
    prefix and take the cache's first ``F`` entries.

    ``param_shardings_tree`` and ``cache_shardings_tree``: the sharded
    prefill, as :func:`make_decode_step` takes them (a cache split by
    length is gathered a layer, updated and attended to whole, and each
    rank keeps its entries)."""
    psh, csh = param_shardings_tree, cache_shardings_tree
    if psh is not None and csh is None:
        raise ValueError("a sharded prefill step needs cache_shardings_tree")

    def prefill(params, tokens, caches, frontend_feats=None):
        logits, new_caches, _ = forward(
            params, tokens, cfg, caches=caches, cache_index=0,
            frontend_feats=frontend_feats, impl=impl,
            compute_dtype=compute_dtype, shardings=psh, cache_shardings=csh)
        return _whole_last_logits(logits, cfg, psh, caches, csh), new_caches

    return prefill


def make_decode_step(cfg: ModelConfig, *, impl="auto",
                     compute_dtype=torch.bfloat16, param_shardings_tree=None,
                     cache_shardings_tree=None):
    """``decode(params, tokens (B, 1), caches, cache_index) -> (logits
    (B, V), caches)``; ``cache_index`` is the tokens already seen, a
    scalar (a lockstep batch) or a (B,) vector (per-slot counts, the
    serving engine).

    ``param_shardings_tree`` (``param_shardings(mode="serve")``) and
    ``cache_shardings_tree`` (``cache_shardings``): the sharded decode
    step, under ``activation_sharding`` on their mesh. ``params`` and
    ``caches`` are this rank's blocks, ``tokens`` and ``cache_index`` its
    rows, and the logits of its rows come back whole. A cache whose KV
    heads the model axis does not divide is split by length and every
    layer decodes through ``models.flash_decode`` (off the window's ring;
    on it, through the gathered cache). A Mamba block decodes
    on this rank's SSM heads and conv channels (``models.ssm``), as the
    reference decodes under ``cache_shardings``."""
    psh, csh = param_shardings_tree, cache_shardings_tree
    if psh is not None and csh is None:
        raise ValueError("a sharded decode step needs cache_shardings_tree")

    def decode(params, tokens, caches, cache_index):
        logits, new_caches, _ = forward(
            params, tokens, cfg, caches=caches, cache_index=cache_index,
            impl=impl, compute_dtype=compute_dtype, shardings=psh,
            cache_shardings=csh)
        return _whole_last_logits(logits, cfg, psh, caches, csh), new_caches

    return decode
