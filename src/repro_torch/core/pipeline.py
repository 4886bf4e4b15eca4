"""MHSL split executor: a split plan runs as a pipeline, in one process.

Port of ``repro.core.pipeline``. The paper's multi-hop split learning is
pipeline parallelism: sub-model k runs on device s_k, activations hop
s_k -> s_{k+1} (Eq. 1) and gradients hop back (Eq. 4). The JAX package
runs the stages on a mesh axis with ``ppermute`` hops; here every stage
runs in this process on one card, and a hop is a hand-over of the stage
output (cast to the wire dtype and back, as the reference casts it). The
schedules tick for tick:

* ``fill_drain`` (the reference, :func:`pipeline_loss_fn`): a forward of
  ``M + S - 1`` ticks, stage ``i`` taking microbatch ``t - i`` at tick
  ``t``; the last stage's final norm, LM head and cross-entropy give the
  loss, and the backward is autograd of the whole forward.
* ``1f1b`` (:func:`pipeline_step_fn`): ``M + 2(S-1)`` ticks; at tick
  ``t`` stage ``i`` forwards microbatch ``t - i`` and backwards
  microbatch ``t - 2(S-1) + i``. A forward slot stashes only the stage
  INPUT (a ring of ``2(S-1) + 1``); the backward slot recomputes the
  stage forward under autograd and pulls the cotangent through it
  (rematerialized backward). The last stage's forward slot only stashes:
  its forward runs inside the loss VJP, which carries the final norm, the
  LM head in the compute dtype and the cross-entropy, seeded with
  ``1/M``. Stage 0's input cotangent scatters into the embedding
  gradient; with tied embeddings the head gradient adds to it.

Each stage runs only its own layers, so uneven splits need no padding
blocks. Every period-1 config runs (attention blocks with a dense MLP or
an MoE, or Mamba blocks); as in the reference, the stage loss drops the
MoE router's ``aux``. ``PipelineConfig.transport`` keeps the reference's
two values: the reference's ``"overlap"`` issues a tick's hops before its
compute and ``"sync"`` after it, but both hand each buffer over exactly
one tick after it was made, so in one process they are the same schedule.
Pipelined serving (:func:`pipeline_serve_fns`) runs the reference's
serial token ring over per-stage KV rings (:func:`stage_kv_caches`).
Not ported (they raise ``NotImplementedError``): ``env_axis`` data
parallelism, the union layout for mixed block periods (Jamba, MoE every
k layers) and stage hops across cards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor

SCHEDULES = ("1f1b", "fill_drain")
STAGE_IMPLS = ("reference", "pallas")


@dataclass(frozen=True)
class PipelineConfig:
    """Split-executor knobs.

    ``schedule``: ``"1f1b"`` or ``"fill_drain"`` (the reference).
    ``stage_impl``: ``"reference"`` applies blocks through
    ``models.layers`` (``mlp_block``); ``"pallas"`` routes the residual
    MLP half-block through the hand-written stage kernel
    (:mod:`repro_torch.kernels.stage_block`), whose rounding is the fused
    one. The two select different functions, not a kernel and its plain
    version: on a CUDA tensor ``"pallas"`` always launches the kernel.
    ``compute_dtype``: activation dtype of the stage compute (bf16 in
    production, f32 for the parity gates). ``wire_dtype``: the dtype
    activations and cotangents are cast to for each hop (``None`` = the
    compute dtype). ``transport``: ``"overlap"`` or ``"sync"``, the same
    schedule in one process (see the module docstring).
    """

    schedule: str = "1f1b"
    stage_impl: str = "reference"
    compute_dtype: str = "bfloat16"
    wire_dtype: Optional[str] = None
    transport: str = "overlap"

    def __post_init__(self):
        if self.transport not in ("overlap", "sync"):
            raise ValueError(
                f"transport must be 'overlap' or 'sync', got {self.transport!r}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                             f"{self.schedule!r}")
        if self.stage_impl not in STAGE_IMPLS:
            raise ValueError(f"stage_impl must be one of {STAGE_IMPLS}, got "
                             f"{self.stage_impl!r}")

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def wire(self) -> torch.dtype:
        return getattr(torch, self.wire_dtype or self.compute_dtype)

    @property
    def block_impl(self) -> str:
        return "pallas_stage" if self.stage_impl == "pallas" else "auto"


def _check_boundaries(boundaries: Sequence[int],
                      num_layers: Optional[int] = None) -> None:
    """Validate split-plan cut points before they reach the executor.

    ``boundaries`` are CUMULATIVE layer counts: strictly increasing,
    positive, and (when the layer count is known) ending exactly at
    ``num_layers``.
    """
    bl = list(boundaries)
    if not bl:
        raise ValueError("boundaries must be non-empty")
    lo = 0
    for k, b in enumerate(bl):
        if int(b) <= lo:
            raise ValueError(
                "boundaries must be strictly increasing positive cut points; "
                f"got {tuple(bl)} (entry {k} = {b} after {lo})")
        lo = int(b)
    if num_layers is not None and lo != num_layers:
        raise ValueError(
            f"last boundary must equal the layer count {num_layers}; "
            f"got {tuple(bl)}")


def stage_lengths(boundaries: Sequence[int]) -> Tuple[int, ...]:
    _check_boundaries(boundaries)
    out, lo = [], 0
    for b in boundaries:
        out.append(b - lo)
        lo = b
    return tuple(out)


def _period_one(cfg: ModelConfig) -> None:
    """Every layer has one block signature (attention with a dense MLP or
    MoE, or Mamba); mixed periods need the union layout, not ported."""
    period = M.find_period(M.signature(cfg))
    if period > 1:
        raise NotImplementedError(
            f"{cfg.name}: period-{period} block patterns need the union layout "
            "(a per-slot switch), which is not ported; the executor runs "
            "period-1 configs")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: modality frontends are not ported")


def _stage_ranges(cfg: ModelConfig, boundaries: Sequence[int],
                  env_axis) -> List[Tuple[int, int]]:
    """Checked ``[lo, hi)`` layer ranges of the stages."""
    if env_axis is not None:
        raise NotImplementedError(
            "env_axis (data parallelism across stage replicas) is not ported; "
            "the executor runs every stage in one process")
    _period_one(cfg)
    _check_boundaries(boundaries, num_layers=cfg.num_layers)
    bl = [int(b) for b in boundaries]
    return list(zip([0] + bl[:-1], bl))


def _microbatches(tokens: Tensor, labels: Tensor, n_microbatches: int):
    m_total, t_len = tokens.shape
    if m_total % n_microbatches:
        raise ValueError(f"{m_total} rows do not split into {n_microbatches} "
                         "microbatches")
    mb = m_total // n_microbatches
    return (tokens.reshape(n_microbatches, mb, t_len),
            labels.reshape(n_microbatches, mb, t_len))


def _stage_forward(cfg, blocks, x, positions, impl):
    slot_sig = M.signature(cfg)[0]
    for blk in blocks:
        x, _, _ = M.block_apply(blk, x, cfg, slot_sig, positions=positions,
                                impl=impl)
    return x


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits_loss(cfg, y, final_norm, head, labels):
    xh = L.rms_norm(y, final_norm, cfg.norm_eps)
    return M.softmax_xent(xh @ head.to(y.dtype), labels)


def pipeline_loss_fn(cfg: ModelConfig, boundaries: Sequence[int],
                     n_microbatches: int, pipe: Optional[PipelineConfig] = None,
                     env_axis: Optional[str] = None):
    """The fill-drain (GPipe) pipelined LM loss, the REFERENCE path:
    ``(params, tokens, labels) -> loss``, differentiable by autograd.
    tokens: ``(M * mb, T)``. No wire cast on the hops (as the reference's
    fill-drain hops in the compute dtype)."""
    ranges = _stage_ranges(cfg, boundaries, env_axis)
    s_stages = len(ranges)
    pipe = pipe or PipelineConfig()
    blk_impl, act_dtype = pipe.block_impl, pipe.dtype

    def fn(params, tokens, labels):
        tok_mb, lab_mb = _microbatches(tokens, labels, n_microbatches)
        slot = params["slots"][0]
        stages = [[M.layer_params(slot, r) for r in range(lo, hi)]
                  for lo, hi in ranges]
        head = _head(params, cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        buf: List[Optional[Tensor]] = [None] * s_stages
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for t in range(n_microbatches + s_stages - 1):
            nxt: List[Optional[Tensor]] = [None] * s_stages
            for i in range(s_stages):
                m = t - i
                if not 0 <= m < n_microbatches:
                    continue
                x = (params["embed"][tok_mb[m]].to(act_dtype) if i == 0
                     else buf[i])
                x = _stage_forward(cfg, stages[i], x, positions, blk_impl)
                if i == s_stages - 1:
                    loss_acc = loss_acc + _logits_loss(
                        cfg, x, params["final_norm"], head, lab_mb[m])
                else:
                    nxt[i + 1] = x  # the hop (Eq. 1)
            buf = nxt
        return loss_acc / n_microbatches

    return fn


def _grad_leaves(tree):
    """Detached copies of ``tree``'s leaves that require grad, and the
    tree rebuilt on them."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    return leaves, tree_unflatten(tree, leaves)


def _accumulate(acc, grads):
    return grads if acc is None else [a + g for a, g in zip(acc, grads)]


def pipeline_step_fn(cfg: ModelConfig, boundaries: Sequence[int],
                     n_microbatches: int,
                     pipe: PipelineConfig = PipelineConfig(),
                     env_axis: Optional[str] = None):
    """Build the pipelined train step: ``(params, tokens, labels) -> (loss,
    grads)``, grads in the ``params`` tree layout.

    ``pipe.schedule == "1f1b"`` runs the interleaved schedule of the
    module docstring; ``"fill_drain"`` is autograd of
    :func:`pipeline_loss_fn`. Stage compute runs in ``pipe.dtype``; hops
    cast to ``pipe.wire`` and back.
    """
    if pipe.schedule == "fill_drain":
        loss_fn = pipeline_loss_fn(cfg, boundaries, n_microbatches, pipe=pipe,
                                   env_axis=env_axis)

        def fd_step(params, tokens, labels):
            leaves, p = _grad_leaves(params)
            with torch.enable_grad():
                loss = loss_fn(p, tokens, labels)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves, grads)]
            return loss.detach(), tree_unflatten(params, grads)

        return fd_step

    ranges = _stage_ranges(cfg, boundaries, env_axis)
    s_stages = len(ranges)
    m_micro = n_microbatches
    n_ticks = m_micro + 2 * (s_stages - 1)
    depth = 2 * (s_stages - 1) + 1  # activation-stash ring depth
    blk_impl = pipe.block_impl
    cdtype, wdtype = pipe.dtype, pipe.wire

    def fn(params, tokens, labels):
        tok_mb, lab_mb = _microbatches(tokens, labels, m_micro)
        dev = tokens.device
        slot = params["slots"][0]
        positions = torch.arange(tokens.shape[1], device=dev)
        embed = params["embed"]
        head_src = embed if cfg.tie_embeddings else params["lm_head"]
        # per stage: grad leaves of its layers (views into the stacked slot)
        stage_leaves, stage_blocks = [], []
        for lo, hi in ranges:
            layers = [M.layer_params(slot, r) for r in range(lo, hi)]
            leaves, blocks = _grad_leaves(layers)
            stage_leaves.append(leaves)
            stage_blocks.append(blocks)
        norm_leaf = params["final_norm"].detach().requires_grad_(True)
        head_leaf = head_src.detach().requires_grad_(True)
        seed = torch.full((), 1.0 / m_micro, dtype=torch.float32, device=dev)

        gblocks = [None] * s_stages
        gembed = torch.zeros_like(embed)
        gnorm = torch.zeros_like(params["final_norm"])
        ghead = torch.zeros_like(head_src)
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        stash = [[None] * depth for _ in range(s_stages)]
        buf_x: List[Optional[Tensor]] = [None] * s_stages
        buf_g: List[Optional[Tensor]] = [None] * s_stages

        for t in range(n_ticks):
            # the hops (Eq. 1 forward, Eq. 4 gradient): last tick's
            # wire-dtype outputs arrive in the compute dtype
            x_in = [None if b is None else b.to(cdtype) for b in buf_x]
            g_in = [None if b is None else b.to(cdtype) for b in buf_g]
            buf_x, buf_g = [None] * s_stages, [None] * s_stages
            for i in range(s_stages):
                last = i == s_stages - 1
                # ---- forward slot: microbatch t - i ----------------------
                mf = t - i
                if 0 <= mf < m_micro:
                    x0 = embed[tok_mb[mf]].to(cdtype) if i == 0 else x_in[i]
                    stash[i][mf % depth] = x0
                    if not last:
                        with torch.no_grad():
                            y = _stage_forward(cfg, stage_blocks[i], x0,
                                               positions, blk_impl)
                        buf_x[i + 1] = y.to(wdtype)
                # ---- backward slot: microbatch t - 2(S-1) + i ------------
                mbk = t - 2 * (s_stages - 1) + i
                if not 0 <= mbk < m_micro:
                    continue
                x_sv = stash[i][mbk % depth].detach().requires_grad_(True)
                stash[i][mbk % depth] = None
                with torch.enable_grad():
                    y = _stage_forward(cfg, stage_blocks[i], x_sv, positions,
                                       blk_impl)
                    if last:
                        head = head_leaf.T if cfg.tie_embeddings else head_leaf
                        li = _logits_loss(cfg, y, norm_leaf, head, lab_mb[mbk])
                        out = torch.autograd.grad(
                            li, stage_leaves[i] + [norm_leaf, head_leaf, x_sv],
                            seed)
                        dbl, (dfn, dhd, dx) = out[:-3], out[-3:]
                        gnorm = gnorm + dfn
                        ghead = ghead + dhd
                        loss_acc = loss_acc + li.detach()
                    else:
                        out = torch.autograd.grad(
                            y, stage_leaves[i] + [x_sv], g_in[i])
                        dbl, dx = out[:-1], out[-1]
                gblocks[i] = _accumulate(gblocks[i], list(dbl))
                if i == 0:
                    # the cotangent of the embedding lookup
                    gembed.index_add_(0, tok_mb[mbk].reshape(-1),
                                      dx.reshape(-1, dx.shape[-1]).to(gembed.dtype))
                else:
                    buf_g[i - 1] = dx.to(wdtype)

        layer_grads = []
        for layers, g in zip(stage_blocks, gblocks):
            layer_grads.extend(tree_unflatten(layers, g))
        grads = {"final_norm": gnorm,
                 "slots": (tree_map(lambda *xs: torch.stack(xs),
                                    layer_grads[0], *layer_grads[1:]),)}
        if cfg.tie_embeddings:
            grads["embed"] = gembed + ghead
        else:
            grads["embed"] = gembed
            grads["lm_head"] = ghead
        return loss_acc / m_micro, {k: grads[k] for k in params}

    return fn


# ---------------------------------------------------------------------------
# serving: the token ring over per-stage KV rings
# ---------------------------------------------------------------------------


def _attention_only(cfg: ModelConfig, what: str) -> None:
    if any(kind != "A" for kind, _, _ in M.signature(cfg)):
        raise ValueError(
            f"{what}: SSM/hybrid archs are unservable - padded batched "
            "prefill relies on causal masking, which protects KV attention "
            "but not recurrent scan state")


def stage_kv_caches(cfg: ModelConfig, boundaries: Sequence[int],
                    num_slots: int, cache_len: int, dtype=torch.float32,
                    device=None):
    """Per-stage KV rings for pipelined serving, zero-filled.

    Returns ``{"k", "v"}`` of shape ``(S, max_len, B, kv_len, KH, hd)``,
    the reference's layout: stage ``k``'s ring holds only its own layers'
    entries (row ``i`` of stage ``k`` is global layer ``boundaries[k-1] +
    i``); the rows past a stage's length pad the layout and stay zero."""
    from repro_torch.device import resolve_device

    _attention_only(cfg, "stage_kv_caches")
    lens = stage_lengths(boundaries)
    kv_len = (min(cache_len, cfg.attention_window)
              if cfg.attention_window is not None else cache_len)
    shape = (len(lens), max(lens), num_slots, kv_len, cfg.num_kv_heads,
             cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def pipeline_serve_fns(cfg: ModelConfig, boundaries: Sequence[int], *,
                       pipe: PipelineConfig = PipelineConfig(
                           compute_dtype="float32")):
    """The serving passes of a split plan: ``(prefill, decode)`` with the
    serving engine's runner signatures.

    * ``prefill(params, caches, prompts)``: ``prompts`` (B, P) ->
      ``(logits (B, P, V) f32, caches)``, a fresh-sequence pass (scalar
      cache index 0) through every stage.
    * ``decode(params, tok, caches, pos)``: ``tok`` (B, 1), ``pos`` (B,)
      per-slot entry counts -> ``(logits (B, V) f32, caches)``.

    Both run the reference's serial token ring in one process: stage
    ``t`` runs its own layers over its own KV ring, then its output hops
    to stage ``t + 1`` cast to ``pipe.wire`` and back to the compute dtype
    (the Eq. 1 transmission); the last stage's final norm and LM head give
    the logits, in f32 as the reference's masked ``psum`` returns them.
    ``pipe.stage_impl="pallas"`` routes each dense MLP half-block through
    the stage kernel. Attention-only configs of period 1 run; SSM and
    hybrid configs and capacity MoE are refused as the reference refuses
    them, and periods above 1 (MoE every k layers) need the union layout,
    which is not ported."""
    _attention_only(cfg, "pipeline serving")
    sig = M.signature(cfg)
    if any(is_moe for _, is_moe, _ in sig) and cfg.moe.dispatch != "dropless":
        raise ValueError(
            "pipeline serving: capacity-dropping MoE is unservable (padded "
            "prefill rows steal expert capacity from real rows); set "
            "moe.dispatch='dropless'")
    ranges = _stage_ranges(cfg, boundaries, None)
    slot_sig = sig[0]
    blk_impl, cdtype, wdtype = pipe.block_impl, pipe.dtype, pipe.wire

    def ring_pass(params, caches, x, positions, cache_index):
        slot = params["slots"][0]
        plan = L.cache_plan(cfg, positions, cache_index, x.shape[0], x.shape[1],
                            caches["k"].shape[3])
        new_k, new_v = [], []
        for t, (lo, hi) in enumerate(ranges):
            if t > 0:  # the hop: wire-dtype bytes
                x = x.to(wdtype).to(cdtype)
            ks, vs = [], []
            for i, layer in enumerate(range(lo, hi)):
                x, nc, _ = M.block_apply(
                    M.layer_params(slot, layer), x, cfg, slot_sig,
                    positions=positions,
                    cache={"k": caches["k"][t, i], "v": caches["v"][t, i]},
                    cache_index=cache_index, impl=blk_impl, plan=plan)
                ks.append(nc["k"])
                vs.append(nc["v"])
            pad = caches["k"].shape[1] - (hi - lo)  # padding rows stay
            new_k.append(torch.cat([torch.stack(ks), caches["k"][t, hi - lo:]])
                         if pad else torch.stack(ks))
            new_v.append(torch.cat([torch.stack(vs), caches["v"][t, hi - lo:]])
                         if pad else torch.stack(vs))
        xh = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = (xh @ _head(params, cfg).to(x.dtype)).float()
        return logits, {"k": torch.stack(new_k), "v": torch.stack(new_v)}

    def prefill(params, caches, prompts):
        x = params["embed"].to(cdtype)[prompts.long()]
        positions = torch.arange(prompts.shape[1], device=prompts.device)
        with torch.inference_mode():
            return ring_pass(params, caches, x, positions, 0)

    def decode(params, tok, caches, pos):
        x = params["embed"].to(cdtype)[tok.long()]
        pos = pos.long()
        with torch.inference_mode():
            logits, caches = ring_pass(params, caches, x, pos[:, None], pos)
        return logits[:, -1], caches

    return prefill, decode
