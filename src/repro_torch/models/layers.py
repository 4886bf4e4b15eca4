"""Core transformer layers: RMSNorm, RoPE, GQA attention, MLPs, MoE.

Port of ``repro.models.layers``, cache-free paths only. Everything is
functional: ``init_*`` returns a dict of tensors, the ``*_apply``-style
functions consume it. Activations run in their own dtype (bf16 in
production) with f32 norm, rope, softmax and router arithmetic, and
every rounding point sits where the reference puts it. Cached decode and
``flash_decode`` come with the serving slice; the all-to-all MoE across
cards (``moe_a2a``) with the multi-card work.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    """f32 statistics; ``x * rsqrt`` is rounded to ``x.dtype`` before the
    weight (also in ``x.dtype``) multiplies it, as the reference rounds."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None,
               device: DeviceLike = None) -> Tensor:
    """``N(0, 1) * scale`` (``1/sqrt(d_in)`` by default), ``(d_in, d_out)``;
    ``gen`` lives on ``device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    dev = resolve_device(device)
    return (torch.randn((d_in, d_out), generator=gen, device=dev) * scale).to(dtype)


def activation_fn(name: str):
    """``gelu`` is the tanh approximation, ``jax.nn.gelu``'s default."""
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    if name == "silu":
        return F.silu
    raise KeyError(name)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_angles(positions: Tensor, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin of shape (..., S, head_dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd//2) or (B, S, hd//2)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.dim() == 2:  # (S, hd/2) -> broadcast over batch and heads
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, hd/2)
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos_ - x2 * sin_, x1 * sin_ + x2 * cos_], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                   device: DeviceLike = None):
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = resolve_device(device)
    p = {
        "wq": init_dense(gen, d, h * hd, dtype, device=dev),
        "wk": init_dense(gen, d, kh * hd, dtype, device=dev),
        "wv": init_dense(gen, d, kh * hd, dtype, device=dev),
        "wo": init_dense(gen, h * hd, d, dtype, scale=1.0 / math.sqrt(h * hd),
                         device=dev),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kh * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kh * hd,), dtype=dtype, device=dev)
    return p


def _mask_bias(qpos: Tensor, kpos: Tensor, window: Optional[int]) -> Tensor:
    """(Sq, Skv) additive f32 bias: 0 allowed, -inf disallowed."""
    ok = kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok &= kpos[None, :] > (qpos[:, None] - window)
    return torch.where(ok, 0.0, -math.inf).float()


def _repeat_kv(k: Tensor, groups: int) -> Tensor:
    if groups == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, groups, hd).reshape(
        b, s, kh * groups, hd)


def dense_attention(q: Tensor, k: Tensor, v: Tensor, *, q_offset,
                    window: Optional[int] = None, causal: bool = True) -> Tensor:
    """Reference attention; materializes (Sq, Skv) scores. q: (B,Sq,H,hd).
    Scores and softmax in f32; the weights are rounded to ``v.dtype``
    before ``w @ v``."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    k = _repeat_kv(k, h // kh)
    v = _repeat_kv(v, h // kh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd))
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    if causal:
        scores = scores + _mask_bias(qpos, kpos, window)[None, None]
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, q_offset: int = 0,
                      window: Optional[int] = None, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> Tensor:
    """Online-softmax attention over (q chunk, kv chunk) tiles in plain
    PyTorch: the peak temporary is (B, H, q_chunk, kv_chunk). Causal plus
    an optional sliding window; fully masked tiles keep ``p`` and the
    correction at exact zeros."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    kh = k.shape[2]
    g = h // kh
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    n_q = -(-sq // q_chunk)
    n_kv = -(-skv // kv_chunk)
    pad_q = n_q * q_chunk - sq
    pad_kv = n_kv * kv_chunk - skv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for qi in range(n_q):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((b, h, q_chunk, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, h, q_chunk), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        for ki in range(n_kv):
            kc = _repeat_kv(k[:, ki * kv_chunk:(ki + 1) * kv_chunk], g)
            vc = _repeat_kv(v[:, ki * kv_chunk:(ki + 1) * kv_chunk], g)
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kc.float()) * scale
            bias = _mask_bias(qpos, kpos, window)
            # mask out kv padding
            bias = torch.where((kpos < skv)[None, :], bias, -math.inf)
            s = s + bias[None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vc.dtype), vc).float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.transpose(1, 2))  # (B, q_chunk, H, hd)
    out = torch.cat(outs, dim=1)
    return out[:, :sq].to(q.dtype)


def attention_apply(params, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
                    kv_cache=None, cache_index=None, impl: str = "auto"):
    """Self-attention with GQA + RoPE, cache-free.

    ``impl``: ``"dense"``, ``"chunked"``, ``"pallas"`` (the hand-written
    flash-attention kernel, :mod:`repro_torch.kernels.flash_attention`,
    forward only) or ``"auto"`` (chunked above 2048 tokens, else dense).
    ``positions``: (S,) absolute positions. Returns ``(out, None)``.
    """
    if kv_cache is not None or cache_index is not None:
        raise NotImplementedError(
            "cached attention (decode) comes with the serving slice")
    b, s, d = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kh, hd)
    v = v.reshape(b, s, kh, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if impl == "pallas":
        from repro_torch.kernels.flash_attention import flash_attention

        out = flash_attention(q, k, v, causal=True, window=cfg.attention_window)
    elif impl == "chunked" or (impl == "auto" and s > 2048):
        out = chunked_attention(q, k, v, q_offset=0, window=cfg.attention_window)
    elif impl in ("auto", "dense"):
        out = dense_attention(q, k, v, q_offset=0, window=cfg.attention_window)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    out = out.reshape(b, s, h * hd).to(dt)
    return out @ params["wo"].to(dt), None


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype=torch.float32, device: DeviceLike = None):
    dev = resolve_device(device)
    down = dict(scale=1.0 / math.sqrt(d_ff), device=dev)
    if activation == "swiglu":
        return {
            "w_gate": init_dense(gen, d_model, d_ff, dtype, device=dev),
            "w_up": init_dense(gen, d_model, d_ff, dtype, device=dev),
            "w_down": init_dense(gen, d_ff, d_model, dtype, **down),
        }
    return {
        "w_up": init_dense(gen, d_model, d_ff, dtype, device=dev),
        "w_down": init_dense(gen, d_ff, d_model, dtype, **down),
    }


def mlp_apply(params, x: Tensor, activation: str) -> Tensor:
    """Each product is rounded to ``x.dtype``, as the reference's einsums."""
    dt = x.dtype
    if activation == "swiglu":
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        hcurr = F.silu(g) * u
    else:
        hcurr = activation_fn(activation)(x @ params["w_up"].to(dt))
    return hcurr @ params["w_down"].to(dt)


def mlp_block(norm_w: Tensor, params, x: Tensor, activation: str,
              eps: float = 1e-6) -> Tensor:
    """Reference residual MLP half-block: ``x + mlp(rms_norm(x))``.

    The hand-written stage kernel (:mod:`repro_torch.kernels.stage_block`)
    computes the same function with fewer roundings; its backward is
    autograd of THIS function, as the JAX kernel's custom VJP is."""
    return x + mlp_apply(params, rms_norm(x, norm_w, eps), activation)


# ---------------------------------------------------------------------------
# MoE (top-k routing; capacity, dense-reference and dropless dispatch)
# ---------------------------------------------------------------------------

DROPLESS_IMPLS = ("reference", "pallas")


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device: DeviceLike = None):
    """``router`` (D, E) in f32; expert stacks ``w_up``/``w_gate`` (E, D, F)
    and ``w_down`` (E, F, D) in ``dtype`` (``w_gate`` for swiglu only)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    dev = resolve_device(device)

    def stack(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                / math.sqrt(fan_in)).to(dtype)

    p = {"router": init_dense(gen, d, e, torch.float32, device=dev),
         "w_up": stack((e, d, f), d),
         "w_down": stack((e, f, d), f)}
    if cfg.activation == "swiglu":
        p["w_gate"] = stack((e, d, f), d)
    return p


def moe_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(math.ceil(tokens_per_group * m.top_k * m.capacity_factor
                      / m.num_experts))
    return max(c, 1)


def _router_probs(params, xt: Tensor) -> Tensor:
    """Softmax of the f32 router logits over the experts."""
    return torch.softmax(xt.float() @ params["router"].float(), dim=-1)


def _topk_gates(probs: Tensor, k: int):
    """Top-k experts (descending, as ``lax.top_k``) and their gates
    renormalized to sum to one."""
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids


def _load_balance_aux(probs: Tensor, ids: Tensor, cfg: ModelConfig) -> Tensor:
    """Switch load-balance loss ``E * sum_e f_e P_e * weight``, with f_e
    the share of tokens whose first choice is e; means over every axis
    but the experts'."""
    e = cfg.moe.num_experts
    dims = tuple(range(probs.dim() - 1))
    f_e = torch.mean(F.one_hot(ids[..., 0], e).float(), dim=dims)
    p_e = torch.mean(probs, dim=dims)
    return e * torch.sum(f_e * p_e) * cfg.moe.router_aux_weight


def expert_ffn(x: Tensor, w_gate, w_up: Tensor, w_down: Tensor,
               activation: str) -> Tensor:
    """An expert's FFN over rows ``x`` (batched over leading dims of both).
    Each product is taken in f32 on the operands rounded to ``x.dtype``
    and rounded back, the reference's ``preferred_element_type=f32``; the
    activation runs in ``x.dtype``."""
    dt = x.dtype

    def mm(a, w):
        return (a.float() @ w.to(dt).float()).to(dt)

    u = mm(x, w_up)
    h = F.silu(mm(x, w_gate)) * u if activation == "swiglu" else \
        activation_fn(activation)(u)
    return mm(h, w_down)


def moe_apply(params, x: Tensor, cfg: ModelConfig):
    """Capacity-bounded MoE, x (B, S, D) -> ``(y, aux)``. Dispatch by
    scatter-add into an (E, C, D) buffer per group (= batch row); choices
    past an expert's capacity are dropped."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    c = moe_capacity(s, cfg)
    dt = x.dtype

    probs = _router_probs(params, x)
    gate_vals, expert_ids = _topk_gates(probs, k)  # (B, S, k)

    # position of each (token, choice) within its expert, per group
    flat = expert_ids.reshape(b, s * k)  # token-major
    onehot = F.one_hot(flat, e)  # (B, S*k, E)
    pos = torch.cumsum(onehot, dim=1) - 1
    pos_in_expert = torch.gather(pos, 2, flat[..., None])[..., 0].reshape(b, s, k)
    keep = pos_in_expert < c
    slot = expert_ids * c + torch.clamp(pos_in_expert, max=c - 1)  # (B, S, k)

    # k separate scatters into the flattened (B * E * C, D) buffer
    group = (torch.arange(b, device=x.device) * (e * c))[:, None]
    buf = x.new_zeros((b * e * c, d))
    for j in range(k):
        src = x * keep[:, :, j:j + 1].to(dt)
        buf = buf.index_add(0, (slot[:, :, j] + group).reshape(-1),
                            src.reshape(-1, d))
    buf = buf.reshape(b, e, c, d)

    if cfg.activation == "swiglu":
        g = torch.einsum("becd,edf->becf", buf, params["w_gate"].to(dt))
        u = torch.einsum("becd,edf->becf", buf, params["w_up"].to(dt))
        hcurr = F.silu(g) * u
    else:
        u = torch.einsum("becd,edf->becf", buf, params["w_up"].to(dt))
        hcurr = activation_fn(cfg.activation)(u)
    out = torch.einsum("becf,efd->becd", hcurr, params["w_down"].to(dt))
    out = out.reshape(b, e * c, d)

    got = out[torch.arange(b, device=x.device)[:, None],
              slot.reshape(b, s * k)].reshape(b, s, k, d)
    w = (gate_vals * keep).to(dt)
    y = torch.einsum("bskd,bsk->bsd", got, w)
    return y, _load_balance_aux(probs, expert_ids, cfg)


def _moe_route(params, xt: Tensor, cfg: ModelConfig):
    """Token routing shared by the dropless and dense-reference paths:
    xt (T, D) -> ``(gates (T, k) f32, expert_ids (T, k), aux)``."""
    probs = _router_probs(params, xt)
    gates, ids = _topk_gates(probs, cfg.moe.top_k)
    return gates, ids, _load_balance_aux(probs, ids, cfg)


def _moe_combine(out_choices: Tensor, gates: Tensor, dtype) -> Tensor:
    """(T, k, D) per-choice expert outputs and (T, k) gates -> (T, D),
    through one einsum on both the dropless and the dense side."""
    return torch.einsum("tkd,tk->td", out_choices, gates.to(dtype))


def moe_apply_dense(params, x: Tensor, cfg: ModelConfig):
    """Dense per-expert reference: every expert's FFN over every token,
    then the routed outputs are picked and combined. O(T * E) rows: the
    ground truth the dropless dispatch is held to, never a production
    path."""
    b, s, d = x.shape
    e = cfg.moe.num_experts
    xt = x.reshape(b * s, d)
    gates, ids, aux = _moe_route(params, xt, cfg)
    stacked = torch.stack([
        expert_ffn(xt, params["w_gate"][j] if "w_gate" in params else None,
                   params["w_up"][j], params["w_down"][j], cfg.activation)
        for j in range(e)])  # (E, T, D)
    got = stacked[ids, torch.arange(b * s, device=x.device)[:, None]]
    y = _moe_combine(got, gates, x.dtype)
    return y.reshape(b, s, d), aux


def dropless_layout(expert_ids: Tensor, num_experts: int, block_size: int):
    """The dropless dispatch's padded layout for (T, k) routed choices.

    The T*k flat choices are stably sorted by expert and packed into
    per-expert regions padded to ``block_size`` rows, within the static
    bound ``ceil((T*k + E*(block_size-1)) / block_size) * block_size``.
    Returns ``(order, dest, p_rows, block_eid)``: the sort permutation,
    each sorted choice's buffer row, the buffer's row count and the
    owning expert of every block (int32; trailing empty blocks name the
    last expert)."""
    t, k = expert_ids.shape
    e, blk = num_experts, block_size
    dev = expert_ids.device
    flat = expert_ids.reshape(-1)
    order = torch.argsort(flat, stable=True)  # ties keep token order
    sorted_eids = flat[order]
    counts = torch.zeros(e, dtype=torch.long, device=dev).index_add_(
        0, flat, torch.ones_like(flat))
    padded = ((counts + blk - 1) // blk) * blk
    ends = torch.cumsum(padded, dim=0)
    starts = ends - padded
    excl = torch.cumsum(counts, dim=0) - counts
    pos_in_expert = torch.arange(t * k, device=dev) - excl[sorted_eids]
    dest = starts[sorted_eids] + pos_in_expert  # unique rows
    p_rows = -(-(t * k + e * (blk - 1)) // blk) * blk
    block_eid = torch.clamp(
        torch.searchsorted(ends, torch.arange(p_rows // blk, device=dev) * blk,
                           right=True), max=e - 1).to(torch.int32)
    return order, dest, p_rows, block_eid


def moe_apply_dropless(params, x: Tensor, cfg: ModelConfig, *,
                       impl: str = "reference", block_size: int = 128):
    """Dropless MoE dispatch: every routed (token, choice) is computed.

    x (B, S, D) -> ``(y, aux)``. The choices are gathered into the
    block-padded expert-sorted buffer of :func:`dropless_layout`, the
    expert FFN runs over it block by block, and the outputs are gathered
    back through the inverse permutation and combined with one einsum.
    ``impl="reference"`` runs ``grouped_ffn_reference`` (a batched einsum
    over gathered weights); ``impl="pallas"`` the hand-written grouped
    kernel (:mod:`repro_torch.kernels.moe_dispatch`), whose activation
    rounds once where the reference rounds per operation. Padding rows are
    zero and never gathered back."""
    from repro_torch.kernels.moe_dispatch import (
        grouped_ffn_reference, grouped_moe_ffn,
    )

    if impl not in DROPLESS_IMPLS:
        raise ValueError(f"unknown dropless impl {impl!r}; have {DROPLESS_IMPLS}")
    m = cfg.moe
    b, s, d = x.shape
    k = m.top_k
    t = b * s
    xt = x.reshape(t, d)
    gates, ids, aux = _moe_route(params, xt, cfg)
    order, dest, p_rows, block_eid = dropless_layout(ids, m.num_experts,
                                                     block_size)
    pbuf = x.new_zeros((p_rows, d)).index_copy(0, dest, xt[order // k])
    if impl == "reference":
        out_p = grouped_ffn_reference(pbuf, block_eid, params.get("w_gate"),
                                      params["w_up"], params["w_down"],
                                      cfg.activation)
    else:
        out_p = grouped_moe_ffn(pbuf, block_eid, params,
                                activation=cfg.activation)
    out_sorted = out_p[dest]
    inv = torch.argsort(order)  # flat choice -> sorted row
    got = out_sorted[inv].reshape(t, k, d)
    y = _moe_combine(got, gates, x.dtype)
    return y.reshape(b, s, d), aux
