"""Core transformer layers: RMSNorm, RoPE, GQA attention, MLPs.

Port of ``repro.models.layers``, cache-free paths only. Everything is
functional: ``init_*`` returns a dict of tensors, the ``*_apply``-style
functions consume it. Activations run in their own dtype (bf16 in
production) with f32 norm, rope and softmax arithmetic, and every
rounding point sits where the reference puts it. Cached decode,
``flash_decode`` and MoE come with the serving and SSM/MoE slices.
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
