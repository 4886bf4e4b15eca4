"""Core transformer layers: RMSNorm, RoPE, GQA attention, MLPs, MoE.

Port of ``repro.models.layers``. Everything is functional: ``init_*``
returns a dict of tensors, the ``*_apply``-style functions consume it.
Activations run in their own dtype (bf16 in production) with f32 norm,
rope, softmax and router arithmetic, and every rounding point sits where
the reference puts it. Attention takes a KV cache for serving (a scalar
or a per-row cache index, and the sliding-window ring).

Under the sharded step (``distribution.sharding``) the attention, MLP and
MoE functions take a ``split`` (:class:`~repro_torch.distribution.sharding.ModelSplit`):
their weights are then this rank's blocks along the model axis (heads,
FFN columns, experts), or whole where the split gathers them, and the
partial results are summed over the model axis. ``split=None`` is the
one-process layer.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distribution import collectives as C

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


class CachePlan(NamedTuple):
    """What every attention layer of one cached forward shares: the rope
    angles of the inputs' positions, each row's write positions in the
    cache (B, s), and the additive f32 mask, broadcastable to (B, H, s, C).
    :func:`cache_plan` makes it once per forward instead of per layer."""

    cos: Tensor
    sin: Tensor
    rows: Tensor
    bias: Tensor


def cache_plan(cfg: ModelConfig, positions: Tensor, cache_index, batch: int,
               s: int, cache_len: int) -> CachePlan:
    """The :class:`CachePlan` of ``s`` inputs at ``positions`` ((S,), or
    (B, S) for a vector index) written into a ``cache_len``-entry cache
    after ``cache_index`` entries (a scalar or a (B,) vector).

    A cache of exactly ``cfg.attention_window`` entries is a ring when one
    token is decoded: the token lands at ``t % C``, and entry ``i`` holds
    absolute position ``t - ((t - i) mod C)``, valid iff >= 0. Otherwise
    the write starts at ``cache_index``, clamped to ``[0, C - s]`` so that
    it fits, as ``jax.lax.dynamic_update_slice`` clamps it (an index at the
    edge lands where the reference puts it), and the mask is causal on the
    unclamped positions, within the window if there is one."""
    if s > cache_len:
        raise ValueError(f"a {s}-token update does not fit a {cache_len}-entry cache")
    dev = positions.device
    idx = torch.as_tensor(cache_index, device=dev).to(torch.long)
    vec = idx.dim() == 1
    window = cfg.attention_window
    ent = torch.arange(cache_len, device=dev)
    if window is not None and cache_len == window and s == 1:
        start = idx % cache_len
        t = idx[:, None] if vec else idx
        ok = (t - torch.remainder(t - ent, cache_len)) >= 0
        bias = torch.where(ok, 0.0, -math.inf)
        bias = bias[:, None, None, :] if vec else bias[None, None, None, :]
    else:
        start = idx
        ok = ent <= positions[..., None]  # (s, C) or (B, s, C)
        ok = ok & (ent < ((idx[:, None, None] if vec else idx) + s))
        if window is not None:
            ok = ok & (ent > (positions[..., None] - window))
        bias = torch.where(ok, 0.0, -math.inf)
        bias = bias[:, None] if vec else bias[None, None]
    start = torch.clamp(start.expand(batch), 0, cache_len - s)
    rows = start[:, None] + torch.arange(s, device=dev)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return CachePlan(cos, sin, rows, bias.float())


def _row_cache_update(cache: Tensor, fresh: Tensor, rows: Tensor) -> Tensor:
    """Slot-indexed KV write: row ``b`` of ``cache`` (B, C, KH, hd) takes
    ``fresh[b]`` (s, KH, hd) at entries ``rows[b]`` (s,), each row at its
    own position (``CachePlan.rows``, which holds the reference's clamp).
    Returns a new tensor."""
    b, s = rows.shape
    idx = rows[:, :, None, None].expand(b, s, *cache.shape[2:])
    return cache.scatter(1, idx, fresh.to(cache.dtype))


def _cached_attention(q: Tensor, ck: Tensor, cv: Tensor, bias: Tensor,
                      v_dtype) -> Tensor:
    """Attention of q (B, s, H, hd) over the whole cache (B, C, KH, hd)
    with an additive f32 ``bias`` broadcast to (B, H, s, C): f32 scores
    and softmax, the weights rounded to ``v_dtype`` before ``w @ v``. The
    query heads of one KV head are one group of the products (head ``h``
    reads KV head ``h // (H / KH)``, as ``_repeat_kv`` orders them), so
    the cache is never copied per query head."""
    b, s, h, hd = q.shape
    c, kh = ck.shape[1], ck.shape[2]
    g = h // kh
    scores = torch.einsum("bqkgd,bckd->bkgqc", q.reshape(b, s, kh, g, hd).float(),
                          ck.float()).reshape(b, h, s, c) / math.sqrt(hd)
    w = torch.softmax(scores + bias, dim=-1).to(v_dtype)
    if cv.dtype != w.dtype:  # a cache dtype other than the activations'
        dt = torch.promote_types(cv.dtype, w.dtype)
        w, cv = w.to(dt), cv.to(dt)
    out = torch.einsum("bkgqc,bckd->bqkgd", w.reshape(b, kh, g, s, c), cv)
    return out.reshape(b, s, h, hd)


def attention_apply(params, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
                    kv_cache=None, cache_index=None, impl: str = "auto",
                    plan: Optional[CachePlan] = None, split=None):
    """Self-attention with GQA + RoPE.

    ``positions``: (S,) absolute positions, or (B, S) per-row positions
    when ``cache_index`` is a vector. Without a cache, ``impl`` picks the
    route: ``"dense"``, ``"chunked"``, ``"pallas"`` (the hand-written
    flash-attention kernel, :mod:`repro_torch.kernels.flash_attention`,
    forward only) or ``"auto"`` (chunked above 2048 tokens, else dense).

    ``kv_cache``: ``{"k", "v"}`` of shape (B, C, KH, hd), decode and
    prefill for serving; ``cache_index`` is the number of valid entries
    already in it, a scalar or a (B,) vector of per-row counts (each row
    writes its fresh K/V at its own position and masks its own history),
    with the sliding-window ring of :func:`cache_plan`. ``plan``: the
    forward's shared :class:`CachePlan` (made here when None). The cached
    path ignores ``impl``, as the reference's does.

    ``split`` (the sharded step): this rank's heads or columns, see
    :func:`_sharded_attention`.

    Returns ``(out, new_cache)``, ``new_cache`` None without a cache.
    """
    if split is not None and split.attn is not None:
        return _sharded_attention(params, x, cfg, positions=positions,
                                  kv_cache=kv_cache, cache_index=cache_index,
                                  impl=impl, plan=plan, split=split)
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
    if kv_cache is not None and plan is None:
        plan = cache_plan(cfg, positions, cache_index, b, s, kv_cache["k"].shape[1])
    if plan is not None:
        # one rope pass over the query and key heads together (the same
        # arithmetic per element, half the launches of a decode step's rope)
        qk = apply_rope(torch.cat([q, k], dim=2), plan.cos, plan.sin)
        q, k = qk[:, :, :h], qk[:, :, h:]
    else:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = None
    if kv_cache is not None:
        ck = _row_cache_update(kv_cache["k"], k, plan.rows)
        cv = _row_cache_update(kv_cache["v"], v, plan.rows)
        out = _cached_attention(q, ck, cv, plan.bias, v.dtype)
        new_cache = {"k": ck, "v": cv}
    else:
        out = _attention_core(q, k, v, cfg, impl)
    out = out.reshape(b, s, h * hd).to(dt)  # the cache dtype may differ
    return out @ params["wo"].to(dt), new_cache


def _attention_core(q: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig,
                    impl: str) -> Tensor:
    """Causal (windowed) attention of a fresh sequence by ``impl``."""
    if impl == "pallas":
        from repro_torch.kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True, window=cfg.attention_window)
    if impl == "chunked" or (impl == "auto" and q.shape[1] > 2048):
        return chunked_attention(q, k, v, q_offset=0, window=cfg.attention_window)
    if impl in ("auto", "dense"):
        return dense_attention(q, k, v, q_offset=0, window=cfg.attention_window)
    raise ValueError(f"unknown attention impl {impl!r}")


def _length_shard_update(cache: Tensor, fresh: Tensor, rows: Tensor,
                         start: int) -> Tensor:
    """:func:`_row_cache_update` on this rank's part of a cache split by
    length: global entries ``start .. start + L_loc - 1``. Each row's
    fresh entries (one token: ``rows`` (B, 1)) land here only if their
    global row is in that range."""
    l_loc = cache.shape[1]
    loc = rows - start
    inside = (loc >= 0) & (loc < l_loc)
    loc = loc.clamp(0, l_loc - 1)
    idx = loc[:, :, None, None].expand(*loc.shape, *cache.shape[2:])
    old = torch.gather(cache, 1, idx)
    fresh = torch.where(inside[:, :, None, None], fresh.to(cache.dtype), old)
    return cache.scatter(1, idx, fresh)


def _sharded_attention(params, x: Tensor, cfg: ModelConfig, *, positions,
                       kv_cache, cache_index, impl, plan, split):
    """Attention on a model line (``split.attn``):

    * ``"heads"``: this rank's query heads from its column blocks of
      ``wq`` (``bq``); its KV heads from its blocks of ``wk``/``wv`` when
      ``split.kv_heads``, else every KV head from the gathered weights,
      of which each local query head takes its own; its rows of ``wo``,
      the partial outputs summed over the model axis.
    * ``"cols"`` (decoding on a cache split by length, or replicated):
      the query, key and value columns of this rank's blocks, gathered
      into whole heads; every head attends; this rank's rows of ``wo``,
      summed. On a length split a one-token step off the window's ring
      goes through ``flash_decode`` on this rank's entries; a multi-token
      step (a prefill) and a one-token step on a ring-sized cache gather
      the cache's entries over the model axis, take the one-process
      update and attention, and keep this rank's entries (2 L KH hd B
      elements gathered a layer), as the reference's masked dense and
      ring branches run under GSPMD.
    """
    mesh, ax = split.mesh, split.axis
    b, s, d = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    # a rank's x-gradient through its heads or column blocks is a part
    xin = C.enter_parallel(x, mesh, ax)

    def proj(w, bias):
        whole = split.attn == "cols" and params[w].shape[1] == (
            h if w == "wq" else kh) * hd  # the same on every rank
        y = (x if whole else xin) @ params[w].to(dt)
        return y + params[bias].to(dt) if cfg.qkv_bias else y

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    if split.attn == "heads":
        hl = q.shape[-1] // hd
        q = q.reshape(b, s, hl, hd)
        if k.shape[-1] < kh * hd:  # this rank's KV heads
            k = k.reshape(b, s, -1, hd)
            v = v.reshape(b, s, -1, hd)
        else:  # every KV head: each local query head takes its own
            sel = (split.index * hl + torch.arange(hl, device=x.device)) // (h // kh)
            k = k.reshape(b, s, kh, hd)[:, :, sel]
            v = v.reshape(b, s, kh, hd)[:, :, sel]
    else:
        # the column blocks of q, k and v gathered in one transfer; with this
        # rank's rows of wo, each rank's head gradients are parts
        grad = "sum" if params["wo"].shape[0] < h * hd else "slice"
        parts = [q, k, v]
        cut = [i for i, n in enumerate((h, kh, kh)) if parts[i].shape[-1] < n * hd]
        if cut:
            cols = [parts[i].shape[-1] for i in cut]
            got = C.all_gather_ad(torch.cat([parts[i] for i in cut], dim=-1), mesh,
                                  ax, dim=-1, grad=grad)
            got = got.reshape(b, s, split.size, sum(cols))
            for i, piece in zip(cut, torch.split(got, cols, dim=-1)):
                parts[i] = piece.reshape(b, s, -1)
        q, k, v = (t.reshape(b, s, -1, hd) for t in parts)
    if kv_cache is not None and plan is None:
        plan = cache_plan(cfg, positions, cache_index, b, s,
                          split.kv_len or kv_cache["k"].shape[1])
    if plan is not None:
        cos, sin = plan.cos, plan.sin
    else:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    hq = q.shape[2]
    qk = apply_rope(torch.cat([q, k], dim=2), cos, sin)
    q, k = qk[:, :, :hq], qk[:, :, hq:]

    new_cache = None
    if kv_cache is not None and split.kv_len is not None:
        window = cfg.attention_window
        l_loc = kv_cache["k"].shape[1]
        start = split.index * l_loc
        if s == 1 and (window is None or split.kv_len != window):
            from repro_torch.models.flash_decode import flash_decode

            ck = _length_shard_update(kv_cache["k"], k, plan.rows, start)
            cv = _length_shard_update(kv_cache["v"], v, plan.rows, start)
            out = flash_decode(q, ck, cv, cache_index, window=window)
        else:
            # a multi-token step, or a one-token step on the window's ring:
            # the one-process path on the gathered cache, of which this
            # rank keeps its entries
            ck = _row_cache_update(C.all_gather(kv_cache["k"], mesh, ax, dim=1),
                                   k, plan.rows)
            cv = _row_cache_update(C.all_gather(kv_cache["v"], mesh, ax, dim=1),
                                   v, plan.rows)
            out = _cached_attention(q, ck, cv, plan.bias, v.dtype)
            ck = ck[:, start:start + l_loc].contiguous()
            cv = cv[:, start:start + l_loc].contiguous()
        new_cache = {"k": ck, "v": cv}
    elif kv_cache is not None:
        ck = _row_cache_update(kv_cache["k"], k, plan.rows)
        cv = _row_cache_update(kv_cache["v"], v, plan.rows)
        out = _cached_attention(q, ck, cv, plan.bias, v.dtype)
        new_cache = {"k": ck, "v": cv}
    else:
        out = _attention_core(q, k, v, cfg, impl)
    out = out.reshape(b, s, -1).to(dt)
    wo = params["wo"]
    if out.shape[-1] > wo.shape[0]:  # every head, this rank's rows of wo
        per = wo.shape[0]
        out = out[..., split.index * per:(split.index + 1) * per]
    y = out @ wo.to(dt)
    if out.shape[-1] < h * hd:  # partial sums of the row-parallel product
        y = C.leave_parallel(y, mesh, ax)
    return y, new_cache


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


def mlp_apply(params, x: Tensor, activation: str, split=None) -> Tensor:
    """Each product is rounded to ``x.dtype``, as the reference's einsums.
    ``split.mlp``: this rank's FFN columns (``w_gate`` / ``w_up``) and rows
    (``w_down``), the partial outputs summed over the model axis."""
    if split is not None and split.mlp:
        x = C.enter_parallel(x, split.mesh, split.axis)
        return C.leave_parallel(mlp_apply(params, x, activation), split.mesh,
                                split.axis)
    dt = x.dtype
    if activation == "swiglu":
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        hcurr = F.silu(g) * u
    else:
        hcurr = activation_fn(activation)(x @ params["w_up"].to(dt))
    return hcurr @ params["w_down"].to(dt)


def mlp_block(norm_w: Tensor, params, x: Tensor, activation: str,
              eps: float = 1e-6, split=None) -> Tensor:
    """Reference residual MLP half-block: ``x + mlp(rms_norm(x))``.

    The hand-written stage kernel (:mod:`repro_torch.kernels.stage_block`)
    computes the same function with fewer roundings; its backward is
    autograd of THIS function, as the JAX kernel's custom VJP is."""
    return x + mlp_apply(params, rms_norm(x, norm_w, eps), activation, split)


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


def _load_balance_aux(probs: Tensor, ids: Tensor, cfg: ModelConfig,
                      split=None) -> Tensor:
    """Switch load-balance loss ``E * sum_e f_e P_e * weight``, with f_e
    the share of tokens whose first choice is e; means over every axis
    but the experts'. ``split``: the means are over the whole batch, its
    rows summed over the batch axes."""
    e = cfg.moe.num_experts
    dims = tuple(range(probs.dim() - 1))
    if split is None or not split.batch:
        f_e = torch.mean(F.one_hot(ids[..., 0], e).float(), dim=dims)
        p_e = torch.mean(probs, dim=dims)
    else:
        n = probs[..., 0].numel() * math.prod(split.mesh.shape.get(a, 1)
                                              for a in split.batch)
        f_e = C.all_reduce(F.one_hot(ids[..., 0], e).float().sum(dims),
                           split.mesh, split.batch) / n
        p_e = C.leave_parallel(probs.sum(dims), split.mesh, split.batch) / n
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


def _expert_range(split, e: int):
    """This rank's experts ``(lo, hi)`` under ``split.experts``, else all."""
    if split is None or not split.experts:
        return 0, e
    per = e // split.size
    return split.index * per, (split.index + 1) * per


def moe_apply(params, x: Tensor, cfg: ModelConfig, split=None):
    """Capacity-bounded MoE, x (B, S, D) -> ``(y, aux)``. Dispatch by
    scatter-add into an (E, C, D) buffer per group (= batch row); choices
    past an expert's capacity are dropped. ``split.experts``: the expert
    stacks are this rank's experts, which run on their part of the
    buffer; every choice's output is summed over the model axis from the
    rank of its expert."""
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
    lo, hi = _expert_range(split, e)
    xe = x if hi - lo == e else C.enter_parallel(x, split.mesh, split.axis)
    group = (torch.arange(b, device=x.device) * (e * c))[:, None]
    buf = x.new_zeros((b * e * c, d))
    for j in range(k):
        src = xe * keep[:, :, j:j + 1].to(dt)
        buf = buf.index_add(0, (slot[:, :, j] + group).reshape(-1),
                            src.reshape(-1, d))
    buf = buf.reshape(b, e, c, d)[:, lo:hi]

    if cfg.activation == "swiglu":
        g = torch.einsum("becd,edf->becf", buf, params["w_gate"].to(dt))
        u = torch.einsum("becd,edf->becf", buf, params["w_up"].to(dt))
        hcurr = F.silu(g) * u
    else:
        u = torch.einsum("becd,edf->becf", buf, params["w_up"].to(dt))
        hcurr = activation_fn(cfg.activation)(u)
    out = torch.einsum("becf,efd->becd", hcurr, params["w_down"].to(dt))
    if hi - lo < e:  # this rank's experts in the whole buffer
        out = torch.cat([out.new_zeros((b, lo, c, d)), out,
                         out.new_zeros((b, e - hi, c, d))], dim=1)
    out = out.reshape(b, e * c, d)

    got = out[torch.arange(b, device=x.device)[:, None],
              slot.reshape(b, s * k)].reshape(b, s, k, d)
    if hi - lo < e:
        got = C.leave_parallel(got, split.mesh, split.axis)
    w = (gate_vals * keep).to(dt)
    y = torch.einsum("bskd,bsk->bsd", got, w)
    return y, _load_balance_aux(probs, expert_ids, cfg, split)


def _moe_route(params, xt: Tensor, cfg: ModelConfig, split=None):
    """Token routing shared by the dropless and dense-reference paths:
    xt (T, D) -> ``(gates (T, k) f32, expert_ids (T, k), aux)``."""
    probs = _router_probs(params, xt)
    gates, ids = _topk_gates(probs, cfg.moe.top_k)
    return gates, ids, _load_balance_aux(probs, ids, cfg, split)


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
                       impl: str = "reference", block_size: int = 128,
                       split=None):
    """Dropless MoE dispatch: every routed (token, choice) is computed.

    x (B, S, D) -> ``(y, aux)``. The choices are gathered into the
    block-padded expert-sorted buffer of :func:`dropless_layout`, the
    expert FFN runs over it block by block, and the outputs are gathered
    back through the inverse permutation and combined with one einsum.
    ``impl="reference"`` runs ``grouped_ffn_reference`` (a batched einsum
    over gathered weights); ``impl="pallas"`` the hand-written grouped
    kernel (:mod:`repro_torch.kernels.moe_dispatch`), whose activation
    rounds once where the reference rounds per operation. Padding rows are
    zero and never gathered back. ``split.experts``: the expert stacks
    are this rank's experts, which run on their blocks of the buffer;
    every choice's output is summed over the model axis from the rank of
    its expert."""
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
    gates, ids, aux = _moe_route(params, xt, cfg, split)
    order, dest, p_rows, block_eid = dropless_layout(ids, m.num_experts,
                                                     block_size)
    lo, hi = _expert_range(split, m.num_experts)
    local = hi - lo < m.num_experts
    xe = C.enter_parallel(xt, split.mesh, split.axis) if local else xt
    pbuf = x.new_zeros((p_rows, d)).index_copy(0, dest, xe[order // k])
    rows = None
    if local:  # this rank's experts' blocks
        mine = torch.nonzero((block_eid >= lo) & (block_eid < hi))[:, 0]
        rows = (mine[:, None] * block_size
                + torch.arange(block_size, device=x.device)).reshape(-1)
        pbuf, block_eid = pbuf[rows], block_eid[mine] - lo
    if not pbuf.shape[0]:  # no block routed to this rank's experts
        out_p = pbuf
    elif impl == "reference":
        out_p = grouped_ffn_reference(pbuf, block_eid, params.get("w_gate"),
                                      params["w_up"], params["w_down"],
                                      cfg.activation)
    else:
        out_p = grouped_moe_ffn(pbuf, block_eid, params,
                                activation=cfg.activation)
    if local:
        out_p = out_p.new_zeros((p_rows, d)).index_copy(0, rows, out_p)
    out_sorted = out_p[dest]
    inv = torch.argsort(order)  # flat choice -> sorted row
    got = out_sorted[inv].reshape(t, k, d)
    if local:
        got = C.leave_parallel(got, split.mesh, split.axis)
    y = _moe_combine(got, gates, x.dtype)
    return y.reshape(b, s, d), aux
