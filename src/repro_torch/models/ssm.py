"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060].

Port of ``repro.models.ssm``, cache-free path. The chunked SSD algorithm:
an intra-chunk quadratic (attention-like) term plus the recurrent state
carried across chunks. :func:`ssd_chunked` is the plain PyTorch route;
``mamba_apply(use_pallas=True)`` takes the hand-written scan kernel
(:mod:`repro_torch.kernels.ssd_scan`), which computes the same chunk
recurrence from a zero state. The rounding points are the reference's:
``in_proj`` and the convolution run in the activation dtype, ``dt`` goes
through ``softplus`` in f32, the scan runs in f32, and the gated RMSNorm
computes in f32 and rounds back. The single-token recurrent step and the
``ssm_state``/``conv_state`` caches come with the serving slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


def segsum(x: Tensor) -> Tensor:
    """Stable segment sum: ``out[..., i, j] = sum_{j<k<=i} x[..., k]``,
    ``-inf`` for ``j > i``. x: (..., T) -> (..., T, T)."""
    t = x.shape[-1]
    xx = x[..., None, :].expand(*x.shape, t).transpose(-1, -2)
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device), -1)
    xx = torch.where(mask, xx, torch.zeros((), dtype=x.dtype, device=x.device))
    out = torch.cumsum(xx, dim=-2)
    mask2 = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device), 0)
    return torch.where(mask2, out, torch.full((), -math.inf, dtype=x.dtype,
                                              device=x.device))


def _pad_seq(t: Tensor, pad: int) -> Tensor:
    """Zero rows appended along dim 1."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))], dim=1)


def ssd_chunked(x: Tensor, dt: Tensor, a: Tensor, b: Tensor, c: Tensor,
                chunk: int = 64, h0: Optional[Tensor] = None):
    """Chunked SSD. x (B, S, H, P), dt (B, S, H) positive steps, a (H,)
    negative rates, b/c (B, S, N) (one group), h0 (B, H, P, N) or None.
    Returns ``(y (B, S, H, P), h_final (B, H, P, N))``."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    x, dt, b, c = (_pad_seq(t, pad) for t in (x, dt, b, c))
    nc = x.shape[1] // chunk

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)

    da = dtc * a[None, None, None, :]  # (B, nc, L, H) log-decay per step
    da_cum = torch.cumsum(da, dim=2)

    # 1) intra-chunk (diagonal block) output
    decay = torch.exp(segsum(da.permute(0, 1, 3, 2)))  # (B, nc, H, L, L)
    scores = torch.einsum("bzln,bzmn,bzhlm->bzhlm", cc, bc, decay)
    y_diag = torch.einsum("bzhlm,bzmh,bzmhp->bzlhp", scores, dtc, xc)

    # 2) per-chunk final states
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)  # (B, nc, L, H)
    states = torch.einsum("bzln,bzlh,bzlhp->bzhpn", bc, decay_states * dtc, xc)

    # 3) inter-chunk recurrence over the chunk index
    chunk_decay = torch.exp(da_cum[:, :, -1, :])  # (B, nc, H)
    hprev = h0 if h0 is not None else x.new_zeros((bsz, h, p, n))
    h_before = []
    for z in range(nc):
        h_before.append(hprev)
        hprev = hprev * chunk_decay[:, z, :, None, None] + states[:, z]
    h_before = torch.stack(h_before, dim=1)  # (B, nc, H, P, N) entering chunk

    # 4) state -> output contribution
    state_decay = torch.exp(da_cum)  # (B, nc, L, H)
    y_off = torch.einsum("bzln,bzhpn,bzlh->bzlhp", cc, h_before, state_decay)

    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)
    return y[:, :s], hprev


# ---------------------------------------------------------------------------
# full Mamba-2 block
# ---------------------------------------------------------------------------


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device: DeviceLike = None):
    """The reference's layout: ``in_proj`` (D, 2 di + 2 N + H) for z, x, B,
    C, dt; a depthwise ``conv_w`` (K, di + 2 N); ``a_log``, ``dt_bias``
    and ``d_skip`` in f32 whatever ``dtype`` is."""
    d = cfg.d_model
    sc = cfg.ssm
    di = sc.d_inner(d)
    nh = sc.num_heads(d)
    n = sc.d_state
    dev = resolve_device(device)
    d_in_proj = 2 * di + 2 * n + nh
    conv_dim = di + 2 * n
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": (torch.randn((d, d_in_proj), generator=gen, device=dev)
                    / math.sqrt(d)).to(dtype),
        "conv_w": (torch.randn((sc.d_conv, conv_dim), generator=gen, device=dev)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros((nh,), **f32),
        "d_skip": torch.ones((nh,), **f32),
        "norm_w": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": (torch.randn((di, d), generator=gen, device=dev)
                     / math.sqrt(di)).to(dtype),
    }


def causal_conv1d(x: Tensor, w: Tensor, bias: Tensor, state=None):
    """Depthwise causal convolution as a sum of shifted slices, then silu.
    x: (B, S, C); w: (K, C). Returns ``(y, last K-1 input rows)``."""
    if state is not None:
        raise NotImplementedError("the conv state (decode) comes with the "
                                  "serving slice")
    k = w.shape[0]
    s = x.shape[1]
    x_ext = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2])), x], dim=1)
    y = x_ext[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        y = y + x_ext[:, i:i + s, :] * w[i][None, None, :]
    y = y + bias[None, None, :]
    new_state = x_ext[:, -(k - 1):, :] if k > 1 else None
    return F.silu(y), new_state


def mamba_apply(params, x: Tensor, cfg: ModelConfig, *, ssm_state=None,
                conv_state=None, use_pallas: bool = False):
    """Mamba-2 block, cache-free: x (B, S, D) -> ``(y, (h_final,
    conv_tail))``. ``use_pallas`` runs the scan through the hand-written
    kernel (forward only, from a zero state); otherwise
    :func:`ssd_chunked`."""
    if ssm_state is not None or conv_state is not None:
        raise NotImplementedError("cached Mamba (decode) comes with the "
                                  "serving slice")
    bsz, s, d = x.shape
    sc = cfg.ssm
    di = sc.d_inner(d)
    nh = sc.num_heads(d)
    n = sc.d_state
    dtv = x.dtype

    zxbcdt = x @ params["in_proj"].to(dtv)
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out, new_conv = causal_conv1d(conv_in, params["conv_w"].to(dtv),
                                       params["conv_b"].to(dtv))
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    a = -torch.exp(params["a_log"])

    xh = xin.reshape(bsz, s, nh, sc.head_dim)
    if use_pallas:
        from repro_torch.kernels.ssd_scan import ssd_scan

        y, new_ssm = ssd_scan(xh.float(), dt, a, bmat.float(), cmat.float(),
                              chunk=sc.chunk)
    else:
        y, new_ssm = ssd_chunked(xh.float(), dt, a, bmat.float(), cmat.float(),
                                 chunk=sc.chunk)
    y = y + xh.float() * params["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(dtv)
    # gated RMSNorm (Mamba-2)
    y = y * F.silu(z)
    y32 = y.float()
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + cfg.norm_eps)).to(dtv) * params["norm_w"].to(dtv)
    out = y @ params["out_proj"].to(dtv)
    return out, (new_ssm.float(), new_conv)
