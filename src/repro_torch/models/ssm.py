"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060].

Port of ``repro.models.ssm``. The chunked SSD algorithm: an intra-chunk
quadratic (attention-like) term plus the recurrent state carried across
chunks. :func:`ssd_chunked` is the plain PyTorch route;
``mamba_apply(use_pallas=True)`` takes the hand-written scan kernel
(:mod:`repro_torch.kernels.ssd_scan`), which computes the same chunk
recurrence from a zero state. For serving, :func:`ssd_decode_step` is the
single-token recurrent step and :func:`mamba_apply` carries the
``ssm_state`` / ``conv_state`` caches. The rounding points are the
reference's: ``in_proj`` and the convolution run in the activation dtype,
``dt`` goes through ``softplus`` in f32, the scan runs in f32, and the
gated RMSNorm computes in f32 and rounds back.
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


def ssd_decode_step(x: Tensor, dt: Tensor, a: Tensor, b: Tensor, c: Tensor,
                    h: Tensor):
    """One recurrent step: ``h' = exp(dt a) h + dt x b^T``, ``y = h' c``.
    x (B, 1, H, P), dt (B, 1, H), a (H,), b/c (B, 1, N), h (B, H, P, N).
    Returns ``(y (B, 1, H, P), h')``."""
    dec = torch.exp(dt[:, 0, :] * a[None, :])  # (B, H)
    upd = torch.einsum("bhp,bn->bhpn", x[:, 0] * dt[:, 0, :, None], b[:, 0])
    h_new = h * dec[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, c[:, 0])[:, None]
    return y, h_new


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
    x: (B, S, C); w: (K, C); ``state`` the previous K-1 input rows
    (B, K-1, C), zeros when None. Returns ``(y, last K-1 input rows)``."""
    k = w.shape[0]
    s = x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    x_ext = torch.cat([state, x], dim=1)
    y = x_ext[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        y = y + x_ext[:, i:i + s, :] * w[i][None, None, :]
    y = y + bias[None, None, :]
    new_state = x_ext[:, -(k - 1):, :] if k > 1 else None
    return F.silu(y), new_state


def _block(local: int, whole: int, me: int) -> slice:
    """This rank's block of ``whole`` items when it holds ``local`` of
    them (all of them where the model axis does not divide ``whole``)."""
    return slice(None) if local == whole else slice(me * local, (me + 1) * local)


def mamba_apply(params, x: Tensor, cfg: ModelConfig, *, ssm_state=None,
                conv_state=None, use_pallas: bool = False, split=None):
    """Mamba-2 block: x (B, S, D) -> ``(y, (ssm_state', conv_state'))``.

    Without states (training, held-out loss) the scan starts from zero.
    With states and S == 1 it is one recurrent decode step
    (:func:`ssd_decode_step`); with states and S > 1 (a cached prefill)
    :func:`ssd_chunked` starts from ``ssm_state``. ``use_pallas`` runs a
    scan of more than one step through the hand-written kernel, which, as
    the reference's kernel, starts from a zero state: a passed
    ``ssm_state`` is dropped there, as the reference drops it. The conv
    state continues the convolution across calls and comes back in its
    own dtype.

    ``split`` (a sharded decode's ``ModelSplit`` with ``split.ssm``, with
    states): the block runs on this rank's part of the weights and states,
    as GSPMD runs the reference under ``cache_shardings``: ``in_proj`` is
    this rank's block of columns, the conv state its block of channels,
    the SSM state its block of heads and ``out_proj`` its block of rows
    (each whole where the model axis does not divide it). The splits do
    not line up (a block of columns cuts across z, x, B, C and dt; B and C
    are read by every head), so the projected columns and the convolved
    channels are gathered over the line and each rank takes what its heads
    read. The gated RMSNorm's sum of squares over ``d_inner`` and the
    row-parallel ``out_proj``'s partial products are summed over the
    line."""
    bsz, s, d = x.shape
    sc = cfg.ssm
    di = sc.d_inner(d)
    nh = sc.num_heads(d)
    n = sc.d_state
    hd = sc.head_dim
    dtv = x.dtype
    ch = heads = cols = slice(None)
    if split is not None:
        from repro_torch.distribution import collectives as C

        mesh, ax, me = split.mesh, split.axis, split.index
        hl = ssm_state.shape[1]  # this rank's heads, conv channels
        ch = _block(conv_state.shape[-1], di + 2 * n, me)
        heads, cols = _block(hl, nh, me), _block(hl * hd, di, me)

    zxbcdt = x @ params["in_proj"].to(dtv)
    if zxbcdt.shape[-1] != 2 * di + 2 * n + nh:  # this rank's columns
        zxbcdt = C.all_gather(zxbcdt, mesh, ax, dim=-1)
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    decode = ssm_state is not None and s == 1
    conv_out, new_conv = causal_conv1d(
        conv_in[..., ch], params["conv_w"][:, ch].to(dtv),
        params["conv_b"][ch].to(dtv),
        state=None if conv_state is None else conv_state.to(dtv))
    if conv_state is not None and new_conv is not None:
        new_conv = new_conv.to(conv_state.dtype)
    if conv_out.shape[-1] != di + 2 * n:  # this rank's channels
        conv_out = C.all_gather(conv_out, mesh, ax, dim=-1)
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt[..., heads].float() + params["dt_bias"][heads][None, None, :])
    a = -torch.exp(params["a_log"][heads])

    xh = xin.reshape(bsz, s, nh, hd)[:, :, heads]
    if decode:
        y, new_ssm = ssd_decode_step(xh.float(), dt, a, bmat.float(),
                                     cmat.float(), ssm_state.float())
    elif use_pallas:
        from repro_torch.kernels.ssd_scan import ssd_scan

        # from a zero state: ssm_state is dropped, as in the reference;
        # the kernel takes contiguous tensors (x, B and C are views of the
        # conv output in an f32 block)
        y, new_ssm = ssd_scan(xh.float().contiguous(), dt, a,
                              bmat.float().contiguous(),
                              cmat.float().contiguous(), chunk=sc.chunk)
    else:
        y, new_ssm = ssd_chunked(
            xh.float(), dt, a, bmat.float(), cmat.float(), chunk=sc.chunk,
            h0=None if ssm_state is None else ssm_state.float())
    y = y + xh.float() * params["d_skip"][heads][None, None, :, None]
    y = y.reshape(bsz, s, -1).to(dtv)
    # gated RMSNorm (Mamba-2) over the whole d_inner
    y = y * F.silu(z[..., cols])
    y32 = y.float()
    if y.shape[-1] == di:
        var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    else:  # this rank's heads
        var = C.all_reduce(torch.sum(y32 * y32, dim=-1, keepdim=True),
                           mesh, ax) / di
    y = (y32 * torch.rsqrt(var + cfg.norm_eps)).to(dtv) \
        * params["norm_w"][cols].to(dtv)
    w_out = params["out_proj"]
    rl = w_out.shape[0]  # this rank's rows
    if rl != y.shape[-1]:  # the rows do not line up with the heads
        if y.shape[-1] != di:
            y = C.all_gather(y, mesh, ax, dim=-1)
        y = y[..., _block(rl, di, me)]
    out = y @ w_out.to(dtv)
    if rl != di:  # row-parallel: partial products
        out = C.all_reduce(out, mesh, ax)
    return out, (new_ssm.float(), new_conv)
