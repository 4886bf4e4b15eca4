"""Causal GQA flash attention, with a backward for the tensor-core body.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_kernel``, launched by ``flash_attention``'s ``pallas_call``) with a
CUDA C++ kernel for Hopper, ``csrc/flash_attention.cu``, built with
``nvcc`` for ``sm_90a`` at first use and bound with :mod:`ctypes`.

It computes ``kernels/ref.py``'s ``flash_attention_ref``: f32 scores and
softmax over the keys a query may see (causal, an optional sliding
``window``, queries at absolute positions ``q_offset + i``), the output
cast to the input dtype. GQA maps query head ``h`` to kv head
``h // (H // KH)``. What bounds the call on an H100 and how the design
follows is written at the top of the CUDA source.

* :func:`flash_attention` is the wrapper. A CUDA tensor launches the
  kernel or raises; only CPU tensors take the plain version. Every
  launch adds one to :data:`launches`.
* The input dtype fixes the kernel body (:func:`body`), with no option
  and no fallback between them: f16 and bf16 take ``"wgmma"``, the
  tensor-core body (TMA-fed ``wgmma``; the probabilities enter ``p @ v``
  as two terms in the input dtype, ``T(p) + T(p - T(p))``, and the row
  sums come from the unrounded f32 values); f32 takes ``"fma"``, the f32
  FMA body (nothing rounded before the output). The tensor-core body's
  tensors must suit TMA (16-byte aligned bases).
* :func:`flash_attention_ref` is the plain PyTorch version. The CPU
  path and the tests use it.
* Both bodies are built for head dims :data:`HEAD_DIMS`. Any other head
  dim up to 256 is zero-padded to the next of them (:func:`padded_head_dim`)
  on q, k and v, with the scale of the true head dim, and the output is
  sliced back: zero columns change no score and add only zero output
  columns. That costs one copy of q, k, v and o each. Above 256 the
  wrapper raises: the tensor-core body's O accumulator of 64 rows would
  exceed the register file.
* The tensor-core body has a backward at head dims :data:`BWD_HEAD_DIMS`
  (after padding), which the JAX kernel lacks (it has no VJP): where a
  gradient is required, :func:`flash_attention` runs as a
  :class:`torch.autograd.Function` whose forward also keeps the rows'
  log-sum-exp and the output's second term ``T(o - T(o))``, and whose
  backward is the hand-written ``flash_bwd_*`` kernels (one more count in
  :data:`launches`; :func:`has_backward`). dq, dk and dv come back in the
  input dtype, bit-equal from call to call. The f32 FMA body, other head
  dims and CPU tensors have no backward: the wrapper raises when a
  gradient would be required there.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels._tma import check_tma

# kernel launches since the last reset (a caller sets it to 0 to count a run)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# head dims both bodies are instantiated for (csrc/flash_attention.cu)
HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)
# head dims the tensor-core body's backward is instantiated for
BWD_HEAD_DIMS = (64, 128)
# the forward's log-sum-exp and the backward's D are laid out at Sq padded
# to the forward's 128-row tiles
_ROW_TILE = 128

_lib = None


def body(dtype) -> str:
    """The kernel body that inputs of ``dtype`` take: ``"wgmma"`` (tensor
    cores) for f16 and bf16, ``"fma"`` (f32 FMA units) for f32."""
    if dtype in (torch.float16, torch.bfloat16):
        return "wgmma"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"flash_attention kernel takes f32/f16/bf16, got {dtype}")


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build

        lib = _build.load("flash_attention")
        tail = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.flash_attention_fma.restype = ctypes.c_int
        lib.flash_attention_fma.argtypes = tail
        lib.flash_attention_wgmma.restype = ctypes.c_int
        lib.flash_attention_wgmma.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                                              + tail[4:])
        lib.flash_attention_bwd_wgmma.restype = ctypes.c_int
        lib.flash_attention_bwd_wgmma.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                                                  + tail[4:])
        lib.flash_attention_wgmma_smem.restype = ctypes.c_int
        lib.flash_attention_wgmma_smem.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def padded_head_dim(hd: int) -> int:
    """The instantiated head dim the kernel runs ``hd`` at: ``hd`` itself
    or the next of :data:`HEAD_DIMS`. Raises above 256."""
    for width in HEAD_DIMS:
        if hd <= width:
            return width
    raise ValueError(f"flash_attention kernel takes head_dim <= {HEAD_DIMS[-1]}, "
                     f"got {hd}: the tensor-core body's O accumulator of 64 rows "
                     "would exceed the register file")


def has_backward(dtype, hd: int) -> bool:
    """Whether a gradient flows through the kernel for CUDA inputs of
    ``dtype`` and head dim ``hd``: the tensor-core body (f16, bf16) at a
    head dim whose padded width is one of :data:`BWD_HEAD_DIMS`."""
    return (dtype in (torch.float16, torch.bfloat16) and 0 < hd <= HEAD_DIMS[-1]
            and padded_head_dim(hd) in BWD_HEAD_DIMS)


def pad_head_dim(q, k, v):
    """q, k and v zero-padded along the head dim to
    :func:`padded_head_dim` (unchanged where it is instantiated), and that
    width. With the true head dim's scale, attention of the padded tensors
    is the original's in its first ``hd`` output columns and 0 in the
    rest: the zero columns add nothing to any score."""
    hd = q.shape[-1]
    width = padded_head_dim(hd)
    if width != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, width - hd)) for t in (q, k, v))
    return q, k, v, width


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: Optional[float] = None):
    """Plain PyTorch version (``kernels/ref.py`` of the JAX package):
    q (B, Sq, H, hd), k/v (B, Skv, KH, hd) -> (B, Sq, H, hd) in q's dtype;
    the scores are scaled by ``scale`` (default ``1 / sqrt(hd)``)."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    kr = torch.repeat_interleave(k, g, dim=2)
    vr = torch.repeat_interleave(v, g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float())
    s = s * (1.0 / math.sqrt(hd) if scale is None else scale)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(ok[None, None], s, -math.inf)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vr.float())
    return out.to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B, Sq, H, hd) and k, v "
                         "(B, Skv, KH, hd)")
    b, _, h, hd = q.shape
    kb, _, kh, khd = k.shape
    if (kb != b or khd != hd or tuple(v.shape) != tuple(k.shape)
            or kh == 0 or h % kh):
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def _launch(q, k, v, causal, window, q_offset, keep=False):
    """Launch the CUDA kernel on the current stream (no fallback). With
    ``keep`` (the tensor-core body) also return what the backward needs:
    the padded q, k, v and output, the output's second term and the rows'
    log-sum-exp."""
    global launches
    _check(q, k, v)
    dev = q.device
    route = body(q.dtype)
    for t in (k, v):
        if t.device != dev or t.dtype != q.dtype:
            raise TypeError("flash_attention kernel needs q, k, v on "
                            f"{dev} in {q.dtype}; got {t.device} {t.dtype}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention kernel needs contiguous inputs")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    padded_head_dim(hd)  # raises above 256
    if b == 0 or sq == 0:
        return (torch.empty_like(q), None) if keep else torch.empty_like(q)
    if skv == 0:
        raise ValueError("flash_attention needs at least one key")
    q, k, v, width = pad_head_dim(q, k, v)
    lib = _library()
    out = torch.empty_like(q)
    args = (b, sq, skv, h, kh, width, 1.0 / math.sqrt(hd), int(causal),
            0 if window is None else int(window), int(q_offset))
    if route == "wgmma":
        # the tensor maps' strides, innermost first: a row, a head's rows,
        # a batch row
        es = q.element_size()
        for name, t, n_heads, seq in (("q", q, h, sq), ("k", k, kh, skv),
                                      ("v", v, kh, skv)):
            check_tma(f"flash_attention {name}", t.data_ptr(),
                      [width * es, n_heads * width * es, seq * n_heads * width * es])
    lse = o_lo = None
    if keep:
        sq_pad = -(-sq // _ROW_TILE) * _ROW_TILE
        lse = torch.empty((b, h, sq_pad), dtype=torch.float32, device=dev)
        o_lo = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma":
            err = lib.flash_attention_wgmma(
                _DTYPE_CODE[q.dtype], *ptrs, 0 if lse is None else lse.data_ptr(),
                0 if o_lo is None else o_lo.data_ptr(), *args, stream)
        else:
            err = lib.flash_attention_fma(*ptrs, *args, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    res = out if width == hd else out[..., :hd].contiguous()
    return (res, (q, k, v, out, o_lo, lse)) if keep else res


def _launch_bwd(dout, saved, causal, window, q_offset):
    """The backward kernels on the current stream: dq, dk, dv (the input
    dtype) from the forward's padded tensors ``saved`` and ``dout``."""
    global launches
    q, k, v, out, o_lo, lse = saved
    b, sq, h, width = q.shape
    skv, kh = k.shape[1], k.shape[2]
    hd = dout.shape[-1]
    dout = dout.contiguous()
    if width != hd:
        dout = torch.nn.functional.pad(dout, (0, width - hd))
    es = q.element_size()
    check_tma("flash_attention dout", dout.data_ptr(),
              [width * es, h * width * es, sq * h * width * es])
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dpart = (None if h == kh else
             torch.empty((2, b, skv, h, width), dtype=torch.float32, device=q.device))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_wgmma(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), o_lo.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            0 if dpart is None else dpart.data_ptr(), b, sq, skv, h, kh, width,
            1.0 / math.sqrt(hd), int(causal), 0 if window is None else int(window),
            int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: cudaError {err}")
    launches += 1
    if width != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The tensor-core body with its backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, saved = _launch(q, k, v, causal, window, q_offset, keep=True)
        ctx.args = (causal, window, q_offset)
        ctx.empty = saved is None
        if saved is not None:
            ctx.save_for_backward(*saved)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        if ctx.empty:
            return (None,) * 6
        return (*_launch_bwd(dout, ctx.saved_tensors, *ctx.args), None, None, None)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0):
    """Causal GQA attention: q (B, Sq, H, hd), k/v (B, Skv, KH, hd), all
    one dtype (f32, f16 or bf16); queries sit at absolute positions
    ``q_offset + i``. On CUDA tensors f16/bf16 run the tensor-core body
    and f32 the FMA body (:func:`body`). A gradient flows through CUDA
    f16/bf16 inputs at the head dims of :func:`has_backward`; elsewhere
    the call raises if a gradient would be required."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type == "cuda" and has_backward(q.dtype, q.shape[-1]):
            return _FlashAttention.apply(q, k, v, causal, window, q_offset)
        raise RuntimeError(
            "flash_attention has a backward only for CUDA f16/bf16 inputs at "
            f"head dims padded to {BWD_HEAD_DIMS} (got {q.device.type} {q.dtype}, "
            f"head dim {q.shape[-1]}); call it under torch.no_grad() or use "
            "impl='dense'/'chunked' for training")
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        _check(q, k, v)
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    raise TypeError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
