"""Causal GQA flash attention, forward only.

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
* There is no backward, as the JAX kernel has no VJP: the wrapper raises
  when a gradient would be required.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels._tma import check_tma

# kernel launches since the last reset (a caller sets it to 0 to count a run)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# head dims both bodies are instantiated for (csrc/flash_attention.cu)
HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)

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
        lib.flash_attention_wgmma.argtypes = [ctypes.c_int] + tail
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


def _launch(q, k, v, causal, window, q_offset):
    """Launch the CUDA kernel on the current stream (no fallback)."""
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
        return torch.empty_like(q)
    if skv == 0:
        raise ValueError("flash_attention needs at least one key")
    q, k, v, width = pad_head_dim(q, k, v)
    lib = _library()
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, h, kh, width, 1.0 / math.sqrt(hd), int(causal),
            0 if window is None else int(window), int(q_offset))
    if route == "wgmma":
        # the tensor maps' strides, innermost first: a row, a head's rows,
        # a batch row
        es = q.element_size()
        for name, t, n_heads, seq in (("q", q, h, sq), ("k", k, kh, skv),
                                      ("v", v, kh, skv)):
            check_tma(f"flash_attention {name}", t.data_ptr(),
                      [width * es, n_heads * width * es, seq * n_heads * width * es])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma":
            err = lib.flash_attention_wgmma(_DTYPE_CODE[q.dtype], *args, stream)
        else:
            err = lib.flash_attention_fma(*args, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out if width == hd else out[..., :hd].contiguous()


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0):
    """Causal GQA attention, forward only: q (B, Sq, H, hd), k/v
    (B, Skv, KH, hd), all one dtype (f32, f16 or bf16); queries sit at
    absolute positions ``q_offset + i``. On CUDA tensors f16/bf16 run the
    tensor-core body and f32 the FMA body (:func:`body`). Raises if a
    gradient would be required (the JAX kernel has no VJP either)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward (as the JAX kernel "
                           "has no VJP); call it under torch.no_grad() or use "
                           "impl='dense'/'chunked' for training")
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        _check(q, k, v)
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    raise TypeError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
