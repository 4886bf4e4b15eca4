"""Fused residual MLP half-block of the split executor.

Replaces the Pallas TPU kernel ``repro/kernels/stage_block.py``
(``_kernel_gated`` / ``_kernel_plain``, launched by ``_forward``'s
``pallas_call``) with a CUDA C++ kernel for Hopper,
``csrc/stage_mlp_block.cu``, built with ``nvcc`` for ``sm_90a`` at first
use and bound with :mod:`ctypes`.

It computes ``x + down(act(rms_norm(x) @ w_up [, @ w_gate]))`` with the
Pallas body's rounding points, which are not ``mlp_block``'s: the
normalized rows and every weight are rounded to the activation dtype,
the up/gate and down products accumulate in f32, the activation runs in
f32 on the f32 accumulators and only its result is rounded before the
down product; the output is ``(x32 + y)`` rounded once. The weights are
read in their stored dtype (f32 master weights on the split executor)
and rounded to the activation dtype on chip. What bounds the call on an
H100 and how the design follows is written at the top of the CUDA
source.

* :func:`stage_mlp_block` is the wrapper. A CUDA tensor launches the
  kernel or raises; only CPU tensors take the plain version. Every
  launch adds one to :data:`launches` (one launch = one call, which the
  CUDA side runs as several grids on the current stream).
* The activation dtype fixes the kernel body (:func:`body`), with no
  option and no fallback between them: f16 and bf16 take ``"wgmma"``,
  the tensor-core body (rms_norm_rows, a TMA-fed ``wgmma`` up +
  activation GEMM, a split-K ``wgmma`` down GEMM over
  :func:`split_k_plan`'s splits, and a fixed-order sum of the splits
  with the residual); f32 takes ``"fma"``, the f32 FMA body
  (rms_norm_rows, up_act, down_residual). The tensor-core body's tensors
  must suit TMA (:func:`repro_torch.kernels._tma.check_tma`: D and F
  times the element size multiples of 16 bytes, aligned weights).
* :func:`stage_mlp_block_ref` is the plain PyTorch version with the
  kernel's rounding. The CPU path and the tests use it.
* The gradient is a :class:`torch.autograd.Function` whose backward is
  autograd of ``models.layers.mlp_block``, as the JAX kernel's custom VJP
  is JAX AD of the same function. No backward kernel: JAX has none.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._tma import check_tma
from repro_torch.models.layers import activation_fn, mlp_block

# kernel launches since the last reset (a caller sets it to 0 to count a run)
launches = 0

ACTIVATIONS = ("swiglu", "gelu", "relu2", "silu")
_ACT_CODE = {name: i for i, name in enumerate(ACTIVATIONS)}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# (rows, columns, depth) of one CTA's tile in the tensor-core body's
# GEMMs; csrc/stage_mlp_block.cu tc::kBM, tc::kBN, tc::kBK
TC_TILE = (256, 128, 64)
H100_SMS = 132

_lib = None


def body(dtype) -> str:
    """The kernel body that activations of ``dtype`` take: ``"wgmma"``
    (tensor cores) for f16 and bf16, ``"fma"`` (f32 FMA units) for f32."""
    if dtype in (torch.float16, torch.bfloat16):
        return "wgmma"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"stage_mlp_block kernel takes f32/f16/bf16, got {dtype}")


def split_k_plan(rows: int, d: int, f: int, sms: int = H100_SMS):
    """How the tensor-core body splits the down product's reduction over
    F: ``(splits, tiles_per_split)``, split ``z`` taking the k-tiles
    ``[z * tiles_per_split, min((z + 1) * tiles_per_split, k_tiles))`` of
    ``TC_TILE[2]`` rows of F each, which cover ``[0, F)`` once.

    There are ``ceil(rows / 256) * ceil(d / 128)`` output tiles; the
    splits give at least ``sms`` CTAs where F has enough k-tiles, and among
    such plans (up to 4x the fewest splits) the one with the least
    ``waves * tiles_per_split`` (one CTA per SM) wins, the fewest splits
    on a tie (less f32 scratch to write and sum)."""
    bm, bn, bk = TC_TILE
    tiles = math.ceil(rows / bm) * math.ceil(d / bn)
    k_tiles = math.ceil(f / bk)
    need = min(sms, tiles * k_tiles)
    lo = min(k_tiles, math.ceil(sms / tiles))
    best = None
    for s in range(lo, min(k_tiles, 4 * lo) + 1):
        per = math.ceil(k_tiles / s)
        splits = math.ceil(k_tiles / per)
        if tiles * splits < need:
            continue
        cost = math.ceil(tiles * splits / sms) * per
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build

        lib = _build.load("stage_mlp_block")
        lib.stage_mlp_block_fma.restype = ctypes.c_int
        lib.stage_mlp_block_fma.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p])
        lib.stage_mlp_block_wgmma.restype = ctypes.c_int
        lib.stage_mlp_block_wgmma.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
            + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.stage_mlp_block_wgmma_smem.restype = ctypes.c_int
        lib.stage_mlp_block_wgmma_smem.argtypes = [ctypes.c_int] * 2
        _lib = lib
    return _lib


def _act(name: str, g, u):
    """Gated/plain activation in f32. ``g`` is None for ungated MLPs."""
    if name == "swiglu":
        return torch.nn.functional.silu(g) * u
    return activation_fn(name)(u)


def stage_mlp_block_ref(norm_w, params, x, *, activation: str, eps: float = 1e-6):
    """Plain PyTorch version of the kernel (mirrors the Pallas body):
    ``h = (x32 * rsqrt(mean(x32^2) + eps)).to(dt) * norm_w.to(dt)``, f32
    products of ``dt``-rounded operands, the activation in f32, its
    result rounded to ``dt``, output ``(x32 + y).to(x.dtype)``."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    h = (x32 * torch.rsqrt(var + eps)).to(dt) * norm_w.to(dt)
    hf = h.float()

    def w(name):
        return params[name].to(dt).float()

    g = hf @ w("w_gate") if activation == "swiglu" else None
    u = hf @ w("w_up")
    hcurr = _act(activation, g, u).to(dt)
    y = hcurr.float() @ w("w_down")
    return (x32 + y).to(x.dtype)


def _check(norm_w, params, x, activation):
    if activation not in _ACT_CODE:
        raise ValueError(f"unknown activation {activation!r}; have {ACTIVATIONS}")
    if x.dim() < 2:
        raise ValueError(f"stage_mlp_block takes x (..., D), got {tuple(x.shape)}")
    d = x.shape[-1]
    w_up, w_down = params["w_up"], params["w_down"]
    f = w_up.shape[-1]
    gated = activation == "swiglu"
    if gated != ("w_gate" in params):
        raise ValueError(f"{activation} needs w_gate iff gated; params have "
                         f"{sorted(params)}")
    shapes_ok = (tuple(norm_w.shape) == (d,) and tuple(w_up.shape) == (d, f)
                 and tuple(w_down.shape) == (f, d)
                 and (not gated or tuple(params["w_gate"].shape) == (d, f)))
    if not shapes_ok:
        raise ValueError(
            f"stage_mlp_block shapes disagree: x {tuple(x.shape)}, norm_w "
            f"{tuple(norm_w.shape)}, "
            + ", ".join(f"{k} {tuple(v.shape)}" for k, v in sorted(params.items())))
    return d, f


def _launch(norm_w, params, x, activation, eps):
    """Launch the CUDA kernel on the current stream (no fallback)."""
    global launches
    d, f = _check(norm_w, params, x, activation)
    weights = [params[k] for k in ("w_gate", "w_up", "w_down") if k in params]
    dev = x.device
    route = body(x.dtype)
    if norm_w.dtype not in _DTYPE_CODE:
        raise TypeError(f"stage_mlp_block kernel takes f32/f16/bf16, got x "
                        f"{x.dtype}, weights {norm_w.dtype}")
    for t in [norm_w] + weights:
        if t.device != dev or t.dtype != norm_w.dtype:
            raise TypeError("stage_mlp_block kernel needs norm_w and the weights "
                            f"on {dev} in one dtype; got {t.device} {t.dtype}")
    for t in [x, norm_w] + weights:
        if not t.is_contiguous():
            raise ValueError("stage_mlp_block kernel needs contiguous inputs")
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    h = torch.empty((rows, d), dtype=x.dtype, device=dev)
    hc = torch.empty((rows, f), dtype=x.dtype, device=dev)
    gate = params["w_gate"].data_ptr() if "w_gate" in params else None
    lib = _library()
    wptrs = (gate, params["w_up"].data_ptr(), params["w_down"].data_ptr())
    if route == "wgmma":
        # every tensor a tensor map reads: h and hc (rows of D and F in
        # x's dtype), the weights (rows of F and D in their own)
        xs, ws = x.element_size(), norm_w.element_size()
        check_tma("stage_mlp_block h", h.data_ptr(), [d * xs])
        check_tma("stage_mlp_block hc", hc.data_ptr(), [f * xs])
        for name in ("w_gate", "w_up"):
            if name in params:
                check_tma(f"stage_mlp_block {name}", params[name].data_ptr(), [f * ws])
        check_tma("stage_mlp_block w_down", params["w_down"].data_ptr(), [d * ws])
        splits, per = split_k_plan(
            rows, d, f, torch.cuda.get_device_properties(dev).multi_processor_count)
        part = torch.empty((splits, rows, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma":
            err = lib.stage_mlp_block_wgmma(
                _DTYPE_CODE[x.dtype], _DTYPE_CODE[norm_w.dtype],
                _ACT_CODE[activation], x.data_ptr(), norm_w.data_ptr(), *wptrs,
                h.data_ptr(), hc.data_ptr(), part.data_ptr(), out.data_ptr(),
                rows, d, f, eps, splits, per, stream)
        else:
            err = lib.stage_mlp_block_fma(
                _DTYPE_CODE[norm_w.dtype], _ACT_CODE[activation], x.data_ptr(),
                norm_w.data_ptr(), *wptrs, h.data_ptr(), hc.data_ptr(),
                out.data_ptr(), rows, d, f, eps, stream)
    if err != 0:
        raise RuntimeError(f"stage_mlp_block kernel launch failed: cudaError {err}")
    launches += 1
    return out


def _forward(norm_w, params, x, activation, eps):
    if x.device.type == "cuda":
        return _launch(norm_w, params, x, activation, eps)
    if x.device.type == "cpu":
        _check(norm_w, params, x, activation)
        return stage_mlp_block_ref(norm_w, params, x, activation=activation, eps=eps)
    raise TypeError(f"stage_mlp_block runs on cuda or cpu tensors, got {x.device}")


def _mlp_params(w_gate, w_up, w_down):
    p = {"w_up": w_up, "w_down": w_down}
    if w_gate is not None:
        p["w_gate"] = w_gate
    return p


class _StageFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, norm_w, w_gate, w_up, w_down, activation, eps):
        ctx.save_for_backward(x, norm_w, w_gate, w_up, w_down)
        ctx.activation, ctx.eps = activation, eps
        return _forward(norm_w, _mlp_params(w_gate, w_up, w_down), x,
                        activation, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            xs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(saved, need)]
            x, norm_w, w_gate, w_up, w_down = xs
            out = mlp_block(norm_w, _mlp_params(w_gate, w_up, w_down), x,
                            ctx.activation, ctx.eps)
            leaves = [t for t in xs if t is not None and t.requires_grad]
            it = iter(torch.autograd.grad(out, leaves, g) if leaves else ())
        grads = [next(it) if t is not None and t.requires_grad else None
                 for t in xs]
        return (*grads, None, None)


def stage_mlp_block(norm_w, params, x, *, activation: str, eps: float = 1e-6):
    """Fused residual MLP half-block: ``x + mlp(rms_norm(x, norm_w))``.

    ``params`` is the ``models.layers.init_mlp`` dict; ``x`` is
    ``(B, S, D)`` in f32, f16 or bf16; ``norm_w`` and the weights share
    one of those dtypes. Forward runs the hand-written kernel (f32
    accumulation; on CUDA tensors f16/bf16 ``x`` takes the tensor-core
    body and f32 the FMA body, :func:`body`); backward is autograd of
    ``models.layers.mlp_block``.
    """
    return _StageFunction.apply(x, norm_w, params.get("w_gate"),
                                params["w_up"], params["w_down"],
                                activation, eps)
