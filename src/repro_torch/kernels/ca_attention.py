"""Fused history cross-attention for the CA actor (paper Eq. 24).

Replaces the Pallas TPU kernel ``repro/kernels/ca_attention.py``
(``_kernel``, launched by ``_ca_forward``'s ``pallas_call``) with a CUDA
C++ kernel for Hopper, ``csrc/ca_attention.cu``, built with ``nvcc`` for
``sm_90a`` at first use and bound with :mod:`ctypes`.

Only the current-state query row of ``cross_attention`` reaches the
actor, so the kernel computes that row alone: ``q = obs @ wq_s``,
``K, V = hist @ wk, hist @ wv``, the masked ``(B, I)`` score row,
a max-subtracted softmax and ``sum_i w_i V_i``, in f32 whatever the
storage type, then writes ``[obs, s']``. What bounds it on an H100 and
how the design follows is written at the top of the CUDA source: at the
main path's shapes the call is bound by its bytes at ~0.06 us, far below
a launch, so the kernel stages everything in one round trip of bulk
asynchronous copies and runs its three products on the tensor cores in
3xTF32.

Any shape the reference takes runs, up to the f32 work arrays of 16 rows
fitting in shared memory (:func:`plan`): where the weights and the
history of a tile do not fit in the 227 KB a CTA may use, the kernel
streams them in chunks (the plan picks the fewest round trips).

* :func:`ca_attention` is the wrapper. A CUDA tensor launches the kernel
  or raises; only CPU tensors take the plain version. Every launch adds
  one to :data:`launches`.
* :func:`ca_attention_ref` is the plain PyTorch version, line for line
  the Pallas ``_kernel``. The CPU path and the tests use it.
* The gradient is a :class:`torch.autograd.Function` whose backward is
  autograd of ``cross_attention_slim``, as the JAX kernel's custom VJP
  is JAX AD of the same function; ``wq_h`` gets an exact zero.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.agents.attention import cross_attention_slim

# kernel launches since the last reset (a caller sets it to 0 to count a run)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build

        lib = _build.load("ca_attention")
        lib.ca_attention_launch.restype = ctypes.c_int
        lib.ca_attention_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
        lib.ca_attention_plan.restype = ctypes.c_int
        lib.ca_attention_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ca_attention_floor_launch.restype = ctypes.c_int
        lib.ca_attention_floor_launch.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def plan(dtype, obs_dim, pair_dim, i, c):
    """The kernel's plan for a shape: ``{"smem": bytes of dynamic shared
    memory, "wrows": weight rows per streamed chunk (>= the larger of
    obs_dim and pair_dim: every matrix whole), "ichunk": history pairs
    staged at a time, "stages": weight stages}``. Raises ``ValueError``
    where no plan fits (the f32 work arrays of a CTA's rows alone exceed
    shared memory)."""
    info = (ctypes.c_int * 4)()
    if not _library().ca_attention_plan(_DTYPE_CODE[dtype], obs_dim, pair_dim,
                                        i, c, info):
        raise ValueError(
            f"ca_attention kernel: no plan fits shared memory for obs_dim "
            f"{obs_dim}, pair_dim {pair_dim}, I {i}, C {c}")
    return dict(zip(("smem", "wrows", "ichunk", "stages"), info))


def launch_floor(stream=None):
    """Launch one empty kernel of the same library on the current stream:
    the floor any launch pays, for timing beside the kernel. Not counted."""
    stream = stream or torch.cuda.current_stream().cuda_stream
    err = _library().ca_attention_floor_launch(stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")


def ca_attention_ref(obs, history, hist_mask, wq_s, wk, wv):
    """Plain PyTorch version of the kernel (mirrors the Pallas ``_kernel``):
    f32 scores/softmax, ``finfo(f32).min`` masking, zeros for rows with no
    valid history, output ``[obs, s']`` in ``obs.dtype``."""
    blk, i, pair_dim = history.shape
    f32 = torch.float32
    q = obs.to(f32) @ wq_s.to(f32)
    h2 = history.reshape(blk * i, pair_dim).to(f32)
    k = (h2 @ wk.to(f32)).reshape(blk, i, -1)
    v = (h2 @ wv.to(f32)).reshape(blk, i, -1)
    scale = 1.0 / math.sqrt(wk.shape[-1])
    s = (q[:, None, :] * k).sum(-1) * scale
    valid = hist_mask > 0
    s = torch.where(valid, s, torch.finfo(f32).min)
    s = s - s.max(-1, keepdim=True).values
    e = torch.exp(s)
    w = e / e.sum(-1, keepdim=True)
    att = (w[:, :, None] * v).sum(1)
    att = torch.where(valid.any(-1, keepdim=True), att, 0.0)
    return torch.cat([obs, att.to(obs.dtype)], dim=-1)


def _check(obs, history, hist_mask, wq_s, wk, wv):
    if obs.dim() != 2 or history.dim() != 3 or hist_mask.dim() != 2:
        raise ValueError("ca_attention takes obs (B, obs_dim), history "
                         "(B, I, pair_dim) and hist_mask (B, I)")
    b, obs_dim = obs.shape
    _, i, pair_dim = history.shape
    c = wk.shape[-1]
    if (history.shape[0] != b or tuple(hist_mask.shape) != (b, i)
            or tuple(wq_s.shape) != (obs_dim, c)
            or tuple(wk.shape) != (pair_dim, c)
            or tuple(wv.shape) != (pair_dim, c)):
        raise ValueError(
            f"ca_attention shapes disagree: obs {tuple(obs.shape)}, history "
            f"{tuple(history.shape)}, mask {tuple(hist_mask.shape)}, wq_s "
            f"{tuple(wq_s.shape)}, wk {tuple(wk.shape)}, wv {tuple(wv.shape)}")
    return b, obs_dim, pair_dim, i, c


def _launch(obs, history, hist_mask, wq_s, wk, wv):
    """Launch the CUDA kernel on the current stream (no fallback)."""
    global launches
    b, obs_dim, pair_dim, i, c = _check(obs, history, hist_mask, wq_s, wk, wv)
    tensors = (obs, history, hist_mask, wq_s, wk, wv)
    dev = obs.device
    if obs.dtype not in _DTYPE_CODE:
        raise TypeError(f"ca_attention kernel takes f32/f16/bf16, got {obs.dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != obs.dtype:
            raise TypeError("ca_attention kernel needs every input on "
                            f"{dev} in {obs.dtype}; got {t.device} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("ca_attention kernel needs contiguous inputs")
    if b == 0:
        return torch.cat([obs, obs.new_zeros((0, c))], dim=-1)
    plan(obs.dtype, obs_dim, pair_dim, i, c)  # raises where none fits
    lib = _library()
    out = torch.empty((b, obs_dim + c), dtype=obs.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ca_attention_launch(
            _DTYPE_CODE[obs.dtype], obs.data_ptr(), history.data_ptr(),
            hist_mask.data_ptr(), wq_s.data_ptr(), wk.data_ptr(),
            wv.data_ptr(), out.data_ptr(), b, obs_dim, pair_dim, i, c,
            1.0 / math.sqrt(c), stream)
    if err != 0:
        raise RuntimeError(f"ca_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out


def _forward(obs, history, hist_mask, wq_s, wk, wv):
    if obs.device.type == "cuda":
        return _launch(obs, history, hist_mask, wq_s, wk, wv)
    if obs.device.type == "cpu":
        _check(obs, history, hist_mask, wq_s, wk, wv)
        return ca_attention_ref(obs, history, hist_mask, wq_s, wk, wv)
    raise TypeError(f"ca_attention runs on cuda or cpu tensors, got {obs.device}")


class _CAFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, obs, history, hist_mask, wq_s, wq_h, wk, wv):
        ctx.save_for_backward(obs, history, hist_mask, wq_s, wq_h, wk, wv)
        return _forward(obs, history, hist_mask, wq_s, wk, wv)

    @staticmethod
    def backward(ctx, g):
        obs, history, hist_mask, wq_s, wq_h, wk, wv = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            o, h, pq, pk, pv = (t.detach().requires_grad_(need[j])
                                for j, t in ((0, obs), (1, history), (3, wq_s),
                                             (5, wk), (6, wv)))
            out = cross_attention_slim({"wq_s": pq, "wk": pk, "wv": pv},
                                       o, h, hist_mask)
            leaves = [t for t in (o, h, pq, pk, pv) if t.requires_grad]
            it = iter(torch.autograd.grad(out, leaves, g) if leaves else ())
        go, gh, gq, gk, gv = (next(it) if t.requires_grad else None
                              for t in (o, h, pq, pk, pv))
        gqh = torch.zeros_like(wq_h) if need[4] else None
        return go, gh, None, gq, gqh, gk, gv


def ca_attention(params, obs, history, hist_mask):
    """Fused masked history cross-attention (batched call sites).

    ``params``: the ``init_cross_attention`` dict (``wq_h`` is unused: only
    the current-state query row survives to the output). ``obs``
    (B, obs_dim), ``history`` (B, I, pair_dim) newest-last, ``hist_mask``
    (B, I) with 1 = valid pair, all in one dtype (f32, f16 or bf16).
    Returns ``(B, obs_dim + C)``, matching ``cross_attention``'s output.
    Differentiable: the backward pass is autograd of the slim reference.
    """
    return _CAFunction.apply(obs, history, hist_mask, params["wq_s"],
                             params["wq_h"], params["wk"], params["wv"])
