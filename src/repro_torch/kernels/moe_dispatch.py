"""Grouped expert FFN of the dropless MoE dispatch.

Replaces the Pallas TPU kernel ``repro/kernels/moe_dispatch.py``
(``_kernel_gated`` / ``_kernel_plain``, launched by ``_forward``'s
``pallas_call``) with a CUDA C++ kernel for Hopper,
``csrc/grouped_moe_ffn.cu``, built with ``nvcc`` for ``sm_90a`` at first
use and bound with :mod:`ctypes`.

``models.layers.moe_apply_dropless`` sorts the routed (token, choice)
rows by expert and pads every expert's rows to whole blocks of ``blk``
rows; ``block_eid`` names each block's expert. The kernel runs the
expert FFN over that buffer with the Pallas body's rounding points: the
weights rounded to the activation dtype per element, the gate/up products
summed in f32 and rounded before the activation, its result rounded, the
down product summed in f32 and rounded on store. The Pallas body takes
the activation in the activation dtype (one rounding per operation); the
kernel takes it in f32 on the rounded operands and rounds once. What
bounds the call on an H100 and how the design follows is written at the
top of the CUDA source.

* :func:`grouped_moe_ffn` is the wrapper. A CUDA tensor launches the
  kernel or raises; only CPU tensors take the plain version. Every
  launch adds one to :data:`launches` (one launch = one call, two GEMM
  grids on the current stream: up + activation, down).
* The row dtype fixes the kernel body (:func:`body`), with no option and
  no fallback between them: f16 and bf16 take ``"wgmma"``, the
  tensor-core body (TMA-fed ``wgmma`` GEMMs over 128-row tiles of one
  expert each, cut on the card by :func:`device_tile_schedule`, whose plain
  version is :func:`tile_schedule`); a tile whose rows are all zero (the
  trailing padding blocks) reads nothing and writes zeros; f32 takes
  ``"fma"``, the f32 FMA body (row tiles of 64/32/8 rows,
  :func:`row_tile`). The tensor-core body needs ``block_eid``
  non-decreasing, as ``dropless_layout`` makes it, and tensors TMA can
  take (:func:`repro_torch.kernels._tma.check_tma`).
* :func:`grouped_ffn_reference` is the plain PyTorch version (the JAX
  package's function of the same name): the CPU path, the
  ``impl="reference"`` route of the dropless dispatch, and the backward.
* The gradient is a :class:`torch.autograd.Function` whose backward is
  autograd of :func:`grouped_ffn_reference`, as the JAX kernel's custom
  VJP is JAX AD of it. No backward kernel: JAX has none.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._tma import check_tma
from repro_torch.models.layers import expert_ffn

# kernel launches since the last reset (a caller sets it to 0 to count a run)
launches = 0

ACTIVATIONS = ("swiglu", "gelu", "relu2", "silu")
_ACT_CODE = {name: i for i, name in enumerate(ACTIVATIONS)}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# the FMA body's row tiles; a tile must not straddle two expert blocks
ROW_TILES = (64, 32, 8)
# rows of one CTA tile of the tensor-core body, and the most experts its
# schedule takes; csrc/grouped_moe_ffn.cu tc::kBM, tc::kMaxExperts
TC_ROWS = 128
MAX_EXPERTS = 2048

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build

        lib = _build.load("grouped_moe_ffn")
        lib.grouped_moe_ffn_fma.restype = ctypes.c_int
        lib.grouped_moe_ffn_fma.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.grouped_moe_ffn_wgmma.restype = ctypes.c_int
        lib.grouped_moe_ffn_wgmma.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.grouped_moe_ffn_schedule.restype = ctypes.c_int
        lib.grouped_moe_ffn_schedule.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        lib.grouped_moe_ffn_wgmma_smem.restype = ctypes.c_int
        lib.grouped_moe_ffn_wgmma_smem.argtypes = [ctypes.c_int] * 2
        _lib = lib
    return _lib


def body(dtype) -> str:
    """The kernel body that rows of ``dtype`` take: ``"wgmma"`` (tensor
    cores) for f16 and bf16, ``"fma"`` (f32 FMA units) for f32."""
    if dtype in (torch.float16, torch.bfloat16):
        return "wgmma"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"grouped_moe_ffn kernel takes f32/f16/bf16 rows, got {dtype}")


def max_tiles(rows: int, blk: int, num_experts: int) -> int:
    """A static bound on the number of :data:`TC_ROWS`-row tiles that
    cutting each expert's row range of a ``rows``-row buffer of ``blk``-row
    blocks can give: ``sum_e ceil(rows_e / 128) <= rows // 128 + (experts
    with rows)``, and when ``blk <= 128`` no more tiles than blocks."""
    nb = rows // blk
    bound = rows // TC_ROWS + min(nb, num_experts)
    return min(bound, nb) if blk <= TC_ROWS else bound


def tile_schedule(buf, block_eid, blk: int, num_experts: int):
    """The tensor-core body's row tiles, plain version of the two grids
    that compute them on the card (:func:`device_tile_schedule`):
    ``(max_tiles, 4)`` int32 rows ``(expert, first row, end row of the
    expert's range, live)``, tile ``t`` of an expert covering rows
    ``[first, min(first + 128, end))``.

    ``block_eid`` must be non-decreasing (``dropless_layout`` makes it so),
    so that each expert's blocks are contiguous; its range is cut into
    128-row tiles, in expert order. ``live`` is 0 for a tile whose rows of
    ``buf`` are all zero (the kernel then reads nothing and writes zeros:
    FFN(0) = 0 for every activation; a NaN row counts as live), else 1.
    Tiles past the last one are ``(E - 1, rows, rows, 0)``: the kernel
    skips them."""
    nb = block_eid.shape[0]
    dev = block_eid.device
    eid = block_eid.long()
    rows_e = torch.zeros(num_experts, dtype=torch.long, device=dev).index_add_(
        0, eid, torch.full_like(eid, blk))
    end_e = torch.cumsum(rows_e, 0)
    tiles_e = (rows_e + TC_ROWS - 1) // TC_ROWS
    tend_e = torch.cumsum(tiles_e, 0)
    # first row of tile t of expert e = start_e + (t - first tile of e) * 128
    base_e = end_e - rows_e - (tend_e - tiles_e) * TC_ROWS
    t = torch.arange(max_tiles(nb * blk, blk, num_experts), device=dev)
    owner = torch.searchsorted(tend_e, t, right=True).clamp_(max=num_experts - 1)
    end = end_e[owner]
    first = torch.where(t < tend_e[-1], base_e[owner] + t * TC_ROWS, end)
    # non-zero rows counted by a prefix sum
    nz = torch.linalg.vector_norm(buf, ord=float("inf"), dim=1) != 0
    cs = torch.nn.functional.pad(torch.cumsum(nz, 0), (1, 0))
    live = (cs[torch.minimum(first + TC_ROWS, end)] - cs[first]) > 0
    return torch.stack([owner, first, end, live.long()], 1).to(torch.int32)


def device_tile_schedule(buf, block_eid, blk: int, num_experts: int):
    """:func:`tile_schedule` of 16-bit CUDA rows ``buf``, computed on the
    card by the kernel library's two schedule grids (one block for the
    ranges, one block per tile for ``live``), on the current stream with no
    host sync."""
    nb = block_eid.shape[0]
    sched = torch.empty((max_tiles(nb * blk, blk, num_experts), 4),
                        dtype=torch.int32, device=buf.device)
    with torch.cuda.device(buf.device):
        err = _library().grouped_moe_ffn_schedule(
            block_eid.data_ptr(), nb, blk, num_experts, buf.data_ptr(),
            buf.shape[1], sched.data_ptr(), sched.shape[0],
            torch.cuda.current_stream(buf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_moe_ffn schedule launch failed: cudaError {err}")
    return sched


def grouped_ffn_reference(buf, block_eid, w_gate, w_up, w_down,
                          activation: str):
    """Expert FFN over a block-padded expert-sorted buffer, plain PyTorch.

    ``buf`` (P, D): rows ``[i*blk, (i+1)*blk)`` belong to expert
    ``block_eid[i]``; weights are the ``init_moe`` stacks (``w_gate`` None
    without a gate). Each block's expert weights are gathered (rounded to
    ``buf``'s dtype), the products summed in f32 and rounded back, the
    activation taken in ``buf``'s dtype. Returns (P, D)."""
    nb = block_eid.shape[0]
    p, d = buf.shape
    dt = buf.dtype
    idx = block_eid.long()

    def gather(w):
        return None if w is None else w.to(dt)[idx]

    out = expert_ffn(buf.reshape(nb, p // nb, d),
                     gather(w_gate) if activation == "swiglu" else None,
                     gather(w_up), gather(w_down), activation)
    return out.reshape(p, d)


def row_tile(blk: int) -> int:
    """The FMA body's row tile for blocks of ``blk`` rows: the largest of
    :data:`ROW_TILES` that divides it."""
    for bm in ROW_TILES:
        if blk % bm == 0:
            return bm
    raise ValueError(f"grouped_moe_ffn kernel takes blocks of a multiple of "
                     f"8 rows, got {blk}")


def _check(buf, block_eid, w_gate, w_up, w_down, activation):
    if activation not in _ACT_CODE:
        raise ValueError(f"unknown activation {activation!r}; have {ACTIVATIONS}")
    if buf.dim() != 2 or block_eid.dim() != 1 or block_eid.shape[0] == 0:
        raise ValueError(f"grouped_moe_ffn takes buf (P, D) and block_eid "
                         f"(n_blocks,), got {tuple(buf.shape)}, "
                         f"{tuple(block_eid.shape)}")
    p, d = buf.shape
    nb = block_eid.shape[0]
    if p % nb:
        raise ValueError(f"{p} rows do not split into {nb} blocks")
    e, _, f = w_up.shape
    gated = activation == "swiglu"
    if gated != (w_gate is not None):
        raise ValueError(f"{activation} needs w_gate iff gated")
    ok = (tuple(w_up.shape) == (e, d, f) and tuple(w_down.shape) == (e, f, d)
          and (not gated or tuple(w_gate.shape) == (e, d, f)))
    if not ok:
        raise ValueError(
            f"grouped_moe_ffn shapes disagree: buf {tuple(buf.shape)}, w_up "
            f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)}, w_gate "
            f"{None if w_gate is None else tuple(w_gate.shape)}")
    return p, d, f, p // nb


def _launch(buf, block_eid, w_gate, w_up, w_down, activation):
    """Launch the CUDA kernel on the current stream (no fallback).
    ``block_eid`` must hold expert ids in ``[0, E)``, non-decreasing, as
    the dropless layout makes them (checking would stall the stream)."""
    global launches
    p, d, f, blk = _check(buf, block_eid, w_gate, w_up, w_down, activation)
    route = body(buf.dtype)
    bm = row_tile(blk)  # the tensor-core body takes the same blk (multiples of 8)
    weights = [w for w in (w_gate, w_up, w_down) if w is not None]
    dev = buf.device
    wdt = w_up.dtype
    if wdt not in (torch.float32, buf.dtype):
        raise TypeError(f"grouped_moe_ffn kernel takes f32 weights or weights "
                        f"in the rows' dtype {buf.dtype}, got {wdt}")
    for t in weights:
        if t.device != dev or t.dtype != wdt:
            raise TypeError("grouped_moe_ffn kernel needs the weights on "
                            f"{dev} in one dtype; got {t.device} {t.dtype}")
    if block_eid.device != dev or block_eid.dtype != torch.int32:
        raise TypeError(f"block_eid must be int32 on {dev}, got "
                        f"{block_eid.dtype} on {block_eid.device}")
    for t in [buf, block_eid] + weights:
        if not t.is_contiguous():
            raise ValueError("grouped_moe_ffn kernel needs contiguous inputs")
    out = torch.empty_like(buf)
    if d == 0 or f == 0:
        return out.zero_()
    h = torch.empty((p, f), dtype=buf.dtype, device=dev)
    gate = None if w_gate is None else w_gate.data_ptr()
    lib = _library()
    if route == "wgmma":
        # every tensor a tensor map reads: buf and h (rows of D and F in
        # the rows' dtype), the weights (rows of F and D in their own)
        xs, ws = buf.element_size(), w_up.element_size()
        check_tma("grouped_moe_ffn buf", buf.data_ptr(), [d * xs])
        check_tma("grouped_moe_ffn h", h.data_ptr(), [f * xs])
        for name, w, cols in (("w_gate", w_gate, f), ("w_up", w_up, f),
                              ("w_down", w_down, d)):
            if w is not None:
                check_tma(f"grouped_moe_ffn {name}", w.data_ptr(),
                          [cols * ws, w[0].numel() * ws])
        experts = w_up.shape[0]
        if experts > MAX_EXPERTS or max_tiles(p, blk, experts) > 65535:
            raise ValueError(f"grouped_moe_ffn kernel takes at most {MAX_EXPERTS} "
                             f"experts and 65535 row tiles; got {experts} experts, "
                             f"{p} rows")
        sched = device_tile_schedule(buf, block_eid, blk, experts)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma":
            err = lib.grouped_moe_ffn_wgmma(
                _DTYPE_CODE[buf.dtype], _DTYPE_CODE[wdt], _ACT_CODE[activation],
                buf.data_ptr(), sched.data_ptr(), sched.shape[0], gate,
                w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(), out.data_ptr(),
                p, d, f, experts, stream)
        else:
            err = lib.grouped_moe_ffn_fma(
                _ACT_CODE[activation], bm, buf.data_ptr(), block_eid.data_ptr(),
                gate, w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
                out.data_ptr(), p, blk, d, f, stream)
    if err != 0:
        raise RuntimeError(f"grouped_moe_ffn kernel launch failed: cudaError {err}")
    launches += 1
    return out


def _forward(buf, block_eid, w_gate, w_up, w_down, activation):
    if buf.device.type == "cuda":
        return _launch(buf, block_eid, w_gate, w_up, w_down, activation)
    if buf.device.type == "cpu":
        _check(buf, block_eid, w_gate, w_up, w_down, activation)
        return grouped_ffn_reference(buf, block_eid, w_gate, w_up, w_down,
                                     activation)
    raise TypeError(f"grouped_moe_ffn runs on cuda or cpu tensors, got "
                    f"{buf.device}")


class _GroupedFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, block_eid, w_gate, w_up, w_down, activation):
        ctx.save_for_backward(buf, block_eid, w_gate, w_up, w_down)
        ctx.activation = activation
        return _forward(buf, block_eid, w_gate, w_up, w_down, activation)

    @staticmethod
    def backward(ctx, g):
        buf, block_eid, w_gate, w_up, w_down = ctx.saved_tensors
        need = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[2:5]
        with torch.enable_grad():
            xs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip((buf, w_gate, w_up, w_down), need)]
            out = grouped_ffn_reference(xs[0], block_eid, *xs[1:],
                                        ctx.activation)
            leaves = [t for t in xs if t is not None and t.requires_grad]
            it = iter(torch.autograd.grad(out, leaves, g) if leaves else ())
        db, dwg, dwu, dwd = [next(it) if t is not None and t.requires_grad
                             else None for t in xs]
        return db, None, dwg, dwu, dwd, None


def grouped_moe_ffn(buf, block_eid, params, *, activation: str):
    """Fused grouped expert FFN over a block-padded sorted buffer.

    ``params`` is the ``models.layers.init_moe`` dict; ``buf`` (P, D) is
    f32, f16 or bf16, the weights f32 or ``buf``'s dtype; ``block_eid``
    (P / blk,) int32, non-decreasing, with ``blk`` a multiple of 8 on the
    card. Forward runs the hand-written kernel (on CUDA tensors f16/bf16
    rows take the tensor-core body and f32 the FMA body, :func:`body`);
    backward is autograd of :func:`grouped_ffn_reference`. Without a gate
    no placeholder is passed, so ``w_up`` gets its gradient once."""
    w_gate = params.get("w_gate") if activation == "swiglu" else None
    return _GroupedFunction.apply(buf, block_eid, w_gate, params["w_up"],
                                  params["w_down"], activation)
