"""Mamba-2 SSD chunk recurrence (forward only), from a zero state.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``_kernel``,
launched by ``ssd_scan``'s ``pallas_call``) with a CUDA C++ kernel for
Hopper, ``csrc/ssd_scan.cu``, built with ``nvcc`` for ``sm_90a`` at first
use and bound with :mod:`ctypes`.

For each chunk of ``L`` steps, with ``da_cum`` the inclusive cumulative
sum of ``dt * a`` inside the chunk, it computes

    y_i = sum_{j<=i} (C_i . B_j) exp(da_cum_i - da_cum_j) dt_j x_j
          + exp(da_cum_i) (C_i . h)
    h  <- exp(da_cum_{L-1}) h + sum_l exp(da_cum_{L-1} - da_cum_l) dt_l x_l B_l^T

and returns ``y`` and the final state ``h`` (f32), as the Pallas body
does. Steps past ``S`` count as ``dt = 0``, ``x = 0`` (the reference's zero
padding). What bounds the call on an H100 and how the design follows is
written at the top of the CUDA source.

* :func:`ssd_scan` is the wrapper. A CUDA tensor launches the kernel or
  raises; only CPU tensors take the plain version. Every launch adds one
  to :data:`launches` (one launch = one call, two grids on the current
  stream: ``C . B^T`` once per batch row and chunk into scratch, then the
  chunk recurrence).
* The scan takes f32 only, so one body serves it (:func:`body`):
  ``"mma"``, every product on the tensor cores as 3xTF32 ``mma.sync``
  (each operand split into two TF32 terms, three products summed in f32),
  which holds the f32 gate that one TF32 product would miss.
* :func:`ssd_scan_ref` is the plain PyTorch version, the Pallas body's
  arithmetic chunk by chunk. The CPU path and the tests use it.
* Any chunk and any ``d_state`` run: :func:`by_state_tiles` maps a call
  onto the kernel's limits (chunk <= 64, N <= 128) by two identities, and
  the CPU tests apply the same rewrite to the plain version.
* There is no backward and no initial state, as the JAX kernel has
  neither: the wrapper raises when a gradient would be required.
"""
from __future__ import annotations

import ctypes

import torch

# kernel launches since the last reset (a caller sets it to 0 to count a run)
launches = 0

# the kernel's tile limits: chunk rows, head_dim columns per block (larger
# head_dim is split over blocks), state width
MAX_CHUNK = 64
P_TILE = 64
MAX_STATE = 128

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build

        lib = _build.load("ssd_scan")
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.ssd_scan_smem.restype = ctypes.c_int
        lib.ssd_scan_smem.argtypes = []
        _lib = lib
    return _lib


def body(dtype) -> str:
    """The kernel body that inputs of ``dtype`` take: ``"mma"`` (3xTF32
    ``mma.sync`` on the tensor cores) for f32, the only dtype the scan
    takes."""
    if dtype == torch.float32:
        return "mma"
    raise TypeError(f"ssd_scan kernel takes f32, got {dtype}")


def ssd_scan_ref(x, dt, a, b, c, *, chunk: int = 64):
    """Plain PyTorch version of the kernel (the Pallas body, batched over
    batch rows and heads): x (B, S, H, P), dt (B, S, H), a (H,), b/c
    (B, S, N) -> ``(y (B, S, H, P) in x's dtype, h_last (B, H, P, N) f32)``."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((bsz, pad, *t.shape[2:]))], dim=1)
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xc, dtc, bc, cc = chunks(x), chunks(dt), chunks(b), chunks(c)
    a = a.float()
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    hs = x.new_zeros((bsz, h, p, n), dtype=torch.float32)
    ys = []
    for z in range(nc):
        xz, dtz, bz, cz = xc[:, z], dtc[:, z], bc[:, z], cc[:, z]
        da_cum = torch.cumsum(dtz * a, dim=1)  # (B, L, H)
        seg = da_cum[:, :, None, :] - da_cum[:, None, :, :]  # (B, i, j, H)
        decay = torch.where(tril[None, :, :, None], torch.exp(seg),
                            torch.zeros((), device=x.device))
        scores = torch.einsum("bin,bjn->bij", cz, bz)[..., None] * decay
        y_diag = torch.einsum("bijh,bjhp->bihp", scores * dtz[:, None, :, :], xz)
        y_off = (torch.einsum("bin,bhpn->bihp", cz, hs)
                 * torch.exp(da_cum)[..., None])
        ys.append(y_diag + y_off)
        w = torch.exp(da_cum[:, -1:, :] - da_cum) * dtz  # (B, L, H)
        upd = torch.einsum("blhp,bln->bhpn", xz * w[..., None], bz)
        hs = hs * torch.exp(da_cum[:, -1, :])[:, :, None, None] + upd
    y = torch.stack(ys, dim=1).reshape(bsz, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), hs


def by_state_tiles(scan, x, dt, a, b, c, *, chunk: int):
    """``scan(x, dt, a, b, c, chunk=...)`` at any chunk and any d_state N,
    through calls within the kernel's limits.

    * Any chunk. The SSD result does not depend on the chunk length:
      chunking is an exact rewrite of the recurrence h_t = exp(dt_t a) h_t-1
      + dt_t x_t B_t^T, y_t = C_t . h_t, and the zero padding of a ragged
      last chunk (dt = 0, x = 0) changes neither y nor h_last. So a chunk
      above MAX_CHUNK runs at MAX_CHUNK; only the rounding differs.
    * Any N. y_t = sum_n C_tn h_t[:, n] is a sum over the state's columns,
      and each column of h evolves on its own (C . B^T is a sum over n and
      the decays multiply it elementwise). So N splits into tiles of at
      most MAX_STATE columns: y is the sum of the tiles' y, h_last the
      concatenation of their h_last.
    """
    chunk = min(chunk, MAX_CHUNK)
    n = b.shape[-1]
    if n <= MAX_STATE:
        return scan(x, dt, a, b, c, chunk=chunk)
    y, hs = None, []
    for n0 in range(0, n, MAX_STATE):
        cols = slice(n0, min(n, n0 + MAX_STATE))
        y_t, h_t = scan(x, dt, a, b[..., cols].contiguous(), c[..., cols].contiguous(),
                        chunk=chunk)
        y = y_t if y is None else y + y_t
        hs.append(h_t)
    return y, torch.cat(hs, dim=-1)


def _check(x, dt, a, b, c, chunk):
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 3:
        raise ValueError("ssd_scan takes x (B, S, H, P), dt (B, S, H), a (H,), "
                         "b and c (B, S, N)")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or tuple(b.shape) != (bsz, s, n) or tuple(c.shape) != (bsz, s, n)):
        raise ValueError(
            f"ssd_scan shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def _launch(x, dt, a, b, c, *, chunk):
    """Launch the CUDA kernel on the current stream (no fallback), at
    chunk <= MAX_CHUNK and N <= MAX_STATE (see :func:`by_state_tiles`)."""
    global launches
    _check(x, dt, a, b, c, chunk)
    dev = x.device
    for t in (x, dt, a, b, c):
        body(t.dtype)
        if t.device != dev:
            raise TypeError(f"ssd_scan kernel takes f32 tensors on {dev}; got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("ssd_scan kernel needs contiguous inputs")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty_like(x)
    h_last = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    if y.numel() == 0 or h_last.numel() == 0:
        return y, h_last.zero_()
    # C . B^T of every (batch row, chunk), in the kernel's 64 x 64 tiles
    cb = torch.empty((bsz, -(-s // chunk), MAX_CHUNK, MAX_CHUNK),
                     dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_launch(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                                  b.data_ptr(), c.data_ptr(), cb.data_ptr(),
                                  y.data_ptr(), h_last.data_ptr(), bsz, s, h,
                                  p, n, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    launches += 1
    return y, h_last


def ssd_scan(x, dt, a, b, c, *, chunk: int = 64):
    """SSD chunk scan from a zero state: x (B, S, H, P), dt (B, S, H),
    a (H,), b/c (B, S, N), f32 on the card. Returns ``(y, h_last)``.
    Raises if a gradient would be required (the JAX kernel has no VJP)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b, c)):
        raise RuntimeError("ssd_scan has no backward (as the JAX kernel has no "
                           "VJP); call it under torch.no_grad() or use "
                           "ssd_chunked for training")
    if x.device.type == "cuda":
        _check(x, dt, a, b, c, chunk)
        return by_state_tiles(_launch, x, dt, a, b, c, chunk=chunk)
    if x.device.type == "cpu":
        _check(x, dt, a, b, c, chunk)
        return ssd_scan_ref(x, dt, a, b, c, chunk=chunk)
    raise TypeError(f"ssd_scan runs on cuda or cpu tensors, got {x.device}")
