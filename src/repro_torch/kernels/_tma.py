"""What a TMA tensor map can describe, checked on the host.

``cuTensorMapEncodeTiled`` (libcuda) takes a global base address
aligned to 16 bytes and strides (every dimension but the innermost) that
are multiples of 16 bytes. The tensor-core bodies load their tiles by
TMA, so their wrappers check every tensor they hand to a tensor map with
:func:`check_tma` and raise a clear error rather than a refused launch.
"""
from __future__ import annotations

from typing import Sequence

TMA_ALIGN = 16  # bytes


def check_tma(name: str, data_ptr: int, strides_bytes: Sequence[int]) -> None:
    """Raise ``ValueError`` if a tensor at ``data_ptr`` with the given
    outer strides (bytes) cannot be described by a TMA tensor map."""
    if data_ptr % TMA_ALIGN:
        raise ValueError(f"{name}: the tensor-core body loads it by TMA, which "
                         f"needs a {TMA_ALIGN}-byte aligned base; got address "
                         f"{data_ptr:#x}")
    bad = [s for s in strides_bytes if s % TMA_ALIGN]
    if bad:
        raise ValueError(f"{name}: the tensor-core body loads it by TMA, which "
                         f"needs strides that are multiples of {TMA_ALIGN} "
                         f"bytes; got {list(strides_bytes)} bytes")
