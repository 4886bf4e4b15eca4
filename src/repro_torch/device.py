"""Device resolution shared by every entry point of the port.

``cuda`` is the default. Asking for ``cuda`` where none is available
raises: there is no silent fallback to the CPU. Tests pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def same_device(a: DeviceLike, b: DeviceLike) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` without an index
    is the current card)."""
    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return norm(a) == norm(b)
