"""Modality frontend stubs: the projector of precomputed features.

Port of ``repro.models.frontends``. The ViT and codec encoders are not
implemented (as in the reference): the data pipeline supplies
precomputed patch or frame embeddings of the encoder's width, and the
only learned piece is the projector that maps them into ``d_model``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

# feature widths the (stub) encoders would emit
FRONTEND_DIMS = {"vision": 1024, "audio": 128}


def init_frontend(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                  device: DeviceLike = None):
    """``{"proj": (d_in, d_model), "bias": (d_model,)}``, the projector drawn
    from ``gen`` (a generator on ``device``)."""
    d_in = FRONTEND_DIMS[cfg.frontend]
    dev = resolve_device(device)
    return {
        "proj": (torch.randn((d_in, cfg.d_model), generator=gen, device=dev)
                 / math.sqrt(d_in)).to(dtype),
        "bias": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }


def frontend_apply(params, feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, d_in) -> (B, F, d_model), in ``feats``' dtype."""
    return feats @ params["proj"].to(feats.dtype) + params["bias"].to(feats.dtype)
