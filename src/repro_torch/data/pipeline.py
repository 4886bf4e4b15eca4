"""Synthetic data pipeline: seeded next-token LM batches.

Port of ``repro.data.pipeline``. The pipeline is deterministic and
seeded (no dataset downloads): next-token LM batches plus stub modality
features for the VLM and audio architectures. The draws are numpy's, in
the reference's order, so the port's batches equal the JAX package's
value for value; they are handed over as torch tensors on ``device``.
The reference's ``input_specs`` (``jax.ShapeDtypeStruct`` stand-ins for
XLA dry-runs) has no counterpart here: nothing in the port is lowered
ahead of time.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.frontends import FRONTEND_DIMS


def _frontend_len(cfg: ModelConfig) -> int:
    return cfg.frontend_tokens if cfg.frontend != "none" else 0


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A train batch of ``seq`` positions: ``tokens`` and ``labels`` (the
    tokens shifted by one) of ``seq - F`` text positions, int32, and for a
    frontend config ``frontend`` (B, F, d_in) f32 features, ``F`` the
    config's ``frontend_tokens``."""
    dev = resolve_device(device)
    f = _frontend_len(cfg)
    s_text = seq - f
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, s_text + 1), dtype=np.int32)
    out = {
        "tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
        "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev),
    }
    if f:
        feats = rng.standard_normal((batch, f, FRONTEND_DIMS[cfg.frontend]),
                                    dtype=np.float32)
        out["frontend"] = torch.from_numpy(feats).to(dev)
    return out


def synthetic_stream(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                     device: DeviceLike = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless batches, the ``n``-th drawn from seed ``seed + n``."""
    step = 0
    while True:
        yield synthetic_batch(cfg, batch, seq, seed=seed + step, device=device)
        step += 1
