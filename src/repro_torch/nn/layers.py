"""Tiny NN library for the RL networks, PyTorch port of ``repro.nn.layers``.

Params are nested dicts of tensors with JAX's layout (``x @ w + b``, ``w``
of shape ``(d_in, d_out)``), so weights carry across as a copy. Init draws
come from an explicit CPU ``torch.Generator`` and are then moved to
``device`` (``cuda`` by default, see :mod:`repro_torch.device`): the
same seed gives the same weights on every device.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device


def init_normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32) * scale).to(device)


def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, device: DeviceLike = None):
    device = resolve_device(device)
    scale = scale if scale is not None else math.sqrt(2.0 / d_in)
    return {
        "w": init_normal(gen, (d_in, d_out), scale, device),
        "b": torch.zeros((d_out,), dtype=torch.float32, device=device),
    }


def dense_apply(p, x):
    return x @ p["w"] + p["b"]


def init_layernorm(d: int, device: DeviceLike = None):
    device = resolve_device(device)
    return {"g": torch.ones((d,), device=device),
            "b": torch.zeros((d,), device=device)}


def layernorm_apply(p, x, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["g"] + p["b"]


def init_mlp(gen: torch.Generator, dims: Sequence[int],
             device: DeviceLike = None):
    device = resolve_device(device)
    return {"layers": [init_dense(gen, a, b, device=device)
                       for a, b in zip(dims[:-1], dims[1:])]}


def mlp_apply(p, x, act=F.relu, final_act=None):
    n = len(p["layers"])
    for i, lp in enumerate(p["layers"]):
        x = dense_apply(lp, x)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def init_residual_mlp(gen: torch.Generator, d_in: int, d_hidden: int,
                      n_blocks: int, d_out: int, device: DeviceLike = None):
    """MLP with residual blocks (paper's ICM feature extractor)."""
    device = resolve_device(device)
    blocks = [
        {
            "fc1": init_dense(gen, d_hidden, d_hidden, device=device),
            "fc2": init_dense(gen, d_hidden, d_hidden, device=device),
            "ln": init_layernorm(d_hidden, device=device),
        }
        for _ in range(n_blocks)
    ]
    return {
        "inp": init_dense(gen, d_in, d_hidden, device=device),
        "blocks": blocks,
        "out": init_dense(gen, d_hidden, d_out, device=device),
    }


def residual_mlp_apply(p, x, final_act=None):
    h = F.relu(dense_apply(p["inp"], x))
    for b in p["blocks"]:
        r = F.relu(dense_apply(b["fc1"], layernorm_apply(b["ln"], h)))
        h = h + dense_apply(b["fc2"], r)
    out = dense_apply(p["out"], h)
    return final_act(out) if final_act is not None else out


def init_gru(gen: torch.Generator, d_in: int, d_hidden: int,
             device: DeviceLike = None):
    device = resolve_device(device)
    s = math.sqrt(1.0 / d_hidden)
    return {
        "wi": init_normal(gen, (d_in, 3 * d_hidden), s, device),
        "wh": init_normal(gen, (d_hidden, 3 * d_hidden), s, device),
        "b": torch.zeros((3 * d_hidden,), device=device),
    }


def gru_apply(p, h, x):
    """Standard GRU cell. h: (..., H), x: (..., D) -> new h."""
    gi = x @ p["wi"] + p["b"]
    gh = h @ p["wh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h
