"""Replay buffer on the host (numpy, circular), port of
``repro.core.agents.buffer``.

The trainers use the device ring of ``rollout`` (``buffer_init`` /
``buffer_add`` / ``buffer_gather``); this host buffer is kept, as the
reference keeps it, for parity. ``sample`` draws its indices from a numpy
generator and hands the rows over as tensors on a given device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class ReplayBuffer:
    def __init__(self, capacity: int, example: Dict[str, np.ndarray]):
        self.capacity = capacity
        self.size = 0
        self.ptr = 0
        self.store = {}
        for k, v in example.items():
            if isinstance(v, dict):
                self.store[k] = {
                    kk: np.zeros((capacity,) + np.shape(vv), np.asarray(vv).dtype)
                    for kk, vv in v.items()
                }
            else:
                self.store[k] = np.zeros((capacity,) + np.shape(v),
                                         np.asarray(v).dtype)

    def add(self, item: Dict):
        i = self.ptr
        for k, v in item.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    self.store[k][kk][i] = np.asarray(vv)
            else:
                self.store[k][i] = np.asarray(v)
        self.ptr = (self.ptr + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, rng: np.random.Generator, batch: int,
               device: DeviceLike = None) -> Dict:
        """``batch`` rows drawn uniformly from the filled slots with
        ``rng``, as tensors on ``device`` (``cuda`` by default)."""
        dev = resolve_device(device)
        idx = rng.integers(0, self.size, size=batch)

        def take(v):
            if isinstance(v, dict):
                return {kk: torch.from_numpy(vv[idx]).to(dev)
                        for kk, vv in v.items()}
            return torch.from_numpy(v[idx]).to(dev)

        return {k: take(v) for k, v in self.store.items()}
