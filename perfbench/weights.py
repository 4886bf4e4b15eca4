"""Weights and tokens made from ``--seed``, on the device.

The weights fill a layout of ``(path, shape)`` leaves (the program's
tree, taken from its shapes alone). Each leaf has its own generator,
seeded from the run's seed and the leaf's index, so one leaf can be made
again without the others, and it is drawn in one call in f32, the type
the masters are kept in. The configuration's ``init`` rules pick a
leaf's mean and spread by a pattern on its path.
"""
from __future__ import annotations

import hashlib
import math
import re
from typing import Any, Dict, List, Sequence, Tuple

import torch

Layout = List[Tuple[str, Tuple[int, ...]]]


def sub_seed(seed: int, *tags: Any) -> int:
    """A 63-bit seed for the stream named by ``tags`` under ``seed``."""
    text = ":".join([str(int(seed))] + [str(t) for t in tags]).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def _rule(rules: Sequence[Dict[str, Any]], path: str, shape) -> Tuple[float, float]:
    for r in rules:
        if re.search(r["pattern"], path):
            std = r["std"]
            if std == "fan_in":  # x @ W: the input dimension is the next to last
                std = 1.0 / math.sqrt(shape[-2])
            return float(r.get("mean", 0.0)), float(std)
    raise KeyError(f"no init rule matches leaf {path!r}")


def make_leaf(seed: int, index: int, path: str, shape, rules, device) -> torch.Tensor:
    """Leaf ``index`` (at ``path``) of the tree seeded by ``seed``: f32."""
    mean, std = _rule(rules, path, shape)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "leaf", index))
    x = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    x.mul_(std)
    if mean:
        x.add_(mean)
    return x


def make_params(seed: int, layout: Layout, rules, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``layout``: ``{path: f32 tensor}``."""
    return {path: make_leaf(seed, i, path, shape, rules, device)
            for i, (path, shape) in enumerate(layout)}


SAMPLE = 1 << 16  # elements of a leaf that the gradient's distance reads


def sample_index(seed: int, index: int, numel: int, k: int = SAMPLE) -> torch.Tensor:
    """Positions (CPU, int64) of the elements of leaf ``index`` whose
    values the comparison reads: all of a small leaf, else ``k`` drawn
    from the seed."""
    if numel <= k:
        return torch.arange(numel)
    gen = torch.Generator().manual_seed(sub_seed(seed, "sample", index))
    return torch.randint(0, numel, (k,), generator=gen)


def token_batches(seed: int, vocab: int, rows: int, seq: int, device):
    """An endless stream of ``(tokens, labels)`` batches of ``rows x seq``
    ids drawn uniformly from the vocabulary on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "tokens"))
    while True:
        toks = torch.randint(0, vocab, (rows, seq), generator=gen, device=device)
        labs = torch.randint(0, vocab, (rows, seq), generator=gen, device=device)
        yield toks, labs
