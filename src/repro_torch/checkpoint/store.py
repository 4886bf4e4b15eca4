"""Trees of tensors <-> one ``.npz`` archive, the counterpart of
``repro.checkpoint.store``.

The archive layout is the reference's, so that each side reads the
other's archives of the same tree: every leaf is stored under its key path
joined with ``/`` (a dict key or a list/tuple index as written, a
NamedTuple field as ``.field``, as ``jax.tree_util`` key paths print),
and a ``__manifest__`` entry lists the names, bf16 leaves marked
``::bf16`` (numpy has no bf16, so they are stored as f32). Restore takes a
``like`` tree: its structure, shapes and dtypes are checked and kept, and
each leaf lands on the ``like`` leaf's device. On a mesh each rank
restores its blocks from the whole tree's archive (``shardings=``).
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves_with_path as _flatten_with_path
from repro_torch.tree import tree_unflatten


def _key_str(path: Tuple[str, ...]) -> str:
    return "/".join(path)


def save_pytree(tree: Any, path: str) -> None:
    """Write ``tree`` to ``path`` atomically: the archive is written to a
    temp file through an open handle (``np.savez`` would append ``.npz``
    to a bare name) and moved into place with ``os.replace``, so a crash
    mid-save never leaves a torn archive where a checkpoint is expected."""
    arrays = {}
    manifest = []
    for p, leaf in _flatten_with_path(tree):
        k = _key_str(p)
        x = torch.as_tensor(leaf).detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
            manifest.append(k + "::bf16")
        else:
            manifest.append(k)
        arrays[k] = x.numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __manifest__=np.asarray(json.dumps(manifest)), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str, like: Any, shardings: Any = None) -> Any:
    """The tree saved at ``path``, in the structure of ``like``: every name
    and shape is checked, each leaf is cast to the ``like`` leaf's dtype
    and put on its device.

    ``shardings`` (a tree of ``distribution.sharding.Sharding`` records in
    ``like``'s structure): ``like`` holds this rank's blocks; each archive
    leaf must have the global shape of its block, and this rank keeps only
    its block of it."""
    leaves = []
    shs = [None] * len(_flatten_with_path(like)) if shardings is None else \
        [sh for _, sh in _flatten_with_path(shardings)]
    with np.load(path, allow_pickle=False) as z:
        for (p, ref), sh in zip(_flatten_with_path(like), shs):
            k = _key_str(p)
            if k not in z:
                raise KeyError(f"checkpoint {path} missing leaf {k}")
            arr = z[k]
            want = tuple(ref.shape) if sh is None else sh.global_shape(ref.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{k}: shape {arr.shape} != expected {want}")
            if sh is not None:
                arr = arr[sh.index(arr.shape)]
            leaves.append(torch.from_numpy(np.array(arr)).to(ref.device, ref.dtype))
    return tree_unflatten(like, leaves)
