"""Trees of tensors <-> one ``.npz`` archive, the counterpart of
``repro.checkpoint.store``.

The archive layout is the reference's, so that each side reads the
other's archives of the same tree: every leaf is stored under its key path
joined with ``/`` (a dict key or a list/tuple index as written, a
NamedTuple field as ``.field``, as ``jax.tree_util`` key paths print),
and a ``__manifest__`` entry lists the names, bf16 leaves marked
``::bf16`` (numpy has no bf16, so they are stored as f32). Restore takes a
``like`` tree: its structure, shapes and dtypes are checked and kept, and
each leaf lands on the ``like`` leaf's device.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.tree import _is_namedtuple, tree_unflatten


def _flatten_with_path(tree: Any, path: Tuple[str, ...] = ()) -> List:
    """``[(path, leaf)]`` in :func:`repro_torch.tree.tree_leaves` order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _flatten_with_path(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [x for f, v in zip(tree._fields, tree)
                for x in _flatten_with_path(v, path + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_path(v, path + (str(i),))]
    if tree is None:
        return []
    return [(path, tree)]


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


def load_pytree(path: str, like: Any) -> Any:
    """The tree saved at ``path``, in the structure of ``like``: every name
    and shape is checked, each leaf is cast to the ``like`` leaf's dtype
    and put on its device."""
    leaves = []
    with np.load(path, allow_pickle=False) as z:
        for p, ref in _flatten_with_path(like):
            k = _key_str(p)
            if k not in z:
                raise KeyError(f"checkpoint {path} missing leaf {k}")
            arr = z[k]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{k}: shape {arr.shape} != expected "
                                 f"{tuple(ref.shape)}")
            leaves.append(torch.from_numpy(np.array(arr)).to(ref.device, ref.dtype))
    return tree_unflatten(like, leaves)
