"""Minimal pytree helpers over nested dicts, lists, tuples and NamedTuples.

Parameters, optimizer states and replay batches are plain nested
containers of tensors, as in the JAX package, so that carrying weights
across the two is a copy. ``None`` and empty containers are structure,
not leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over ``tree`` and structurally equal ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of ``tree`` in the order :func:`tree_map` visits them."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """Rebuild ``tree``'s structure with ``leaves`` (in :func:`tree_leaves`
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
