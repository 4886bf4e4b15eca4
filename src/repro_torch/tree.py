"""Minimal pytree helpers over nested dicts, lists, tuples and NamedTuples,
and the tree-shaped gradient that ``jax.value_and_grad`` gives.

Parameters, optimizer states and replay batches are plain nested
containers of tensors, as in the JAX package, so that carrying weights
across the two is a copy. ``None`` and empty containers are structure,
not leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


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


def tree_leaves_with_path(tree: Any, path: Tuple[str, ...] = ()) -> List:
    """``[(path, leaf)]`` in :func:`tree_leaves` order: a dict key or a
    list/tuple index as written, a NamedTuple field as ``.field``, as
    ``jax.tree_util`` key paths print."""
    if isinstance(tree, dict):
        return [x for k in tree
                for x in tree_leaves_with_path(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [x for f, v in zip(tree._fields, tree)
                for x in tree_leaves_with_path(v, path + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_with_path(v, path + (str(i),))]
    if tree is None:
        return []
    return [(path, tree)]


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


def value_and_grad(fn: Callable, tree: Any):
    """``(value, aux, grads)`` of ``fn(tree) -> loss`` or ``(loss, aux)``,
    as ``jax.value_and_grad`` gives them: ``grads`` has ``tree``'s
    structure, and a leaf the loss does not touch gets an exact zero.
    ``value`` and ``aux`` come back detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
    out = fn(tree_unflatten(tree, leaves))
    loss, aux = out if isinstance(out, tuple) else (out, None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    aux = tree_map(lambda x: x.detach(), aux)
    return loss.detach(), aux, tree_unflatten(tree, grads)


def tree_stack(trees: List[Any]) -> Any:
    """Stack structurally equal trees leafwise along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def tree_index(tree: Any, i: int) -> Any:
    """Slice ``i`` of every leaf's leading axis (undoes :func:`tree_stack`)."""
    return tree_map(lambda x: x[i], tree)
