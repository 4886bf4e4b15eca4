"""AdamW as the JAX package writes it (``repro.optim.optimizers``).

Not ``torch.optim.AdamW``: the defaults differ (``b2=0.95`` here) and the
update is the same (init, update) pair over parameter trees, so the two
frameworks take the same steps from the same state::

    opt = adamw(lr=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Functional, like the reference: every call returns new tensors. On a
mesh, ``update(grads, state, params, shardings=)`` takes trees of this
rank's blocks (``distribution.sharding.param_shardings``) and clips by
the global norm of the whole tree, summed over the mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any = None
    nu: Any = None


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32. ``shardings``:
    ``tree`` holds this rank's blocks, and the norm is the whole tree's
    (``distribution.sharding.global_norm``)."""
    if shardings is not None:
        from repro_torch.distribution.sharding import global_norm as mesh_norm

        return mesh_norm(tree, shardings)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _clip_scale(tree, max_norm: float, shardings=None, norm=None):
    """``(scale, norm)``: the factor that brings ``tree``'s global norm
    (``norm`` where the caller has it) to at most ``max_norm``, and that
    norm."""
    if norm is None:
        norm = global_norm(tree, shardings)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(tree, max_norm: float):
    """Scale ``tree`` so its global norm is at most ``max_norm``; returns
    ``(clipped, norm)``."""
    scale, norm = _clip_scale(tree, max_norm)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def lr(step):
        frac = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return base_lr * (final_frac + (1 - final_frac) * cos)

    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def lr(step):
        w = torch.clamp(step / max(warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, base_lr * w, cos(step - warmup))

    return lr


def adamw(
    lr: Union[float, Callable] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = None,
    state_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """``lr`` is a number or a function of the (int32 tensor) step, as
    :func:`cosine_schedule` returns; ``max_grad_norm`` clips the gradients
    by their global norm before the moments see them (``update``'s
    ``grad_norm``: that norm, where the caller has computed it)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        leaf = tree_leaves(params)[0]
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=tree_map(lambda x: torch.zeros_like(x, dtype=state_dtype), params),
            nu=tree_map(lambda x: torch.zeros_like(x, dtype=state_dtype), params),
        )

    def update(grads, state: OptState, params=None, shardings=None,
               grad_norm=None):
        scale = None
        if max_grad_norm is not None:  # clip_by_global_norm, leaf by leaf below
            scale, _ = _clip_scale(grads, max_grad_norm, shardings, grad_norm)
        step = state.step + 1
        stepf = step.float()
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        lr_t = lr_fn(step)

        def one(g, m, v, p):
            # leaf by leaf, so that only one leaf's clipped gradient and
            # temporaries exist at a time beside the new trees; the
            # in-place steps round as b1*m + (1-b1)*g, b2*v + (1-b2)*g^2 and
            # -(lr * (m/bc1) / (sqrt(v/bc2) + eps)) do
            if scale is not None:
                g = g * scale.to(g.dtype)
            m = (b1 * m).add_((1 - b1) * g.to(m.dtype))
            v = (b2 * v).add_(torch.square(g.to(v.dtype)).mul_(1 - b2))
            u = (m / bc1).mul_(lr_t).div_(torch.sqrt(v / bc2).add_(eps)).neg_()
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(u.dtype)
            return m, v, u.to(p.dtype)

        out = [one(*xs) for xs in zip(tree_leaves(grads), tree_leaves(state.mu),
                                      tree_leaves(state.nu), tree_leaves(params))]
        mu, nu, updates = (tree_unflatten(grads, list(col)) for col in zip(*out))
        return updates, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def sgd_momentum(lr: Union[float, Callable] = 1e-2,
                 momentum: float = 0.9) -> Optimizer:
    """SGD with heavy-ball momentum: ``mu = momentum mu + g``, update
    ``-lr(step) mu``; ``lr`` as :func:`adamw` takes it."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        leaf = tree_leaves(params)[0]
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=tree_map(torch.zeros_like, params))

    def update(grads, state: OptState, params=None, shardings=None,
               grad_norm=None):
        step = state.step + 1  # no clip: blocks update as they are
        mu = tree_map(lambda m, g: momentum * m + g.to(m.dtype), state.mu, grads)
        lr_t = lr_fn(step)
        updates = tree_map(lambda m, p: (-lr_t * m).to(p.dtype), mu, params)
        return updates, OptState(step=step, mu=mu)

    return Optimizer(init=init, update=update)
