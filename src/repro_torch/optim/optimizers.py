"""AdamW as the JAX package writes it (``repro.optim.optimizers``).

Not ``torch.optim.AdamW``: the defaults differ (``b2=0.95`` here) and the
update is the same (init, update) pair over parameter trees, so the two
frameworks take the same steps from the same state::

    opt = adamw(lr=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Functional, like the reference: every call returns new tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


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


def adamw(
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        leaf = tree_leaves(params)[0]
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params),
            nu=tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params),
        )

    def update(grads, state: OptState, params=None):
        step = state.step + 1
        stepf = step.float()
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(v.dtype)),
                      state.nu, grads)

        def upd(m, v, p):
            u = -(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
            if weight_decay:
                u = u - lr * weight_decay * p.to(u.dtype)
            return u.to(p.dtype)

        updates = tree_map(upd, mu, nu, params)
        return updates, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)
