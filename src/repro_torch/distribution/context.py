"""Activation-sharding context, the counterpart of
``repro.distribution.context``.

``activation_sharding(mesh, batch_axes, ...)`` installs the mesh the
sharded step runs on, the axes its batch rows are split over, the model
(tensor-parallel) axis and the reference's two switches, ``kv_seq_shard``
and ``moe_a2a``. The layers read the predicates to pick their route, as
the reference's do: a MoE layer takes ``models.moe_a2a`` under
``moe_a2a_enabled() and a2a_applicable(cfg)``, and a one-token decode on
a cache the model axis splits by length (the axis does not divide the KV
heads, :func:`model_axis_divides`) takes ``models.flash_decode``.
``kv_seq_shard`` is the reference's placement of the fresh K/V by
sequence on such a cache, a constraint without a value: here each rank
always writes only the fresh rows that fall in its part of the cache, so
:func:`kv_seq_shard_enabled` picks no route.

Roles: ``'batch'`` -> the batch axes, ``'model'`` -> the tensor-parallel
axis, ``'expert'`` -> an alias of ``'model'`` (experts live on it).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple

from repro_torch.distribution.sharding import Axes, axes_size, axes_tuple
from repro_torch.launch.mesh import Mesh

_STATE = {"mesh": None, "batch": None, "model": "model", "kv_seq": False,
          "moe_a2a": False}


@contextmanager
def activation_sharding(mesh: Mesh, batch_axes: Axes, model_axis: str = "model",
                        kv_seq_shard: bool = False, moe_a2a: bool = False):
    old = dict(_STATE)
    _STATE.update(mesh=mesh, batch=batch_axes, model=model_axis,
                  kv_seq=kv_seq_shard, moe_a2a=moe_a2a)
    try:
        yield
    finally:
        _STATE.clear()
        _STATE.update(old)


def constrain(x, roles: Dict[int, str]):
    """The reference's sharding constraint, kept under its name. It has
    nothing to impose here: a JAX array is global and the constraint
    places its blocks, while a port tensor already is this rank's block,
    whose placement the sharded step fixed when it made it. Returns
    ``x``."""
    return x


def active() -> bool:
    return _STATE["mesh"] is not None


def mesh() -> Optional[Mesh]:
    """The installed mesh (``None`` outside a context)."""
    return _STATE["mesh"]


def batch_axes() -> Tuple[str, ...]:
    """The installed batch axes, as a tuple (empty: the batch is whole on
    every rank)."""
    return axes_tuple(_STATE["batch"])


def model_axis() -> str:
    return _STATE["model"]


def kv_seq_shard_enabled() -> bool:
    return bool(_STATE.get("kv_seq"))


def moe_a2a_enabled() -> bool:
    return bool(_STATE.get("moe_a2a"))


def model_axis_divides(n: int) -> bool:
    """True when the tensor-parallel axis evenly divides ``n`` (False when
    no activation-sharding context is installed)."""
    m = _STATE["mesh"]
    if m is None:
        return False
    return n % axes_size(m, _STATE["model"]) == 0
