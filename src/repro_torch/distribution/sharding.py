"""Placement rules on a mesh of ranks: the population and stage rules of
``repro.distribution.sharding``.

The axis rules (:func:`batch_axes`, :func:`population_axes`) return what
the reference's return, mesh axis names or ``None``. Where the reference
builds a ``NamedSharding``, the port returns which rows of the sharded
dimension this rank holds: a ``slice``, the whole dimension
(``slice(None)``) when that dimension is replicated. A dimension sharded
over several axes is split row-major over them, the first axis
outermost, as a ``PartitionSpec`` splits it.

The parameter, cache and activation rules of the reference
(``spec_for_param``, ``param_shardings``, ``cache_shardings``) are not
ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

from repro_torch.launch.mesh import Mesh

Axes = Union[None, str, Tuple[str, ...]]

ENV_AXIS = "env"
STAGE_AXIS = "stage"


def mesh_axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def _maybe(axis: Optional[str], dim: int, mesh: Mesh) -> Optional[str]:
    """``axis`` for a dim only if the mesh has it and it divides the dim."""
    if axis is None or axis not in mesh.axis_names:
        return None
    if dim % mesh_axis_size(mesh, axis) != 0:
        return None
    return axis


def _data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_axes(mesh: Mesh, batch: int) -> Optional[Tuple[str, ...]]:
    """Largest prefix of ``('pod', 'data')`` whose product divides
    ``batch``."""
    axes, prod = [], 1
    for a in _data_axes(mesh):
        prod *= mesh_axis_size(mesh, a)
        if batch % prod:
            break
        axes.append(a)
    return tuple(axes) if axes else None


def axes_tuple(axes: Axes) -> Tuple[str, ...]:
    """A rule's axes as a tuple (``None``: no axis)."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def shard_rows(mesh: Mesh, axes: Axes, dim: int) -> slice:
    """The rows of a ``dim``-long dimension sharded over ``axes`` that
    this rank holds (all of them for no axis)."""
    axes = axes_tuple(axes)
    if not axes:
        return slice(None)
    n, block = 1, 0
    for a in axes:
        n *= mesh_axis_size(mesh, a)
        block = block * mesh_axis_size(mesh, a) + mesh.axis_index(a)
    if dim % n:
        raise ValueError(f"{dim} rows do not split over {axes} ({n} shards)")
    per = dim // n
    return slice(block * per, (block + 1) * per)


def population_axes(mesh: Mesh, num: int) -> Axes:
    """Mesh axes for a population axis of size ``num``: a dedicated
    ``'env'`` axis (``launch.mesh.make_population_mesh``) wins; otherwise
    the largest divisible prefix of ``('pod', 'data')``. ``None``
    (replicate) when nothing divides ``num``."""
    if ENV_AXIS in mesh.axis_names:
        return _maybe(ENV_AXIS, num, mesh)
    return batch_axes(mesh, num)


def population_sharding(mesh: Mesh, num: int, ndim: int = 1) -> slice:
    """This rank's rows of a ``(num, ...)`` population-axis array (all of
    them when the population is replicated); ``ndim`` is the array's rank
    (every trailing dimension is replicated)."""
    return shard_rows(mesh, population_axes(mesh, num), num)


def replicated_sharding(mesh: Mesh) -> slice:
    """Every row (agent parameters shared by every shard)."""
    return slice(None)


def stage_sharding(mesh: Mesh, ndim: int = 1, stage_axis: str = STAGE_AXIS,
                   num: Optional[int] = None) -> slice:
    """This rank's rows of an ``(S, ...)`` stage-stacked array on a mesh
    with a stage axis (``num`` = S, the stage-axis size by default):
    replicated along every other axis, in particular along ``env``."""
    if stage_axis not in mesh.axis_names:
        return slice(None)
    num = mesh_axis_size(mesh, stage_axis) if num is None else num
    return shard_rows(mesh, stage_axis, num)


def microbatch_sharding(mesh: Mesh, ndim: int, env_axis: str = ENV_AXIS,
                        rows: Optional[int] = None) -> slice:
    """This rank's rows of the SECOND dimension of ``(M, mb, ...)``
    microbatched data (``rows`` = mb; the env-axis size by default):
    microbatch rows over the env axis, the schedule dimension and
    everything trailing replicated. Without an env axis, every row."""
    if env_axis not in mesh.axis_names:
        return slice(None)
    rows = mesh_axis_size(mesh, env_axis) if rows is None else rows
    return shard_rows(mesh, env_axis, rows)

