"""Placement of the RL engine's population over a mesh of ranks, the
counterpart of ``repro.distribution.population``.

The reference shards the ``num_envs`` / scenario axis of its arrays over
a device mesh and lets GSPMD run the unchanged vmapped functions; its
metrics leave through ``jax.device_get``, which all-gathers the shards.
Here each rank is a process that computes only its rows of that axis
(:func:`shard_population`), agent parameters are replicated (every rank
holds its own copy), and :func:`gather_population` all-gathers the rows
back in population order. ``mesh=None`` is the no-mesh path: every
helper is then the identity.

Random draws stay the unsharded run's: a :class:`PopulationGenerator`
stands in for a ``torch.Generator`` in the rollout, draws each
whole-population tensor from the generator every rank holds alike, and
keeps this rank's rows (:func:`population_rand`).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.distribution import collectives as C
from repro_torch.distribution.sharding import (population_axes,
                                               population_sharding)
from repro_torch.launch.mesh import Mesh
from repro_torch.tree import tree_map

Tensor = torch.Tensor


def mesh_size(mesh: Mesh) -> int:
    return mesh.size


def population_shardings(tree: Any, mesh: Mesh, num: int) -> Any:
    """Per leaf of ``tree``, the rows of its leading axis this rank holds:
    this rank's share where that axis has size ``num``, every row for any
    other leaf (scalars, shared state). The same rule serves env-state
    chunks (``num = num_envs``) and stacked per-scenario state (``num =
    num_scenarios``)."""

    def one(x):
        if x.dim() >= 1 and x.shape[0] == num:
            return population_sharding(mesh, num, x.dim())
        return slice(None)

    return tree_map(one, tree)


def shard_population(tree: Any, mesh: Optional[Mesh], num: int) -> Any:
    """This rank's rows of every leaf whose leading axis is ``num``; other
    leaves whole. ``mesh=None`` returns ``tree``."""
    if mesh is None:
        return tree
    return tree_map(lambda x, rows: x[rows], tree,
                    population_shardings(tree, mesh, num))


def replicate(tree: Any, mesh: Optional[Mesh]) -> Any:
    """``tree`` on the mesh's device, whole on every rank (agent
    parameters and optimizer state)."""
    if mesh is None:
        return tree
    return tree_map(lambda x: x.to(mesh.device), tree)


def gather_population(tree: Any, mesh: Optional[Mesh], num: int) -> Any:
    """The whole population from this rank's rows: every leaf of ``tree``
    holds this rank's rows of a population axis of size ``num`` (its
    leading axis), all-gathered in population order. A replicated
    population (``num`` not divisible over the mesh) comes back as it
    is."""
    if mesh is None:
        return tree
    axes = population_axes(mesh, num)
    return tree_map(lambda x: C.all_gather(x, mesh, axes), tree)


def population_rows(mesh: Optional[Mesh], num: int) -> range:
    """The indices of the population this rank holds."""
    if mesh is None:
        return range(num)
    return range(num)[population_sharding(mesh, num)]


class PopulationGenerator:
    """A generator for one rank's rows of a population: draws through
    :func:`population_rand` make the whole population's tensor from
    ``gen`` and keep ``rows``, so ``gen`` advances as in the unsharded
    run."""

    def __init__(self, gen: torch.Generator, num: int, rows: range):
        self.gen, self.num, self.rows = gen, num, rows


def population_rand(shape, gen, device) -> Tensor:
    """``torch.rand(shape)`` from ``gen``: a ``torch.Generator``, or a
    :class:`PopulationGenerator`, which draws ``(num,) + shape[1:]`` and
    returns this rank's rows (``shape[0]`` must be their count)."""
    if not isinstance(gen, PopulationGenerator):
        return torch.rand(shape, generator=gen, device=device)
    shape = tuple(shape)
    if shape[0] != len(gen.rows):
        raise ValueError(f"a draw of {shape[0]} rows from a generator of "
                         f"{len(gen.rows)} population rows")
    full = torch.rand((gen.num,) + shape[1:], generator=gen.gen, device=device)
    return full[gen.rows.start:gen.rows.stop]
