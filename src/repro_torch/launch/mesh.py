"""Meshes of ``torch.distributed`` ranks, the counterpart of
``repro.launch.mesh``.

A JAX mesh is a grid of devices with named axes; here it is a grid of the
ranks of the default process group, which the caller initializes (a
launcher, ``torchrun``, or a test's spawn) with the backend of its
choice. Each axis is a process subgroup: along axis ``a`` a rank's
subgroup holds the ranks that differ from it in coordinate ``a`` only.
The grid is row-major over the ranks ``0 .. size-1``: on a (stage x env)
mesh, row ``s``, column ``e`` is rank ``s * n_envs + e``, stage-major as
the reference pins its device grid.

A 1-rank mesh needs no process group: its collectives are identities,
as a 1-device JAX mesh needs no setup. Asking for more ranks than the
world has raises, as the reference's ``assert``s do. Building a mesh of
more than one rank is a collective call: every rank of the world makes
it, in the same order, with the same arguments.

A rank's device is ``cuda:{LOCAL_RANK % device_count}`` (its global
rank where ``LOCAL_RANK`` is unset) unless the caller passes a device,
as ``device="cpu"``. On a host with one card every rank shares
``cuda:0``; such ranks talk over gloo, which carries host tensors only
(:mod:`repro_torch.distribution.collectives` stages through the host).

:func:`make_production_mesh` is the reference's 512-device production
mesh as a shape record: ``launch.dryrun`` sizes each rank's blocks on
it under the sharding rules and runs rank 0's step on them, whose
collectives record themselves without a process group
(:mod:`repro_torch.distribution.collectives`); no rank is started.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Mesh:
    """A named grid of ranks as seen from one rank.

    ``axis_names`` and ``axis_sizes`` name and size the axes; ``coords``
    are this rank's coordinates (``None`` for a rank of the world outside
    the grid); ``groups`` maps each axis of more than one rank to this
    rank's subgroup along it, and ``group`` is the subgroup of the whole
    mesh (``None``: the default group, or no group for one rank).
    """

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Optional[Tuple[int, ...]] = (0,)
    device: torch.device = torch.device("cpu")
    groups: Dict[str, Any] = field(default_factory=dict)
    group: Any = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} names {len(self.axis_names)} "
                             f"axes, sizes {self.axis_sizes} give "
                             f"{len(self.axis_sizes)}")
        if self.coords is not None and (
                len(self.coords) != len(self.axis_sizes)
                or any(not 0 <= c < n for c, n in zip(self.coords, self.axis_sizes))):
            raise ValueError(f"coordinates {self.coords} are off the "
                             f"{self.axis_sizes} grid")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def ranks(self) -> np.ndarray:
        """The grid of global ranks (the reference's ``mesh.devices``)."""
        return np.arange(self.size).reshape(self.axis_sizes)

    @property
    def rank(self) -> Optional[int]:
        """This rank's global rank, ``None`` outside the grid."""
        return None if self.coords is None else int(self.ranks[self.coords])

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        self._member()
        return self.coords[self.axis_names.index(name)]

    def axis_ranks(self, name: str) -> Tuple[int, ...]:
        """Global ranks of this rank's line along axis ``name``, in axis
        order."""
        self._member()
        i = self.axis_names.index(name)
        idx = list(self.coords)
        idx[i] = slice(None)
        return tuple(int(r) for r in self.ranks[tuple(idx)])

    def _member(self) -> None:
        if self.coords is None:
            raise ValueError(f"this rank is outside the {self.shape} mesh")


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rank_device(rank: int, device: DeviceLike) -> torch.device:
    if device is not None:
        return resolve_device(device)
    resolve_device(None)  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              device: DeviceLike = None) -> Mesh:
    """The ``axis_sizes`` grid of ranks ``0 .. prod - 1`` with one
    subgroup per axis line. A collective call when the grid has more than
    one rank (every rank of the world calls ``new_group`` for every line,
    in the same order); ranks past the grid get ``coords=None``."""
    sizes = tuple(int(n) for n in axis_sizes)
    names = tuple(axis_names)
    need = int(np.prod(sizes))
    rank, world = _world()
    if any(n < 1 for n in sizes) or need > world:
        raise ValueError(f"a {dict(zip(names, sizes))} mesh needs {need} "
                         f"ranks, the world has {world}")
    grid = np.arange(need).reshape(sizes)
    coords = (tuple(int(c) for c in np.argwhere(grid == rank)[0])
              if rank < need else None)
    groups, group = {}, None
    if need > 1:
        for i, name in enumerate(names):
            if sizes[i] == 1:
                continue
            for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
                g = dist.new_group([int(r) for r in line])
                if coords is not None and rank in line:
                    groups[name] = g
        if need < world:
            group = dist.new_group(list(range(need)))
    return Mesh(names, sizes, coords, _rank_device(rank, device), groups, group)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's shape, ``(16, 16)`` over ``("data",
    "model")`` or ``(2, 16, 16)`` over ``("pod", "data", "model")``, seen
    from rank 0, with no process group and on no device: a record for the
    sharding rules (``spec_for_param``, ``param_shardings``,
    ``cache_shardings``, ``batch_axes``), which give rank 0's block of
    each leaf (every rank's has the same shape). A collective on it
    touches no process group: it records what rank 0 would issue and
    returns an empty meta tensor of its result's shape
    (:mod:`repro_torch.distribution.collectives`), so rank 0's step runs
    on meta tensors and counts its collectives (``launch.dryrun``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, coords=(0,) * len(shape), device=torch.device("meta"))


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> Mesh:
    """A (data x model) mesh over the world's ranks (tests)."""
    return make_mesh((data, model), ("data", "model"), device)


def make_stage_mesh(n_stages: int, stage_axis: str = "stage",
                    device: DeviceLike = None) -> Mesh:
    """1-D mesh for the split executor's stages: stage ``k`` of a split
    plan runs on rank ``k``, and the point-to-point transfers along this
    axis play the paper's wireless activation and gradient hops."""
    return make_mesh((n_stages,), (stage_axis,), device)


def make_stage_env_mesh(n_stages: int, n_envs: Optional[int] = None,
                        stage_axis: str = "stage", env_axis: str = "env",
                        device: DeviceLike = None) -> Mesh:
    """2-D (stage x env) mesh: row ``s``, column ``e`` (rank ``s * n_envs
    + e``) holds stage ``s`` for env shard ``e``. The executor hops along
    ``stage_axis`` and splits microbatch rows over ``env_axis``;
    ``distribution.sharding.population_axes`` picks the ``"env"`` axis by
    name, so ``train_population`` runs on this mesh unchanged.
    ``n_envs=None`` takes every remaining rank (``world // n_stages``)."""
    if n_envs is None:
        n_envs = _world()[1] // n_stages
    return make_mesh((n_stages, n_envs), (stage_axis, env_axis), device)


def make_population_mesh(num_devices: Optional[int] = None, axis: str = "env",
                         device: DeviceLike = None) -> Mesh:
    """1-D mesh for the RL engine's population axis: the trainers shard
    their ``num_envs`` / scenario axis over it, agent parameters stay
    replicated. ``num_devices=None`` takes the whole world; a 1-rank mesh
    is the bit-identical counterpart of ``mesh=None``."""
    n = _world()[1] if num_devices is None else num_devices
    return make_mesh((n,), (axis,), device)
