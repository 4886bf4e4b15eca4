"""Placement rules on a mesh of ranks, the counterpart of
``repro.distribution.sharding``.

The axis rules (:func:`batch_axes`, :func:`population_axes`) return what
the reference's return, mesh axis names or ``None``; :func:`spec_for_param`
returns the reference's ``PartitionSpec`` as a tuple, one entry per
dimension (an axis name, a tuple of them, or ``None``). Where the
reference builds a ``NamedSharding``, the population and stage rules
return which rows of the sharded dimension this rank holds, a ``slice``
(``slice(None)``: the dimension is replicated), and the parameter, cache
and batch rules (:func:`param_shardings`, :func:`cache_shardings`,
:func:`batch_sharding`) return :class:`Sharding` records, ``(mesh,
spec)``: a record gives this rank's block of a global tensor and the
global shape of a block. A JAX array is global and its sharding places
its blocks; here each rank holds its block of every sharded tensor. A
dimension sharded over several axes is split row-major over them, the
first axis outermost, as a ``PartitionSpec`` splits it.

The sharded step (``models.model.make_train_step(param_shardings_tree=)``,
``make_decode_step(param_shardings_tree=, cache_shardings_tree=)``) holds
parameters, both AdamW moments and caches as those blocks. The split of
its forward, :class:`ModelSplit`, follows what GSPMD derives from the
specs: FSDP over ``data`` (each ``data``-sharded dimension gathered just
before use, the gathered copy dropped after it and gathered again in the
rematerialized backward, each gradient reduce-scattered back to its
block) and tensor parallelism over ``model`` where the rules shard whole
units: attention heads (column-parallel ``wq``/``wk``/``wv``,
``bq``/``bk``/``bv``, row-parallel ``wo``), FFN columns (``w_gate``,
``w_up``; row-parallel ``w_down``), experts, and the vocabulary
(``embed`` / ``lm_head``: a masked lookup summed over ``model`` and
vocab-parallel logits with a distributed log-softmax). A leaf is
gathered over ``model`` where its block would not be whole:

* a KV width whose head count the axis does not divide (its block would
  cut a head): the KV weights are gathered, each rank computes every KV
  head and takes the ones its query heads read, and their gradients are
  summed over ``model``;
* the attention of a config whose query heads the axis does not divide;
* an FFN width or an expert count the axis does not divide;
* Mamba's fused ``in_proj`` / ``out_proj`` (and the rest of the block),
  except when decoding: then the block runs on this rank's ``in_proj``
  columns, conv channels, SSM heads and ``out_proj`` rows, whose splits
  do not line up, so the columns and the conv output are gathered and
  each rank takes the pieces its heads read (``models.ssm``);
* the frontend ``proj``;
* ``embed`` / ``lm_head`` when the axis does not divide the vocabulary.

A leaf that no batch axis shards (a norm, a bias, the router along
``data`` when it does not divide) has its gradient summed over the batch
axes after the backward (:func:`sync_grads`). Decoding on a cache whose
KV heads the axis does not divide (split by length,
``models.flash_decode``) computes the query, key and value columns of
its block and gathers them, so every rank attends with every head over
its part of the cache.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

from repro_torch.launch.mesh import Mesh
from repro_torch.tree import tree_leaves_with_path, tree_map, tree_unflatten

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


def axes_size(mesh: Mesh, axes: Axes) -> int:
    """The number of blocks ``axes`` split a dimension into."""
    return math.prod(mesh_axis_size(mesh, a) for a in axes_tuple(axes))


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


def shard_index(mesh: Mesh, spec: Sequence[Axes], shape) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` placed by ``spec``, one
    :func:`shard_rows` per dimension."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {tuple(spec)} does not fit shape {tuple(shape)}")
    return tuple(shard_rows(mesh, ax, n) for ax, n in zip(spec, shape))


@dataclass(frozen=True, eq=False)
class Sharding:
    """Where a tensor lives on a mesh, the port's ``NamedSharding``:
    ``spec`` has one entry per dimension, the axis (or axes) it is split
    over or ``None``."""

    mesh: Mesh
    spec: Tuple[Axes, ...]
    # how many ranks hold the block, where the spec alone does not say it
    # (:func:`stage_shardings`)
    holders: Optional[int] = None

    def index(self, shape) -> Tuple[slice, ...]:
        """This rank's block of a global tensor of ``shape``."""
        return shard_index(self.mesh, self.spec, shape)

    def block(self, x):
        """This rank's block of the global tensor ``x`` (a view)."""
        return x[self.index(x.shape)]

    def global_shape(self, block_shape) -> Tuple[int, ...]:
        return tuple(n * axes_size(self.mesh, ax)
                     for ax, n in zip(self.spec, block_shape))

    def block_shape(self, shape) -> Tuple[int, ...]:
        return tuple(n // axes_size(self.mesh, ax) for ax, n in zip(self.spec, shape))

    @property
    def replicas(self) -> int:
        """How many ranks hold each block (the ranks the spec does not
        split it over, unless ``holders`` says it)."""
        if self.holders is not None:
            return self.holders
        return self.mesh.size // math.prod(axes_size(self.mesh, ax)
                                           for ax in self.spec)

    def drop_leading(self) -> "Sharding":
        """The record of one entry of the leading (never sharded) dim."""
        if self.spec and self.spec[0] is not None:
            raise ValueError(f"the leading dim of {self.spec} is sharded")
        return Sharding(self.mesh, tuple(self.spec[1:]))

    def __repr__(self):
        return f"Sharding({self.mesh.shape}, {self.spec})"


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


def stage_shardings(share, cfg, boundaries: Sequence[int], mesh: Mesh,
                    stage_axis: str = STAGE_AXIS):
    """Records for a :func:`repro_torch.core.pipeline.stage_params` share
    on a stage mesh, so that :func:`global_norm` (and so AdamW's clip,
    ``update(..., shardings=)``) counts every leaf of the whole tree once:
    a slot's rows are split over the stage axis by the plan (unevenly, so
    ``block`` and ``global_shape`` do not apply to them); the embedding
    lives on the first stage and, with tied embeddings, on the last too
    (two holders of one summed gradient); the final norm and the head on
    the last stage, a frontend on the first. Along any other axis of the
    mesh each is replicated."""
    n = mesh_axis_size(mesh, stage_axis)
    if n != len(boundaries):
        raise ValueError(f"a {len(boundaries)}-stage plan on a {stage_axis!r} "
                         f"axis of {n} ranks")
    other = mesh.size // n

    def one(path, leaf):
        spec = [None] * leaf.dim()
        if path.startswith("slots/"):
            spec[0] = stage_axis
        twice = path == "embed" and cfg.tie_embeddings and n > 1
        return Sharding(mesh, tuple(spec), holders=(2 if twice else 1) * other)

    return _with_paths(share, one)


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


def _entry(axes: Axes) -> Axes:
    """A spec entry as a ``PartitionSpec`` keeps it: ``None``, one axis
    name, or a tuple of two or more."""
    axes = axes_tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def batch_sharding(mesh: Mesh, batch_spec, *, extra_dims: int = 1) -> Sharding:
    """Sharding for (B, ...) arrays: B over ``('pod', 'data')`` when
    divisible. ``batch_spec``: B, or a tensor whose leading dim it is."""
    b = batch_spec if isinstance(batch_spec, int) else batch_spec.shape[0]
    return Sharding(mesh, (_entry(batch_axes(mesh, b)),) + (None,) * extra_dims)


# ---------------------------------------------------------------------------
# parameter sharding by key path
# ---------------------------------------------------------------------------


def spec_for_param(path: str, shape: Tuple[int, ...], cfg, mesh: Mesh) -> Tuple:
    """A parameter (by key path + shape) -> its spec, the reference's rule
    table: weights take ``data`` (FSDP) on one dimension and ``model``
    (tensor parallel) on another, each only where it divides. Stacked
    layer-group params (``slots/``) have a leading ``repeats`` dim, never
    sharded."""
    dims = list(shape)
    stacked = "slots/" in path
    off = 1 if stacked and len(dims) >= 2 else 0  # leading repeats dim

    def spec(*entries):
        full = [None] * len(dims)
        for i, ax in enumerate(entries):
            full[off + i] = _maybe(ax, dims[off + i], mesh)
        return tuple(full)

    leaf = path.split("/")[-1]
    if leaf == "embed":  # (V, D)
        return spec("model", "data")
    if leaf == "lm_head":  # (D, V)
        return spec("data", "model")
    if leaf in ("wq", "wk", "wv"):  # (D, H*hd)
        return spec("data", "model")
    if leaf == "wo":  # (H*hd, D)
        return spec("model", "data")
    if leaf in ("bq", "bk", "bv"):
        return spec("model")
    if leaf in ("w_gate", "w_up"):
        if len(dims) - off == 3:  # MoE (E, D, F)
            return spec("model", "data", None)
        return spec("data", "model")  # (D, F)
    if leaf == "w_down":
        if len(dims) - off == 3:  # MoE (E, F, D)
            return spec("model", None, "data")
        return spec("model", "data")  # (F, D)
    if leaf == "router":  # (D, E)
        return spec("data", None)
    if leaf == "in_proj":  # (D, Din)
        return spec("data", "model")
    if leaf == "out_proj":  # (di, D)
        return spec("model", "data")
    if leaf == "proj":  # frontend (d_in, D)
        return spec("data", "model")
    # norms, biases, conv, scalars: replicated
    return (None,) * len(dims)


def _path_str(path: Sequence[str]) -> str:
    """A key path of the port's trees (``tree_leaves_with_path``) as the
    reference's ``_path_str`` writes a JAX key path."""
    return "/".join(path)


def _with_paths(tree: Any, fn) -> Any:
    """``tree`` with each leaf replaced by ``fn(path_str, leaf)``."""
    return tree_unflatten(tree, [fn(_path_str(p), leaf)
                                 for p, leaf in tree_leaves_with_path(tree)])


def param_shardings(params_shape, cfg, mesh: Mesh, *, mode: str = "train"):
    """Tree of :class:`Sharding` records matching a params (or optimizer
    state) tree of tensors or of anything with a ``.shape``.

    ``mode="train"``: FSDP over ``data`` + tensor parallel over ``model``.
    ``mode="serve"``: weights resident, the ``data`` axis dropped from
    every weight spec."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")

    def one(path, leaf):
        sp = spec_for_param(path, tuple(leaf.shape), cfg, mesh)
        if mode == "serve":
            sp = tuple(None if ax == "data" else ax for ax in sp)
        return Sharding(mesh, sp)

    return _with_paths(params_shape, one)


def cache_shardings(caches_shape, cfg, mesh: Mesh, batch: int):
    """KV caches (repeats, B, len, KH, hd): batch over the batch axes, KV
    heads over ``model`` when it divides them, else the cache length over
    ``model``; SSM states (repeats, B, H, P, N): heads over ``model``;
    conv states (repeats, B, K-1, C): channels over ``model``."""
    baxes = _entry(batch_axes(mesh, batch))

    def one(path, leaf):
        dims = tuple(leaf.shape)
        name = path.split("/")[-1]
        if name in ("k", "v"):
            kh_ax = _maybe("model", dims[3], mesh)
            len_ax = _maybe("model", dims[2], mesh) if kh_ax is None else None
            return Sharding(mesh, (None, baxes, len_ax, kh_ax, None))
        if name == "ssm":
            return Sharding(mesh, (None, baxes, _maybe("model", dims[2], mesh),
                                   None, None))
        if name == "conv":
            return Sharding(mesh, (None, baxes, None, _maybe("model", dims[3], mesh)))
        return Sharding(mesh, (None,) * len(dims))

    return _with_paths(caches_shape, one)


def blocks(tree, shardings):
    """Each leaf's block on this rank (copies, so the global tree can be
    freed)."""
    return tree_map(lambda x, sh: sh.block(x).clone(), tree, shardings)


def gather_tree(tree, shardings):
    """The global tree from every rank's blocks (a collective: every rank
    of the mesh calls it; every rank gets the whole tree)."""
    from repro_torch.distribution import collectives as C

    def one(x, sh):
        for d, ax in enumerate(sh.spec):
            if ax is not None:
                x = C.all_gather(x, sh.mesh, ax, dim=d)
        return x

    return tree_map(one, tree, shardings)


# ---------------------------------------------------------------------------
# the sharded step's split over the model axis
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class ModelSplit:
    """How a sharded forward runs on this rank (see the module docstring).

    ``batch``: the axes the batch rows are split over (tokens differ
    along them); ``axis``: the model axis (``None`` when it has one rank);
    ``attn``: ``"heads"`` (this rank's query heads, and its KV heads when
    ``kv_heads``, else every KV head from gathered weights), ``"cols"``
    (the query, key and value columns of this rank's block, gathered;
    every head attends; decoding on a cache split by length or
    replicated) or ``None`` (the attention weights gathered); ``mlp``,
    ``experts``, ``vocab``: the FFN columns, the experts and the
    vocabulary split over ``axis``; ``kv_len``: the global cache length
    when the cache is split by length over ``axis``; ``ssm``: decoding
    Mamba blocks on this rank's ``in_proj`` columns, conv channels, SSM
    heads and ``out_proj`` rows (``models.ssm.mamba_apply``)."""

    mesh: Mesh
    batch: Tuple[str, ...]
    axis: Optional[str]
    attn: Optional[str] = None
    kv_heads: bool = False
    mlp: bool = False
    experts: bool = False
    vocab: bool = False
    kv_len: Optional[int] = None
    ssm: bool = False

    @property
    def size(self) -> int:
        return 1 if self.axis is None else mesh_axis_size(self.mesh, self.axis)

    @property
    def index(self) -> int:
        return 0 if self.axis is None else self.mesh.axis_index(self.axis)


def model_split(cfg, mesh: Mesh, batch: Axes, model_axis: str = "model", *,
                cache_spec: Optional[Sequence[Axes]] = None,
                cache_len: Optional[int] = None,
                decoding: bool = False) -> ModelSplit:
    """The :class:`ModelSplit` of ``cfg`` on ``mesh`` with the batch split
    over ``batch``. ``cache_spec`` (a KV cache leaf's spec, decoding):
    heads over the model axis attend on this rank's heads, a length split
    (global length ``cache_len``) or a replicated cache on every head.
    ``decoding`` (a forward through caches): Mamba blocks run on this
    rank's part of the block, as ``cache_shardings`` places their states."""
    tp = mesh_axis_size(mesh, model_axis) if model_axis in mesh.axis_names else 1
    base = dict(mesh=mesh, batch=axes_tuple(batch),
                axis=model_axis if tp > 1 else None)
    if tp == 1:
        return ModelSplit(**base)
    heads = bool(cfg.num_heads) and cfg.num_heads % tp == 0
    kv_heads = heads and cfg.num_kv_heads % tp == 0
    attn = "heads" if heads else None
    kv_len = None
    if cache_spec is not None and cfg.num_heads:
        if cache_spec[3] is not None:  # KV heads over the model axis
            attn, kv_heads = "heads", True
        else:
            attn, kv_heads = "cols", False
            kv_len = cache_len if cache_spec[2] is not None else None
    moe = cfg.moe.enabled
    return ModelSplit(
        **base, attn=attn, kv_heads=kv_heads, kv_len=kv_len,
        mlp=bool(cfg.d_ff) and cfg.d_ff % tp == 0,
        experts=moe and cfg.moe.num_experts % tp == 0,
        vocab=cfg.vocab_size % tp == 0,
        ssm=decoding and "M" in cfg.pattern)


def leaf_use(path: str, split: ModelSplit) -> Tuple[bool, bool]:
    """``(keep, partial)`` for the leaf at ``path``: whether the sharded
    forward computes with this rank's block along the model axis
    (``keep``) or gathers it, and whether its gradient on one rank of the
    model axis is a part of the whole (``partial``: summed over it)."""
    if split.axis is None:
        return False, False
    parts = path.split("/")
    leaf, family = parts[-1], parts[-2] if len(parts) > 1 else ""
    if family == "attn":
        if leaf in ("wk", "wv", "bk", "bv") and split.attn == "heads" \
                and not split.kv_heads:
            return False, True
        return split.attn is not None, False
    if family == "mlp":
        return split.mlp, False
    if family == "moe":
        return leaf != "router" and split.experts, False
    if family == "mamba":
        return split.ssm and leaf in ("in_proj", "out_proj"), False
    if leaf in ("embed", "lm_head") and len(parts) == 1:
        return split.vocab, False
    return False, False


def _sum_axes(path: str, split: ModelSplit) -> Tuple[str, ...]:
    """The axes over which the leaf's gradient is a part of the whole."""
    _, partial = leaf_use(path, split)
    return split.batch + ((split.axis,) if partial else ())


def use_param(x, sh: Sharding, path: str, split: ModelSplit):
    """The tensor the sharded forward computes with for the block ``x``
    of the leaf at ``path``: gathered over every axis of its spec but the
    model axis where the leaf is kept (:func:`leaf_use`). The backward
    reduce-scatters the gradient over the axes where it is a part (the
    batch axes, the model axis of a partial leaf) and slices it elsewhere."""
    from repro_torch.distribution import collectives as C

    keep, _ = leaf_use(path, split)
    sums = _sum_axes(path, split)
    for d, entry in enumerate(sh.spec):
        for ax in reversed(axes_tuple(entry)):
            if keep and ax == split.axis:
                continue
            x = C.all_gather_ad(x, sh.mesh, ax, dim=d,
                                grad="sum" if ax in sums else "slice")
    return x


def use_tree(tree, shardings, split: ModelSplit, prefix: str = ""):
    """:func:`use_param` over a tree whose leaves sit at ``prefix/...``."""
    flat = tree_leaves_with_path(tree)
    shs = tree_leaves_with_path(shardings)
    out = [use_param(x, sh, _path_str((prefix,) + p if prefix else p), split)
           for (p, x), (_, sh) in zip(flat, shs)]
    return tree_unflatten(tree, out)


def sync_grads(grads, shardings, split: ModelSplit):
    """Each gradient summed over the axes where it is a part and that do
    not split the leaf (those :func:`use_param`'s backward already
    reduce-scattered): after this, every rank holds the whole gradient of
    its block."""
    from repro_torch.distribution import collectives as C

    out = []
    for (p, g), (_, sh) in zip(tree_leaves_with_path(grads),
                               tree_leaves_with_path(shardings)):
        split_by = {a for e in sh.spec for a in axes_tuple(e)}
        for ax in _sum_axes(_path_str(p), split):
            if ax not in split_by:
                g = C.all_reduce(g, sh.mesh, ax)
        out.append(g)
    return tree_unflatten(grads, out)


def global_norm(tree, shardings):
    """The global norm of a tree of blocks: each rank's squared norms,
    each leaf's divided by the number of ranks holding its block, summed
    over the mesh (so a leaf replicated along an axis counts once)."""
    import torch

    from repro_torch.distribution import collectives as C
    from repro_torch.tree import tree_leaves

    shs = tree_leaves(shardings)
    mesh = shs[0].mesh
    sq = sum(torch.sum(torch.square(x.float())) / sh.replicas
             for x, sh in zip(tree_leaves(tree), shs))
    return torch.sqrt(C.all_reduce(sq, mesh, mesh.axis_names))
