"""Every cross-rank transfer of the port, along the axes of a
:class:`repro_torch.launch.mesh.Mesh`.

* :func:`all_gather`: this rank's line along an axis, concatenated in
  axis order along a dimension;
* :func:`all_reduce`: the sum, mean or max over an axis;
* :func:`reduce_scatter`: the sum over an axis, this rank's block of it;
* :func:`all_to_all`: block ``j`` of a dimension to the ``j``-th rank of
  the line, the blocks received concatenated in source order;
* :func:`exchange`: point-to-point sends and receives along an axis,
  posted together and then waited on, so two neighbours never both block;
* :func:`broadcast`: one rank's tensor to every rank of its line (the
  serving ring's logits off the last stage, the host's tick schedule off
  rank 0);
* :func:`barrier` over the whole mesh.

The differentiable forms carry the sharded train step's backward across
ranks (``torch.autograd.Function`` subclasses, each with its transpose):
:func:`all_to_all_ad` (an all-to-all back), :func:`all_gather_ad` (a
reduce-scatter back, or this rank's slice when what follows is the same
on every rank of the line), and the column / row-parallel pair
:func:`enter_parallel` (identity forward, gradient summed over the line)
and :func:`leave_parallel` (sum forward, gradient passed through), with
:func:`scale_grad`.

An axis of one rank (and a 1-rank mesh) makes every collective an
identity; a collective over several axes runs over each in turn. On an
NCCL group tensors travel as they are, on the card. On a gloo group,
which carries host tensors only, a CUDA tensor is copied to the host,
sent, and the result copied back: ranks that share one card talk this
way, so their transfers measure host staging, not a link. bf16 travels
as its 16 bits (a float16 view) where a transfer only moves data, and is
summed in f32 and rounded once where it is reduced. :func:`transport`
names which of the two a mesh uses. A CPU tensor on an NCCL group
raises; nothing falls back silently.

:func:`record_collectives` counts what a run issues: inside it every
collective adds one count, its per-rank result bytes and its group size
to a :class:`repro_torch.distribution.records.CollectiveStats` under the
reference's kind names (each axis of a collective over several axes is
one collective; each send of :func:`exchange` one
``collective-permute``). The differentiable forms record the transfers
of their forward and backward as these run. An axis of one rank records
nothing, as XLA emits no collective on one device. The bytes come from
shapes and dtypes alone (the buffer a transfer carries: bf16 reduced in
f32 counts 4 bytes an element), so a recorded run is the same run. Off
by default; then nothing is kept.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distribution.records import CollectiveStats
from repro_torch.distribution.sharding import Axes, axes_tuple
from repro_torch.launch.mesh import Mesh

Tensor = torch.Tensor

_RECORDER: Optional[CollectiveStats] = None


@contextlib.contextmanager
def record_collectives() -> Iterator[CollectiveStats]:
    """Count every collective issued inside the context into the
    :class:`CollectiveStats` it yields (an enclosing recorder is set
    aside meanwhile and counts none of them)."""
    global _RECORDER
    outer, _RECORDER = _RECORDER, CollectiveStats()
    try:
        yield _RECORDER
    finally:
        _RECORDER = outer


def _record(kind: str, numel: int, dtype: torch.dtype, n: int) -> None:
    if _RECORDER is not None:
        _RECORDER.add(kind, numel * dtype.itemsize, n)


def _axes(mesh: Mesh, axes: Axes) -> List[str]:
    """The mesh axes of more than one rank a collective runs over."""
    return [a for a in axes_tuple(axes) if mesh.shape.get(a, 1) > 1]


def _staged(x: Tensor, group) -> bool:
    """Whether ``x`` must go through the host on ``group``."""
    backend = dist.get_backend(group)
    if backend == dist.Backend.NCCL:
        if not x.is_cuda:
            raise ValueError("NCCL carries CUDA tensors only, got one on "
                             f"{x.device}")
        return False
    return x.is_cuda


def _wire(x: Tensor) -> Tensor:
    """A contiguous tensor gloo can carry: bf16 travels as its 16 bits,
    viewed as float16 (gloo carries no int16)."""
    x = x.contiguous()
    return x.view(torch.float16) if x.dtype == torch.bfloat16 else x


def transport(mesh: Mesh) -> str:
    """``"none"`` (one rank), ``"nccl"``, or ``"gloo, staged through the
    host"``, the transport of the mesh's collectives on CUDA tensors."""
    if mesh.size == 1:
        return "none"
    backend = dist.get_backend(mesh.group)
    return "nccl" if backend == dist.Backend.NCCL else f"{backend}, staged through the host"


def _moved(x: Tensor, dim: int, group) -> Tuple[Tensor, bool]:
    """``x`` detached with ``dim`` leading, contiguous, on the host when
    ``group`` stages it; and whether it does."""
    staged = _staged(x, group)
    src = x.detach().movedim(dim, 0).contiguous()
    return (src.cpu() if staged else src), staged


def all_gather(x: Tensor, mesh: Mesh, axes: Axes, dim: int = 0) -> Tensor:
    """``x`` of every rank on this rank's line along ``axes``,
    concatenated along ``dim`` in axis order (row-major over several
    axes, the first outermost)."""
    for axis in reversed(_axes(mesh, axes)):
        group = mesh.groups[axis]
        src, staged = _moved(x, dim, group)
        wire = _wire(src)
        parts = [torch.empty_like(wire) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, wire, group=group)
        _record("all-gather", wire.numel() * len(parts), wire.dtype, len(parts))
        if src.dtype == torch.bfloat16:
            parts = [p.view(torch.bfloat16) for p in parts]
        out = torch.cat(parts).movedim(0, dim)
        x = out.to(x.device) if staged else out
    return x


_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX}


def all_reduce(x: Tensor, mesh: Mesh, axes: Axes, op: str = "sum") -> Tensor:
    """The sum (``op="sum"``), mean (``"mean"``) or max (``"max"``) of
    ``x`` over this rank's line along ``axes`` (over the sub-grid they
    span, for several); ``x`` is left as it was."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
    for axis in _axes(mesh, axes):
        group = mesh.groups[axis]
        staged = _staged(x, group)
        dt = x.dtype
        buf = x.detach().cpu() if staged else x.detach()
        buf = buf.float() if dt == torch.bfloat16 else buf.clone()
        dist.all_reduce(buf, op=_OPS[op], group=group)
        _record("all-reduce", buf.numel(), buf.dtype, mesh.shape[axis])
        if op == "mean":
            buf = buf / mesh.shape[axis]
        buf = buf.to(dt)
        x = buf.to(x.device) if staged else buf
    return x


def reduce_scatter(x: Tensor, mesh: Mesh, axes: Axes, dim: int = 0) -> Tensor:
    """The sum of ``x`` over this rank's line along ``axes``, of which this
    rank keeps its block of ``dim`` (the block :func:`all_gather` would
    put at its place)."""
    for axis in _axes(mesh, axes):
        group = mesh.groups[axis]
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"{x.shape[dim]} rows do not split over {axis} ({n})")
        dt = x.dtype
        src, staged = _moved(x, dim, group)
        src = src.float() if dt == torch.bfloat16 else src
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        _record("reduce-scatter", out.numel(), out.dtype, n)
        out = out.to(dt).movedim(0, dim)
        x = out.to(x.device) if staged else out
    return x


def all_to_all(x: Tensor, mesh: Mesh, axes: Axes, dim: int = 0) -> Tensor:
    """Block ``j`` of ``x``'s ``dim`` (split into as many equal blocks as
    the line has ranks) goes to the ``j``-th rank of the line; the blocks
    this rank receives come back concatenated along ``dim`` in source
    order (``jax.lax.all_to_all`` with ``split_axis = concat_axis``)."""
    axis = _axes(mesh, axes)
    if len(axis) > 1:
        raise NotImplementedError(f"an all-to-all over several axes {axis}")
    if not axis:
        return x
    group = mesh.groups[axis[0]]
    src, staged = _moved(x, dim, group)
    wire = _wire(src)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    _record("all-to-all", out.numel(), out.dtype, mesh.shape[axis[0]])
    if src.dtype == torch.bfloat16:
        out = out.view(torch.bfloat16)
    out = out.movedim(0, dim)
    return out.to(x.device) if staged else out


def _slice_block(x: Tensor, mesh: Mesh, axes: Axes, dim: int) -> Tensor:
    """This rank's block of ``x``'s ``dim`` along ``axes`` (no transfer)."""
    for axis in _axes(mesh, axes):
        n, i = mesh.shape[axis], mesh.axis_index(axis)
        per = x.shape[dim] // n
        x = x.narrow(dim, i * per, per)
    return x


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return all_to_all(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, *ctx.args), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, grad):
        ctx.args = (mesh, axes, dim)
        ctx.grad = grad
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        fn = reduce_scatter if ctx.grad == "sum" else _slice_block
        return fn(g.contiguous(), *ctx.args), None, None, None, None


class _EnterParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, *ctx.args), None, None


class _LeaveParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def all_to_all_ad(x: Tensor, mesh: Mesh, axes: Axes, dim: int = 0) -> Tensor:
    """:func:`all_to_all` whose backward is the all-to-all of the
    gradient (its transpose)."""
    if not _axes(mesh, axes):
        return x
    return _AllToAll.apply(x, mesh, axes, dim)


def all_gather_ad(x: Tensor, mesh: Mesh, axes: Axes, dim: int = 0,
                  grad: str = "sum") -> Tensor:
    """:func:`all_gather` along ``dim`` with a backward: ``grad="sum"``
    reduce-scatters the gradient (the transpose: what follows differs
    from rank to rank of the line, each gradient a part); ``"slice"``
    keeps this rank's block of it (what follows is the same on every rank
    of the line, each gradient already whole)."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad must be 'sum' or 'slice', got {grad!r}")
    if not _axes(mesh, axes):
        return x
    return _AllGather.apply(x, mesh, axes, dim, grad)


def enter_parallel(x: Tensor, mesh: Mesh, axes: Axes) -> Tensor:
    """Identity forward; the gradient is summed over the line (the input
    of column-parallel products, each rank's gradient a part)."""
    if not _axes(mesh, axes):
        return x
    return _EnterParallel.apply(x, mesh, axes)


def leave_parallel(x: Tensor, mesh: Mesh, axes: Axes) -> Tensor:
    """The sum over the line forward; the gradient passes through (the
    partial outputs of row-parallel products, or partial statistics)."""
    if not _axes(mesh, axes):
        return x
    return _LeaveParallel.apply(x, mesh, axes)


def scale_grad(x: Tensor, scale: float) -> Tensor:
    """Identity forward; the gradient times ``scale``."""
    return x if scale == 1 else _ScaleGrad.apply(x, scale)


def exchange(mesh: Mesh, axis: str,
             sends: Sequence[Tuple[Tensor, int]],
             recvs: Sequence[Tuple[Tuple[int, ...], torch.dtype, int]],
             device=None) -> List[Tensor]:
    """Point-to-point transfers along ``axis``: ``sends`` are ``(tensor,
    offset)`` pairs, sent to the rank ``offset`` steps along the axis;
    ``recvs`` are ``(shape, dtype, offset)`` triples, received from the
    rank ``offset`` steps along it, returned in order on ``device``. All
    are posted before any is waited on."""
    if not sends and not recvs:
        return []
    peers = mesh.axis_ranks(axis)
    me = mesh.axis_index(axis)
    staged = dist.get_backend(mesh.group) != dist.Backend.NCCL
    works, keep, out = [], [], []
    # the k-th message between two ranks in one exchange carries tag k on
    # both sides, so several messages to one peer cannot cross
    sent, got = {}, {}
    for x, off in sends:
        src = x.detach().cpu() if staged and x.is_cuda else x.detach()
        wire = _wire(src)
        keep.append(wire)  # alive until the send completes
        tag = sent[off] = sent.get(off, -1) + 1
        works.append(dist.isend(wire, dst=peers[me + off], tag=tag))
        _record("collective-permute", wire.numel(), wire.dtype, len(peers))
    for shape, dtype, off in recvs:
        wdtype = torch.float16 if dtype == torch.bfloat16 else dtype
        dev = "cpu" if staged else device
        buf = torch.empty(shape, dtype=wdtype, device=dev)
        tag = got[off] = got.get(off, -1) + 1
        works.append(dist.irecv(buf, src=peers[me + off], tag=tag))
        out.append(buf)
    for w in works:
        w.wait()
    out = [b.view(torch.bfloat16) if d == torch.bfloat16 else b
           for b, (_, d, _) in zip(out, recvs)]
    return [b.to(device) for b in out] if device is not None else out


def broadcast(x: Tensor, mesh: Mesh, axis: str, src: int = 0) -> Tensor:
    """The tensor of the rank at coordinate ``src`` of this rank's line
    along ``axis``, on every rank of the line: each rank passes a tensor of
    the same shape and dtype (the others' values are not read) and gets
    the source's, bit for bit, on its own tensor's device."""
    if not _axes(mesh, axis):
        return x
    group = mesh.groups[axis]
    staged = _staged(x, group)
    buf = x.detach().cpu() if staged else x.detach()
    wire = _wire(buf).clone()
    dist.broadcast(wire, src=mesh.axis_ranks(axis)[src], group=group)
    _record("broadcast", wire.numel(), wire.dtype, mesh.shape[axis])
    out = wire.view(torch.bfloat16) if x.dtype == torch.bfloat16 else wire
    return out.to(x.device) if staged else out


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh arrives (no-op on one rank)."""
    if mesh.size > 1:
        dist.barrier(group=mesh.group)
