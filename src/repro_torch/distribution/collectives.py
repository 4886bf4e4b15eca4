"""Every cross-rank transfer of the port, along the axes of a
:class:`repro_torch.launch.mesh.Mesh`.

* :func:`all_gather`: this rank's line along an axis, concatenated in
  axis order;
* :func:`all_reduce`: the sum or mean over an axis;
* :func:`exchange`: point-to-point sends and receives along an axis,
  posted together and then waited on, so two neighbours never both block;
* :func:`barrier` over the whole mesh.

An axis of one rank (and a 1-rank mesh) makes every collective an
identity. On an NCCL group tensors travel as they are, on the card. On a
gloo group, which carries host tensors only, a CUDA tensor is copied to
the host, sent, and the result copied back: ranks that share one card
talk this way, so their transfers measure host staging, not a link.
:func:`transport` names which of the two a mesh uses. A CPU tensor on an
NCCL group raises; nothing falls back silently.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distribution.sharding import Axes, axes_tuple
from repro_torch.launch.mesh import Mesh

Tensor = torch.Tensor


def _axis(mesh: Mesh, axes: Axes) -> Optional[str]:
    """The one mesh axis a collective runs over (``None``: no transfer)."""
    names = [a for a in axes_tuple(axes) if mesh.shape.get(a, 1) > 1]
    if len(names) > 1:
        raise NotImplementedError(f"a collective over several axes {names}")
    return names[0] if names else None


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
    """A contiguous tensor gloo can carry: bf16 travels as its int16 bits."""
    x = x.contiguous()
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def transport(mesh: Mesh) -> str:
    """``"none"`` (one rank), ``"nccl"``, or ``"gloo, staged through the
    host"``, the transport of the mesh's collectives on CUDA tensors."""
    if mesh.size == 1:
        return "none"
    backend = dist.get_backend(mesh.group)
    return "nccl" if backend == dist.Backend.NCCL else f"{backend}, staged through the host"


def all_gather(x: Tensor, mesh: Mesh, axes: Axes) -> Tensor:
    """``x`` of every rank on this rank's line along ``axes``,
    concatenated along the leading dimension in axis order."""
    axis = _axis(mesh, axes)
    if axis is None:
        return x
    group = mesh.groups[axis]
    staged = _staged(x, group)
    src = x.detach().cpu() if staged else x.detach()
    wire = _wire(src)
    parts = [torch.empty_like(wire) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, wire, group=group)
    if src.dtype == torch.bfloat16:
        parts = [p.view(torch.bfloat16) for p in parts]
    out = torch.cat(parts)
    return out.to(x.device) if staged else out


def all_reduce(x: Tensor, mesh: Mesh, axes: Axes, op: str = "sum") -> Tensor:
    """The sum (``op="sum"``) or mean (``"mean"``) of ``x`` over this
    rank's line along ``axes``; ``x`` is left as it was."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    axis = _axis(mesh, axes)
    if axis is None:
        return x
    group = mesh.groups[axis]
    staged = _staged(x, group)
    buf = x.detach().cpu().clone() if staged else x.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if op == "mean":
        buf = buf / mesh.shape[axis]
    return buf.to(x.device) if staged else buf


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
    for shape, dtype, off in recvs:
        wdtype = torch.int16 if dtype == torch.bfloat16 else dtype
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


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh arrives (no-op on one rank)."""
    if mesh.size > 1:
        dist.barrier(group=mesh.group)
