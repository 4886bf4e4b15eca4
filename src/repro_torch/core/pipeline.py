"""MHSL split executor: a split plan runs as a pipeline, in one process
or one stage per rank.

Port of ``repro.core.pipeline``. The paper's multi-hop split learning is
pipeline parallelism: sub-model k runs on device s_k, activations hop
s_k -> s_{k+1} (Eq. 1) and gradients hop back (Eq. 4). The JAX package
runs the stages on a mesh axis with ``ppermute`` hops. Here, without a
mesh, every stage runs in this process and a hop is a hand-over of the
stage output (cast to the wire dtype and back, as the reference casts
it); with a stage mesh (``pipeline_step_fn(mesh=)``), stage k runs on
rank k and a hop is a point-to-point transfer of the wire-dtype tensor,
tick for tick the same schedule. The schedules:

* ``fill_drain`` (the reference, :func:`pipeline_loss_fn`): a forward of
  ``M + S - 1`` ticks, stage ``i`` taking microbatch ``t - i`` at tick
  ``t``; the last stage's final norm, LM head and cross-entropy give the
  loss. In one process the backward is autograd of the whole forward; on
  a stage mesh each rank keeps every microbatch's graph of its stage
  (GPipe's stash, no rematerialization) and pulls the cotangents through
  them in reverse microbatch order over ``M + S - 1`` more ticks, the
  ``2(M + S - 1)`` ticks of the schedule.
* ``1f1b`` (:func:`pipeline_step_fn`): ``M + 2(S-1)`` ticks; at tick
  ``t`` stage ``i`` forwards microbatch ``t - i`` and backwards
  microbatch ``t - 2(S-1) + i``. A forward slot stashes only the stage
  INPUT (a ring of ``2(S-1) + 1``); the backward slot recomputes the
  stage forward under autograd and pulls the cotangent through it
  (rematerialized backward). The last stage's forward slot only stashes:
  its forward runs inside the loss VJP, which carries the final norm, the
  LM head in the compute dtype and the cross-entropy, seeded with
  ``1/M``. Stage 0's input cotangent scatters into the embedding
  gradient; with tied embeddings the head gradient adds to it.

Each stage runs only its own layers, so uneven splits need no padding
blocks. Mixed block periods (Jamba's attention/Mamba hybrid, MoE every k
layers) run through 1F1B: layer ``r`` is applied with its own slot's
block, slot ``r % period``, row ``r // period``, as ``model.forward``
applies it. The reference's union layout (every layer row carrying every
slot's fields, zero-filled, under a ``lax.switch``) exists only so that
one SPMD scan can run every stage, and is not needed in one process; the
gradients come back in the reference's ``params["slots"]`` layout all
the same. ``fill_drain`` stays period-1, as in the reference. As in the
reference, the stage loss drops the MoE router's ``aux``, and the
executor runs tokens only: a modality frontend's projector gets zero
gradients. ``PipelineConfig.transport`` keeps the reference's
two values: the reference's ``"overlap"`` issues a tick's hops before its
compute and ``"sync"`` after it, but both hand each buffer over exactly
one tick after it was made, so they are the same schedule here (on a
mesh, each tick's transfers are posted together and waited on before its
compute).
Pipelined serving (:func:`pipeline_serve_fns`) runs the reference's
serial token ring over per-stage KV rings (:func:`stage_kv_caches`), in
one process or one stage per rank. Both train schedules run in one
process or one stage per rank.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map, tree_stack, tree_unflatten

Tensor = torch.Tensor

SCHEDULES = ("1f1b", "fill_drain")
STAGE_IMPLS = ("reference", "pallas")


@dataclass(frozen=True)
class PipelineConfig:
    """Split-executor knobs.

    ``schedule``: ``"1f1b"`` or ``"fill_drain"`` (the reference).
    ``stage_impl``: ``"reference"`` applies blocks through
    ``models.layers`` (``mlp_block``); ``"pallas"`` routes the residual
    MLP half-block through the hand-written stage kernel
    (:mod:`repro_torch.kernels.stage_block`), whose rounding is the fused
    one. The two select different functions, not a kernel and its plain
    version: on a CUDA tensor ``"pallas"`` always launches the kernel.
    ``compute_dtype``: activation dtype of the stage compute (bf16 in
    production, f32 for the parity gates). ``wire_dtype``: the dtype
    activations and cotangents are cast to for each hop (``None`` = the
    compute dtype). ``transport``: ``"overlap"`` or ``"sync"``, the same
    schedule here (see the module docstring).
    """

    schedule: str = "1f1b"
    stage_impl: str = "reference"
    compute_dtype: str = "bfloat16"
    wire_dtype: Optional[str] = None
    transport: str = "overlap"

    def __post_init__(self):
        if self.transport not in ("overlap", "sync"):
            raise ValueError(
                f"transport must be 'overlap' or 'sync', got {self.transport!r}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                             f"{self.schedule!r}")
        if self.stage_impl not in STAGE_IMPLS:
            raise ValueError(f"stage_impl must be one of {STAGE_IMPLS}, got "
                             f"{self.stage_impl!r}")

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def wire(self) -> torch.dtype:
        return getattr(torch, self.wire_dtype or self.compute_dtype)

    @property
    def block_impl(self) -> str:
        return "pallas_stage" if self.stage_impl == "pallas" else "auto"


def _check_boundaries(boundaries: Sequence[int],
                      num_layers: Optional[int] = None) -> None:
    """Validate split-plan cut points before they reach the executor.

    ``boundaries`` are CUMULATIVE layer counts: strictly increasing,
    positive, and (when the layer count is known) ending exactly at
    ``num_layers``.
    """
    bl = list(boundaries)
    if not bl:
        raise ValueError("boundaries must be non-empty")
    lo = 0
    for k, b in enumerate(bl):
        if int(b) <= lo:
            raise ValueError(
                "boundaries must be strictly increasing positive cut points; "
                f"got {tuple(bl)} (entry {k} = {b} after {lo})")
        lo = int(b)
    if num_layers is not None and lo != num_layers:
        raise ValueError(
            f"last boundary must equal the layer count {num_layers}; "
            f"got {tuple(bl)}")


def stage_lengths(boundaries: Sequence[int]) -> Tuple[int, ...]:
    _check_boundaries(boundaries)
    out, lo = [], 0
    for b in boundaries:
        out.append(b - lo)
        lo = b
    return tuple(out)


def _stage_ranges(cfg: ModelConfig,
                  boundaries: Sequence[int]) -> List[Tuple[int, int]]:
    """Checked ``[lo, hi)`` layer ranges of the stages."""
    _check_boundaries(boundaries, num_layers=cfg.num_layers)
    bl = [int(b) for b in boundaries]
    return list(zip([0] + bl[:-1], bl))


def _check_mesh(mesh, n_stages: int, stage_axis: str,
                env_axis: Optional[str]) -> None:
    """``env_axis`` needs a mesh with that axis (as a JAX mesh lacking it
    refuses it); a mesh needs a stage axis of one rank per stage."""
    if env_axis is not None and (mesh is None or env_axis not in mesh.axis_names):
        raise ValueError(f"env_axis={env_axis!r} needs a mesh with that axis, "
                         f"got {None if mesh is None else mesh.shape}")
    if mesh is None:
        return
    if mesh.shape.get(stage_axis) != n_stages:
        raise ValueError(f"a {n_stages}-stage plan needs a mesh whose "
                         f"{stage_axis!r} axis has {n_stages} ranks, got "
                         f"{mesh.shape}")
    extra = set(mesh.axis_names) - {stage_axis, env_axis}
    if any(mesh.shape[a] > 1 for a in extra):
        raise ValueError(f"the executor runs on a {stage_axis!r} (x "
                         f"{env_axis!r}) mesh, got {mesh.shape}")


def _slot_rows(lo: int, hi: int, period: int) -> List[Tuple[int, int]]:
    """Per slot ``j``, the ``[start, stop)`` rows of layers ``lo .. hi -
    1`` that use it (layer ``r`` is row ``r // period`` of slot ``r %
    period``)."""
    out = []
    for j in range(period):
        first = lo + (j - lo) % period
        n = len(range(first, hi, period))
        out.append((first // period, first // period + n))
    return out


def stage_params(params, cfg: ModelConfig, boundaries: Sequence[int],
                 stage: int):
    """Stage ``stage``'s share of ``params`` on a stage mesh (the rows
    ``distribution.sharding.stage_sharding`` gives it): its layers' rows
    of every slot, the embedding (and a frontend) on the first stage, the
    final norm and the LM head on the last; with tied embeddings the last
    stage holds the embedding as its head. Leaves are copies, so the
    whole tree can be dropped."""
    ranges = _stage_ranges(cfg, boundaries)
    lo, hi = ranges[stage]
    period = M.find_period(M.signature(cfg))
    first, last = stage == 0, stage == len(ranges) - 1
    out = {"slots": tuple(tree_map(lambda a: a[a0:a1].clone(), slot)
                          for slot, (a0, a1) in zip(params["slots"],
                                                    _slot_rows(lo, hi, period)))}
    if first or (last and cfg.tie_embeddings):
        out["embed"] = params["embed"].clone()
    if first and "frontend" in params:
        out["frontend"] = tree_map(torch.clone, params["frontend"])
    if last:
        out["final_norm"] = params["final_norm"].clone()
        if not cfg.tie_embeddings:
            out["lm_head"] = params["lm_head"].clone()
    return {k: out[k] for k in params if k in out}


def gather_stage_tree(local, like, cfg: ModelConfig,
                      boundaries: Sequence[int], mesh,
                      stage_axis: str = "stage"):
    """The whole tree from every stage's :func:`stage_params`-shaped
    ``local`` tree (a step's gradients, or parameters), on the first
    stage of this rank's stage line; ``None`` on the other stages.
    ``like`` is a whole tree of the same layout (shapes and dtypes; its
    values are not read; the other stages may pass ``None``). The
    embedding comes from the first stage, the final norm and the head
    from the last. A collective over the stage axis."""
    from repro_torch.distribution import collectives as C

    def sent(tree):
        """What a later stage sends: its slot rows, the last stage its
        norm and head (the first stage's embedding is the one kept)."""
        return {k: tree[k] for k in ("slots", "final_norm", "lm_head")
                if k in tree}

    n = len(_stage_ranges(cfg, boundaries))
    me = mesh.axis_index(stage_axis)
    if me != 0:
        C.exchange(mesh, stage_axis,
                   [(x, -me) for x in tree_leaves(sent(local))], [])
        return None
    meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), like)
    shells = [sent(stage_params(meta, cfg, boundaries, k)) for k in range(n)]
    recvs = [(tuple(x.shape), x.dtype, k) for k in range(1, n)
             for x in tree_leaves(shells[k])]
    got = iter(C.exchange(mesh, stage_axis, [], recvs, device=mesh.device))
    parts = [local] + [tree_unflatten(shells[k], [next(got) for _ in
                                                  tree_leaves(shells[k])])
                       for k in range(1, n)]
    period = M.find_period(M.signature(cfg))
    slots = []
    for j in range(period):
        rows = [p["slots"][j] for p in parts]
        slots.append(tree_map(lambda *xs: torch.cat(xs), *rows))
    out = dict(parts[0], slots=tuple(slots))
    for k in ("final_norm", "lm_head"):
        if k in parts[-1]:
            out[k] = parts[-1][k]
    return {k: out[k] for k in like}


def _microbatches(tokens: Tensor, labels: Tensor, n_microbatches: int):
    m_total, t_len = tokens.shape
    if m_total % n_microbatches:
        raise ValueError(f"{m_total} rows do not split into {n_microbatches} "
                         "microbatches")
    mb = m_total // n_microbatches
    return (tokens.reshape(n_microbatches, mb, t_len),
            labels.reshape(n_microbatches, mb, t_len))


def _layer_params(params, r: int, period: int):
    """Layer ``r``'s block params: row ``r // period`` of slot ``r % period``
    (views into the stacked slot)."""
    return M.layer_params(params["slots"][r % period], r // period)


def _stage_forward(cfg, sigs, blocks, x, positions, impl):
    """The stage's layers in turn, each with its own signature."""
    for sig, blk in zip(sigs, blocks):
        x, _, _ = M.block_apply(blk, x, cfg, sig, positions=positions,
                                impl=impl)
    return x


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits_loss(cfg, y, final_norm, head, labels):
    xh = L.rms_norm(y, final_norm, cfg.norm_eps)
    return M.softmax_xent(xh @ head.to(y.dtype), labels)


def _fill_drain_period(cfg: ModelConfig, sig) -> None:
    """Fill-drain runs period-1 configs, as the reference's."""
    period = M.find_period(sig)
    if period > 1:
        raise ValueError(
            f"{cfg.name}: the fill-drain reference runs period-1 configs, got "
            f"period {period}; mixed block periods run through the '1f1b' "
            "schedule")


def pipeline_loss_fn(cfg: ModelConfig, boundaries: Sequence[int],
                     n_microbatches: int, pipe: Optional[PipelineConfig] = None,
                     env_axis: Optional[str] = None, *, mesh=None,
                     stage_axis: str = "stage"):
    """The fill-drain (GPipe) pipelined LM loss, the REFERENCE path:
    ``(params, tokens, labels) -> loss``. tokens: ``(M * mb, T)``. No wire
    cast on the hops (as the reference's fill-drain hops in the compute
    dtype). In one process the loss is differentiable by autograd. On a
    stage ``mesh`` (``env_axis`` as :func:`pipeline_step_fn` takes it)
    each rank passes its :func:`stage_params` share and runs its stage's
    forward ticks, and every rank gets the loss; its gradient is
    ``pipeline_step_fn(schedule="fill_drain", mesh=)``'s."""
    sig = M.signature(cfg)
    _fill_drain_period(cfg, sig)
    ranges = _stage_ranges(cfg, boundaries)
    _check_mesh(mesh, len(ranges), stage_axis, env_axis)
    pipe = pipe or PipelineConfig()
    if mesh is not None:
        step = _rank_step(cfg, ranges, 1, [sig[lo:hi] for lo, hi in ranges],
                          n_microbatches, pipe, mesh, stage_axis, env_axis,
                          "fill_drain", grads=False)
        return lambda params, tokens, labels: step(params, tokens, labels)[0]
    s_stages = len(ranges)
    blk_impl, act_dtype = pipe.block_impl, pipe.dtype

    def fn(params, tokens, labels):
        tok_mb, lab_mb = _microbatches(tokens, labels, n_microbatches)
        stages = [[_layer_params(params, r, 1) for r in range(lo, hi)]
                  for lo, hi in ranges]
        head = _head(params, cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        buf: List[Optional[Tensor]] = [None] * s_stages
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for t in range(n_microbatches + s_stages - 1):
            nxt: List[Optional[Tensor]] = [None] * s_stages
            for i in range(s_stages):
                m = t - i
                if not 0 <= m < n_microbatches:
                    continue
                x = (params["embed"][tok_mb[m]].to(act_dtype) if i == 0
                     else buf[i])
                x = _stage_forward(cfg, sig[ranges[i][0]:ranges[i][1]],
                                   stages[i], x, positions, blk_impl)
                if i == s_stages - 1:
                    loss_acc = loss_acc + _logits_loss(
                        cfg, x, params["final_norm"], head, lab_mb[m])
                else:
                    nxt[i + 1] = x  # the hop (Eq. 1)
            buf = nxt
        return loss_acc / n_microbatches

    return fn


def _grad_leaves(tree):
    """Detached copies of ``tree``'s leaves that require grad, and the
    tree rebuilt on them."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    return leaves, tree_unflatten(tree, leaves)


def _accumulate(acc, grads):
    """``acc += grads`` leafwise, in place: the first microbatch's gradient
    tensors become the accumulators (copied only where autograd handed
    one tensor to two leaves), so a stage's gradients are held once, not
    twice, while the next are added."""
    if acc is None:
        seen, acc = set(), []
        for g in grads:
            if g.data_ptr() in seen:
                g = g.clone()
            seen.add(g.data_ptr())
            acc.append(g)
        return acc
    for a, g in zip(acc, grads):
        a.add_(g)
    return acc


class _Stage:
    """Stage ``i`` of one step: its two slots per tick and its gradients.
    Under 1F1B the forward slot stashes its input and, except on the last
    stage, runs the stage without autograd; the backward slot recomputes
    the stage under autograd and pulls the cotangent through it (on the
    last stage, through the loss). Under fill-drain (on a stage mesh) the
    forward slot runs the stage (and the loss) under autograd and stashes
    the graph, which the backward slot pulls the cotangent through. Stage
    0 scatters its input cotangent into the embedding gradient. In one
    process every 1F1B stage is a ``_Stage``; on a stage mesh each rank
    runs one."""

    def __init__(self, i, n_stages, layers, sigs, step):
        self.i, self.last = i, i == n_stages - 1
        self.leaves, self.blocks = _grad_leaves(layers)
        self.sigs, self.step = sigs, step
        self.stash = [None] * step.depth
        self.grads = None  # accumulated gradients of self.leaves

    def _input(self, mb: int, x_in: Optional[Tensor]) -> Tensor:
        s = self.step
        return s.embed[s.tok_mb[mb]].to(s.cdtype) if self.i == 0 else x_in

    def _run(self, x: Tensor, mb: int, grad: bool = True) -> Tensor:
        """The stage's forward of microbatch ``mb`` from ``x`` (under
        autograd when ``grad``): its output, or on the last stage its
        loss, which is added to the step's."""
        s = self.step
        with torch.set_grad_enabled(grad):
            y = _stage_forward(s.cfg, self.sigs, self.blocks, x, s.positions,
                               s.blk_impl)
            if not self.last:
                return y
            with tracing.span("head.loss", phase="forward"):
                mark = tracing.mark_in(y, "head.loss")
                head = s.head_leaf.T if s.cfg.tie_embeddings else s.head_leaf
                li = tracing.mark_out(
                    _logits_loss(s.cfg, y, s.norm_leaf, head, s.lab_mb[mb]), mark)
        s.loss_acc = s.loss_acc + li.detach()
        return li

    def _pull(self, mb: int, x: Tensor, out: Tensor,
              g_in: Optional[Tensor]) -> Optional[Tensor]:
        """The cotangent of microbatch ``mb`` through ``out`` (the stage's
        output, or the last stage's loss, seeded with ``1/M``) back to the
        stage's leaves and its input ``x``; returns the hop to the
        previous stage in the wire dtype (``None`` if there is none)."""
        s = self.step
        if self.last:
            res = torch.autograd.grad(
                out, self.leaves + [s.norm_leaf, s.head_leaf, x], s.seed)
            dbl, (dfn, dhd, dx) = res[:-3], res[-3:]
            s.gnorm = s.gnorm + dfn
            s.ghead = s.ghead + dhd
        else:
            res = torch.autograd.grad(out, self.leaves + [x], g_in)
            dbl, dx = res[:-1], res[-1]
        self.grads = _accumulate(self.grads, list(dbl))
        if self.i > 0:
            return dx.to(s.wdtype)
        # the cotangent of the embedding lookup
        s.gembed.index_add_(0, s.tok_mb[mb].reshape(-1),
                            dx.reshape(-1, dx.shape[-1]).to(s.gembed.dtype))
        return None

    def forward(self, mf: int, x_in: Optional[Tensor]) -> Optional[Tensor]:
        """Microbatch ``mf``'s 1F1B forward slot; returns the hop to the
        next stage in the wire dtype (``None`` if there is none)."""
        s = self.step
        if not 0 <= mf < s.m_micro:
            return None
        with tracing.span("pipeline.forward_slot", stage=self.i, mb=mf):
            x0 = self._input(mf, x_in)
            self.stash[mf % s.depth] = x0
            if self.last:
                return None
            return self._run(x0, mf, grad=False).to(s.wdtype)

    def backward(self, mbk: int, g_in: Optional[Tensor]) -> Optional[Tensor]:
        """Microbatch ``mbk``'s 1F1B backward slot; returns the hop to the
        previous stage in the wire dtype (``None`` if there is none)."""
        s = self.step
        if not 0 <= mbk < s.m_micro:
            return None
        with tracing.span("pipeline.backward_slot", stage=self.i, mb=mbk):
            x_sv = self.stash[mbk % s.depth].detach().requires_grad_(True)
            self.stash[mbk % s.depth] = None
            with tracing.span("pipeline.recompute", stage=self.i, mb=mbk):
                out = self._run(x_sv, mbk)
            with tracing.span("pipeline.grad", stage=self.i, mb=mbk):
                return self._pull(mbk, x_sv, out, g_in)

    def fd_forward(self, mf: int, x_in: Optional[Tensor],
                   grad: bool = True) -> Optional[Tensor]:
        """Microbatch ``mf``'s fill-drain forward slot: its graph is kept
        for :meth:`fd_backward` (none without ``grad``); returns the hop
        to the next stage (``None`` if there is none)."""
        s = self.step
        if not 0 <= mf < s.m_micro:
            return None
        x0 = self._input(mf, x_in).detach().requires_grad_(grad)
        out = self._run(x0, mf, grad)
        if grad:
            self.stash[mf] = (x0, out)
        return None if self.last else out.detach().to(s.wdtype)

    def fd_backward(self, mbk: int, g_in: Optional[Tensor]) -> Optional[Tensor]:
        """Microbatch ``mbk``'s fill-drain backward slot, through the graph
        its forward slot kept."""
        if not 0 <= mbk < self.step.m_micro:
            return None
        (x0, out), self.stash[mbk] = self.stash[mbk], None
        return self._pull(mbk, x0, out, g_in)


class _Step:
    """What the stages of one step share: the data, the loss seed, and the
    accumulators of the loss and of the embedding, norm and head
    gradients (each written by one stage only)."""

    def __init__(self, cfg, params, tok_mb, lab_mb, m_micro, depth, pipe,
                 first: bool, last: bool):
        dev = tok_mb.device
        self.cfg, self.tok_mb, self.lab_mb = cfg, tok_mb, lab_mb
        self.m_micro, self.depth = m_micro, depth
        self.blk_impl, self.cdtype, self.wdtype = pipe.block_impl, pipe.dtype, pipe.wire
        self.positions = torch.arange(tok_mb.shape[-1], device=dev)
        self.seed = torch.full((), 1.0 / m_micro, dtype=torch.float32, device=dev)
        self.loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        if first:
            self.embed = params["embed"]
            self.gembed = torch.zeros_like(params["embed"])
        if last:
            head_src = params["embed"] if cfg.tie_embeddings else params["lm_head"]
            self.norm_leaf = params["final_norm"].detach().requires_grad_(True)
            self.head_leaf = head_src.detach().requires_grad_(True)
            self.gnorm = torch.zeros_like(params["final_norm"])
            self.ghead = torch.zeros_like(head_src)


def _stage_grads(stages, ranges, period):
    """The stages' layer gradients in the slots layout: slot ``j`` holds
    the rows of its layers in layer order (the reference's
    ``split_union_grads`` layout)."""
    by_layer = {}
    for st, (lo, hi) in zip(stages, ranges):
        for r, g in zip(range(lo, hi), tree_unflatten(st.blocks, st.grads)):
            by_layer[r] = g
    layers = sorted(by_layer)
    return tuple(tree_stack([by_layer[r] for r in layers if r % period == j])
                 for j in range(period))


def pipeline_step_fn(cfg: ModelConfig, boundaries: Sequence[int],
                     n_microbatches: int,
                     pipe: PipelineConfig = PipelineConfig(),
                     env_axis: Optional[str] = None, *, mesh=None,
                     stage_axis: str = "stage"):
    """Build the pipelined train step: ``(params, tokens, labels) -> (loss,
    grads)``, grads in the ``params`` tree layout (slot ``j`` of a
    period-``p`` config holds the gradients of layers ``j, j + p, ...``;
    a frontend's projector gets zeros).

    ``pipe.schedule == "1f1b"`` runs the interleaved schedule of the
    module docstring; ``"fill_drain"`` is autograd of
    :func:`pipeline_loss_fn` in one process. Stage compute runs in
    ``pipe.dtype``; 1F1B hops cast to ``pipe.wire`` and back, fill-drain
    hops travel in the compute dtype.

    ``mesh`` (``launch.mesh.make_stage_mesh`` or ``make_stage_env_mesh``)
    runs stage ``k`` on the rank at coordinate ``k`` of ``stage_axis``,
    tick for tick as in one process: each tick's hops are point-to-point
    transfers to and from the neighbouring stages, posted together. Under
    fill-drain each rank keeps its stage's graph of every microbatch from
    its ``M + S - 1`` forward ticks and pulls the cotangents through them
    in reverse microbatch order over ``M + S - 1`` backward ticks. Each
    rank passes its own share of the parameters, :func:`stage_params`,
    and gets the gradients in that share's layout
    (:func:`gather_stage_tree` assembles the whole tree); the loss, on
    every rank, is the last stage's. With tied embeddings the first
    stage's embedding gradient and the last stage's head gradient are
    summed across the two ranks. ``env_axis`` (a ``(stage x env)`` mesh)
    splits each microbatch's rows over the env axis and averages the loss
    and every gradient over it after the stage reductions. Every rank
    takes the whole ``tokens`` and ``labels``.
    """
    sig = M.signature(cfg)
    period = M.find_period(sig)
    ranges = _stage_ranges(cfg, boundaries)
    _check_mesh(mesh, len(ranges), stage_axis, env_axis)
    stage_sigs = [sig[lo:hi] for lo, hi in ranges]
    if pipe.schedule == "fill_drain":
        _fill_drain_period(cfg, sig)
        if mesh is not None:
            return _rank_step(cfg, ranges, period, stage_sigs, n_microbatches,
                              pipe, mesh, stage_axis, env_axis, "fill_drain")
        loss_fn = pipeline_loss_fn(cfg, boundaries, n_microbatches, pipe=pipe)

        def fd_step(params, tokens, labels):
            leaves, p = _grad_leaves(params)
            with torch.enable_grad():
                loss = loss_fn(p, tokens, labels)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves, grads)]
            return loss.detach(), tree_unflatten(params, grads)

        return fd_step

    if mesh is not None:
        return _rank_step(cfg, ranges, period, stage_sigs, n_microbatches,
                          pipe, mesh, stage_axis, env_axis, "1f1b")
    s_stages = len(ranges)
    m_micro = n_microbatches
    n_ticks = m_micro + 2 * (s_stages - 1)
    depth = 2 * (s_stages - 1) + 1  # activation-stash ring depth

    def fn(params, tokens, labels):
        with tracing.span("pipeline.step"):
            return ticks(params, tokens, labels)

    def ticks(params, tokens, labels):
        tok_mb, lab_mb = _microbatches(tokens, labels, m_micro)
        step = _Step(cfg, params, tok_mb, lab_mb, m_micro, depth, pipe,
                     True, True)
        stages = [_Stage(i, s_stages,
                         [_layer_params(params, r, period) for r in range(lo, hi)],
                         stage_sigs[i], step)
                  for i, (lo, hi) in enumerate(ranges)]
        buf_x: List[Optional[Tensor]] = [None] * s_stages
        buf_g: List[Optional[Tensor]] = [None] * s_stages
        for t in range(n_ticks):
            # the hops (Eq. 1 forward, Eq. 4 gradient): last tick's
            # wire-dtype outputs arrive in the compute dtype
            with tracing.span("pipeline.hop"):
                x_in = [None if b is None else b.to(step.cdtype) for b in buf_x]
                g_in = [None if b is None else b.to(step.cdtype) for b in buf_g]
            buf_x, buf_g = [None] * s_stages, [None] * s_stages
            for i, st in enumerate(stages):
                y = st.forward(t - i, x_in[i])
                if y is not None:
                    buf_x[i + 1] = y
                dx = st.backward(t - 2 * (s_stages - 1) + i, g_in[i])
                if dx is not None:
                    buf_g[i - 1] = dx

        grads = {"final_norm": step.gnorm,
                 "slots": _stage_grads(stages, ranges, period)}
        if "frontend" in params:  # the executor runs tokens only
            grads["frontend"] = tree_map(torch.zeros_like, params["frontend"])
        if cfg.tie_embeddings:
            grads["embed"] = step.gembed + step.ghead
        else:
            grads["embed"] = step.gembed
            grads["lm_head"] = step.ghead
        return step.loss_acc / m_micro, {k: grads[k] for k in params}

    return fn


def _slot_ticks(i: int, s_stages: int, m_micro: int, schedule: str):
    """Stage ``i``'s ``(forward microbatch, backward microbatch)`` at each
    tick of a step (out of ``[0, M)``: no slot). 1F1B: ``t - i`` and
    ``t - 2(S-1) + i`` over ``M + 2(S-1)`` ticks. Fill-drain: ``t - i``
    over ``M + S - 1`` forward ticks, then microbatch ``M - 1 - u + (S - 1
    - i)`` at backward tick ``u`` over as many."""
    if schedule == "1f1b":
        for t in range(m_micro + 2 * (s_stages - 1)):
            yield t - i, t - 2 * (s_stages - 1) + i
        return
    n_fwd = m_micro + s_stages - 1
    for t in range(n_fwd):
        yield t - i, -1
    for u in range(n_fwd):
        yield -1, m_micro - 1 - u + (s_stages - 1 - i)


def _rank_step(cfg, ranges, period, stage_sigs, m_micro, pipe, mesh,
               stage_axis, env_axis, schedule, grads=True):
    """:func:`pipeline_step_fn` on a stage mesh under ``schedule``: this
    rank's stage. Without ``grads``, fill-drain's forward ticks only, and
    ``(loss, None)``."""
    from repro_torch.distribution import collectives as C
    from repro_torch.distribution.sharding import microbatch_sharding

    s_stages = len(ranges)
    i = mesh.axis_index(stage_axis)
    lo, hi = ranges[i]
    first, last = i == 0, i == s_stages - 1
    rows = _slot_rows(lo, hi, period)
    fill_drain = schedule == "fill_drain"
    if fill_drain:  # the reference's fill-drain hops in the compute dtype
        pipe = replace(pipe, wire_dtype=None)
    depth = m_micro if fill_drain else 2 * (s_stages - 1) + 1

    def fn(params, tokens, labels):
        tok_mb, lab_mb = _microbatches(tokens, labels, m_micro)
        if env_axis is not None:  # this env shard's rows of each microbatch
            mine = microbatch_sharding(mesh, 3, env_axis, rows=tok_mb.shape[1])
            tok_mb, lab_mb = tok_mb[:, mine], lab_mb[:, mine]
        step = _Step(cfg, params, tok_mb, lab_mb, m_micro, depth, pipe,
                     first, last)
        layers = [M.layer_params(params["slots"][r % period],
                                 r // period - rows[r % period][0])
                  for r in range(lo, hi)]
        st = _Stage(i, s_stages, layers, stage_sigs[i], step)
        if fill_drain:
            fwd, bwd = partial(st.fd_forward, grad=grads), st.fd_backward
        else:
            fwd, bwd = st.forward, st.backward
        hop = (tok_mb.shape[1], tok_mb.shape[2], cfg.d_model)
        y = dx = None  # this rank's hops of the last tick
        for mf, mbk in _slot_ticks(i, s_stages, m_micro, schedule):
            if not grads and mbk >= 0:
                break
            recvs = []
            if not first and 0 <= mf < m_micro:
                recvs.append((hop, step.wdtype, -1))
            if not last and 0 <= mbk < m_micro:
                recvs.append((hop, step.wdtype, +1))
            sends = [(b, off) for b, off in ((y, +1), (dx, -1)) if b is not None]
            got = C.exchange(mesh, stage_axis, sends, recvs,
                             device=tok_mb.device)
            got = [g.to(step.cdtype) for g in got]
            x_in = got.pop(0) if recvs and recvs[0][2] == -1 else None
            g_in = got.pop(0) if got else None
            y = fwd(mf, x_in)
            dx = bwd(mbk, g_in)

        loss = C.all_reduce(step.loss_acc / m_micro if last
                            else torch.zeros_like(step.loss_acc), mesh, stage_axis)
        if not grads:
            if env_axis is not None:
                loss = C.all_reduce(loss, mesh, env_axis, "mean")
            return loss, None
        return _rank_grads(cfg, params, st, step, lo, hi, period, mesh,
                           stage_axis, env_axis, loss)

    return fn


def _rank_grads(cfg, params, st, step, lo, hi, period, mesh, stage_axis,
                env_axis, loss):
    """A rank's ``(loss, grads)`` after its stage's ticks, in its share's
    layout: its layers' rows of each slot, the final norm and head on
    the last stage, the tied embedding's two gradients summed on the
    first and the last stage, then the mean over the env shards."""
    from repro_torch.distribution import collectives as C

    i, s_stages = st.i, mesh.shape[stage_axis]
    first, last = i == 0, st.last
    layer_grads = list(zip(range(lo, hi), tree_unflatten(st.blocks, st.grads)))
    slots = []
    for j in range(period):
        mine = [g for r, g in layer_grads if r % period == j]
        slots.append(tree_stack(mine) if mine else
                     tree_map(torch.zeros_like, params["slots"][j]))
    grads = {"slots": tuple(slots)}
    if first and "frontend" in params:
        grads["frontend"] = tree_map(torch.zeros_like, params["frontend"])
    if last:
        grads["final_norm"] = step.gnorm
        if not cfg.tie_embeddings:
            grads["lm_head"] = step.ghead
    if cfg.tie_embeddings:
        # the first stage's lookup and the last stage's head gradients
        # meet: the sum, on both ranks
        if first and last:
            grads["embed"] = step.gembed + step.ghead
        elif last:
            grads["embed"] = C.exchange(
                mesh, stage_axis, [(step.ghead, -i)],
                [(tuple(step.ghead.shape), step.ghead.dtype, -i)],
                device=step.ghead.device)[0]
        elif first:
            ghead = C.exchange(
                mesh, stage_axis, [],
                [(tuple(step.gembed.shape), step.gembed.dtype, s_stages - 1)],
                device=step.gembed.device)[0]
            grads["embed"] = step.gembed + ghead
            C.exchange(mesh, stage_axis, [(grads["embed"], s_stages - 1)], [])
    elif first:
        grads["embed"] = step.gembed
    if env_axis is not None:  # the mean of the env shards' means
        loss = C.all_reduce(loss, mesh, env_axis, "mean")
        grads = tree_map(lambda g: C.all_reduce(g, mesh, env_axis, "mean"),
                         grads)
    return loss, {k: grads[k] for k in params}


# ---------------------------------------------------------------------------
# serving: the token ring over per-stage KV rings
# ---------------------------------------------------------------------------


def _attention_only(cfg: ModelConfig, what: str) -> None:
    if any(kind != "A" for kind, _, _ in M.signature(cfg)):
        raise ValueError(
            f"{what}: SSM/hybrid archs are unservable - padded batched "
            "prefill relies on causal masking, which protects KV attention "
            "but not recurrent scan state")


def stage_kv_caches(cfg: ModelConfig, boundaries: Sequence[int],
                    num_slots: int, cache_len: int, dtype=torch.float32,
                    device=None, *, mesh=None, stage_axis: str = "stage"):
    """Per-stage KV rings for pipelined serving, zero-filled.

    Returns ``{"k", "v"}`` of shape ``(S, max_len, B, kv_len, KH, hd)``,
    the reference's layout: stage ``k``'s ring holds only its own layers'
    entries (row ``i`` of stage ``k`` is global layer ``boundaries[k-1] +
    i``); the rows past a stage's length pad the layout and stay zero.
    On a stage ``mesh`` it returns this rank's ring only, the reference's
    ``P(stage)`` block: ``(1, max_len, B, kv_len, KH, hd)``."""
    from repro_torch.device import resolve_device

    _attention_only(cfg, "stage_kv_caches")
    lens = stage_lengths(boundaries)
    _check_mesh(mesh, len(lens), stage_axis, None)
    kv_len = (min(cache_len, cfg.attention_window)
              if cfg.attention_window is not None else cache_len)
    shape = (1 if mesh is not None else len(lens), max(lens), num_slots, kv_len,
             cfg.num_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _serve_stage(cfg, sig, layers, ring, x, positions, cache_index, blk_impl,
                 plan):
    """A stage's serving pass: ``layers`` (global index, block params) in
    turn over the stage's KV ring ``ring`` (``{"k", "v"}``, ``(max_len,
    B, kv_len, KH, hd)``). Returns ``x`` and the new ring, its padding
    rows kept."""
    ks, vs = [], []
    for i, (layer, blk) in enumerate(layers):
        x, nc, _ = M.block_apply(
            blk, x, cfg, sig[layer], positions=positions,
            cache={"k": ring["k"][i], "v": ring["v"][i]},
            cache_index=cache_index, impl=blk_impl, plan=plan)
        ks.append(nc["k"])
        vs.append(nc["v"])

    def kept(old, new):
        new = torch.stack(new)
        return torch.cat([new, old[len(layers):]]) if old.shape[0] > len(layers) else new

    return x, {"k": kept(ring["k"], ks), "v": kept(ring["v"], vs)}


def _serve_logits(params, cfg, x):
    """The last stage's final norm and LM head, in f32."""
    xh = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (xh @ _head(params, cfg).to(x.dtype)).float()


def pipeline_serve_fns(cfg: ModelConfig, boundaries: Sequence[int], *,
                       pipe: PipelineConfig = PipelineConfig(
                           compute_dtype="float32"),
                       mesh=None, stage_axis: str = "stage"):
    """The serving passes of a split plan: ``(prefill, decode)`` with the
    serving engine's runner signatures.

    * ``prefill(params, caches, prompts)``: ``prompts`` (B, P) ->
      ``(logits (B, P, V) f32, caches)``, a fresh-sequence pass (scalar
      cache index 0) through every stage.
    * ``decode(params, tok, caches, pos)``: ``tok`` (B, 1), ``pos`` (B,)
      per-slot entry counts -> ``(logits (B, V) f32, caches)``.

    Both run the reference's serial token ring: stage ``t`` runs its own
    layers over its own KV ring, then its output hops to stage ``t + 1``
    cast to ``pipe.wire`` and back to the compute dtype (the Eq. 1
    transmission); the last stage's final norm and LM head give the
    logits, in f32 as the reference's masked ``psum`` returns them.
    ``pipe.stage_impl="pallas"`` routes each dense MLP half-block through
    the stage kernel. Attention-only configs run, mixed periods (MoE every
    k layers) with each layer's own slot; SSM and hybrid configs and
    capacity MoE are refused as the reference refuses them.

    Without ``mesh`` every stage runs in turn in this process over the
    whole ``(S, ...)`` rings and the whole ``params``. On a stage ``mesh``
    (``launch.mesh.make_stage_mesh``) stage ``t`` runs on the rank at
    coordinate ``t`` of ``stage_axis``, over its own ring
    (``stage_kv_caches(mesh=)``) and its share of the parameters
    (:func:`stage_params`); every rank passes the same tokens. The hop
    into stage ``t`` is a point-to-point transfer of the wire-dtype
    activation from rank ``t - 1``, and the logits come off the last
    stage in one broadcast, so every rank holds the same f32 logits, bit
    for bit: the value of the reference's masked sum, whose other terms
    are exact zeros. A rank's transfers depend only on its stage, never on
    which slots are live (the reference keeps its hops outside every
    ``cond`` for the same reason)."""
    _attention_only(cfg, "pipeline serving")
    sig = M.signature(cfg)
    if any(is_moe for _, is_moe, _ in sig) and cfg.moe.dispatch != "dropless":
        raise ValueError(
            "pipeline serving: capacity-dropping MoE is unservable (padded "
            "prefill rows steal expert capacity from real rows); set "
            "moe.dispatch='dropless'")
    period = M.find_period(sig)
    ranges = _stage_ranges(cfg, boundaries)
    _check_mesh(mesh, len(ranges), stage_axis, None)
    blk_impl, cdtype, wdtype = pipe.block_impl, pipe.dtype, pipe.wire

    def ring_pass(params, caches, x, positions, cache_index):
        plan = L.cache_plan(cfg, positions, cache_index, x.shape[0], x.shape[1],
                            caches["k"].shape[3])
        new = []
        for t, (lo, hi) in enumerate(ranges):
            if t > 0:  # the hop: wire-dtype bytes
                x = x.to(wdtype).to(cdtype)
            layers = [(r, _layer_params(params, r, period)) for r in range(lo, hi)]
            x, ring = _serve_stage(cfg, sig, layers,
                                   {"k": caches["k"][t], "v": caches["v"][t]},
                                   x, positions, cache_index, blk_impl, plan)
            new.append(ring)
        return _serve_logits(params, cfg, x), {
            k: torch.stack([r[k] for r in new]) for k in ("k", "v")}

    if mesh is not None:
        ring_pass = _rank_ring_pass(cfg, sig, ranges, period, pipe, mesh,
                                    stage_axis)

    def prefill(params, caches, prompts):
        x = None if "embed" not in params else params["embed"].to(cdtype)[prompts.long()]
        positions = torch.arange(prompts.shape[1], device=prompts.device)
        with torch.inference_mode():
            return ring_pass(params, caches, x, positions, 0)

    def decode(params, tok, caches, pos):
        x = None if "embed" not in params else params["embed"].to(cdtype)[tok.long()]
        pos = pos.long()
        with torch.inference_mode():
            logits, caches = ring_pass(params, caches, x, pos[:, None], pos)
        return logits[:, -1], caches

    return prefill, decode


def _rank_ring_pass(cfg, sig, ranges, period, pipe, mesh, stage_axis):
    """:func:`pipeline_serve_fns`' ring on a stage mesh: this rank's
    stage. ``x`` is the embedded input on the first stage (the other
    stages receive theirs); its batch and length come from ``positions``
    and the ring."""
    from repro_torch.distribution import collectives as C

    s_stages = len(ranges)
    i = mesh.axis_index(stage_axis)
    lo, hi = ranges[i]
    first, last = i == 0, i == s_stages - 1
    rows = _slot_rows(lo, hi, period)

    def ring_pass(params, caches, x, positions, cache_index):
        b, s = caches["k"].shape[2], positions.shape[-1]
        dev = caches["k"].device
        plan = L.cache_plan(cfg, positions, cache_index, b, s, caches["k"].shape[3])
        if not first:  # the hop in from the previous stage
            x = C.exchange(mesh, stage_axis, [],
                           [((b, s, cfg.d_model), pipe.wire, -1)],
                           device=dev)[0].to(pipe.dtype)
        layers = [(r, M.layer_params(params["slots"][r % period],
                                     r // period - rows[r % period][0]))
                  for r in range(lo, hi)]
        x, ring = _serve_stage(cfg, sig, layers,
                               {"k": caches["k"][0], "v": caches["v"][0]}, x,
                               positions, cache_index, pipe.block_impl, plan)
        if last:
            logits = _serve_logits(params, cfg, x)
        else:
            C.exchange(mesh, stage_axis, [(x.to(pipe.wire), +1)], [])
            logits = torch.empty((b, s, cfg.vocab_size), dtype=torch.float32,
                                 device=dev)
        logits = C.broadcast(logits, mesh, stage_axis, src=s_stages - 1)
        return logits, {k: v[None] for k, v in ring.items()}

    return ring_pass
