"""Model backends for the serving engine.

Port of ``repro.serving.runners``. A runner exposes the two functions the
engine composes into its step:

* ``prefill(params, caches, prompts)``: ``prompts`` (B, P) ->
  ``(logits (B, P, V), new_caches)``, a fresh-sequence pass (scalar cache
  index 0). The engine gathers each row's logits at its own prompt length
  and merges the cache rows of the slots it admitted (:func:`cache_where`).
* ``decode(params, tok, caches, pos)``: ``tok`` (B, 1), ``pos`` (B,)
  per-slot entry counts -> ``(logits (B, V), new_caches)``, one token per
  slot at each slot's OWN position (slot-indexed KV writes,
  ``models.layers.cache_plan``).

Both backends take attention-only architectures (MoE under DROPLESS
dispatch): the padded batched prefill relies on causal masking to keep
pad garbage out of valid rows, which holds for KV caches but not for SSM
recurrent state, nor for capacity-bounded MoE routing (pad tokens would
take expert capacity from real rows; dropless dispatch computes every
routed token).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.tree import tree_map

Tensor = torch.Tensor


def check_servable(cfg: ModelConfig) -> None:
    """Raise for architectures the serving engine cannot run correctly:
    SSM and hybrid (a padded prefill would pollute the recurrent state)
    and capacity-dropping MoE."""
    sig = M.signature(cfg)
    if any(kind != "A" for kind, _, _ in sig):
        raise ValueError(
            "serving engine: SSM/hybrid archs are unservable - padded "
            "batched prefill is masked out of KV attention but would "
            "pollute the recurrent scan state")
    if any(is_moe for _, is_moe, _ in sig) and cfg.moe.dispatch != "dropless":
        raise ValueError(
            "serving engine: capacity-dropping MoE is unservable (padded "
            "prefill rows steal expert capacity from real rows); set "
            "moe.dispatch='dropless'")


class SingleDeviceRunner:
    """The whole model on one device; caches are the stacked per-layer
    rings of ``models.model.init_caches``. ``device`` is ``cuda`` unless
    the caller asks for the CPU."""

    def __init__(self, cfg: ModelConfig, *, compute_dtype=torch.float32,
                 device: DeviceLike = None):
        check_servable(cfg)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)

    def init_caches(self, num_slots: int, cache_len: int):
        return M.init_caches(self.cfg, num_slots, cache_len,
                             dtype=self.compute_dtype, device=self.device)

    def prefill(self, params, caches, prompts):
        logits, new_caches, _ = M.forward(
            params, prompts, self.cfg, caches=caches, cache_index=0,
            compute_dtype=self.compute_dtype)
        return logits, new_caches

    def decode(self, params, tok, caches, pos):
        logits, new_caches, _ = M.forward(
            params, tok, self.cfg, caches=caches, cache_index=pos,
            compute_dtype=self.compute_dtype)
        return logits[:, -1], new_caches


class PipelineRunner:
    """A split plan served stage by stage: per-stage KV rings, hops cast
    to the wire dtype.

    ``boundaries`` is the split plan's cumulative cut points (the Eq. 10
    decision variable); each stage holds only its own layers' KV ring and
    activations cross stage boundaries in ``pipe.wire`` dtype
    (:func:`repro_torch.core.pipeline.pipeline_serve_fns`). Without a
    ``mesh`` the stages run in turn in this process on ``device``. On a
    stage ``mesh`` (``launch.mesh.make_stage_mesh(len(boundaries))``, as
    the reference places its stages) stage ``t`` runs on the rank at
    coordinate ``t`` of ``stage_axis``, on the mesh's device unless
    ``device`` is given: :meth:`init_caches` returns this rank's ring, the
    passes take this rank's :func:`~repro_torch.core.pipeline.stage_params`
    share, and every rank gets the same logits."""

    def __init__(self, cfg: ModelConfig, boundaries: Sequence[int], *,
                 pipe=None, device: DeviceLike = None, mesh=None,
                 stage_axis: str = "stage"):
        from repro_torch.core.pipeline import PipelineConfig, pipeline_serve_fns

        check_servable(cfg)
        if pipe is None:
            pipe = PipelineConfig(compute_dtype="float32")
        self.cfg = cfg
        self.boundaries = tuple(int(b) for b in boundaries)
        self.pipe = pipe
        self.mesh = mesh
        self.stage_axis = stage_axis
        self.compute_dtype = pipe.dtype
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        self._prefill, self._decode = pipeline_serve_fns(
            cfg, self.boundaries, pipe=pipe, mesh=mesh, stage_axis=stage_axis)

    def init_caches(self, num_slots: int, cache_len: int):
        from repro_torch.core.pipeline import stage_kv_caches

        return stage_kv_caches(self.cfg, self.boundaries, num_slots, cache_len,
                               dtype=self.compute_dtype, device=self.device,
                               mesh=self.mesh, stage_axis=self.stage_axis)

    def prefill(self, params, caches, prompts):
        return self._prefill(params, caches, prompts)

    def decode(self, params, tok, caches, pos):
        return self._decode(params, tok, caches, pos)


def cache_where(mask: Tensor, new_caches, old_caches):
    """Per-slot cache select: ``mask`` (B,) picks NEW rows, else old.

    The slot axis sits left of (kv_len, KH, hd) in both runner layouts:
    axis -4."""

    def one(n, o):
        m = mask.reshape((1,) * (n.dim() - 4) + (-1, 1, 1, 1))
        return torch.where(m, n, o)

    return tree_map(one, new_caches, old_caches)
