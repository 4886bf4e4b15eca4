"""Deterministic fault injection for the unreliable wireless edge.

Port of ``repro.core.faults``. Faults are an explicit, replayable input:

* :class:`FaultSchedule` - per-device outage windows, per-hop link
  bandwidth and latency degradation, and per-device straggler factors,
  as f32 tensors. Like ``ScenarioParams`` it is an argument: a schedule
  changes no code path.
* :class:`FaultClock` - the one mapping from executor ticks or the
  serving service's virtual time onto the schedule's time axis, so the
  1F1B transport simulator and the serving loop read the same windows.
* :func:`degrade_scenario` - folds the link degradation into a
  ``ScenarioParams``, so the Eq. 10/11 plan oracle, the transport tick
  model and the online re-planner price a partial outage from one source.

Schedules are hand-built (:func:`fault_free`, :func:`make_schedule`,
:func:`reference_schedule`) or sampled (:func:`sample_fault_schedule`).
``jax.random`` streams cannot be replayed in torch, so the sampler takes
its uniforms (:class:`FaultDraws`) where the reference takes a key, or
draws them from a ``torch.Generator``: the same draws give the same
schedule, bit for bit. A schedule lies on ``device`` (``cuda`` unless
the caller asks for the CPU); the host-side consumers (the transport
simulator, the serving loop) read a host copy once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor

_INF = float("inf")


class FaultSchedule(NamedTuple):
    """Fault state of one deployment (all leaves f32 tensors).

    ``D`` devices (the env's ``U`` trainers plus the server as row
    ``U``), ``W`` outage windows per device, ``H`` inter-stage hops
    (``max_split - 1``, matching ``ScenarioParams.hop_bandwidth_hz``).
    Unused windows are ``[inf, inf)`` and match no time.
    """

    outage_start: Tensor  # (D, W) seconds; inf = unused window
    outage_end: Tensor    # (D, W) seconds (half-open [start, end))
    hop_bandwidth_scale: Tensor  # (H,) multiplier in (0, 1] on link bandwidth
    hop_latency_add_s: Tensor    # (H,) added fixed per-hop latency (s)
    compute_slowdown: Tensor     # (D,) straggler multiplier >= 1 on compute

    @property
    def num_devices(self) -> int:
        return self.outage_start.shape[-2]

    @property
    def num_windows(self) -> int:
        return self.outage_start.shape[-1]

    @property
    def num_hops(self) -> int:
        return self.hop_bandwidth_scale.shape[-1]

    def to(self, device: DeviceLike) -> "FaultSchedule":
        return FaultSchedule(*(x.to(device) for x in self))


def fault_free(num_devices: int, num_hops: int, num_windows: int = 1,
               device: DeviceLike = None) -> FaultSchedule:
    """The no-op schedule: no outages, unit link scale, no stragglers.

    Every query under it reproduces the fault-free numbers bit-exactly
    (``degrade_scenario`` multiplies by 1.0 and adds 0.0 in f32)."""
    dev = resolve_device(device)
    return FaultSchedule(
        outage_start=torch.full((num_devices, num_windows), _INF, device=dev),
        outage_end=torch.full((num_devices, num_windows), _INF, device=dev),
        hop_bandwidth_scale=torch.ones((num_hops,), device=dev),
        hop_latency_add_s=torch.zeros((num_hops,), device=dev),
        compute_slowdown=torch.ones((num_devices,), device=dev),
    )


def make_schedule(
    num_devices: int,
    num_hops: int,
    *,
    outages: Sequence[Tuple[int, float, float]] = (),
    hop_bandwidth_scale: Optional[Sequence[float]] = None,
    hop_latency_add_s: Optional[Sequence[float]] = None,
    compute_slowdown: Optional[Sequence[float]] = None,
    num_windows: Optional[int] = None,
    device: DeviceLike = None,
) -> FaultSchedule:
    """Hand-built schedule: ``outages`` is a list of ``(device, start_s,
    end_s)`` windows; the degradation vectors default to the fault-free
    values."""
    per_dev: dict = {}
    for dev, t0, t1 in outages:
        if not 0 <= dev < num_devices:
            raise ValueError(f"outage device {dev} not in [0, {num_devices})")
        if not t1 > t0:
            raise ValueError(f"outage window [{t0}, {t1}) is empty")
        per_dev.setdefault(int(dev), []).append((float(t0), float(t1)))
    w = max([len(v) for v in per_dev.values()] + [1])
    if num_windows is not None:
        if num_windows < w:
            raise ValueError(
                f"num_windows={num_windows} < {w} windows on one device")
        w = num_windows
    start = np.full((num_devices, w), _INF, np.float32)
    end = np.full((num_devices, w), _INF, np.float32)
    for dev, wins in per_dev.items():
        for i, (t0, t1) in enumerate(sorted(wins)):
            start[dev, i] = t0
            end[dev, i] = t1
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    base = fault_free(num_devices, num_hops, w, device=dev)
    return base._replace(
        outage_start=f32(start),
        outage_end=f32(end),
        hop_bandwidth_scale=(base.hop_bandwidth_scale if hop_bandwidth_scale is None
                             else f32(hop_bandwidth_scale)),
        hop_latency_add_s=(base.hop_latency_add_s if hop_latency_add_s is None
                           else f32(hop_latency_add_s)),
        compute_slowdown=(base.compute_slowdown if compute_slowdown is None
                          else f32(compute_slowdown)),
    )


class FaultDraws(NamedTuple):
    """The uniforms in [0, 1) of one sampled schedule: ``on`` (D, W) (an
    outage where ``on < outage_prob``: the reference's ``bernoulli``),
    ``t0`` and ``length`` (D, W), ``bandwidth`` and ``latency`` (H,),
    ``slowdown`` (D,)."""

    on: Tensor
    t0: Tensor
    length: Tensor
    bandwidth: Tensor
    latency: Tensor
    slowdown: Tensor


def draw_faults(gen: torch.Generator, num_devices: int, num_hops: int,
                num_windows: int = 1) -> FaultDraws:
    """The uniforms of :func:`sample_fault_schedule` from ``gen``, on its
    device."""
    shape = (num_devices, num_windows)

    def u(s):
        return torch.rand(s, generator=gen, device=gen.device)

    return FaultDraws(on=u(shape), t0=u(shape), length=u(shape),
                      bandwidth=u((num_hops,)), latency=u((num_hops,)),
                      slowdown=u((num_devices,)))


def _uniform(u: Tensor, lo: float, hi: float) -> Tensor:
    """``jax.random.uniform``'s map of [0, 1) onto [lo, hi) in f32:
    ``max(lo, u * (hi - lo) + lo)`` with one rounding of the
    multiply-add, as XLA fuses it (the f32 product is exact in f64)."""
    lo = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi = torch.tensor(hi, dtype=torch.float32, device=u.device)
    fma = (u.double() * (hi - lo).double() + lo.double()).to(torch.float32)
    return torch.maximum(lo, fma)


def sample_fault_schedule(
    draws,
    num_devices: int,
    num_hops: int,
    *,
    horizon_s: float,
    num_windows: int = 1,
    outage_prob: float = 0.3,
    outage_len_s: Tuple[float, float] = (0.05, 0.5),
    bandwidth_scale: Tuple[float, float] = (0.5, 1.0),
    latency_add_s: Tuple[float, float] = (0.0, 0.0),
    slowdown: Tuple[float, float] = (1.0, 1.0),
) -> FaultSchedule:
    """Random schedule: each (device, window) slot is an outage with
    probability ``outage_prob``, starting uniformly in the horizon with a
    uniform length; the hop and straggler degradations draw uniformly
    from their ranges. ``draws`` is a :class:`FaultDraws` or a
    ``torch.Generator`` (its :func:`draw_faults`); the same draws give the
    same schedule, bit for bit (the replay contract chaos runs lean on).
    The schedule lies where the draws do."""
    if isinstance(draws, torch.Generator):
        draws = draw_faults(draws, num_devices, num_hops, num_windows)
    on = draws.on < outage_prob
    t0 = _uniform(draws.t0, 0.0, horizon_s)
    ln = _uniform(draws.length, *outage_len_s)
    inf = torch.tensor(_INF, device=on.device)
    return FaultSchedule(
        outage_start=torch.where(on, t0, inf).to(torch.float32),
        outage_end=torch.where(on, t0 + ln, inf).to(torch.float32),
        hop_bandwidth_scale=_uniform(draws.bandwidth, *bandwidth_scale),
        hop_latency_add_s=_uniform(draws.latency, *latency_add_s),
        compute_slowdown=_uniform(draws.slowdown, *slowdown),
    )


def reference_schedule(num_devices: int, num_hops: int, *,
                       tick_seconds: float = 0.02,
                       device: DeviceLike = None) -> FaultSchedule:
    """The fixed reference schedule of the chaos checks: device 0 drops
    out for ticks [4, 9) of the serving fault clock, every hop runs at 80%
    bandwidth."""
    return make_schedule(
        num_devices, num_hops,
        outages=[(0, 4 * tick_seconds, 9 * tick_seconds)],
        hop_bandwidth_scale=[0.8] * num_hops, device=device,
    )


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def _t(schedule: FaultSchedule, t) -> Tensor:
    return torch.as_tensor(t, dtype=torch.float32,
                           device=schedule.outage_start.device)


def device_up(schedule: FaultSchedule, t) -> Tensor:
    """(D,) bool mask: the device is outside every outage window at ``t``."""
    t = _t(schedule, t)
    down = ((t >= schedule.outage_start) & (t < schedule.outage_end)).any(dim=-1)
    return ~down


def next_recovery(schedule: FaultSchedule, t, devices=None) -> Tensor:
    """Earliest time >= ``t`` at which every (selected) device is up.

    ``devices`` selects rows (default: all). Returns ``t`` itself when
    nothing is down, so a caller can jump a virtual clock to the end of an
    outage instead of spinning."""
    start, end = schedule.outage_start, schedule.outage_end
    if devices is not None:
        idx = torch.as_tensor(np.asarray(devices, np.int64), device=start.device)
        start, end = start[idx], end[idx]
    t = _t(schedule, t)
    covering = (t >= start) & (t < end)
    return torch.maximum(t, torch.where(covering, end, -_INF).max())


def outage_stall(schedule: FaultSchedule, t, devices) -> Tensor:
    """Seconds a step starting at ``t`` on ``devices`` stalls before all of
    them are back up (0.0 when none is down)."""
    return next_recovery(schedule, t, devices) - _t(schedule, t)


def degrade_scenario(sp, schedule: FaultSchedule):
    """Fold the schedule's link degradation into a ``ScenarioParams``.

    Hop ``k`` runs at ``hop_bandwidth_hz[k] * hop_bandwidth_scale[k]`` and
    pays ``hop_latency_s[k] + hop_latency_add_s[k]``: the per-hop link
    model Eq. 10/11 already price, so ``plan_cost``, the plan scorer, the
    split oracle and the transport tick model all see one degraded
    physics. A ``fault_free`` schedule is a bit-exact no-op."""
    from repro_torch.core.scenario import scale_param, shift_param

    h = sp.hop_bandwidth_hz.shape[-1]
    if schedule.num_hops != h:
        raise ValueError(
            f"schedule has {schedule.num_hops} hops, scenario has {h}")
    sp = scale_param(sp, "hop_bandwidth_hz", schedule.hop_bandwidth_scale)
    return shift_param(sp, "hop_latency_s", schedule.hop_latency_add_s)


# ---------------------------------------------------------------------------
# the tick <-> schedule-time mapping
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultClock:
    """Maps executor ticks / serving virtual time onto the schedule.

    ``tick_seconds > 0``: schedule time is ``tick * tick_seconds``,
    independent of the host's wall clock (the chaos checks' clock).
    ``tick_seconds == 0``: schedule time is the caller's virtual ``now``
    (the serving loop's arrival clock).
    """

    tick_seconds: float = 0.0

    def time_of(self, tick: int, now: float = 0.0) -> float:
        if self.tick_seconds > 0:
            return tick * self.tick_seconds
        return now

    def ticks_until(self, t_now: float, t_target: float) -> int:
        """Whole ticks from ``t_now`` until ``t_target`` has passed (at
        least 1; only meaningful for tick-driven clocks)."""
        if self.tick_seconds <= 0:
            return 1
        return max(int(math.ceil((t_target - t_now) / self.tick_seconds)), 1)


__all__ = [
    "FaultClock",
    "FaultDraws",
    "FaultSchedule",
    "degrade_scenario",
    "device_up",
    "draw_faults",
    "fault_free",
    "make_schedule",
    "next_recovery",
    "outage_stall",
    "reference_schedule",
    "sample_fault_schedule",
]
