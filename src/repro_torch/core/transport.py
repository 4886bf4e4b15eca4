"""Structural transport accounting for the split executor.

Port of ``repro.core.transport`` (host numpy, as in the reference). It
prices the 1F1B executor's stage hops from the same physics as the
Eq. 10/11 plan oracle (``splitting.plan_cost_parts``): per-stage compute
times from Eqs. 8-9 and per-hop transmission times from Eqs. 5-7 at each
hop's link bandwidth plus its fixed link latency.

Two transports of the 1F1B schedule are modelled:

* ``"sync"`` - every tick pays its compute, then its hops
  (tick = compute + transport).
* ``"overlap"`` - double-buffered handoff: a tick pays
  ``max(compute, transport)``, the transport being the buffer in flight
  from the previous tick.

At M = 1 the synchronous wall-time model equals ``plan_cost``'s Eq. 10
delay: the same per-stage and per-hop terms, with nothing to overlap.
Under a :class:`repro_torch.core.faults.FaultSchedule`,
:func:`faulted_transport_model` prices degraded links and stragglers and
:func:`simulate_1f1b_faulted` stalls ticks through outages; a fault-free
schedule reproduces the plain model and simulator exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.profiles import LayerProfile
from repro_torch.core.splitting import SplitPlan, plan_cost_parts


@dataclass(frozen=True)
class TransportModel:
    """Per-stage / per-hop cost terms of one plan under one link model.

    Compute and transmission terms are per iteration (the whole batch, as
    in ``plan_cost``); the simulators divide them by M for per-microbatch
    slots. ``hop_latency`` is paid once per microbatch per hop.
    """

    t_comp_fwd: np.ndarray  # (S,)   Eq. 8 stage forward time
    t_comp_bwd: np.ndarray  # (S,)   Eq. 9 stage backward time
    t_tx_fwd: np.ndarray  # (S-1,) activation transmission time (no latency)
    t_tx_bwd: np.ndarray  # (S-1,) cotangent transmission time (no latency)
    hop_latency: np.ndarray  # (S-1,) fixed per-transmission link latency

    @property
    def num_stages(self) -> int:
        return len(self.t_comp_fwd)


def plan_transport_model(profile: LayerProfile, plan: SplitPlan,
                         positions: np.ndarray, p_tx: np.ndarray,
                         decoy_power: np.ndarray, net) -> TransportModel:
    """The executor's transport model from the plan-cost breakdown.

    ``net`` is a ``NetworkConfig`` or a ``ScenarioParams``. The terms come
    from :func:`repro_torch.core.splitting.plan_cost_parts`, so the model
    and the plan oracle agree on hop physics by construction.
    """
    parts = plan_cost_parts(profile, plan, positions, p_tx, decoy_power, net)
    s = plan.num_stages
    lat = net.hop_latency_s
    if isinstance(lat, torch.Tensor):
        lat = lat.cpu().numpy()
    lat = np.asarray(lat, np.float64)[: s - 1]
    return TransportModel(
        t_comp_fwd=parts["t_comp_fwd"],
        t_comp_bwd=parts["t_comp_bwd"],
        t_tx_fwd=parts["t_hop_fwd"] - lat,
        t_tx_bwd=parts["t_hop_bwd"] - lat,
        hop_latency=lat,
    )


def faulted_transport_model(profile: LayerProfile, plan: SplitPlan,
                            positions: np.ndarray, p_tx: np.ndarray,
                            decoy_power: np.ndarray, sp,
                            schedule) -> TransportModel:
    """Transport model under a fault schedule.

    Link degradation folds through ``faults.degrade_scenario`` before the
    plan-cost breakdown: the same degraded ``ScenarioParams`` that
    ``plan_cost`` and the scorer price, so at M = 1 sync the executor's
    delay under partial outage equals Eq. 10's. Per-device straggler
    factors then scale each stage's compute terms through the plan's
    device assignment. A ``fault_free`` schedule is a bit-exact no-op."""
    from repro_torch.core.faults import degrade_scenario

    model = plan_transport_model(profile, plan, positions, p_tx, decoy_power,
                                 degrade_scenario(sp, schedule))
    slow = schedule.compute_slowdown.cpu().numpy().astype(np.float64)
    devs = np.asarray(plan.devices, np.int64)
    return TransportModel(
        t_comp_fwd=model.t_comp_fwd * slow[devs],
        t_comp_bwd=model.t_comp_bwd * slow[devs],
        t_tx_fwd=model.t_tx_fwd,
        t_tx_bwd=model.t_tx_bwd,
        hop_latency=model.hop_latency,
    )


def tick_costs(model: TransportModel, m: int):
    """Per-tick (compute, transport) seconds of the 1F1B schedule.

    At tick ``t`` stage ``i`` forwards microbatch ``t - i`` and backwards
    microbatch ``t - 2(S-1) + i``; stages run in parallel (a tick's
    compute is the max over stages, a stage's two slots are serial), and
    every active hop transmits concurrently (a tick's transport is the max
    over active hops). Returns two ``(n_ticks,)`` arrays with
    ``n_ticks = M + 2(S-1)``.
    """
    s = model.num_stages
    n_ticks = m + 2 * (s - 1)
    fwd_c = model.t_comp_fwd / m
    bwd_c = model.t_comp_bwd / m
    hop_f = model.t_tx_fwd / m + model.hop_latency
    hop_b = model.t_tx_bwd / m + model.hop_latency
    compute = np.zeros(n_ticks)
    transport = np.zeros(n_ticks)
    for t in range(n_ticks):
        per_stage = np.zeros(s)
        for i in range(s):
            if 0 <= t - i < m:  # forward slot (last stage: inside its VJP)
                per_stage[i] += fwd_c[i]
            if 0 <= t - 2 * (s - 1) + i < m:  # backward slot
                per_stage[i] += bwd_c[i]
        compute[t] = per_stage.max()
        tr = 0.0
        for k in range(s - 1):
            if 0 <= t - k < m:  # forward hop k: stage k -> k+1
                tr = max(tr, hop_f[k])
            if 0 <= t - 2 * (s - 1) + (k + 1) < m:  # cotangent hop k+1 -> k
                tr = max(tr, hop_b[k])
        transport[t] = tr
    return compute, transport


def simulate_1f1b(model: TransportModel, m: int, *,
                  transport: str = "overlap") -> dict:
    """Simulated 1F1B wall time under the link model.

    ``transport="sync"``: tick = compute + transport. ``"overlap"``: tick
    = max(compute, in-flight transport), the in-flight buffer being the
    previous tick's. Returns total/compute/transport seconds, the per-tick
    array and the bubble fraction (idle stage-slots over all stage-slots).
    """
    if transport not in ("sync", "overlap"):
        raise ValueError(f"unknown transport {transport!r}")
    s = model.num_stages
    compute, tr = tick_costs(model, m)
    n_ticks = len(compute)
    if transport == "sync":
        per_tick = compute + tr
    else:
        in_flight = np.concatenate([[0.0], tr[:-1]])
        per_tick = np.maximum(compute, in_flight)
    # each of the n_ticks*S stage-ticks has a forward and a backward slot;
    # exactly 2*M*S of them do real work
    active_slots = sum(
        (0 <= t - i < m) + (0 <= t - 2 * (s - 1) + i < m)
        for t in range(n_ticks) for i in range(s)
    )
    return {
        "transport": transport,
        "ticks": n_ticks,
        "total_s": float(per_tick.sum()),
        "compute_s": float(compute.sum()),
        "transport_s": float(tr.sum()),
        "per_tick_s": per_tick,
        "bubble_fraction": 1.0 - active_slots / (2.0 * s * n_ticks),
    }


def simulate_1f1b_faulted(model: TransportModel, m: int, schedule, devices, *,
                          transport: str = "overlap",
                          t_start: float = 0.0) -> dict:
    """:func:`simulate_1f1b` under outage windows.

    ``devices`` is the plan's stage -> device assignment; a tick whose
    start time falls inside an assigned device's outage window stalls
    until the last such device recovers (the executor retries the hop
    until its peer is back), then pays its normal cost. Per-tick costs
    should come from :func:`faulted_transport_model`, so link degradation
    and stragglers are already priced in. Returns the
    :func:`simulate_1f1b` dict plus ``stall_s`` / ``per_tick_stall_s``; a
    ``fault_free`` schedule reproduces :func:`simulate_1f1b` exactly."""
    from repro_torch.core import faults as F

    base = simulate_1f1b(model, m, transport=transport)
    per_tick = np.asarray(base["per_tick_s"], np.float64)
    host = schedule.to("cpu")
    devs = np.asarray(devices, np.int64)
    stalls = np.zeros_like(per_tick)
    t = float(t_start)
    for i, cost in enumerate(per_tick):
        stalls[i] = float(F.outage_stall(host, t, devs))
        t += stalls[i] + float(cost)
    out = dict(base)
    out["per_tick_stall_s"] = stalls
    out["stall_s"] = float(stalls.sum())
    out["total_s"] = float(per_tick.sum() + stalls.sum())
    return out
