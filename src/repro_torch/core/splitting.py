"""Split plans: partition a LayerProfile into S sequential stages.

Port of ``repro.core.splitting``. A plan is ``boundaries`` = cumulative
layer counts [c_1 < ... < c_S = L]: stage k holds layers
[c_{k-1}, c_k). ``devices`` maps stage -> device id (device U == the
server, which always holds the last stage).

Two scoring paths share one :class:`repro_torch.core.profiles.ProfileTable`:

* :func:`plan_cost` - the host reference: one plan at a time, float64
  stage sums from the cumulative tables and Python-float accumulation,
  with each hop's rate and transmission time in f32 through
  ``core.channel`` (as the reference evaluates them in jnp).
* :func:`score_plans` / :func:`make_plan_scorer` - the batched scorer:
  the whole plan batch (e.g. every ``(L-1 choose S-1)`` cut enumeration
  from :func:`stack_boundaries`) is priced in one vectorised pass of
  tensor operations over the plan axis, on the scorer's device, from the
  cumulative tables cast to f32. The network argument is a
  ``NetworkConfig`` (converted by ``scenario_from_net``) or a
  ``ScenarioParams``. Nothing is traced or compiled, so the reference's
  ``trace_count`` / ``jitted`` audit has no counterpart: the work of a
  call is a fixed sequence of operations whatever the number of plans.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.channel import (
    NetworkConfig,
    compute_energy,
    compute_time_bwd,
    compute_time_fwd,
    data_rate,
    state_energy,
    state_time,
    tx_time,
)
from repro_torch.core.profiles import LayerProfile, profile_digest, profile_table
from repro_torch.core.scenario import ScenarioParams, scenario_from_net
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor
F32 = torch.float32


@dataclass(frozen=True)
class SplitPlan:
    boundaries: Tuple[int, ...]  # cumulative, last == L
    devices: Tuple[int, ...]  # stage -> device id (len S; last is server id)

    @property
    def num_stages(self) -> int:
        return len(self.boundaries)

    def stage_range(self, k: int) -> Tuple[int, int]:
        lo = 0 if k == 0 else self.boundaries[k - 1]
        return lo, self.boundaries[k]


def stage_sums(profile: LayerProfile, boundaries: Sequence[int], field: str) -> np.ndarray:
    arr = getattr(profile, field)
    out = []
    lo = 0
    for hi in boundaries:
        out.append(arr[lo:hi].sum())
        lo = hi
    return np.asarray(out)


def boundary_bits(profile: LayerProfile, boundaries: Sequence[int], field: str) -> np.ndarray:
    """Bits transmitted at each inter-stage hop (S-1 hops).

    Hop k carries the activation emitted by the last layer of stage k.
    """
    arr = getattr(profile, field)
    return np.asarray([arr[b - 1] * 8.0 for b in boundaries[:-1]])


def _hop_link(net, num_hops: int):
    """Per-hop (bandwidth_hz, latency_s) of the first ``num_hops`` links.

    Duck-typed over ``NetworkConfig`` (numpy) and ``ScenarioParams``
    (tensors); both are sized ``max_split - 1``, which bounds the hop
    count of any feasible plan.
    """
    bw, lat = net.hop_bandwidth_hz, net.hop_latency_s
    if bw.shape[-1] < num_hops:
        raise ValueError(
            f"link model has {bw.shape[-1]} hops, plan needs {num_hops}")
    return bw[:num_hops], lat[:num_hops]


def plan_cost_parts(
    profile: LayerProfile,
    plan: SplitPlan,
    positions: np.ndarray,  # (U+1, 2) device positions (last row = server)
    p_tx: np.ndarray,  # (S-1,) trainer power per forward hop
    decoy_power: np.ndarray,  # (S-1, U+1) decoy powers per hop (0 = inactive)
    net: NetworkConfig,
) -> dict:
    """Per-stage / per-hop breakdown of :func:`plan_cost` (host floats).

    Returns ``t_comp_fwd``/``t_comp_bwd`` ``(S,)`` stage compute times,
    ``t_hop_fwd``/``t_hop_bwd`` ``(S-1,)`` per-hop transmission times
    (Eq. 6-7 at the hop's link bandwidth, plus its fixed link latency),
    and ``e_comp``/``e_tx`` energies. ``core.transport`` builds its tick
    model from these, which pins the executor's simulated time to the
    Eq. 10/11 oracle.
    """
    s = plan.num_stages
    tab = profile_table(profile)
    b = np.asarray(plan.boundaries, np.int64)
    lo = np.concatenate([[0], b[:-1]])
    fwd = tab.fwd_cum[b] - tab.fwd_cum[lo]
    bwd = tab.bwd_cum[b] - tab.bwd_cum[lo]
    state = tab.state_cum[b] - tab.state_cum[lo]
    act_bits = tab.act_bits[b[:-1] - 1]
    grad_bits = tab.grad_bits[b[:-1] - 1]
    hop_bw, hop_lat = _hop_link(net, s - 1)
    positions = np.asarray(positions)
    # each hop's f32 physics runs where a ScenarioParams' leaves live
    dev = net.bandwidth_hz.device if isinstance(net, ScenarioParams) else None

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    t_comp_fwd = np.zeros(s)
    t_comp_bwd = np.zeros(s)
    e_comp = 0.0
    for k in range(s):
        # resident-state maintenance folds into both stage compute terms,
        # so the transport tick model and the Eq. 10 total agree
        t_state = float(state_time(state[k], net))
        t_comp_fwd[k] = float(compute_time_fwd(fwd[k], net)) + t_state
        t_comp_bwd[k] = float(compute_time_bwd(bwd[k], net)) + t_state
        e_comp += float(compute_energy(fwd[k] + bwd[k], net))
        e_comp += 2.0 * float(state_energy(state[k], net))  # fwd + bwd touch
    t_hop_fwd = np.zeros(max(s - 1, 0))
    t_hop_bwd = np.zeros(max(s - 1, 0))
    e_tx = 0.0
    for k in range(s - 1):
        tx, rx = plan.devices[k], plan.devices[k + 1]
        d_tx_rx = float(np.linalg.norm(positions[tx] - positions[rx]))
        d_dec_rx = np.linalg.norm(positions - positions[rx], axis=1)
        bw = float(hop_bw[k])
        # forward hop
        r = data_rate(f32(p_tx[k]), f32(d_tx_rx), f32(decoy_power[k]),
                      f32(d_dec_rx), net, bandwidth_hz=bw)
        t_f = float(tx_time(f32(act_bits[k]), r)) + float(hop_lat[k])
        # gradient hop (reverse direction, same powers; decoys priced at
        # the transmitter)
        d_dec_tx = np.linalg.norm(positions - positions[tx], axis=1)
        r_b = data_rate(f32(p_tx[k]), f32(d_tx_rx), f32(decoy_power[k]),
                        f32(d_dec_tx), net, bandwidth_hz=bw)
        t_b = float(tx_time(f32(grad_bits[k]), r_b)) + float(hop_lat[k])
        t_hop_fwd[k] = t_f
        t_hop_bwd[k] = t_b
        # the radio is on for the whole hop (latency included)
        e_tx += (float(p_tx[k]) + float(np.sum(decoy_power[k]))) * (t_f + t_b)
    return {
        "t_comp_fwd": t_comp_fwd, "t_comp_bwd": t_comp_bwd,
        "t_hop_fwd": t_hop_fwd, "t_hop_bwd": t_hop_bwd,
        "e_comp": e_comp, "e_tx": e_tx,
    }


def plan_cost(
    profile: LayerProfile,
    plan: SplitPlan,
    positions: np.ndarray,  # (U+1, 2) device positions (last row = server)
    p_tx: np.ndarray,  # (S-1,) trainer power per forward hop
    decoy_power: np.ndarray,  # (S-1, U+1) decoy powers per hop (0 = inactive)
    net: NetworkConfig,
):
    """Total delay (Eq. 10) and energy (Eq. 11) of one training iteration.

    Gradient hops reuse the same powers in reverse. Hop transmissions run
    at the per-hop link bandwidth / latency of ``net``'s link model. See
    :func:`plan_cost_parts` for the breakdown.
    """
    parts = plan_cost_parts(profile, plan, positions, p_tx, decoy_power, net)
    t_total = (parts["t_comp_fwd"].sum() + parts["t_comp_bwd"].sum()
               + parts["t_hop_fwd"].sum() + parts["t_hop_bwd"].sum())
    e_total = parts["e_comp"] + parts["e_tx"]
    return float(t_total), float(e_total)


def enumerate_boundaries(num_layers: int, s: int) -> Iterator[Tuple[int, ...]]:
    """All ways to cut L layers into S non-empty contiguous stages."""
    for cuts in itertools.combinations(range(1, num_layers), s - 1):
        yield tuple(cuts) + (num_layers,)


def stack_boundaries(num_layers: int, s: int) -> np.ndarray:
    """The full enumeration as one ``((L-1 choose S-1), S)`` int32 array,
    built once on the host; :func:`score_plans` scores it in one pass."""
    return np.asarray(list(enumerate_boundaries(num_layers, s)), np.int32)


def even_boundaries(num_layers: int, s: int) -> Tuple[int, ...]:
    base = num_layers // s
    rem = num_layers % s
    out, acc = [], 0
    for k in range(s):
        acc += base + (1 if k < rem else 0)
        out.append(acc)
    return tuple(out)


def plan_devices_up(devices, device_mask) -> Tensor:
    """Per-plan survivability under a device up/down mask.

    ``devices`` is an ``(..., S)`` device-assignment batch (or one
    ``(S,)`` assignment), ``device_mask`` a ``(U+1,)`` bool/float mask
    (1 = up). Returns an ``(...,)`` bool on the mask's device: every stage
    of the plan sits on an up device.
    """
    up = torch.as_tensor(device_mask).bool()
    devs = torch.as_tensor(devices, device=up.device).long()
    return up[devs].all(dim=-1)


# ---------------------------------------------------------------------------
# batched plan scoring
# ---------------------------------------------------------------------------


def _score_batch(consts, boundaries: Tensor, devices: Tensor,
                 positions: Tensor, p_tx: Tensor, decoy: Tensor,
                 sp: ScenarioParams):
    """Eq. 10/11 cost of every plan of the batch at once.

    ``boundaries``/``devices`` ``(N, S)``, ``positions`` ``(U+1, 2)``,
    ``p_tx`` ``(N, S-1)``, ``decoy`` ``(N, S-1, U+1)``. The formulas are
    the reference's ``_score_one``, with the plan axis leading every
    tensor instead of a ``vmap``.
    """
    fwd_cum, bwd_cum, act_bits_t, grad_bits_t, state_cum = consts
    b = boundaries.long()
    lo = torch.cat([torch.zeros_like(b[:, :1]), b[:, :-1]], dim=1)
    fwd = fwd_cum[b] - fwd_cum[lo]  # (N, S)
    bwd = bwd_cum[b] - bwd_cum[lo]
    state = state_cum[b] - state_cum[lo]
    last = b[:, :-1] - 1  # (N, S-1) last layer of each sending stage
    act_bits = act_bits_t[last]
    grad_bits = grad_bits_t[last]

    t_comp = (
        compute_time_fwd(fwd, sp, lam=sp.lambda_f)
        + compute_time_bwd(bwd, sp, lam=sp.lambda_b)
        + 2.0 * state_time(state, sp)  # fwd + bwd touch, as in plan_cost
    ).sum(-1)
    e_comp = (compute_energy(fwd + bwd, sp)
              + 2.0 * state_energy(state, sp)).sum(-1)

    s = b.shape[1]
    hop_bw = sp.hop_bandwidth_hz[: s - 1]
    hop_lat = sp.hop_latency_s[: s - 1]
    dv = devices.long()
    tx_pos = positions[dv[:, :-1]]  # (N, S-1, 2)
    rx_pos = positions[dv[:, 1:]]
    d_tx_rx = torch.linalg.vector_norm(tx_pos - rx_pos, dim=-1)
    d_dec_rx = torch.linalg.vector_norm(positions - rx_pos[:, :, None, :], dim=-1)
    d_dec_tx = torch.linalg.vector_norm(positions - tx_pos[:, :, None, :], dim=-1)
    r_f = data_rate(p_tx, d_tx_rx, decoy, d_dec_rx, sp, bandwidth_hz=hop_bw)
    r_b = data_rate(p_tx, d_tx_rx, decoy, d_dec_tx, sp, bandwidth_hz=hop_bw)
    t_f = tx_time(act_bits, r_f) + hop_lat
    t_b = tx_time(grad_bits, r_b) + hop_lat
    t_total = t_comp + (t_f + t_b).sum(-1)
    e_total = e_comp + ((p_tx + decoy.sum(-1)) * (t_f + t_b)).sum(-1)
    return t_total, e_total


def make_plan_scorer(profile: LayerProfile, device: DeviceLike = None):
    """The batched scorer of ``profile`` on ``device`` (``cuda`` by default).

    Returns ``scorer(boundaries, devices, positions, p_tx, decoy_power,
    net) -> (delay (N,), energy (N,))`` where ``boundaries``/``devices``
    are ``(N, S)`` plan batches (``devices`` may also be one ``(S,)``
    assignment shared by every plan, likewise ``p_tx`` ``(S-1,)`` and
    ``decoy_power`` ``(S-1, U+1)``), and ``net`` is a ``NetworkConfig`` or
    a ``ScenarioParams`` on the scorer's device. The profile's cumulative
    tables are cast to f32 on the device once, as ``MHSLEnv`` casts them.
    """
    dev = resolve_device(device)
    tab = profile_table(profile)

    def f32(x):
        return torch.as_tensor(x, dtype=F32, device=dev)

    consts = (f32(tab.fwd_cum), f32(tab.bwd_cum), f32(tab.act_bits),
              f32(tab.grad_bits), f32(tab.state_cum))
    scenarios: dict = {}  # NetworkConfig -> its ScenarioParams on dev

    def scorer(boundaries, devices, positions, p_tx, decoy_power, net):
        if isinstance(net, ScenarioParams):
            sp = net
        else:
            sp = scenarios.get(net)
            if sp is None:
                sp = scenarios[net] = scenario_from_net(net, device=dev)
        boundaries = torch.as_tensor(boundaries, dtype=torch.int32, device=dev)
        n, s = boundaries.shape
        if s - 1 > sp.hop_bandwidth_hz.shape[-1]:
            raise ValueError(
                f"link model has {sp.hop_bandwidth_hz.shape[-1]} hops, "
                f"plans need {s - 1}")
        devices = torch.as_tensor(devices, dtype=torch.int32,
                                  device=dev).expand(n, s)
        p_tx = f32(p_tx).expand(n, s - 1)
        decoy_power = f32(decoy_power)
        decoy_power = decoy_power.expand(n, s - 1, decoy_power.shape[-1])
        return _score_batch(consts, boundaries, devices, f32(positions),
                            p_tx, decoy_power, sp)

    return scorer


# one scorer per (profile content, device): equal-content profiles rebuilt
# per sweep point share its device tables, and a CPU caller never gets a
# CUDA scorer
_SCORER_CACHE: dict = {}


def score_plans(profile: LayerProfile, boundaries, devices, positions, p_tx,
                decoy_power, net, device: DeviceLike = None):
    """Score a whole plan batch in one pass (see :func:`make_plan_scorer`),
    with one cached scorer per profile content and device."""
    dev = resolve_device(device)
    key = (profile_digest(profile), dev)
    scorer = _SCORER_CACHE.get(key)
    if scorer is None:
        scorer = _SCORER_CACHE[key] = make_plan_scorer(profile, dev)
    return scorer(boundaries, devices, positions, p_tx, decoy_power, net)
