"""Scenario parameters as a runtime value (parameter half).

Port of the parameter half of ``repro.core.scenario``: the env's static
structure (U devices, E_max eavesdroppers, S stages, number of power
levels) stays on ``MHSLEnv`` and fixes every tensor shape; the dynamic
physics lives in ``ScenarioParams``, a NamedTuple of f32 tensors passed
as an argument through ``channel -> leakage -> env -> rollout ->
trainers``. The scenario-batched trainers come in a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.channel import NetworkConfig
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class ScenarioParams(NamedTuple):
    """Dynamic physics of one MHSL scenario (all leaves f32 tensors)."""

    monitor_prob: Tensor  # (E,) per-eavesdropper q_e
    eave_mask: Tensor  # (E,) 1.0 = active, 0.0 = padded-out eavesdropper
    know_eave_locations: Tensor  # () 1.0 = l_M observed, 0.0 = blinded
    gamma_t: Tensor  # () per-iteration delay budget (s)
    gamma_e: Tensor  # () per-iteration energy budget (J)
    bandwidth_hz: Tensor  # () B
    noise_w: Tensor  # () N0 * B in watts
    rayleigh_o: Tensor  # () o
    power_levels: Tensor  # (P,) discrete transmit powers (W)
    leak_scale: Tensor  # () leakage reward scale
    area_m: Tensor  # () deployment area side length
    f_cpu_hz: Tensor  # () f^B device CPU clock
    theta_chip: Tensor  # () vartheta chip energy coefficient
    lambda_f: Tensor  # () Eq. 8 complexity multiplier (seed applied 1.0)
    lambda_b: Tensor  # () Eq. 9 complexity multiplier (seed applied 1.0)
    hop_bandwidth_hz: Tensor  # (max_split - 1,)
    hop_latency_s: Tensor  # (max_split - 1,)
    state_cycles_per_bit: Tensor  # ()

    @property
    def num_eaves(self) -> int:
        return self.monitor_prob.shape[-1]

    @property
    def num_power_levels(self) -> int:
        return self.power_levels.shape[-1]

    @property
    def num_hops(self) -> int:
        return self.hop_bandwidth_hz.shape[-1]


def scenario_from_net(net: NetworkConfig, *, know_eave_locations: bool = True,
                      leak_scale: float = 1.0,
                      device: DeviceLike = None) -> ScenarioParams:
    """The dynamic-physics tuple matching a Table-I config, in f32 on
    ``device`` (``cuda`` by default). ``lambda_f``/``lambda_b`` are 1.0, as
    in the reference (the seed env never applied ``NetworkConfig.lambda_f``
    to Eqs. 8-9)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    e = net.num_eaves
    return ScenarioParams(
        monitor_prob=torch.full((e,), net.monitor_prob, dtype=torch.float32,
                                device=dev),
        eave_mask=torch.ones((e,), dtype=torch.float32, device=dev),
        know_eave_locations=f32(1.0 if know_eave_locations else 0.0),
        gamma_t=f32(net.gamma_t),
        gamma_e=f32(net.gamma_e),
        bandwidth_hz=f32(net.bandwidth_hz),
        noise_w=f32(net.noise_w),
        rayleigh_o=f32(net.rayleigh_o),
        power_levels=f32(net.power_levels),
        leak_scale=f32(leak_scale),
        area_m=f32(net.area_m),
        f_cpu_hz=f32(net.f_cpu_hz),
        theta_chip=f32(net.theta_chip),
        lambda_f=f32(1.0),
        lambda_b=f32(1.0),
        hop_bandwidth_hz=f32(net.hop_bandwidth_hz),
        hop_latency_s=f32(net.hop_latency_s),
        state_cycles_per_bit=f32(net.state_cycles_per_bit),
    )


def replace_param(base: ScenarioParams, name: str, value) -> ScenarioParams:
    """Replace one field, broadcasting scalars to the field's shape
    (e.g. ``monitor_prob=0.3`` -> ``full((E,), 0.3)``)."""
    ref = getattr(base, name)
    val = torch.as_tensor(value, dtype=ref.dtype, device=ref.device)
    return base._replace(**{name: val.expand(ref.shape).clone()})


def scale_param(base: ScenarioParams, name: str, scale) -> ScenarioParams:
    """Scale one field elementwise, keeping its dtype."""
    ref = getattr(base, name)
    val = ref * torch.as_tensor(scale, dtype=ref.dtype, device=ref.device)
    return base._replace(**{name: val.to(ref.dtype)})


def shift_param(base: ScenarioParams, name: str, delta) -> ScenarioParams:
    """Shift one field elementwise, keeping its dtype."""
    ref = getattr(base, name)
    val = ref + torch.as_tensor(delta, dtype=ref.dtype, device=ref.device)
    return base._replace(**{name: val.to(ref.dtype)})


def with_active_eaves(base: ScenarioParams, count: int) -> ScenarioParams:
    """Only the first ``count`` eavesdroppers active; the rest are padding
    (zero monitoring, zero observation)."""
    e = base.num_eaves
    if not 0 <= count <= e:
        raise ValueError(f"count must be in [0, {e}], got {count}")
    mask = (torch.arange(e, device=base.eave_mask.device) < count)
    return base._replace(eave_mask=mask.to(base.eave_mask.dtype))
