"""Scenario parameters as a runtime value, and scenario sweeps.

Port of ``repro.core.scenario``: the env's static structure (U devices,
E_max eavesdroppers, S stages, number of power levels) stays on
``MHSLEnv`` and fixes every tensor shape; the dynamic physics lives in
``ScenarioParams``, a NamedTuple of f32 tensors passed as an argument
through ``channel -> leakage -> env -> rollout -> trainers``.

A sweep is a stacked ``ScenarioParams`` (leading axis N, from
:func:`scenario_grid` and :func:`stack_scenarios`). The population
rollout and evaluator run its scenarios in turn, each replaying the same
episode draws: one ``torch.Generator`` re-seeded with the same seed per
scenario. Nothing compiles, so the reference's ``jit_cache_size`` has no
counterpart. Per-scenario agents (``share_params=False``) come with
``train_population`` in a later slice.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
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


# ---------------------------------------------------------------------------
# grid construction + stacking
# ---------------------------------------------------------------------------


def scenario_grid(base: ScenarioParams, **axes: Sequence) -> List[ScenarioParams]:
    """Cartesian product over named parameter axes.

    ``scenario_grid(base, monitor_prob=[0.3, 0.6], gamma_e=[50.0, 75.0])``
    yields 4 scenarios in row-major order of the keyword arguments. The
    special axis ``active_eaves`` takes integer counts and varies
    ``eave_mask`` (padded-E sweep).
    """
    names = list(axes)
    out = []
    for combo in itertools.product(*(axes[n] for n in names)):
        sp = base
        for name, value in zip(names, combo):
            if name == "active_eaves":
                sp = with_active_eaves(sp, int(value))
            else:
                sp = replace_param(sp, name, value)
        out.append(sp)
    return out


def stack_scenarios(scenarios: Sequence[ScenarioParams]) -> ScenarioParams:
    """Stack N scenarios into one batched tuple (leading axis N)."""
    if not scenarios:
        raise ValueError("need at least one scenario")
    return ScenarioParams(*(torch.stack(xs) for xs in zip(*scenarios)))


def num_scenarios(stacked: ScenarioParams) -> int:
    return int(stacked.monitor_prob.shape[0])


def unstack_scenarios(stacked: ScenarioParams) -> List[ScenarioParams]:
    """The N scenarios of a stacked tuple, in order."""
    return [ScenarioParams(*(x[i] for x in stacked))
            for i in range(num_scenarios(stacked))]


# ---------------------------------------------------------------------------
# population rollout / evaluation: one episode batch per scenario
# ---------------------------------------------------------------------------


def _check_population(share_params: bool, extra_record=None):
    if not share_params:
        raise NotImplementedError(
            "per-scenario agents (share_params=False) come with "
            "train_population")
    if extra_record is not None:
        raise NotImplementedError(
            "the port's rollout records no extra fields (extra_record)")


def _rollouts(env, policy, hist_len, params, seed, num_envs, scenarios):
    """Each scenario's ``(num_envs, T, ...)`` trajectory, in turn, all from
    the same draws: a generator on the env's device re-seeded with
    ``seed`` per scenario draws the positions of ``num_envs`` fresh
    geometries, then every step's policy and leakage noise, as
    ``loops.evaluate_sac`` does."""
    from repro_torch.core.agents import rollout as R

    for sp in unstack_scenarios(scenarios):
        gen = torch.Generator(device=env.device).manual_seed(seed)
        st0 = env.reset(env.sample_positions(gen, num_envs, sp), sp)
        yield R.rollout_episode(env, policy, params, st0, gen, hist_len, sp)[1]


def make_population_rollout(env, policy, hist_len: int, *,
                            share_params: bool = True, extra_record=None):
    """Rollout of one shared agent over every scenario of a sweep.

    Returns ``run(params, seed, num_envs, scenarios)`` where ``scenarios``
    is a stacked ``ScenarioParams`` with leading axis N; trajectory leaves
    come back ``(N, num_envs, T, ...)``. Every scenario replays the same
    episode draws (a controlled comparison).
    """
    from repro_torch.tree import tree_map

    _check_population(share_params, extra_record)

    def run(params, seed: int, num_envs: int, scenarios: ScenarioParams):
        trajs = list(_rollouts(env, policy, hist_len, params, seed, num_envs,
                               scenarios))
        return tree_map(lambda *xs: torch.stack(xs), trajs[0], *trajs[1:])

    return run


def make_population_evaluator(env, policy, hist_len: int = 1, *,
                              share_params: bool = True, leakage_model=None):
    """Evaluation of one shared agent over every scenario of a sweep.

    Returns ``evaluate(params, seed, episodes, scenarios)`` ->
    ``{"reward", "leak", "viol"}``, each an ``(N,)`` float64 tensor on the
    host: per scenario the total of the episode batch over episodes and
    steps divided by ``episodes``, with ``evaluate_sac``'s arithmetic (an
    f32 sum of the ``(episodes, T)`` trajectory field on the device,
    divided on the host). ``leakage_model`` overrides the env's
    :class:`~repro_torch.core.leakage.LeakageModel` for this evaluation.
    """
    _check_population(share_params)
    if leakage_model is not None:
        env = dataclasses.replace(env, leakage_model=leakage_model)
    keys = ("reward", "leak", "viol")

    def evaluate(params, seed: int, episodes: int, scenarios: ScenarioParams):
        sums = {k: [] for k in keys}
        for traj in _rollouts(env, policy, hist_len, params, seed, episodes,
                              scenarios):
            for k in keys:
                sums[k].append(traj[k].sum())
        return {k: torch.stack(v).cpu().double() / episodes
                for k, v in sums.items()}

    return evaluate


def evaluate_population(env, policy, params, scenarios: ScenarioParams, *,
                        episodes: int = 20, seed: int = 1000,
                        hist_len: int = 1, share_params: bool = True,
                        leakage_model=None) -> Dict[str, np.ndarray]:
    """Evaluate ``params`` across a stacked scenario batch (a fresh
    geometry per episode, the same episode draws per scenario).

    The seeds mirror ``loops.evaluate_sac``, so a batch-of-1 sweep
    reproduces its numbers exactly. ``leakage_model`` swaps the leakage
    pricing for this evaluation (analytic by default).
    """
    ev = make_population_evaluator(env, policy, hist_len,
                                   share_params=share_params,
                                   leakage_model=leakage_model)
    out = ev(params, seed, episodes, scenarios)
    return {k: v.numpy() for k, v in out.items()}
