"""Online split re-planning: re-score cut points as load shifts.

Port of ``repro.serving.replanner``. Between engine ticks the service's
link and budget conditions drift (load thins each hop's bandwidth;
batteries drain the energy budget). The re-planner wraps the env's split
oracle (``MHSLEnv.make_split_oracle``, the batched plan scorer over the
full boundary enumeration) and re-scores EVERY candidate plan under the
shifted :class:`repro_torch.core.scenario.ScenarioParams`.

``replan(..., exclude_devices=...)`` marks every plan whose assignment
touches an excluded (dead) device infeasible through the oracle's
``device_mask``, and ``candidate_assignments="rotations"`` scores the
trainer ring's rotations, so a decision can route around a failed
device. Re-plans are decisions, not live migrations: the engine keeps
serving on its current plan.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch


class OnlineReplanner:
    """Re-scores the split-plan enumeration under shifted conditions.

    ``load`` in [0, 1] (e.g. the engine's slot occupancy) scales the
    per-hop bandwidth down by ``bandwidth_sensitivity * load`` and the
    energy budget down by ``energy_drain`` per replan call (batteries
    only drain).

    ``candidate_assignments``: ``None`` keeps the canonical ring (the
    first S-1 stages on trainers 0..S-2, the last on the server);
    ``"rotations"`` scores all U rotations of the trainer ring (server
    stage fixed); an explicit sequence of device tuples is used as is.

    The candidate geometry (device positions) comes from ``env.reset`` on
    positions drawn by a generator on the env's device seeded by
    ``seed``; the JAX package draws it from ``PRNGKey(seed)``, so the two
    geometries differ unless ``dev_pos`` is set to the same value."""

    def __init__(self, env, *, scenario=None,
                 bandwidth_sensitivity: float = 0.5,
                 energy_drain: float = 0.0, seed: int = 0,
                 candidate_assignments=None):
        self.env = env
        self.oracle = env.make_split_oracle()
        self.base = env._params(scenario)
        self.bandwidth_sensitivity = float(bandwidth_sensitivity)
        self.energy_drain = float(energy_drain)
        self._drained = 0.0
        dev = env.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = env.reset(env.sample_positions(gen, 1, self.base), self.base)
        self.dev_pos = state.dev_pos[0]
        canonical = tuple(range(env.S - 1)) + (env.U,)
        if candidate_assignments is None:
            assignments = [canonical]
        elif candidate_assignments == "rotations":
            assignments = [
                tuple((j + i) % env.U for i in range(env.S - 1)) + (env.U,)
                for j in range(env.U)
            ]
        else:
            assignments = [tuple(int(d) for d in a)
                           for a in candidate_assignments]
            if not assignments:
                raise ValueError("candidate_assignments is empty")
            for a in assignments:
                if len(a) != env.S:
                    raise ValueError(
                        f"assignment {a} has {len(a)} stages, env has {env.S}")
        self.assignments: Tuple[Tuple[int, ...], ...] = tuple(assignments)
        self.devices = torch.as_tensor(self.assignments[0], device=dev)
        self.p_tx = torch.full((env.S - 1,), float(self.base.power_levels[0]),
                               device=dev)
        self.decoy_power = torch.zeros((env.S - 1, env.U + 1), device=dev)

    def shifted_scenario(self, load: float):
        """The scenario the next replan scores under (pure; no state)."""
        bw_scale = max(1.0 - self.bandwidth_sensitivity * float(load), 1e-3)
        return self.base._replace(
            hop_bandwidth_hz=self.base.hop_bandwidth_hz * bw_scale,
            gamma_e=self.base.gamma_e * max(1.0 - self._drained, 1e-3),
        )

    def _device_mask(self, exclude_devices: Iterable[int]):
        """(U+1,) up-mask with the excluded rows down (None when empty)."""
        excl = sorted({int(d) for d in exclude_devices})
        if not excl:
            return None
        mask = np.ones((self.env.U + 1,), bool)
        for d in excl:
            if not 0 <= d <= self.env.U:
                raise ValueError(
                    f"excluded device {d} not in [0, {self.env.U}]")
            mask[d] = False
        return torch.as_tensor(mask, device=self.env.device)

    def replan(self, *, load: float, scenario=None,
               exclude_devices: Sequence[int] = ()) -> Dict:
        """Score all plans x candidate assignments under the shifted
        scenario; pick the feasible min-delay plan. Assignments whose
        stages touch an excluded device are skipped outright; the
        oracle's ``device_mask`` enforces the same exclusion in-band.
        Returns a plain-host decision record."""
        sp = scenario if scenario is not None else self.shifted_scenario(load)
        self._drained += self.energy_drain
        mask = self._device_mask(exclude_devices)
        excl = frozenset(int(d) for d in exclude_devices)
        best: Optional[Dict] = None
        any_feasible = False
        num_plans = 0
        for assign in self.assignments:
            if excl and excl.intersection(assign):
                continue
            devices = torch.as_tensor(assign, device=self.env.device)
            out = self.oracle(self.dev_pos, devices, self.p_tx,
                              self.decoy_power, sp, device_mask=mask)
            delay = out["delay"].cpu().numpy()
            feas = out["feasible"].cpu().numpy()
            bounds = out["boundaries"].cpu().numpy()
            num_plans += int(bounds.shape[0])
            any_feasible = any_feasible or bool(feas.any())
            masked = np.where(feas, delay, np.inf)
            i = int(np.argmin(masked))
            cand = {
                "boundaries": tuple(int(b) for b in bounds[i]),
                "devices": assign,
                "delay": float(delay[i]),
                "energy": float(out["energy"][i]),
                "feasible": bool(feas[i]),
                "key": float(masked[i]),
            }
            if best is None or cand["key"] < best["key"]:
                best = cand
        if best is None:  # every assignment intersected the exclusion set
            first = self.oracle(self.dev_pos, self.devices, self.p_tx,
                                self.decoy_power, sp, device_mask=mask)
            best = {
                "boundaries": tuple(int(b) for b in first["boundaries"][0]),
                "devices": self.assignments[0],
                "delay": float("inf"),
                "energy": float("inf"),
                "feasible": False,
                "key": float("inf"),
            }
            num_plans = 0
        best.pop("key", None)
        best.update({
            "any_feasible": any_feasible,
            "load": float(load),
            "num_plans": num_plans,
            "excluded": tuple(sorted(excl)),
        })
        return best
