"""MHSL RL environment (paper §III), batched over a leading env axis.

Port of ``repro.core.env``. Where the JAX env is written for one env
and ``vmap``-ed, every tensor here carries the population axis ``N``
first and every method steps the whole population at once.

Episode structure (2S-1 steps, Eq. 15-23):
  step 1           : pick s_1 and its sub-model size (no transmission)
  steps 2..S       : pick next trainer (server at n=S), sub-model size,
                     decoy set, powers; forward hop s_{n-1} -> s_n happens
  steps S+1..2S-1  : gradient hops back (server -> ... -> s_1); agent picks
                     decoys + powers only

Action (factored discrete, masked), each field ``(N,)`` or ``(N, U)``:
  u       in [0, U)        next trainer device
  size    in [0, NBINS)    sub-model size bin (maps to #layers)
  decoys  in {0,1}^U       deceptive-signal devices for this hop
  p_tx    in [0, P)        trainer power level
  p_d     in [0, P)        decoy power level (shared across decoys)

Static vs dynamic: ``MHSLEnv`` pins the shapes (U, E_max, S, NBINS,
number of power levels, layer profile); every physics constant lives in
a ``ScenarioParams`` passed to ``reset``/``observe``/``step`` (omitted =
``env.scenario()``). The step's randomness (the leakage Monte-Carlo
draw) is an argument: :meth:`MHSLEnv.draw` makes it from a generator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.channel import (
    NetworkConfig,
    compute_energy,
    compute_time_bwd,
    compute_time_fwd,
    data_rate,
    sample_positions,
    state_energy,
    state_time,
    tx_time,
)
from repro_torch.core.leakage import (AnalyticLeakage, LeakageModel, LeakDraws,
                                     draw_leakage)
from repro_torch.core.profiles import LayerProfile, profile_table
from repro_torch.core.scenario import ScenarioParams, scenario_from_net
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor

NBINS = 4  # split-size bins
OMEGA_1 = 5.0  # energy-violation penalty weight (Eq. 20)
OMEGA_2 = 5.0  # time-violation penalty weight

_DEFAULT_LEAKAGE = AnalyticLeakage()


class EnvState(NamedTuple):
    dev_pos: Tensor  # (N, U+1, 2), last row = server
    eav_pos: Tensor  # (N, E, 2)
    e_r: Tensor  # (N,) remaining energy (J)
    t_r: Tensor  # (N,) remaining time (s)
    assigned: Tensor  # (N, U+1) int32, 0 = free, k = holds stage k
    stage_dev: Tensor  # (N, S) int32 device per stage, -1 = unset
    boundaries: Tensor  # (N, S) int32 cumulative layer counts, 0 = unset
    layers_used: Tensor  # (N,) int32
    n: Tensor  # (N,) int32 step counter (1-indexed)
    done: Tensor  # (N,) bool
    leaked: Tensor  # (N,) cumulative information leaked


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """Per-env gather along axis 1: ``x[b, idx[b]]``."""
    idx = idx.long()
    out = torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.dim() - 1))
                       .expand((x.shape[0], 1) + x.shape[2:]))
    return out.squeeze(1)


def _put(x: Tensor, idx: Tensor, value: Tensor, where: Tensor) -> Tensor:
    """Per-env ``x[b, idx[b]] = value[b]`` where ``where[b]`` (2-D x)."""
    hit = torch.arange(x.shape[1], device=x.device) == idx[:, None]
    return torch.where(hit & where[:, None], value[:, None].to(x.dtype), x)


@dataclass(frozen=True)
class MHSLEnv:
    profile: LayerProfile
    net: NetworkConfig = NetworkConfig()
    know_eave_locations: bool = True
    leak_scale: float = 1.0
    # LeakageModel pricing the per-hop information values and the
    # Monte-Carlo draw of step(); None = the paper's AnalyticLeakage, an
    # EmpiricalLeakage prices hops with attacker-measured values.
    leakage_model: Optional[LeakageModel] = None
    device: DeviceLike = field(default=None, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # ---- static structure --------------------------------------------------
    @property
    def U(self) -> int:
        return self.net.num_devices

    @property
    def E(self) -> int:
        return self.net.num_eaves

    @property
    def S(self) -> int:
        return self.net.max_split

    @property
    def L(self) -> int:
        return self.profile.num_layers

    @property
    def episode_len(self) -> int:
        return 2 * self.S - 1

    @property
    def num_power_levels(self) -> int:
        return len(self.net.power_levels)

    @property
    def action_dims(self) -> Dict[str, int]:
        return {
            "u": self.U,
            "size": NBINS,
            "decoys": self.U,  # U binary heads
            "p_tx": self.num_power_levels,
            "p_d": self.num_power_levels,
        }

    @property
    def obs_dim(self) -> int:
        # e_r, t_r, remaining_frac, r (U+1), v one-hot (U+1), l_M (E),
        # l_D (U+1), phase, n/2S
        return 3 + (self.U + 1) + (self.U + 1) + self.E + (self.U + 1) + 2

    # ---- dynamic physics ---------------------------------------------------
    def scenario(self) -> ScenarioParams:
        """Default dynamic-physics tuple matching the constructor flags."""
        return self._default_scenario

    @cached_property
    def _default_scenario(self) -> ScenarioParams:
        return scenario_from_net(self.net,
                                 know_eave_locations=self.know_eave_locations,
                                 leak_scale=self.leak_scale,
                                 device=self.device)

    def _params(self, params: Optional[ScenarioParams]) -> ScenarioParams:
        return self.scenario() if params is None else params

    # ---- split-plan oracle -------------------------------------------------
    def make_split_oracle(self):
        """Oracle over every split of this env's profile.

        Returns ``oracle(dev_pos, devices, p_tx, decoy_power, scenario=None,
        device_mask=None)`` scoring all ``(L-1 choose S-1)`` boundary plans
        (Eq. 10/11 static cost) in one batched pass on the env's device,
        for a candidate device assignment ``devices`` (S,), per-hop trainer
        powers ``p_tx`` (S-1,) and decoy powers ``decoy_power`` (S-1, U+1).
        ``dev_pos`` is one env's (U+1, 2) positions (``st.dev_pos[i]`` of
        an :class:`EnvState`). The result holds the stacked
        ``boundaries`` (on the device) with per-plan ``delay``/``energy``
        and a ``feasible`` mask against the scenario's budgets.
        ``device_mask`` is an optional ``(U+1,)`` up/down mask: plans whose
        assignment touches a down device are infeasible.
        """
        from repro_torch.core.splitting import (make_plan_scorer,
                                                plan_devices_up,
                                                stack_boundaries)

        bounds = torch.as_tensor(stack_boundaries(self.L, self.S),
                                 device=self.device)
        scorer = make_plan_scorer(self.profile, self.device)

        def oracle(dev_pos, devices, p_tx, decoy_power,
                   scenario: Optional[ScenarioParams] = None,
                   device_mask=None):
            sp = self._params(scenario)
            t, e = scorer(bounds, devices, dev_pos, p_tx, decoy_power, sp)
            feasible = (t <= sp.gamma_t) & (e <= sp.gamma_e)
            if device_mask is not None:
                mask = torch.as_tensor(device_mask, device=self.device)
                feasible = feasible & plan_devices_up(devices, mask)
            return {"boundaries": bounds, "delay": t, "energy": e,
                    "feasible": feasible}

        return oracle

    def _leakage(self) -> LeakageModel:
        return (_DEFAULT_LEAKAGE if self.leakage_model is None
                else self.leakage_model)

    @cached_property
    def _consts(self) -> Tuple[Tensor, ...]:
        # the profile's float64 host tables, cast to f32 exactly as the
        # reference's jnp.asarray does; torch.as_tensor alone would keep
        # float64 and every leak and delay value would drift. The per-layer
        # information values route through the LeakageModel.
        t = profile_table(self.profile)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

        return (f32(t.act_bits), f32(t.grad_bits),
                f32(self._leakage().layer_values(t.leak_norm)),
                f32(t.fwd_cum), f32(t.bwd_cum), f32(t.state_cum))

    # ---- randomness ----------------------------------------------------------
    def sample_positions(self, gen: torch.Generator, num_envs: int,
                         params: Optional[ScenarioParams] = None):
        """Uniform device/eavesdropper positions for ``num_envs`` envs."""
        sp = self._params(params)
        return sample_positions(gen, num_envs, self.U, self.E, sp.area_m,
                                device=self.device)

    def draw(self, gen: torch.Generator, num_envs: int) -> LeakDraws:
        """The leakage draw of one :meth:`step` for ``num_envs`` envs."""
        return draw_leakage(gen, (num_envs,), self.E, self.U + 1,
                            device=self.device)

    # ---- reset ---------------------------------------------------------------
    def reset(self, positions: Tuple[Tensor, Tensor],
              params: Optional[ScenarioParams] = None) -> EnvState:
        """Initial state from device positions ``(N, U, 2)`` and
        eavesdropper positions ``(N, E, 2)`` (see :meth:`sample_positions`);
        the server sits at the centre of the area."""
        sp = self._params(params)
        dev, eav = positions
        n_env = dev.shape[0]
        d = self.device
        server = (torch.full((1, 2), 0.5, device=d) * sp.area_m).expand(n_env, 1, 2)
        i32 = torch.int32
        return EnvState(
            dev_pos=torch.cat([dev.to(d, torch.float32), server], dim=1),
            eav_pos=eav.to(d, torch.float32),
            e_r=sp.gamma_e.expand(n_env).clone(),
            t_r=sp.gamma_t.expand(n_env).clone(),
            assigned=torch.zeros((n_env, self.U + 1), dtype=i32, device=d),
            stage_dev=torch.full((n_env, self.S), -1, dtype=i32, device=d),
            boundaries=torch.zeros((n_env, self.S), dtype=i32, device=d),
            layers_used=torch.zeros((n_env,), dtype=i32, device=d),
            n=torch.ones((n_env,), dtype=i32, device=d),
            done=torch.zeros((n_env,), dtype=torch.bool, device=d),
            leaked=torch.zeros((n_env,), dtype=torch.float32, device=d),
        )

    # ---- observation -----------------------------------------------------------
    def observe(self, state: EnvState,
                params: Optional[ScenarioParams] = None) -> Tensor:
        sp = self._params(params)
        v_idx = self._current_tx(state)
        v_onehot = torch.nn.functional.one_hot(v_idx.long(), self.U + 1).float()
        v_pos = _take(state.dev_pos, v_idx)  # (N, 2)
        l_m = torch.linalg.vector_norm(state.eav_pos - v_pos[:, None, :],
                                       dim=-1) / sp.area_m
        # blinded (know_eave_locations=0) and padded (eave_mask=0)
        # eavesdroppers vanish from the observation
        l_m = l_m * sp.know_eave_locations * sp.eave_mask
        l_d = torch.linalg.vector_norm(state.dev_pos - v_pos[:, None, :],
                                       dim=-1) / sp.area_m
        phase = (state.n > self.S).float()
        head = torch.stack([state.e_r / sp.gamma_e, state.t_r / sp.gamma_t,
                            1.0 - state.layers_used / self.L], dim=-1)
        tail = torch.stack([phase, state.n.float() / self.episode_len], dim=-1)
        return torch.cat([head, state.assigned.float() / self.S, v_onehot,
                          l_m, l_d, tail], dim=-1)

    def _current_tx(self, state: EnvState) -> Tensor:
        """Device transmitting at this step (for obs/leak geometry)."""
        n = state.n
        fwd_tx = _take(state.stage_dev, torch.clamp(n - 2, 0, self.S - 1))
        # backward step n transmits from stage s_{2S-n+1} (1-indexed, Eq. 20)
        bwd_tx = _take(state.stage_dev, torch.clamp(2 * self.S - n, 0, self.S - 1))
        idx = torch.where(n <= self.S, fwd_tx, bwd_tx)
        return torch.where(idx < 0, 0, idx).to(torch.int32)

    def _rx(self, state: EnvState) -> Tensor:
        n = state.n
        fwd_rx = _take(state.stage_dev, torch.clamp(n - 1, 0, self.S - 1))
        # backward step n delivers to stage s_{2S-n} (1-indexed, Eq. 20)
        bwd_rx = _take(state.stage_dev,
                       torch.clamp(2 * self.S - n - 1, 0, self.S - 1))
        idx = torch.where(n <= self.S, fwd_rx, bwd_rx)
        return torch.where(idx < 0, self.U, idx).to(torch.int32)

    # ---- action masks ------------------------------------------------------
    def action_masks(self, state: EnvState) -> Dict[str, Tensor]:
        n = state.n
        d = self.device
        n_env = n.shape[0]
        assign_phase = (n < self.S)[:, None]  # steps 1..S-1 pick devices
        u_mask = assign_phase & (state.assigned[:, : self.U] == 0)
        # always keep at least one valid entry for the categorical
        first_u = torch.arange(self.U, device=d) == 0
        u_mask = torch.where(u_mask.any(-1, keepdim=True), u_mask, first_u)
        first_bin = torch.arange(NBINS, device=d) == 0
        size_mask = assign_phase | first_bin
        # decoys: any device not transmitting/receiving this hop
        ar = torch.arange(self.U, device=d)
        busy = (ar == self._current_tx(state)[:, None]) | (ar == self._rx(state)[:, None])
        dec_mask = ~busy & (n >= 2)[:, None]
        p_mask = torch.ones((n_env, self.num_power_levels), dtype=torch.bool,
                            device=d)
        return {"u": u_mask, "size": size_mask,
                "decoys": dec_mask, "p_tx": p_mask, "p_d": p_mask}

    # ---- step ----------------------------------------------------------------
    def step(self, state: EnvState, action: Dict[str, Tensor],
             draws: LeakDraws, params: Optional[ScenarioParams] = None,
             ) -> Tuple[EnvState, Tensor, Tensor, Dict[str, Tensor]]:
        sp = self._params(params)
        act_bits, grad_bits, leak_v, fwd_cum, bwd_cum, state_cum = self._consts
        powers = sp.power_levels
        n = state.n
        S, U, L = self.S, self.U, self.L
        i32 = torch.int32

        # ---- 1) assignment phase bookkeeping (steps 1..S) --------------------
        is_assign = n < S  # agent picks a device for stages 1..S-1
        is_server_stage = n == S  # stage S goes to the server automatically
        stage_idx = torch.clamp(n - 1, 0, S - 1)

        # size mapping: keep >=1 layer for each later stage
        remaining = L - state.layers_used
        stages_after = S - n
        max_take = torch.clamp(remaining - stages_after, min=1)
        frac = (action["size"].float() + 1.0) / NBINS
        take = torch.ceil(frac * max_take).to(i32)
        take = torch.minimum(torch.clamp(take, min=1), max_take)
        take = torch.where(is_server_stage, remaining, take).to(i32)

        new_dev = torch.where(is_assign, action["u"].to(i32),
                              torch.where(is_server_stage, U, -1)).to(i32)
        do_assign = is_assign | is_server_stage
        stage_dev = _put(state.stage_dev, stage_idx, new_dev, do_assign)
        boundaries = _put(state.boundaries, stage_idx,
                          state.layers_used + take, do_assign)
        layers_used = torch.where(do_assign, state.layers_used + take,
                                  state.layers_used).to(i32)
        assigned = _put(state.assigned, torch.clamp(new_dev, 0, U), n,
                        is_assign & (new_dev < U))

        # ---- 2) transmission (steps 2..2S-1) --------------------------------
        has_hop = n >= 2
        fwd_hop = has_hop & (n <= S)
        hop_fwd_idx = torch.clamp(n - 2, 0, S - 2)  # forward hop (0-based)
        hop_bwd_idx = torch.clamp(2 * S - n - 1, 0, S - 2)  # backward hop
        hop = torch.where(fwd_hop, hop_fwd_idx, hop_bwd_idx)

        dev_lo = _take(stage_dev, hop)
        dev_hi = _take(stage_dev, hop + 1)
        tx = torch.where(fwd_hop, dev_lo, dev_hi)
        rx = torch.where(fwd_hop, dev_hi, dev_lo)
        tx = torch.where(tx < 0, 0, tx)
        rx = torch.where(rx < 0, U, rx)
        boundary_layer = torch.clamp(_take(boundaries, hop) - 1, 0, L - 1).long()
        bits = torch.where(fwd_hop, act_bits[boundary_layer],
                           grad_bits[boundary_layer])

        p_tx = powers[action["p_tx"].long()]
        p_d_level = powers[action["p_d"].long()]
        # exclude tx/rx from decoys regardless of agent output
        ar = torch.arange(U, device=n.device)
        busy = (ar == tx[:, None]) | (ar == rx[:, None])
        decoys = torch.where(busy, 0.0, action["decoys"].float())
        decoy_p = torch.cat([decoys * p_d_level[:, None],
                             torch.zeros_like(decoys[:, :1])], dim=-1)  # (N, U+1)

        tx_pos = _take(state.dev_pos, tx)
        rx_pos = _take(state.dev_pos, rx)
        d_tx_rx = torch.linalg.vector_norm(tx_pos - rx_pos, dim=-1) + 1e-6
        d_dec_rx = torch.linalg.vector_norm(state.dev_pos - rx_pos[:, None, :],
                                            dim=-1)
        rate = data_rate(p_tx, d_tx_rx, decoy_p, d_dec_rx, sp)
        t_hop = torch.where(has_hop, tx_time(bits, rate), 0.0)

        # stage compute (Eq. 20): both directions charge stage hop+1 (the
        # receiving stage forwards, the transmitting stage backwards)
        st = hop + 1
        lo = torch.where(st == 0, 0,
                         _take(boundaries, torch.clamp(st - 1, 0, S - 1))).long()
        hi = _take(boundaries, st).long()
        stage_fwd_flops = fwd_cum[hi] - fwd_cum[lo]
        stage_bwd_flops = bwd_cum[hi] - bwd_cum[lo]
        stage_flops = torch.where(fwd_hop, stage_fwd_flops, stage_bwd_flops)
        stage_state = state_cum[hi] - state_cum[lo]
        t_comp = torch.where(
            fwd_hop,
            compute_time_fwd(stage_fwd_flops, sp, lam=sp.lambda_f),
            compute_time_bwd(stage_bwd_flops, sp, lam=sp.lambda_b),
        ) + state_time(stage_state, sp)
        t_comp = torch.where(has_hop, t_comp, 0.0)
        e_comp = torch.where(
            has_hop,
            compute_energy(stage_flops, sp) + state_energy(stage_state, sp),
            0.0)
        e_hop = (p_tx + decoy_p.sum(-1)) * t_hop + e_comp

        # ---- 3) leakage (Eqs. 12-13, 20-21) ----------------------------------
        d_tx_e = torch.linalg.vector_norm(state.eav_pos - tx_pos[:, None, :],
                                          dim=-1)  # (N, E)
        decoy_dist_e = torch.linalg.vector_norm(
            state.dev_pos[:, :, None, :] - state.eav_pos[:, None, :, :], dim=-1
        )  # (N, U+1, E)
        q_e = sp.monitor_prob * sp.eave_mask
        delta = leak_v[boundary_layer] * sp.leak_scale
        leak = torch.where(
            has_hop,
            self._leakage().sample_leakage(draws, p_tx, d_tx_e, decoy_p,
                                           decoy_dist_e, q_e, delta,
                                           sp.rayleigh_o),
            0.0)

        # ---- 4) budgets + reward (Eq. 20) -------------------------------------
        e_r = state.e_r - e_hop
        t_r = state.t_r - t_hop - t_comp
        reward = (-leak - OMEGA_1 * (e_r <= 0).float()
                  - OMEGA_2 * (t_r <= 0).float())
        reward = torch.where(has_hop, reward, 0.0)

        done = n >= self.episode_len
        new_state = EnvState(
            dev_pos=state.dev_pos, eav_pos=state.eav_pos, e_r=e_r, t_r=t_r,
            assigned=assigned, stage_dev=stage_dev, boundaries=boundaries,
            layers_used=layers_used, n=n + 1, done=done,
            leaked=state.leaked + leak,
        )
        info = {"leak": leak, "t_hop": t_hop, "e_hop": e_hop, "rate": rate,
                "tx": tx, "rx": rx, "decoy_p": decoy_p}
        return new_state, reward, done, info
