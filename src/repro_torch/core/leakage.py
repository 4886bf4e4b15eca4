"""Eavesdropper & leakage model, analytic half (paper Theorem 1, Eq. 30).

Port of the analytic part of ``repro.core.leakage``:
  * an eavesdropper locks onto the max-SNR signal among {trainer} U decoys
    (Eq. 12) under Rayleigh fading, giving the capture probability
      P(e captures trainer) = prod_d  p_s m_s,e^-2 / (p_d m_d,e^-2 + p_s m_s,e^-2)
    (Theorem 1 / Eq. 37);
  * expected leakage of one hop = sum_e P_capture(e) * q_e * delta (Eq. 30);
  * a Monte-Carlo draw of one hop's leakage (Eqs. 12-13, 20-21).

Every function broadcasts over leading batch axes (hops, or the env
population). ``jax.random`` streams cannot be reproduced in torch, so
the Monte-Carlo draw takes its uniforms as an argument
(:class:`LeakDraws`); :func:`draw_leakage` makes them from a
``torch.Generator``. The learned-attacker ``EmpiricalLeakage`` waits for
the attack slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.channel import channel_gain
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class HopGeometry(NamedTuple):
    """Transmit geometry of the forward hops of one split plan (leading
    axis = hops, H = S-1 for an S-stage plan)."""

    p_tx: Tensor  # (H,) trainer transmit power per hop
    dist_tx_e: Tensor  # (H, E) trainer -> eavesdropper distances
    decoy_p: Tensor  # (H, D) decoy powers (0 for inactive decoys)
    decoy_dist_e: Tensor  # (H, D, E) decoy -> eavesdropper distances
    boundary_layer: Tensor  # (H,) int cut-layer index (0-based) per hop

    @property
    def num_hops(self) -> int:
        return self.p_tx.shape[0]


class LeakDraws(NamedTuple):
    """Uniforms of one Monte-Carlo leakage draw, per eavesdropper:
    ``snr`` (..., E, D+1) in [1e-12, 1) for the Rayleigh powers (column 0
    the trainer, then the D decoys) and ``monitor`` (..., E) in [0, 1)
    for the monitoring Bernoulli."""

    snr: Tensor
    monitor: Tensor


def draw_leakage(gen: torch.Generator, batch_shape, num_eaves: int,
                 num_decoys: int, device: DeviceLike = None) -> LeakDraws:
    """Uniform draws for :func:`sample_leakage` (``gen`` on ``device``,
    ``cuda`` by default)."""
    device = resolve_device(device)
    shape = tuple(batch_shape) + (num_eaves,)
    u = torch.rand(shape + (num_decoys + 1,), generator=gen, device=device)
    return LeakDraws(snr=1e-12 + u * (1.0 - 1e-12),
                     monitor=torch.rand(shape, generator=gen, device=device))


@dataclass(frozen=True, eq=False)
class AnalyticLeakage:
    """The paper's closed-form leakage model (Theorem 1 + Eq. 30).

    ``value_table`` (per-layer information values, shape (L,)) is only
    needed for :meth:`evaluate`; :meth:`for_profile` builds it.
    """

    value_table: Optional[np.ndarray] = None

    @classmethod
    def for_profile(cls, profile) -> "AnalyticLeakage":
        from repro_torch.core.profiles import profile_table

        return cls(value_table=profile_table(profile).leak_norm)

    def layer_values(self, leak_norm: np.ndarray) -> np.ndarray:
        """The analytic model prices hops with the profile table unchanged."""
        return leak_norm

    def capture_probability(self, p_tx, dist_tx_e, decoy_p, decoy_dist_e,
                            o=1.0) -> Tensor:
        """Theorem 1 product term, per eavesdropper.

        ``p_tx`` (...), ``dist_tx_e`` (..., E), ``decoy_p`` (..., D),
        ``decoy_dist_e`` (..., D, E) -> (..., E)."""
        s_tx = p_tx[..., None] * channel_gain(dist_tx_e, o)  # (..., E)
        s_d = decoy_p[..., :, None] * channel_gain(decoy_dist_e, o)  # (..., D, E)
        # P(S_d < S_tx) per decoy; inactive decoys (p=0) contribute factor 1
        s_tx = s_tx[..., None, :]
        frac = s_tx / torch.clamp(s_d + s_tx, min=1e-30)
        frac = torch.where(decoy_p[..., :, None] > 0, frac, 1.0)
        return torch.prod(frac, dim=-2)

    def expected_leakage(self, p_tx, dist_tx_e, decoy_p, decoy_dist_e, q_e,
                         delta, o=1.0) -> Tensor:
        """Eq. 30: E[I] of one hop; ``q_e`` (..., E), ``delta`` (...)."""
        cap = self.capture_probability(p_tx, dist_tx_e, decoy_p,
                                       decoy_dist_e, o)
        return torch.sum(cap * q_e, dim=-1) * delta

    def sample_leakage(self, draws: LeakDraws, p_tx, dist_tx_e, decoy_p,
                       decoy_dist_e, q_e, delta, o=1.0) -> Tensor:
        """One Monte-Carlo leakage draw: Rayleigh SNRs from the uniforms
        (Exponential(mean = p h) as ``-mean * log(U)``), the argmax per
        eavesdropper, and the monitoring Bernoulli ``U < q_e``."""
        mean_tx = p_tx[..., None] * channel_gain(dist_tx_e, o)  # (..., E)
        mean_d = decoy_p[..., :, None] * channel_gain(decoy_dist_e, o)  # (..., D, E)
        means = torch.cat([mean_tx[..., None, :], mean_d], dim=-2)  # (..., D+1, E)
        snr = -means.transpose(-1, -2) * torch.log(draws.snr)  # (..., E, D+1)
        captured = torch.argmax(snr, dim=-1) == 0  # trainer had max SNR
        monitored = draws.monitor < q_e
        hits = (captured & monitored).sum(-1)
        return hits * delta

    def evaluate(self, scenario, plan: HopGeometry,
                 draws: Optional[LeakDraws] = None) -> Tensor:
        """Per-hop leakage (H,) of ``plan`` under ``scenario``: the Eq. 30
        expectation, or one Monte-Carlo draw per hop when ``draws``
        (leading axis H) is given."""
        if self.value_table is None:
            raise ValueError("evaluate() needs a per-layer value table - "
                             "construct the model via "
                             "AnalyticLeakage.for_profile(profile)")
        table = torch.as_tensor(self.value_table, dtype=torch.float32,
                                device=plan.p_tx.device)
        q_e = scenario.monitor_prob * scenario.eave_mask
        delta = table[plan.boundary_layer] * scenario.leak_scale
        o = scenario.rayleigh_o
        if draws is None:
            return self.expected_leakage(plan.p_tx, plan.dist_tx_e,
                                         plan.decoy_p, plan.decoy_dist_e,
                                         q_e, delta, o)
        return self.sample_leakage(draws, plan.p_tx, plan.dist_tx_e,
                                   plan.decoy_p, plan.decoy_dist_e, q_e,
                                   delta, o)


_ANALYTIC = AnalyticLeakage()


def capture_probability(p_tx, dist_tx_e, decoy_p, decoy_dist_e, o=1.0):
    """Theorem 1 product term, per eavesdropper (see
    :meth:`AnalyticLeakage.capture_probability`)."""
    return _ANALYTIC.capture_probability(p_tx, dist_tx_e, decoy_p,
                                         decoy_dist_e, o)


def expected_leakage(p_tx, dist_tx_e, decoy_p, decoy_dist_e, q_e, delta,
                     o=1.0):
    """Eq. 30: E[I] for one hop (see :meth:`AnalyticLeakage.expected_leakage`)."""
    return _ANALYTIC.expected_leakage(p_tx, dist_tx_e, decoy_p, decoy_dist_e,
                                      q_e, delta, o)


def sample_leakage(draws, p_tx, dist_tx_e, decoy_p, decoy_dist_e, q_e, delta,
                   o=1.0):
    """Monte-Carlo single-draw leakage (see
    :meth:`AnalyticLeakage.sample_leakage`)."""
    return _ANALYTIC.sample_leakage(draws, p_tx, dist_tx_e, decoy_p,
                                    decoy_dist_e, q_e, delta, o)
