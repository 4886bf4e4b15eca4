"""Eavesdropper & leakage model behind the :class:`LeakageModel` protocol.

Port of ``repro.core.leakage``:
  * an eavesdropper locks onto the max-SNR signal among {trainer} U decoys
    (Eq. 12) under Rayleigh fading, giving the capture probability
      P(e captures trainer) = prod_d  p_s m_s,e^-2 / (p_d m_d,e^-2 + p_s m_s,e^-2)
    (Theorem 1 / Eq. 37);
  * expected leakage of one hop = sum_e P_capture(e) * q_e * delta (Eq. 30);
  * a Monte-Carlo draw of one hop's leakage (Eqs. 12-13, 20-21);
  * closed-form optimal powers for |D|=1 (Corollary 1) and |E|=1
    (Corollary 2).

Every function broadcasts over leading batch axes (hops, or the env
population). ``jax.random`` streams cannot be reproduced in torch, so
the Monte-Carlo draw takes its uniforms as an argument
(:class:`LeakDraws`, where the reference takes a key);
:func:`draw_leakage` makes them from a ``torch.Generator``.

Two models share the protocol: :class:`AnalyticLeakage`, the paper's,
whose per-layer information value comes from the profile's assumed
``leak_norm`` table, and :class:`EmpiricalLeakage`, the same wireless
physics with the per-layer value measured by a trained reconstruction
adversary (``repro_torch.attack``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.core.channel import NetworkConfig, channel_gain
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distribution.population import population_rand

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
    ``cuda`` by default; a ``distribution.population.PopulationGenerator``
    draws the whole population and keeps its rows)."""
    device = resolve_device(device)
    shape = tuple(batch_shape) + (num_eaves,)
    u = population_rand(shape + (num_decoys + 1,), gen, device)
    return LeakDraws(snr=1e-12 + u * (1.0 - 1e-12),
                     monitor=population_rand(shape, gen, device))


@runtime_checkable
class LeakageModel(Protocol):
    """Unified per-hop leakage estimator.

    ``evaluate(scenario, plan, draws=None, activations=None)`` returns the
    per-hop leakage ``(H,)`` of ``plan`` under ``scenario``'s physics: the
    expectation when ``draws`` is None, one Monte-Carlo draw per hop
    otherwise. ``activations`` optionally carries the smashed activations
    crossing each hop, for models that score them.

    ``layer_values(leak_norm)`` maps the profile's per-layer information
    table to the table this model prices hops with (identity for the
    analytic model): the hook ``MHSLEnv`` threads through its reward.
    """

    def evaluate(self, scenario, plan: HopGeometry,
                 draws: Optional[LeakDraws] = None,
                 activations=None) -> Tensor: ...

    def layer_values(self, leak_norm: np.ndarray) -> np.ndarray: ...


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

    def _hop_values(self, plan: HopGeometry, activations) -> Tensor:
        """Per-hop information values (H,) before the ``leak_scale``
        factor: the value table at each hop's boundary layer."""
        if self.value_table is None:
            raise ValueError("evaluate() needs a per-layer value table - "
                             "construct the model via "
                             "AnalyticLeakage.for_profile(profile) (or "
                             "EmpiricalLeakage.from_scores)")
        table = torch.as_tensor(self.value_table, dtype=torch.float32,
                                device=plan.p_tx.device)
        return table[plan.boundary_layer]

    def evaluate(self, scenario, plan: HopGeometry,
                 draws: Optional[LeakDraws] = None,
                 activations=None) -> Tensor:
        """Per-hop leakage (H,) of ``plan`` under ``scenario``: the Eq. 30
        expectation, or one Monte-Carlo draw per hop when ``draws``
        (leading axis H) is given. ``activations`` is ignored by the
        analytic model."""
        q_e = scenario.monitor_prob * scenario.eave_mask
        delta = self._hop_values(plan, activations) * scenario.leak_scale
        o = scenario.rayleigh_o
        if draws is None:
            return self.expected_leakage(plan.p_tx, plan.dist_tx_e,
                                         plan.decoy_p, plan.decoy_dist_e,
                                         q_e, delta, o)
        return self.sample_leakage(draws, plan.p_tx, plan.dist_tx_e,
                                   plan.decoy_p, plan.decoy_dist_e, q_e,
                                   delta, o)


@dataclass(frozen=True, eq=False)
class EmpiricalLeakage(AnalyticLeakage):
    """Attacker-measured leakage: the paper's physics, learned values.

    ``depths``/``scores`` hold the trained reconstruction adversary's
    attack accuracy (variance explained, in [0, 1]) at normalised cut
    depths; :meth:`layer_values` interpolates them onto any profile's
    layer axis, so a model measured on a depth-8 transformer prices a
    35-layer ResNet profile's cuts by relative depth. When ``score_fn``
    is set (``repro_torch.attack.make_activation_scorer``) and
    :meth:`evaluate` receives live smashed activations, the hop values
    come from scoring those activations with the trained decoders instead
    of the interpolated table.
    """

    depths: Optional[np.ndarray] = None  # (K,) normalised cut depths in (0, 1)
    scores: Optional[np.ndarray] = None  # (K,) measured attack accuracy
    score_fn: Optional[Callable] = None  # activations dict -> (H,) scores

    @classmethod
    def from_scores(cls, cuts, scores, num_layers_measured: int,
                    num_layers: Optional[int] = None,
                    score_fn: Optional[Callable] = None) -> "EmpiricalLeakage":
        """From per-cut attack accuracies measured on a
        ``num_layers_measured``-layer model; ``num_layers`` sizes the
        ``value_table`` :meth:`evaluate` prices with (the measured depth
        by default)."""
        depths = np.asarray(cuts, np.float64) / float(num_layers_measured)
        scores = np.asarray(scores, np.float64)
        order = np.argsort(depths)
        depths, scores = depths[order], scores[order]
        ell = num_layers_measured if num_layers is None else num_layers
        table = np.interp((np.arange(ell) + 1.0) / ell, depths, scores)
        return cls(value_table=table.astype(np.float32), depths=depths,
                   scores=scores, score_fn=score_fn)

    def layer_values(self, leak_norm: np.ndarray) -> np.ndarray:
        if self.depths is None or self.scores is None:
            raise ValueError("EmpiricalLeakage needs measured depths/scores "
                             "- build it via from_scores()")
        ell = len(leak_norm)
        vals = np.interp((np.arange(ell) + 1.0) / ell, self.depths, self.scores)
        return vals.astype(np.float32)

    def _hop_values(self, plan: HopGeometry, activations) -> Tensor:
        if activations is not None and self.score_fn is not None:
            return torch.as_tensor(self.score_fn(activations),
                                   dtype=torch.float32, device=plan.p_tx.device)
        return super()._hop_values(plan, activations)


_ANALYTIC = AnalyticLeakage()


def plan_hop_geometry(boundaries, devices, dev_pos, eav_pos, p_tx, decoy_p,
                      device: DeviceLike = None) -> HopGeometry:
    """HopGeometry for the forward hops of one concrete split plan.

    ``boundaries``/``devices`` are the (S,) plan arrays (cumulative layer
    counts / device per stage), ``dev_pos`` (U+1, 2) and ``eav_pos``
    (E, 2) the positions, ``p_tx`` scalar or (S-1,) trainer powers and
    ``decoy_p`` (D,) or (S-1, D) decoy powers (decoy interference priced
    at the eavesdropper, as in ``env.step``). The result lies on
    ``dev_pos``'s device when it is a tensor, else on ``device``
    (``cuda`` by default).
    """
    dev = (dev_pos.device if isinstance(dev_pos, torch.Tensor)
           else resolve_device(device))

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    b = torch.as_tensor(boundaries, device=dev).long()
    dv = torch.as_tensor(devices, device=dev).long()
    h = b.shape[0] - 1
    dev_pos, eav_pos = f32(dev_pos), f32(eav_pos)
    tx_pos = dev_pos[dv[:-1]]  # (H, 2) transmitting stage
    dist_tx_e = torch.linalg.vector_norm(eav_pos[None, :, :] - tx_pos[:, None, :],
                                         dim=-1)
    dde = torch.linalg.vector_norm(dev_pos[:, None, :] - eav_pos[None, :, :],
                                   dim=-1)  # (D, E)
    decoy_p = f32(decoy_p)
    if decoy_p.dim() == 1:
        decoy_p = decoy_p.expand(h, decoy_p.shape[0])
    return HopGeometry(p_tx=f32(p_tx).expand(h), dist_tx_e=dist_tx_e,
                       decoy_p=decoy_p, decoy_dist_e=dde.expand((h,) + dde.shape),
                       boundary_layer=torch.clamp(b[:-1] - 1, min=0))


def evaluate_leakage(model: LeakageModel, scenario, plan: HopGeometry,
                     draws: Optional[LeakDraws] = None,
                     activations=None) -> Tensor:
    """Functional entry point of the protocol: per-hop leakage (H,)."""
    return model.evaluate(scenario, plan, draws=draws, activations=activations)


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


# ---------------------------------------------------------------------------
# Corollaries: closed-form optimal powers
# ---------------------------------------------------------------------------


def _f32(*xs):
    return tuple(torch.as_tensor(x, dtype=torch.float32) for x in xs)


def optimal_powers_single_decoy(bits, dist_tx_rx, dist_tx_decoy, b_t, b_e,
                                net: NetworkConfig) -> Tuple[Tensor, Tensor]:
    """Corollary 1 (|D|=1): returns (p_s*, p_d*).

    xi_0 p_s - xi_d p_d = chi_1 (rate constraint tight)
    p_s + p_d = chi_2 = B_E / B_T (energy tight)

    ``dist_tx_decoy`` is the decoy's interference distance at the
    receiver. Where the energy budget is tight (xi_0 chi_2 < chi_1) the
    interior solution would give the decoy negative power: the decoy is
    clamped to 0 and the whole budget goes to the trainer. The energy
    identity p_s + p_d = chi_2 holds in both regimes. Inputs are taken
    in f32, as the reference evaluates them.
    """
    bits, dist_tx_rx, dist_tx_decoy, b_t, b_e = _f32(
        bits, dist_tx_rx, dist_tx_decoy, b_t, b_e)
    o = net.rayleigh_o
    snr_req = 2.0 ** (bits / (b_t * net.bandwidth_hz)) - 1.0
    xi0 = o / dist_tx_rx ** 2
    xid = (o / dist_tx_decoy ** 2) * snr_req
    chi1 = net.noise_w * snr_req
    chi2 = b_e / b_t
    p_d = torch.clamp((xi0 * chi2 - chi1) / (xi0 + xid), min=0.0)
    # equals (chi1 + xid*chi2)/(xi0 + xid) in the interior regime
    p_s = chi2 - p_d
    return p_s, p_d


def optimal_powers_single_eave(bits, dist_tx_rx, decoy_dist_e, b_t, b_e,
                               net: NetworkConfig) -> Tuple[Tensor, Tensor]:
    """Corollary 2 (|E|=1, decoy interference at the receiver ignored):
    returns (p_s*, p_d* (D,)) for ``decoy_dist_e`` (D,) decoy ->
    eavesdropper distances.

    Clamped to physical powers: if the rate constraint alone demands more
    than the whole energy budget (chi_1/xi_0 > chi_2) the trainer gets the
    full budget and the decoys 0.
    """
    bits, dist_tx_rx, decoy_dist_e, b_t, b_e = _f32(
        bits, dist_tx_rx, decoy_dist_e, b_t, b_e)
    o = net.rayleigh_o
    snr_req = 2.0 ** (bits / (b_t * net.bandwidth_hz)) - 1.0
    xi0 = o / dist_tx_rx ** 2
    chi1 = net.noise_w * snr_req
    chi2 = b_e / b_t
    p_s = torch.minimum(chi1 / xi0, chi2)
    # water-levelling: equalize p_d m_{d,e}^-2 across decoys (Eq. 47-50)
    budget = torch.clamp(chi2 - p_s, min=0.0)
    denom = torch.sum(decoy_dist_e ** 2)
    p_d = budget * decoy_dist_e ** 2 / torch.clamp(denom, min=1e-30)
    return p_s, p_d
