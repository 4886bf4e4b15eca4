"""Wireless channel model (paper §II-C, Eq. 5) + Table-I constants.

PyTorch port of ``repro.core.channel``. TDMA links with Rayleigh fading;
deceptive-signal devices appear as interference in the SINR of
eavesdropped/legitimate links. Every function broadcasts over leading
batch axes (the env's population axis); an interferer axis is always the
last one.

The ``net`` argument of every physics function is duck-typed: the static
``NetworkConfig`` (host floats) or a ``ScenarioParams`` of f32 tensors
(``repro_torch.core.scenario``); both expose ``bandwidth_hz``,
``noise_w``, ``rayleigh_o``, ``f_cpu_hz``, ``theta_chip``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclass(frozen=True)
class NetworkConfig:
    """Paper Table I defaults (field for field the JAX package's).

    Structure-defining fields (``num_devices``, ``num_eaves``,
    ``max_split``, ``len(power_levels)``) fix tensor shapes; every other
    field is a physics value carried at run time by ``ScenarioParams``.
    """

    num_devices: int = 6  # U
    num_eaves: int = 2  # E
    area_m: float = 800.0  # 800 x 800 m^2
    bandwidth_hz: float = 1e6  # B = 1 MHz
    # per-hop link overrides: empty = every hop at ``bandwidth_hz``; a
    # tuple of length ``max_split - 1`` gives each hop its own bandwidth.
    # ``hop_latency`` is a fixed per-hop link latency (s).
    hop_bandwidth: tuple = ()
    hop_latency: float = 0.0
    noise_dbm_hz: float = -90.0  # N0
    rayleigh_o: float = 1.0  # o
    monitor_prob: float = 0.8  # q_e
    gamma_t: float = 8.0  # per-iteration delay budget (s)
    gamma_e: float = 75.0  # per-iteration energy budget (J)
    f_cpu_hz: float = 5.5e9  # f^B, 4-7 GHz
    omega_cycles_per_bit: float = 1e5  # omega^B, 1e4-1e6
    lambda_f: float = 1.5e9  # lambda_f FLOPs-scale coefficient (Table I)
    lambda_b: float = 1.5e9  # lambda_b
    theta_chip: float = 1e-28  # vartheta_k energy coefficient
    # maintenance cycles per resident state bit per iteration (0.0 =
    # homogeneous residual-MLP pricing)
    state_cycles_per_bit: float = 0.0
    power_levels: tuple = (0.1, 0.2, 0.5, 1.0)  # discrete transmit powers (W)
    max_split: int = 4  # S (number of sub-models incl. server)

    @property
    def noise_w(self) -> float:
        # N0 * B in watts
        return 10 ** (self.noise_dbm_hz / 10) * 1e-3 * self.bandwidth_hz

    @property
    def hop_bandwidth_hz(self) -> np.ndarray:
        """Per-hop bandwidths, shape ``(max_split - 1,)``."""
        h = self.max_split - 1
        if self.hop_bandwidth:
            if len(self.hop_bandwidth) != h:
                raise ValueError(
                    f"hop_bandwidth needs {h} entries (max_split - 1), "
                    f"got {len(self.hop_bandwidth)}")
            return np.asarray(self.hop_bandwidth, np.float64)
        return np.full(h, self.bandwidth_hz, np.float64)

    @property
    def hop_latency_s(self) -> np.ndarray:
        """Per-hop fixed link latencies, shape ``(max_split - 1,)``."""
        return np.full(self.max_split - 1, self.hop_latency, np.float64)


def channel_gain(dist: Tensor, o=1.0) -> Tensor:
    """h = o * m^-2 (paper's distance-squared path loss)."""
    return o / torch.clamp(dist, min=1.0) ** 2


def data_rate(p_tx, dist_tx_rx, interferer_p, interferer_dist_rx,
              net: NetworkConfig, bandwidth_hz=None) -> Tensor:
    """Eq. 5: TDMA SINR rate with deceptive-signal interference.

    ``interferer_p`` / ``interferer_dist_rx``: (..., D) powers of the
    deceptive devices (0 for inactive) and their distances to the
    receiver; the interference sums over the last axis. ``bandwidth_hz``
    optionally overrides the link bandwidth (noise scales with it).
    """
    sig = p_tx * channel_gain(dist_tx_rx, net.rayleigh_o)
    interf = torch.sum(interferer_p * channel_gain(interferer_dist_rx,
                                                   net.rayleigh_o), dim=-1)
    if bandwidth_hz is None:
        bw, noise = net.bandwidth_hz, net.noise_w
    else:
        bw = bandwidth_hz
        noise = net.noise_w * (bw / net.bandwidth_hz)
    sinr = sig / (interf + noise)
    return bw * torch.log2(1.0 + sinr)


def tx_time(bits: Tensor, rate: Tensor) -> Tensor:
    """Eqs. 6-7: transmission delay of ``bits`` at ``rate``."""
    return bits / torch.clamp(rate, min=1.0)


IPC = 8.0  # FLOPs retired per cycle on the edge-device CPU model


def compute_time_fwd(fwd_flops, net: NetworkConfig, lam=1.0):
    """Eq. 8 re-expressed: T^F = lambda_f * FLOPs / (f * IPC)."""
    return lam * fwd_flops / (net.f_cpu_hz * IPC)


def compute_time_bwd(bwd_flops, net: NetworkConfig, lam=1.0):
    """Eq. 9, same structure with lambda_b."""
    return lam * bwd_flops / (net.f_cpu_hz * IPC)


def compute_energy(flops, net: NetworkConfig):
    """First term of Eq. 11: vartheta * f^2 * cycles (cycles = FLOPs/IPC)."""
    return net.theta_chip * net.f_cpu_hz ** 2 * (flops / IPC)


def state_time(state_bits, net: NetworkConfig):
    """Per-direction cost of a stage's resident state (cycles per bit over
    the CPU clock)."""
    return net.state_cycles_per_bit * state_bits / net.f_cpu_hz


def state_energy(state_bits, net: NetworkConfig):
    """Eq. 11 energy of one direction's state-maintenance cycles."""
    return net.theta_chip * net.f_cpu_hz ** 2 * (
        net.state_cycles_per_bit * state_bits)


def sample_positions(gen: torch.Generator, num_envs: int, num_devices: int,
                     num_eaves: int, area_m, device: DeviceLike = None):
    """Device + eavesdropper positions uniform in the area, for a batch of
    ``num_envs`` envs: ``(num_envs, U, 2)`` and ``(num_envs, E, 2)``.
    ``gen`` must live on ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    dev = torch.rand((num_envs, num_devices, 2), generator=gen,
                     device=device) * area_m
    eav = torch.rand((num_envs, num_eaves, 2), generator=gen,
                     device=device) * area_m
    return dev, eav


def pairwise_dist(a: Tensor, b: Tensor) -> Tensor:
    """a: (..., N, 2), b: (..., M, 2) -> (..., N, M)."""
    return torch.sqrt(torch.sum((a[..., :, None, :] - b[..., None, :, :]) ** 2,
                                dim=-1) + 1e-9)
