"""Corollaries 1-2 on the port: closed-form optimal powers against an
exhaustive grid search (the counterpart of ``benchmarks/table_power.py``).

For sampled geometries, the closed form of Corollary 1 (one decoy) should
attain, up to the grid's resolution, the least expected leakage among all
feasible power pairs; Corollary 2 (one eavesdropper) should water-level
the decoys' received powers. The grid is priced in one batched pass.
Run on the card::

    PYTHONPATH=src python -m repro_torch.figures.table_power
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.channel import NetworkConfig, data_rate, tx_time
from repro_torch.core.leakage import (
    expected_leakage,
    optimal_powers_single_decoy,
    optimal_powers_single_eave,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.figures.common import device_name, emit_csv_row, save_json

GRID = 60  # grid points per power axis, as in the reference


def grid_best(bits, d_tx_rx, d_tx_d, dist_e, dd_e, b_t, b_e, net, n=GRID,
              device: DeviceLike = None):
    """Least expected leakage over an ``n x n`` grid of (trainer, decoy)
    powers that meet the energy budget and the rate constraint; returns
    ``(leak, (p_s, p_d))``, ``(inf, None)`` when no point is feasible.
    Ties go to the first point in the reference's loop order (trainer
    power outer)."""
    dev = resolve_device(device)
    grid = np.linspace(1e-3, float(b_e / b_t), n)
    ps, pd = (x.reshape(-1) for x in np.meshgrid(grid, grid, indexing="ij"))
    energy_ok = ~((ps + pd) * float(b_t) > float(b_e) + 1e-12)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    ps_t, pd_t = f32(ps), f32(pd)[:, None]
    rate = data_rate(ps_t, f32(d_tx_rx), pd_t, f32([d_tx_d]), net)
    ok = (torch.as_tensor(energy_ok, device=dev)
          & ~(tx_time(f32(bits), rate) > float(b_t)))
    leak = expected_leakage(ps_t, f32(dist_e), pd_t, f32(dd_e),
                            f32([net.monitor_prob]), f32(1.0))
    leak = torch.where(ok, leak, torch.inf)
    i = int(torch.argmin(leak))
    best = float(leak[i])
    if best == float("inf"):
        return best, None
    return best, (float(ps[i]), float(pd[i]))


def power_rows(seed: int = 0, trials: int = 5, n: int = GRID,
               device: DeviceLike = None):
    """Corollary 1 against the grid for ``trials`` sampled geometries (the
    reference's draws from ``numpy.random.default_rng(seed)``)."""
    dev = resolve_device(device)
    net = NetworkConfig()
    rng = np.random.default_rng(seed)
    q = torch.tensor([net.monitor_prob], device=dev)
    one = torch.tensor(1.0, device=dev)
    rows = []
    for trial in range(trials):
        d_tx_rx = float(rng.uniform(80, 300))
        d_tx_d = float(rng.uniform(80, 300))
        dist_e = [float(rng.uniform(100, 400))]
        dd_e = [[float(rng.uniform(50, 200))]]
        bits, b_t, b_e = 2e6, 1.5, 3.0
        p_s, p_d = optimal_powers_single_decoy(bits, d_tx_rx, d_tx_d, b_t, b_e, net)
        p_s, p_d = p_s.to(dev), p_d.to(dev)
        closed = float(expected_leakage(
            p_s, torch.tensor(dist_e, device=dev), p_d[None],
            torch.tensor(dd_e, device=dev), q, one))
        g_leak, _ = grid_best(bits, d_tx_rx, d_tx_d, dist_e, dd_e, b_t, b_e,
                              net, n=n, device=dev)
        rows.append(dict(trial=trial, closed_leak=closed, grid_leak=g_leak,
                         p_s=float(p_s), p_d=float(p_d),
                         gap_pct=100 * (closed - g_leak) / max(g_leak, 1e-12)))
    return rows


def water_level_spread(device: DeviceLike = None) -> float:
    """Corollary 2: spread of the decoys' received powers p_d / m^2 at
    three eavesdropper distances (0 when water-levelled)."""
    dd_e = np.asarray([100.0, 250.0, 400.0], np.float32)
    _, p_d = optimal_powers_single_eave(
        2e6, 150.0, torch.as_tensor(dd_e, device=resolve_device(device)),
        1.5, 3.0, NetworkConfig())
    recv = p_d.cpu().numpy() / dd_e ** 2
    return float(recv.max() - recv.min())


def main(seed: int = 0, trials: int = 5, n: int = GRID,
         device: DeviceLike = None):
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rows = power_rows(seed, trials, n, dev)
    secs = time.perf_counter() - t0
    worst_gap = max(r["gap_pct"] for r in rows)
    spread = water_level_spread(dev)
    save_json("table_power", {"device": device_name(dev), "rows": rows,
                              "worst_gap_pct": worst_gap,
                              "recv_power_spread": spread})
    emit_csv_row("table_power/cor1", secs * 1e6 / max(len(rows), 1),
                 f"worst_gap_vs_grid={worst_gap:.2f}%")
    emit_csv_row("table_power/cor2", 0.0,
                 f"recv_power_spread={spread:.2e} (water-levelled)")
    return {"worst_gap_pct": worst_gap, "rows": rows,
            "recv_power_spread": spread}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(trials=a.trials, device=a.device)
