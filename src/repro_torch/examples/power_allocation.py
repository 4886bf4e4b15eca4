"""Optimal transmit powers (Theorem 1 + Corollaries 1-2) walkthrough.

    PYTHONPATH=src python -m repro_torch.examples.power_allocation [--device cpu]

The counterpart of the JAX package's ``examples/power_allocation.py``,
with its inputs: how expected leakage E[I] (Eq. 30) moves with trainer
and decoy power, and that the closed-form powers hit the constrained
optimum. It runs on the card unless ``--device cpu`` is given.
:func:`power_allocation` returns every value ``main`` prints.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core.channel import NetworkConfig, data_rate, tx_time
from repro_torch.core.leakage import (
    expected_leakage,
    optimal_powers_single_decoy,
    optimal_powers_single_eave,
)
from repro_torch.device import DeviceLike, resolve_device

TRAINER_POWERS = (0.05, 0.2, 0.5, 1.0, 1.5)
DECOY_POWERS = (0.0, 0.1, 0.5, 1.0, 2.0)
DECOY_DISTS = (100.0, 250.0, 400.0)


def power_allocation(device: DeviceLike = None) -> Dict[str, Any]:
    """The example's values as Python floats: E[I] and the hop time
    against trainer power, E[I] against decoy power, Corollary 1's powers
    with their E[I], hop time and energy, and Corollary 2's powers with
    each decoy's power received at the eavesdropper."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    net = NetworkConfig()
    d_tx_rx = t(150.0)  # trainer -> receiver
    d_tx_d = t(180.0)  # decoy interference at the receiver
    dist_e = t([250.0])  # trainer -> eavesdropper
    dd_e = t([[90.0]])  # decoy -> eavesdropper (close!)
    q = t([net.monitor_prob])
    bits = t(2e6)
    b_t, b_e = t(1.5), t(3.0)
    one = t(1.0)
    out: Dict[str, Any] = {"trainer": [], "decoy": []}
    for ps in TRAINER_POWERS:
        leak = expected_leakage(t(ps), dist_e, t([0.5]), dd_e, q, one)
        rate = data_rate(t(ps), d_tx_rx, t([0.5]), d_tx_d[None], net)
        out["trainer"].append(dict(p_s=ps, leak=float(leak),
                                   hop_time=float(tx_time(bits, rate))))
    for pd in DECOY_POWERS:
        leak = expected_leakage(t(0.5), dist_e, t([pd]), dd_e, q, one)
        out["decoy"].append(dict(p_d=pd, leak=float(leak)))

    p_s, p_d = optimal_powers_single_decoy(bits, d_tx_rx, d_tx_d, b_t, b_e, net)
    leak = expected_leakage(p_s, dist_e, p_d[None], dd_e, q, one)
    rate = data_rate(p_s, d_tx_rx, p_d[None], d_tx_d[None], net)
    out["corollary1"] = dict(p_s=float(p_s), p_d=float(p_d), leak=float(leak),
                             hop_time=float(tx_time(bits, rate)),
                             energy=(float(p_s) + float(p_d)) * float(b_t))

    dd_many = t(DECOY_DISTS)
    p_s2, p_d2 = optimal_powers_single_eave(bits, d_tx_rx, dd_many, b_t, b_e, net)
    p_d2 = [float(x) for x in p_d2.cpu()]
    out["corollary2"] = dict(
        p_s=float(p_s2), p_d=p_d2,
        received=[pd / d ** 2 for pd, d in zip(p_d2, DECOY_DISTS)])
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = power_allocation(args.device)

    print("E[leak] vs trainer power (decoy fixed 0.5 W):")
    for r in res["trainer"]:
        print(f"  p_s={r['p_s']:4.2f} W  E[I]={r['leak']:.4f}  "
              f"hop_time={r['hop_time']:6.2f} s")
    print("\nE[leak] vs decoy power (trainer fixed 0.5 W):")
    for r in res["decoy"]:
        print(f"  p_d={r['p_d']:4.2f} W  E[I]={r['leak']:.4f}")
    c1 = res["corollary1"]
    print(f"\nCorollary 1 (|D|=1): p_s*={c1['p_s']:.3f} W  p_d*={c1['p_d']:.3f} W")
    print(f"  E[I]={c1['leak']:.4f}, hop_time={c1['hop_time']:.3f} s (= B_T), "
          f"energy={c1['energy']:.3f} J (= B_E)")
    c2 = res["corollary2"]
    print(f"\nCorollary 2 (|E|=1, 3 decoys): p_s*={c2['p_s']:.3f} W")
    for i, (pd, rx) in enumerate(zip(c2["p_d"], c2["received"])):
        print(f"  decoy {i}: d_e={DECOY_DISTS[i]:.0f} m  p_d*={pd:.3f} W "
              f"(received at eave: {rx:.2e})")
    print("  -> received decoy powers are water-levelled at the eavesdropper.")
    return res


if __name__ == "__main__":
    main()
