"""Fig. 10 (repo extension) on the port: analytic vs attacker-measured
leakage per cut (the counterpart of ``benchmarks/fig10_leakage_attack.py``).

Trains the FSHA-style attacker population of ``repro_torch.attack``, one
attacker per (cut point x monitoring scenario), stacked and in lockstep,
against the smashed activations of a reduced depth-8 transformer, then
prices every cut of an 8-stage split plan with both ``LeakageModel``
implementations on the same ``HopGeometry``:

* ``analytic``: the paper's closed-form Eq. 30 with the profile's assumed
  depth-decaying ``leak_norm`` table;
* ``empirical``: the same wireless physics, the per-layer values replaced
  by the trained attackers' measured reconstruction accuracy.

Prints one CSV row per cut and writes a JSON with the training MSE
quarters (the gate: the high-capture attackers' MSE falls on average),
the population's attacker-steps/s, the torch ops a training step
dispatches and, on the card, the CUDA kernels it launches. Run on the
card, or on the CPU with ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.figures.fig10_leakage_attack [--smoke]

:data:`BAND` is the configuration ``chip_smoke.py`` holds to the JAX
package's runs (``tests/data/torch_attack_reference.json``, made by
``tools/jax_attack_reference.py``): per (cut, scenario) the mean held-out
score over seeds, by ``figures.band``'s rule.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.attack import (
    AttackConfig, capture_weight, empirical_model_from, tiny_attack_model_cfg,
    train_attacker_population, train_attacker_populations,
)
from repro_torch.attack.population import (
    count_ops_per_step, profile_kernels_per_step,
)
from repro_torch.core.channel import NetworkConfig
from repro_torch.core.leakage import (
    AnalyticLeakage, evaluate_leakage, plan_hop_geometry,
)
from repro_torch.core.profiles import transformer_profile
from repro_torch.core.scenario import scenario_from_net
from repro_torch.device import resolve_device
from repro_torch.figures.common import device_name, emit_csv_row, save_json

DEPTH = 8
QS = (0.3, 0.8)  # monitoring probabilities -> attacker capture scenarios

BAND = {
    "model": f"tiny_attack_model_cfg(depth={DEPTH})",
    "cuts": list(range(1, DEPTH)),
    "qs": list(QS),
    "steps": 600,
    "control_steps": 60,
    "train_tokens": [32, 64],
    "eval_tokens": [8, 64],
    "seeds": list(range(32)),
}
TORCH_SEEDS = 16  # the port's seeds in chip_smoke.py: the band's first 16


def band_scores(seeds, steps: int, device=None) -> np.ndarray:
    """The band's seeds on the port, all in one stacked population:
    held-out scores (seeds, cuts, qs)."""
    res = train_attacker_populations(
        tiny_attack_model_cfg(depth=DEPTH), seeds=seeds, cuts=BAND["cuts"],
        capture_weights=[capture_weight(q) for q in BAND["qs"]], steps=steps,
        train_tokens=tuple(BAND["train_tokens"]),
        eval_tokens=tuple(BAND["eval_tokens"]), device=device)
    return np.stack([r.scores for r in res])


def _plan_and_scenario(net: NetworkConfig, device):
    """One 8-stage plan (one layer per stage: a hop at every cut) over a
    fixed line of devices with two eavesdroppers."""
    n_dev = DEPTH
    xs = torch.linspace(60.0, 440.0, n_dev)
    dev_pos = torch.stack([xs, torch.full((n_dev,), 250.0)], dim=1)
    eav_pos = torch.tensor([[150.0, 150.0], [350.0, 360.0]])[: net.num_eaves]
    decoy_p = torch.zeros((n_dev,))
    decoy_p[0] = decoy_p[n_dev - 1] = 0.2
    plan = plan_hop_geometry(torch.arange(1, DEPTH + 1), torch.arange(DEPTH),
                             dev_pos.to(device), eav_pos, p_tx=0.5,
                             decoy_p=decoy_p)
    sc = scenario_from_net(net, device=device)
    return plan, sc._replace(eave_mask=torch.ones((net.num_eaves,), device=device))


def main(seed: int = 0, smoke: bool = False, device=None):
    dev = resolve_device(device)
    steps = 200 if smoke else BAND["steps"]
    cuts = np.arange(1, DEPTH)
    model_cfg = tiny_attack_model_cfg(depth=DEPTH)
    cw = [capture_weight(q) for q in QS]

    res = train_attacker_population(model_cfg, cuts=cuts, capture_weights=cw,
                                    steps=steps, seed=seed, device=dev)
    acfg = AttackConfig(d_data=model_cfg.d_model, d_smash=model_cfg.d_model)
    res.ops_per_step = count_ops_per_step(acfg, res.population, device=dev)
    if dev.type == "cuda":
        res.kernels_per_step = profile_kernels_per_step(acfg, res.population,
                                                        device=dev)
    hi = int(np.argmax(cw))  # the highest-capture scenario prices the hops

    prof = transformer_profile(model_cfg, batch=1, seq=64)
    analytic = AnalyticLeakage.for_profile(prof)
    empirical = empirical_model_from(res, scenario_idx=hi)

    net = NetworkConfig()
    plan, sc = _plan_and_scenario(net, dev)
    rows = {}
    for qi, q in enumerate(QS):
        scq = sc._replace(monitor_prob=torch.full((net.num_eaves,), q, device=dev))
        la = evaluate_leakage(analytic, scq, plan).cpu().numpy()
        le = evaluate_leakage(empirical, scq, plan).cpu().numpy()
        rows[q] = {"analytic": la.tolist(), "empirical": le.tolist()}
        if qi == len(QS) - 1:
            for k, cut in enumerate(cuts):
                emit_csv_row(
                    f"fig10/cut={cut}", 0.0,
                    f"analytic={la[k]:.4f} empirical={le[k]:.4f} "
                    + " ".join(f"score(q={QS[s]})={res.scores[k, s]:.3f}"
                               for s in range(len(QS))))

    # the training-health trace of the gate: mean recon MSE of the
    # high-capture attackers in step quarters
    mse_hi = res.recon_mse[:, hi, :].mean(axis=0)
    quarters = mse_hi.reshape(4, -1).mean(axis=1)
    rate = res.population * steps / max(res.seconds, 1e-9)
    payload = {
        "device": device_name(dev),
        "cuts": cuts.tolist(),
        "qs": list(QS),
        "capture_weights": res.capture_weights.tolist(),
        "scores": res.scores.tolist(),
        "final_mse": res.final_mse.tolist(),
        "rows": rows,
        "mse_quarters": quarters.tolist(),
        "population": res.population,
        "steps": steps,
        "pool_seconds": res.pool_seconds,
        "train_seconds": res.seconds,
        "attacker_steps_per_s": rate,
        "ops_per_step": res.ops_per_step,
        "kernels_per_step": res.kernels_per_step,
    }
    save_json("fig10_leakage_attack", payload)
    emit_csv_row("fig10/summary", res.seconds * 1e6 / max(res.population * steps, 1),
                 f"population={res.population} attacker_steps_per_s={rate:.1f} "
                 f"ops_per_step={res.ops_per_step} "
                 f"kernels_per_step={res.kernels_per_step} "
                 f"mse_quarters={'/'.join(f'{m:.3f}' for m in quarters)}")
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="200 steps, not 600")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda unless given")
    a = ap.parse_args()
    main(seed=a.seed, smoke=a.smoke, device=a.device)
