#!/usr/bin/env python3
"""Make the JAX side of the port's fig-10 attack band.

Trains the JAX package's attacker population
(``repro.attack.train_attacker_population``) at the configuration of
``repro_torch.figures.fig10_leakage_attack.BAND`` (the depth-8 probe
model, cuts 1-7, q in (0.3, 0.8), 600 steps) on each of the band's
seeds, and writes the configuration and, per seed, the held-out score
table (cuts x scenarios) to ``tests/data/torch_attack_reference.json``.
The card's machine has no JAX, so the file is made on the CPU and
committed. Run from the repository root::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_attack_reference.py
"""
from __future__ import annotations

import json
import os
import time

from repro.attack import (capture_weight, tiny_attack_model_cfg,
                          train_attacker_population)
from repro_torch.figures import fig10_leakage_attack as FIG10

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                   "torch_attack_reference.json")


def main() -> None:
    band = FIG10.BAND
    cfg = tiny_attack_model_cfg(depth=FIG10.DEPTH)
    cw = [capture_weight(q) for q in band["qs"]]
    runs = []
    t0 = time.perf_counter()
    for seed in band["seeds"]:
        res = train_attacker_population(
            cfg, cuts=band["cuts"], capture_weights=cw, steps=band["steps"],
            seed=seed, train_tokens=tuple(band["train_tokens"]),
            eval_tokens=tuple(band["eval_tokens"]))
        runs.append({"seed": seed, "scores": res.scores.tolist()})
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    with open(OUT, "w") as f:
        json.dump({"config": band, "runs": runs}, f, indent=1)
    print(f"{len(runs)} seeds in {time.perf_counter() - t0:.1f} s -> {OUT}")


if __name__ == "__main__":
    main()
