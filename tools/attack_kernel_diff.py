#!/usr/bin/env python3
"""What a training step of the attacker population launches on the card,
by CUDA event name, in a fresh process.

Usage, on a machine with one card::

    PYTHONPATH=src python3 tools/attack_kernel_diff.py [--reps 2] [--steps 10] \
        [--against chiprun_out/t1_names.json]

For each repetition and each of populations 1, 2 and 14 (fig 10's probe:
``tiny_attack_model_cfg(depth=8)``), ``attack.population.profile_kernel_names``
counts the CUDA events of one ``steps``-step chunk by name. The script
prints each profile's events per step, then every name whose count
differs between populations 2 and 14 or from the first repetition.
``--against FILE`` reads the names by population that
``chip_smoke.py``'s (T1) phase writes from its long-lived process
(``chiprun_out/t1_names.json``) and prints every name whose count
differs from this process's first repetition. The last line is one JSON
object with the per-profile totals and the differing names.
"""
from __future__ import annotations

import argparse
import json
import sys

POPULATIONS = (1, 2, 14)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("attack_kernel_diff: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.attack import AttackConfig, tiny_attack_model_cfg
    from repro_torch.attack.population import profile_kernel_names

    mcfg = tiny_attack_model_cfg(depth=8)
    acfg = AttackConfig(d_data=mcfg.d_model, d_smash=mcfg.d_model)
    runs = {}
    for rep in range(args.reps):
        for n in POPULATIONS:
            names = profile_kernel_names(acfg, n, steps=args.steps, device="cuda")
            runs[(n, rep)] = names
            print(f"population {n} rep {rep}: "
                  f"{sum(names.values()) / args.steps:.1f} CUDA events a step, "
                  f"{len(names)} names", flush=True)

    def differ(a, b):
        return {k[:200]: (a.get(k, 0), b.get(k, 0))
                for k in sorted(set(a) | set(b)) if a.get(k, 0) != b.get(k, 0)}

    out = {"per_step": {f"{n}/{rep}": sum(v.values()) / args.steps
                        for (n, rep), v in runs.items()},
           "2_vs_14": {rep: differ(runs[(2, rep)], runs[(14, rep)])
                       for rep in range(args.reps)},
           "vs_rep_0": {f"{n}/{rep}": differ(runs[(n, 0)], runs[(n, rep)])
                        for (n, rep) in runs if rep}}
    if args.against:
        with open(args.against) as f:
            long_run = json.load(f)
        out["against"] = {n: differ(runs[(int(n), 0)], v)
                          for n, v in long_run.items() if int(n) in POPULATIONS}
    for what, table in out.items():
        if what == "per_step":
            continue
        for key, moved in table.items():
            for name, (a, b) in moved.items():
                print(f"{what} {key}: {name[:120]!r}: {a} -> {b}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
