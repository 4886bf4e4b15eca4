"""Readings that the limits of ``perfbench/checks/<cell>.json`` are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        --faults 3 [--out FILE]

In one process, for each seed: the program's first steps of the cell
(the runner's check steps, at the cell's sizes) against the reference's
(``compare.gaps``): the lower readings. For the first ``--faults`` seeds
also the upper ones, each against the same reference:

* ``control``: the reference in the program's place, its products in
  the precision below the configuration's compute dtype (bf16 -> float8
  e4m3, ``dtypes.control``);
* ``half_batch``: the reference in the program's place with half of the
  batch left out, the mean taken over the rest (the first half of the
  rows in half as many microbatches);
* ``state_unchanged``: the reference in the program's place with a
  learning rate of 0, so that every step starts from the seed's weights.
  On ``change_gap``, ``grad_gap`` and ``grad_dist`` it reads 1 by their
  definition (AdamW's first moment stays 0); its run reads the losses
  and norms of the later steps.

Each reading is one JSON line on standard output (and in ``--out``); the
last line sums them up: per number, the largest program reading and the
smallest reading of each fault.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "perfbench":
    sys.path.pop(0)

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--faults", type=int, default=3,
                    help="seeds (the first ones) that also read the faults")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from perfbench import compare, spec

    cell = spec.cell(args.workload, ROOT)
    train = spec.runner(cell.traffic["kind"], ROOT)
    dev = torch.device("cuda")
    n_check = int(cell.check["steps"])
    micro = cell.traffic["microbatches"]
    out = open(args.out, "a") if args.out else None
    rows = []

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        prog = train.Program(cell, seed, dev)
        ours, batches = prog.check_steps(n_check)
        layout = prog.layout
        del prog
        train.free(dev)
        t1 = time.perf_counter()
        ref = train.reference(cell, seed, layout, batches, micro,
                              cell.config["dtypes"]["reference"], dev)
        t2 = time.perf_counter()
        emit({"seed": seed, "kind": "program", **compare.gaps(ours, ref),
              "losses": ours.loss, "ref_losses": ref.loss, "norms": ours.norm,
              "ref_norms": ref.norm, "still": compare.still_leaves(ref),
              "dist": compare.leaf_dist(ours, ref),
              "program_s": t1 - t0, "reference_s": t2 - t1})
        if i < args.faults:
            ctl = train.reference(cell, seed, layout, batches, micro,
                                  cell.config["dtypes"]["control"], dev)
            emit({"seed": seed, "kind": "control", **compare.gaps(ctl, ref),
                  "dist": compare.leaf_dist(ctl, ref)})
            half = [(a[: a.shape[0] // 2], b[: b.shape[0] // 2]) for a, b in batches]
            hb = train.reference(cell, seed, layout, half, micro // 2,
                                 cell.config["dtypes"]["reference"], dev)
            emit({"seed": seed, "kind": "half_batch", **compare.gaps(hb, ref)})
            still = train.reference(cell, seed, layout, batches, micro,
                                    cell.config["dtypes"]["reference"], dev,
                                    dict(cell.config["optimizer"], lr=0.0))
            emit({"seed": seed, "kind": "state_unchanged", **compare.gaps(still, ref)})
        train.free(dev)

    summary = {"summary": args.workload}
    for kind, pick in (("program", max), ("control", min), ("half_batch", min),
                       ("state_unchanged", min)):
        got = [r for r in rows if r["kind"] == kind]
        if got:
            summary[kind] = {n: pick(r[n] for r in got) for n in compare.NUMBERS}
    emit(summary)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
