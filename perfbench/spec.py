"""``BENCHMARK.json`` and the data files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own, found by its name:

* ``perfbench/configs/<config>.json`` (the entry's ``file``): the
  model's published sizes, the cuts, the plan, dtypes and optimizer;
* ``perfbench/traffic/<traffic>.json``: the traffic's parameters, read
  by the runner its ``kind`` names (``perfbench/runners/<kind>.py``);
* ``perfbench/checks/<cell>.json``: the limits of the numbers that
  decide ``correct``, and the readings each was set from;
* ``perfbench/metrics/<metric>.py``: one reader per per-layer metric.

Nothing here lists a configuration, a cell or a metric.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent



@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    check: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its data files and the
    metrics it reports."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(root / "perfbench" / "traffic" / f"{entry['traffic']}.json"),
        check=load_json(root / "perfbench" / "checks" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (a metric's reader, a
    runner, a port or a reference chosen by a name in the data)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = sys.modules.get(name)
    if mod is None:
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` of ``perfbench/metrics/<metric>.py``."""
    return load_module(root / "perfbench" / "metrics" / f"{metric}.py",
                       f"perfbench_metric_{metric.replace('.', '_')}").read


def runner(kind: str, root: Path = ROOT):
    return load_module(root / "perfbench" / "runners" / f"{kind}.py",
                       f"perfbench_runner_{kind}")


def family(kind: str, family_name: str, root: Path = ROOT):
    """``perfbench/<kind>/<family>.py``: ``ports`` maps a configuration to
    the program's, ``reference`` is the plain model."""
    return load_module(root / "perfbench" / kind / f"{family_name}.py",
                       f"perfbench_{kind}_{family_name}")

