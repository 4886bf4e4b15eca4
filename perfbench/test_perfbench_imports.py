"""What the benchmark loads: never JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` is not ``repro``), and a
reference that loads nothing of the program. A run without a card
prints no result."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_names_after(code: str):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = (
        "from perfbench import spec, compare, weights, yardstick, devtrace\n"
        "b = spec.benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = spec.cell(w['name'])\n"
        "    spec.runner(c.traffic['kind'])\n"
        "    spec.family('ports', c.config['family'])\n"
        "    spec.family('reference', c.config['family'])\n"
        "for m in b['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "import repro_torch.launch.train_mhsl_rl, repro_torch.core.pipeline\n"
        "import repro_torch.kernels.stage_block, repro_torch.models.model\n")
    names = _top_names_after(code)
    assert "repro_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = ("import perfbench.reference.decoder_lm, perfbench.compare\n"
            "import perfbench.weights, perfbench.yardstick\n")
    names = _top_names_after(code)
    assert not names & (FORBIDDEN | {"repro_torch"})


def test_reference_sources_import_nothing_of_the_program():
    for f in (ROOT / "perfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN | {"repro_torch"}, (f, m)


def test_run_without_a_card_prints_no_result():
    """Without a CUDA device the run refuses."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell,
                          "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    import torch

    if torch.cuda.is_available():
        return  # on a card the run is the benchmark's own business
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
