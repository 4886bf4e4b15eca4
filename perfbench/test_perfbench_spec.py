"""``BENCHMARK.json`` and the files it names: the keys, names, characters
and limits each must keep, and every configuration, traffic, check and
reader found by its name."""
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = [m["name"] for m in BENCH["per_layer"]]
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if (ROOT / word).exists():
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_budget_of_a_full_check():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=CONFIGS)
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["why"]) and _line(entry["source"])
    assert entry["source"].startswith("https://")
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    assert sorted(entry["reduced"]) == sorted(conf["cut"])
    for key in entry["reduced"]:
        assert cut_allowed(key, conf), (key, conf["cut"][key])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


VOCAB_FLOOR = 8  # a sliced vocabulary keeps at least 1 / VOCAB_FLOOR of the published one


def cut_allowed(key, conf) -> bool:
    """Whether the configuration ``conf`` may cut ``key``: never a width;
    the vocabulary only as the chip's share of a vocabulary split over
    ``chips`` chips (2 to ``VOCAB_FLOOR``): its cut entry names ``chips``,
    ``here`` times ``chips`` covers the published vocabulary, ``here`` is
    what the file runs, and the configuration's ``deployment`` says that
    the vocabulary is split over that many chips."""
    if key == "vocab_size":
        cut = conf["cut"][key]
        chips = cut.get("chips")
        return (isinstance(chips, int) and 2 <= chips <= VOCAB_FLOOR
                and cut["here"] == conf[key] < cut["published"] <= chips * cut["here"]
                and bool(re.search(rf"vocabulary\b[^.]*\bsplit over {chips} chips\b",
                                   conf.get("deployment", ""))))
    return not re.search(r"(_dim|_rank|size|heads|experts_per_tok)$", key)


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=CELLS)
def test_workload_entry(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["config"] in CONFIGS and entry["chips"] in (1, 4) and _line(entry["why"])
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if entry["name"] in m.get("workloads", CELLS)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(entry["name"] in m.get("workloads", CELLS) for m in BENCH["per_layer"])


def test_cells_are_distinct():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(set(CELLS)) == len(CELLS)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names) and len(set(CONFIGS)) == len(CONFIGS)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25 and math.isfinite(metric["bound"])


def test_setup_metric_is_there():
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=METRICS)
def test_per_layer_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and _line(metric["layer"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e and metric["moves"] != "setup_s"
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS and cell in e2e[metric["moves"]].get("workloads", CELLS)
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("metric", METRICS)
def test_reader_found_by_name(metric):
    from perfbench import spec

    assert callable(spec.reader(metric, ROOT))


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    from perfbench import spec

    cell = spec.cell(name, ROOT)
    assert cell.traffic["kind"] and hasattr(spec.runner(cell.traffic["kind"], ROOT), "run")
    assert cell.config["family"]
    for kind in ("ports", "reference"):
        assert spec.family(kind, cell.config["family"], ROOT)
    limits = cell.check["limits"]
    assert limits and all(math.isfinite(float(v["limit"])) for v in limits.values())
    for name, ent in limits.items():  # each limit between the readings it came from
        if "lower" in ent:
            assert ent["lower"] < ent["limit"] < ent["upper"], name
    assert cell.traffic["rows"] % cell.traffic["microbatches"] == 0


def test_files_under_paths_have_name_characters():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            assert PATH.match(str(f.relative_to(ROOT))), f


def test_no_python_file_lists_the_cells():
    """Cells, configurations and metrics are found by name from their own
    files; no Python file of the benchmark names one."""
    names = CELLS + CONFIGS + [m for m in METRICS if len(m) > 4]
    for f in (ROOT / "perfbench").rglob("*.py"):
        if f.name.startswith("test_perfbench_"):
            continue
        text = f.read_text()
        assert not [n for n in names if f'"{n}"' in text or f"'{n}'" in text], f
