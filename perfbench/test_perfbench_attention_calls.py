"""The reader ``attention_kernel_calls_pct``: its arithmetic on a
fabricated summary, None where the program has no attention counters or
no tracer, and a traced run of each cell at tiny widths on the CPU, where
every call takes the plain route."""
import sys

import pytest

torch = pytest.importorskip("torch")

from perfbench import spec  # noqa: E402

METRIC = "attention_kernel_calls_pct"


def _summary(counters):
    return {"spans": {}, "counters": counters, "steps": 2, "dropped": 0}


@pytest.fixture
def fake_summary(monkeypatch):
    from repro_torch import tracing

    def use(summary):
        monkeypatch.setattr(tracing, "summary", lambda: summary)

    return use


@pytest.mark.parametrize("counters, want", [
    ({"attention.calls": 96, "attention.kernel_calls": 72}, 75.0),
    ({"attention.calls": 120, "attention.kernel_calls": 120}, 100.0),
    ({"attention.calls": 64, "moe.rows_routed": 8}, 0.0),  # no call took the kernel
])
def test_reader_arithmetic_on_a_fabricated_summary(counters, want, fake_summary):
    fake_summary(_summary(counters))
    assert spec.reader(METRIC)(None) == pytest.approx(want)


@pytest.mark.parametrize("counters", [
    {},
    {"moe.rows_routed": 8192, "moe.rows_computed": 24448},
    {"attention.calls": 0, "attention.kernel_calls": 0},
])
def test_reader_gives_none_without_the_counters(counters, fake_summary):
    """An older program counts no attention calls: nothing to read."""
    fake_summary(_summary(counters))
    assert spec.reader(METRIC)(None) is None


def test_reader_gives_none_without_the_tracer(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert spec.reader(METRIC)(None) is None


@pytest.mark.parametrize("workload", [w["name"] for w in spec.benchmark()["workloads"]])
def test_traced_run_at_tiny_widths_on_the_cpu_reads_no_kernel_calls(workload):
    """CPU tensors take the plain route, so the share is reported and 0."""
    from perfbench.test_perfbench_correct import _cell
    from repro_torch import tracing

    tracing.reset()
    res = spec.runner("train").run(_cell(workload), 3_000_000_019, 0.05, True, "cpu", 0.0,
                                   log=lambda msg: None)
    tracing.reset()
    assert res["correct"], res["checks"]
    assert res["metrics"][METRIC]["value"] == 0.0
