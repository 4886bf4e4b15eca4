"""The readers of the program's own spans and counters
(``perfbench/spans.py`` and the ``step_*``, ``pipeline_self_ms`` and
``moe_routed_rows_pct`` metrics): their arithmetic on a fabricated
summary, None where the cell lacks the span, the counter or the tracer,
and a traced run of each cell at tiny widths on the CPU."""
import sys

import pytest

torch = pytest.importorskip("torch")

from perfbench import spec  # noqa: E402

STEPS = 2


def _span(device_ms, self_ms):
    return {"calls": 4, "host_s": 1.0, "self_host_s": 0.5, "device_ms": device_ms,
            "self_device_ms": self_ms, "phases": {}}


DENSE = {
    "spans": {"train.step": _span(2800.0, 1.0), "pipeline.step": _span(2690.0, 30.0),
              "pipeline.hop": _span(4.0, 4.0), "pipeline.forward_slot": _span(600.0, 6.0),
              "pipeline.backward_slot": _span(2050.0, 2.0),
              "pipeline.recompute": _span(800.0, 8.0), "pipeline.grad": _span(1240.0, 20.0),
              "block.attention": _span(1400.0, 1400.0), "block.mlp": _span(1000.0, 1000.0),
              "head.loss": _span(230.0, 230.0), "optim.clip_norm": _span(9.0, 9.0),
              "optim.update": _span(100.0, 100.0)},
    "counters": {}, "steps": STEPS, "dropped": 0}
MOE = {
    "spans": {"train.step": _span(1640.0, 0.0), "pipeline.step": _span(1440.0, 10.0),
              "block.attention": _span(160.0, 160.0), "block.moe": _span(1100.0, 1100.0),
              "head.loss": _span(170.0, 170.0), "optim.update": _span(200.0, 200.0)},
    "counters": {"moe.rows_routed": 8192 * 48, "moe.rows_computed": 24448 * 48},
    "steps": STEPS, "dropped": 0}

# metric: (its value on DENSE, on MOE); None where the cell lacks the span
EXPECTED = {
    "step_attention_ms": (700.0, 80.0),
    "step_mlp_ms": (500.0, None),
    "step_moe_ms": (None, 550.0),
    "step_head_loss_ms": (115.0, 85.0),
    "step_optimizer_ms": (54.5, None),  # MOE lacks optim.clip_norm: no partial sum
    "pipeline_self_ms": ((30 + 4 + 6 + 2 + 8 + 20) / STEPS, 5.0),
    "moe_routed_rows_pct": (None, 100.0 * 8192 / 24448),
}


@pytest.fixture
def fake_summary(monkeypatch):
    from repro_torch import tracing

    def use(summary):
        monkeypatch.setattr(tracing, "summary", lambda: summary)

    return use


@pytest.mark.parametrize("metric", EXPECTED)
def test_reader_arithmetic_on_a_fabricated_summary(metric, fake_summary):
    read = spec.reader(metric)
    for summary, want in zip((DENSE, MOE), EXPECTED[metric]):
        fake_summary(summary)
        got = read(None)
        assert got == (None if want is None else pytest.approx(want)), summary is MOE


@pytest.mark.parametrize("metric", EXPECTED)
def test_reader_gives_none_without_steps_or_device_time(metric, fake_summary):
    read = spec.reader(metric)
    fake_summary(dict(MOE, steps=0))
    assert read(None) is None
    no_device = {k: dict(v, device_ms=None, self_device_ms=None)
                 for k, v in DENSE["spans"].items()}
    fake_summary(dict(DENSE, spans=no_device))
    assert read(None) is None


@pytest.mark.parametrize("metric", EXPECTED)
def test_reader_gives_none_without_the_tracer(metric, monkeypatch):
    """An older program has no ``repro_torch.tracing``: nothing to read."""
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert spec.reader(metric)(None) is None


def test_traced_run_at_tiny_widths_on_the_cpu():
    """A whole ``--trace 1`` run of each cell on the CPU: the spans have
    no device time there, so of these readers only the counters' are
    reported, each in exactly the cells its ``workloads`` list names, and
    ``moe_routed_rows_pct`` is the layout's ``t * k / p_rows``."""
    from perfbench.test_perfbench_correct import _cell
    from repro_torch import tracing
    from repro_torch.models import layers as L

    for w in spec.benchmark()["workloads"]:
        tracing.reset()
        cell = _cell(w["name"])
        res = spec.runner("train").run(cell, 3_000_000_017, 0.05, True, "cpu", 0.0,
                                       log=lambda msg: None)
        tracing.reset()
        assert res["correct"], res["checks"]
        new = set(res["metrics"]) & set(EXPECTED)
        assert new == {m["name"] for m in cell.per_layer
                       if m["name"] in EXPECTED and m["source"] == "program_counter"}
        if "moe_routed_rows_pct" not in new:
            continue
        moe = spec.family("ports", cell.config["family"]).model_config(cell.config).moe
        t = cell.traffic["rows"] // cell.traffic["microbatches"] * cell.traffic["seq"]
        p_rows = L.dropless_layout(torch.zeros((t, moe.top_k), dtype=torch.long),
                                   moe.num_experts, 128)[2]
        assert res["metrics"]["moe_routed_rows_pct"]["value"] == pytest.approx(
            100.0 * t * moe.top_k / p_rows)
