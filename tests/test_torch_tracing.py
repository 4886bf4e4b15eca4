"""The port's tracer (``repro_torch.tracing``) inside the pipelined
training step, on the CPU: a tiny dense and a tiny MoE config on 1F1B in
one process.

* Off (the default), a step records nothing and its tensors carry no
  hook; on, the hooks add no autograd node.
* On, the step's loss and gradients are the off step's, bit for bit (the
  hooks read nothing).
* The spans a step records are the schedule's: S x M forward and S x M
  backward slots, M + 2(S - 1) hops, M x (layers off the last stage +
  all layers) forward spans of each block half, M x layers backward
  ones, M of ``head.loss`` in each phase.
* Each span's parent is the one its layer boundary implies, and its
  self time is no more than its duration.
* The dropless route's counters are its layout's ``t * k`` and
  ``p_rows`` per call.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import configs as TC  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig, pipeline_step_fn  # noqa: E402
from repro_torch.launch import train_mhsl_rl as RUN  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.optimizers import adamw  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# (arch, layers, boundaries): 3 uneven stages dense, 2 stages MoE
CASES = {"dense": ("qwen2.5-3b", 4, (1, 3, 4)),
         "moe": ("qwen3-moe-30b-a3b", 2, (1, 2))}
MICRO, ROWS, SEQ = 2, 4, 16


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.reset()
    yield
    tracing.reset()


def _setup(case):
    arch, layers, bounds = CASES[case]
    cfg = dataclasses.replace(TC.get_config(arch).reduced(), num_layers=layers)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tok, lab = (torch.randint(0, cfg.vocab_size, (ROWS, SEQ), generator=gen)
                for _ in range(2))
    return cfg, bounds, params, tok, lab


def _pipe():
    return PipelineConfig(compute_dtype="float32")


def _train_step(cfg, bounds, params, tok, lab, steps=1):
    opt = adamw(1e-3, max_grad_norm=1.0)
    step = RUN.make_pipeline_train_step(cfg, bounds, MICRO, _pipe(), opt)
    state = opt.init(params)
    for _ in range(steps):
        params, state, loss, _ = step(params, state, tok, lab)
    return loss


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("case", CASES)
def test_off_records_nothing_and_adds_no_node(case):
    cfg, bounds, params, tok, lab = _setup(case)
    _train_step(cfg, bounds, params, tok, lab)
    s = tracing.summary()
    assert s["spans"] == {} and s["counters"] == {} and s["steps"] == 0
    assert tracing.TRACER.records == []
    blk = M.layer_params(params["slots"][0], 0)
    pos = torch.arange(SEQ)
    x = torch.randn(2, SEQ, cfg.d_model, requires_grad=True)
    y, _, _ = M.block_apply(blk, x, cfg, M.signature(cfg)[0], positions=pos)
    assert x._backward_hooks is None and y._backward_hooks is None
    assert not hasattr(x, "_trace_boundary") and not hasattr(y, "_trace_boundary")
    x_on = x.detach().requires_grad_(True)
    with tracing.recording():
        y_on, _, _ = M.block_apply(blk, x_on, cfg, M.signature(cfg)[0], positions=pos)
    assert x_on._backward_hooks and y_on._backward_hooks
    assert len(y_on._trace_boundary.opens) == 1  # the second half's
    assert _graph_names(y_on) == _graph_names(y)  # no autograd node added
    assert torch.equal(y, y_on)


@pytest.mark.parametrize("case", CASES)
def test_on_gives_the_same_loss_and_gradients(case):
    cfg, bounds, params, tok, lab = _setup(case)
    fn = pipeline_step_fn(cfg, bounds, MICRO, pipe=_pipe())
    loss_off, g_off = fn(params, tok, lab)
    with tracing.recording():
        loss_on, g_on = fn(params, tok, lab)
    assert tracing.summary()["spans"]["pipeline.step"]["calls"] == 1
    assert torch.equal(loss_off, loss_on)
    for a, b in zip(tree_leaves(g_off), tree_leaves(g_on), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_span_counts_are_the_schedules(case):
    cfg, bounds, params, tok, lab = _setup(case)
    steps = 2
    with tracing.recording():
        _train_step(cfg, bounds, params, tok, lab, steps=steps)
    s = tracing.summary()
    n_stages, n_layers = len(bounds), bounds[-1]
    off_last = bounds[-2]
    spans = s["spans"]
    assert s["steps"] == steps and s["dropped"] == 0
    for name in ("train.step", "optim.clip_norm", "optim.update", "pipeline.step"):
        assert spans[name]["calls"] == steps, name
    assert spans["pipeline.hop"]["calls"] == steps * (MICRO + 2 * (n_stages - 1))
    for name in ("pipeline.forward_slot", "pipeline.backward_slot",
                 "pipeline.recompute", "pipeline.grad"):
        assert spans[name]["calls"] == steps * n_stages * MICRO, name
    second = "block.moe" if case == "moe" else "block.mlp"
    assert ("block.mlp" in spans) == (case == "dense")
    def calls(name):
        return {k: v["calls"] for k, v in spans[name]["phases"].items()}

    for name in ("block.attention", second):
        assert calls(name) == {"forward": steps * MICRO * (off_last + n_layers),
                               "backward": steps * MICRO * n_layers}, name
    assert calls("head.loss") == {"forward": steps * MICRO, "backward": steps * MICRO}


PARENTS = {"train.step": {None}, "optim.clip_norm": {"train.step"},
           "optim.update": {"train.step"}, "pipeline.step": {"train.step"},
           "pipeline.hop": {"pipeline.step"},
           "pipeline.forward_slot": {"pipeline.step"},
           "pipeline.backward_slot": {"pipeline.step"},
           "pipeline.recompute": {"pipeline.backward_slot"},
           "pipeline.grad": {"pipeline.backward_slot"}}


@pytest.mark.parametrize("case", CASES)
def test_parents_steps_and_self_time(case, monkeypatch):
    cfg, bounds, params, tok, lab = _setup(case)
    closed = []  # spans closed by their own hook or ``with``, not by a parent
    close = tracing.TRACER.close
    monkeypatch.setattr(tracing.TRACER, "close",
                        lambda idx: (closed.append(idx), close(idx)))
    with tracing.recording():
        _train_step(cfg, bounds, params, tok, lab, steps=2)
    recs = tracing.TRACER.records
    assert sorted(closed) == list(range(len(recs)))
    assert recs and all(r.t1 is not None for r in recs)
    steps = {}
    for r in recs:
        parent = None if r.parent is None else recs[r.parent]
        pname = None if parent is None else parent.name
        if r.name in PARENTS:
            assert pname in PARENTS[r.name], (r.name, pname)
        elif r.attrs["phase"] == "backward":  # a layer's backward: autograd's
            assert pname == "pipeline.grad", (r.name, pname)
        elif r.name == "head.loss":
            assert pname == "pipeline.recompute"
        else:  # a block half forward: the forward slot off the last stage
            assert pname in ("pipeline.forward_slot", "pipeline.recompute"), r.name
        if parent is not None:  # a child lies inside its parent
            assert parent.t0 <= r.t0 <= r.t1 <= parent.t1
        if "stage" in r.attrs:
            assert 0 <= r.attrs["stage"] < len(bounds) and 0 <= r.attrs["mb"] < MICRO
        steps.setdefault(r.step, 0)
        steps[r.step] += 1
    assert sorted(steps) == [0, 1] and steps[0] == steps[1]
    for name, s in tracing.summary()["spans"].items():
        assert 0 <= s["self_host_s"] <= s["host_s"], name
        assert s["device_ms"] is None  # no CUDA events off the card


def test_moe_counters_are_the_layouts():
    cfg, bounds, params, tok, lab = _setup("moe")
    with tracing.recording():
        _train_step(cfg, bounds, params, tok, lab)
    s = tracing.summary()
    calls = s["spans"]["block.moe"]["phases"]["forward"]["calls"]
    t, k = ROWS // MICRO * SEQ, cfg.moe.top_k
    ids = torch.zeros((t, k), dtype=torch.long)
    p_rows = L.dropless_layout(ids, cfg.moe.num_experts, 128)[2]
    # every attention half's core is counted too; on the CPU none takes
    # the kernel
    attn = s["spans"]["block.attention"]["phases"]["forward"]["calls"]
    assert s["counters"] == {"moe.rows_routed": calls * t * k,
                             "moe.rows_computed": calls * p_rows,
                             "attention.calls": attn}


def test_profiler_turns_spans_on_and_summary_keeps_them():
    from torch.profiler import ProfilerActivity, profile

    cfg, bounds, params, tok, lab = _setup("dense")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train_step(cfg, bounds, params, tok, lab)
    names = {e.name for e in prof.events()}
    assert {"train.step", "pipeline.grad", "block.attention", "head.loss"} <= names
    first = tracing.summary()
    assert first["steps"] == 1 and first == tracing.summary()
    _train_step(cfg, bounds, params, tok, lab)  # off again
    assert tracing.summary()["steps"] == 1
    tracing.reset()
    assert tracing.summary() == {"spans": {}, "counters": {}, "steps": 0, "dropped": 0}


def test_spans_past_the_cap_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(tracing.TRACER, "cap", 5)
    with tracing.recording():
        for _ in range(3):
            with tracing.span("a"):
                with tracing.span("b"):
                    pass
        tracing.count("c", 2)
    s = tracing.summary()
    assert {k: v["calls"] for k, v in s["spans"].items()} == {"a": 3, "b": 2}
    assert s["dropped"] == 1 and s["counters"] == {"c": 2}
    tracing.count("c", 5)  # off: not counted
    assert tracing.summary()["counters"] == {"c": 2}


def test_closing_a_span_closes_what_is_open_inside_it():
    with tracing.recording():
        with tracing.span("outer"):
            tracing.TRACER.open("left_open", {})
    recs = tracing.TRACER.records
    assert [r.name for r in recs] == ["outer", "left_open"]
    assert all(r.t1 is not None for r in recs) and recs[1].parent == 0
    assert recs[1].t1 <= recs[0].t1
