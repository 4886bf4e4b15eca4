"""Spans and counters inside the port's pipelined training step.

Off by default. It is on while a ``torch.profiler`` is recording
(``torch.autograd._profiler_enabled()``) or inside ``with
recording():``. Off, :func:`span` costs one check and returns a shared
no-op context, :func:`count` returns at once, :func:`mark_in` returns
None and :func:`mark_out` its tensor: nothing is recorded and no hook or
autograd node is added.

On, a span

* opens a profiler range named ``name`` while a profiler records (the
  C++ range of ``record_function``), so it lies on the profiler's
  timeline beside the device events;
* records a CUDA event on the current stream at entry and at exit (once
  CUDA is initialised; the host's ``perf_counter_ns`` always);
* keeps its parent (the innermost open span), its step (the number of
  the enclosing ``train.step`` span) and its attributes.

Spans nest. One step runs on one thread at a time: autograd's device
thread runs a backward while its caller waits inside ``autograd.grad``,
so one stack serves both, and a backward span's parent is the caller's
open span. Closing a span first closes any span still open inside it.

A layer's backward gets a span of its own through gradient hooks, which
launch nothing and add no autograd node: :func:`mark_in` on the layer's
input and :func:`mark_out` on its output. The span opens when autograd
reaches the output's gradient and closes once the input's gradient is
whole. A tensor between two layers carries one hook, which closes the
later layer's span before it opens the earlier one's. Hooks are added
only when tracing is on and the input requires grad.

:func:`summary` reads the records (one device synchronisation);
:func:`reset` clears them. At most ``CAP`` spans are kept; later ones are
dropped and counted.

Spans of the training step (``launch/train_mhsl_rl.py``,
``core/pipeline.py``, ``models/model.py``): ``train.step``,
``optim.clip_norm``, ``optim.update``, ``pipeline.step``,
``pipeline.hop``, ``pipeline.forward_slot``, ``pipeline.backward_slot``
(attributes ``stage``, ``mb``), ``pipeline.recompute``,
``pipeline.grad``, ``head.loss``, ``block.attention``, ``block.mlp``,
``block.moe`` (the last four with ``phase`` ``forward`` or
``backward``). Counters (``models/layers.py`` ``moe_apply_dropless``):
``moe.rows_routed`` (tokens x top-k) and ``moe.rows_computed`` (the
dropless layout's padded rows).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import torch

STEP = "train.step"
CAP = 200_000

_profiler_enabled = torch.autograd._profiler_enabled
# the C++ range behind ``record_function``: ~1 us where ``record_function``
# takes ~25 on a host core
_range = torch._C._profiler._RecordFunctionFast


class _Record:
    __slots__ = ("name", "attrs", "parent", "step", "t0", "t1", "ev0", "ev1", "rf")

    def __init__(self, name, attrs, parent, step):
        self.name, self.attrs, self.parent, self.step = name, attrs, parent, step
        self.t1 = self.ev0 = self.ev1 = None


class Tracer:
    """The records of one process: spans, counters, dropped spans."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.depth = 0  # nesting of ``recording()``
        self.reset()

    def reset(self) -> None:
        self.records: List[_Record] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self.steps = 0
        self._stack: List[int] = []  # indices of open records, innermost last
        self._step: Optional[int] = None

    def open(self, name: str, attrs: Dict[str, Any]) -> Optional[int]:
        """Open a span; its record's index (None when dropped)."""
        if len(self.records) >= self.cap:
            self.dropped += 1
            return None
        if name == STEP:
            self._step = self.steps
            self.steps += 1
        rec = _Record(name, attrs, self._stack[-1] if self._stack else None, self._step)
        rec.rf = _range(name) if _profiler_enabled() else None
        if rec.rf is not None:
            rec.rf.__enter__()
        rec.t0 = time.perf_counter_ns()
        if torch.cuda.is_initialized():
            rec.ev0 = torch.cuda.Event(enable_timing=True)
            rec.ev0.record()
        self.records.append(rec)
        self._stack.append(len(self.records) - 1)
        return len(self.records) - 1

    def close(self, idx: Optional[int]) -> None:
        """Close span ``idx`` and any span still open inside it."""
        if idx is None or idx not in self._stack:
            return
        while self._stack:
            top = self._stack.pop()
            rec = self.records[top]
            if rec.ev0 is not None:
                rec.ev1 = torch.cuda.Event(enable_timing=True)
                rec.ev1.record()
            rec.t1 = time.perf_counter_ns()
            if rec.rf is not None:
                rec.rf.__exit__(None, None, None)
                rec.rf = None
            if rec.name == STEP:
                self._step = None
            if top == idx:
                return

    def count(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def summary(self) -> Dict[str, Any]:
        """Per span name: ``calls``, ``host_s``, ``device_ms`` and
        ``self_device_ms`` (the duration less what its child spans cover;
        both None without CUDA events), ``self_host_s``, and ``phases``
        (``calls`` and ``device_ms`` by ``phase`` attribute); ``counters``;
        ``steps`` (the ``train.step`` spans); ``dropped``. Spans still
        open are left out."""
        if any(r.ev1 is not None for r in self.records):
            torch.cuda.synchronize()
        host, dev = {}, {}
        for i, r in enumerate(self.records):
            if r.t1 is not None:
                host[i] = (r.t1 - r.t0) / 1e9
                if r.ev1 is not None:
                    dev[i] = r.ev0.elapsed_time(r.ev1)
        child_host: Dict[int, float] = {}
        child_dev: Dict[int, float] = {}
        for i, r in enumerate(self.records):
            if i in host and r.parent is not None:
                child_host[r.parent] = child_host.get(r.parent, 0.0) + host[i]
                if i in dev:
                    child_dev[r.parent] = child_dev.get(r.parent, 0.0) + dev[i]
        spans: Dict[str, Dict[str, Any]] = {}
        for i, r in enumerate(self.records):
            if i not in host:
                continue
            s = spans.setdefault(r.name, {"calls": 0, "host_s": 0.0, "self_host_s": 0.0,
                                          "device_ms": None, "self_device_ms": None,
                                          "phases": {}})
            s["calls"] += 1
            s["host_s"] += host[i]
            s["self_host_s"] += host[i] - child_host.get(i, 0.0)
            if i in dev:
                s["device_ms"] = (s["device_ms"] or 0.0) + dev[i]
                s["self_device_ms"] = ((s["self_device_ms"] or 0.0) + dev[i]
                                       - child_dev.get(i, 0.0))
            phase = r.attrs.get("phase")
            if phase is not None:
                ph = s["phases"].setdefault(phase, {"calls": 0, "device_ms": None})
                ph["calls"] += 1
                if i in dev:
                    ph["device_ms"] = (ph["device_ms"] or 0.0) + dev[i]
        return {"spans": spans, "counters": dict(self.counters), "steps": self.steps,
                "dropped": self.dropped}


TRACER = Tracer()


_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "attrs", "idx")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.idx = TRACER.open(self.name, self.attrs)
        return self.idx

    def __exit__(self, *exc):
        TRACER.close(self.idx)
        return False


def span(name: str, **attrs):
    """A context manager: a span named ``name`` with ``attrs`` when
    tracing is on, else a shared no-op."""
    if not (TRACER.depth or _profiler_enabled()):
        return _NULL
    return _Span(name, attrs)


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to counter ``name`` when tracing is on."""
    if TRACER.depth or _profiler_enabled():
        TRACER.count(name, n)


@contextlib.contextmanager
def recording():
    """``with recording():`` turns tracing on inside it (nestable)."""
    TRACER.depth += 1
    try:
        yield TRACER
    finally:
        TRACER.depth -= 1


def summary() -> Dict[str, Any]:
    return TRACER.summary()


def reset() -> None:
    TRACER.reset()


# -- backward spans -----------------------------------------------------------


class _Mark:
    """A layer's backward span: its name and attributes, and the index of
    its record while it is open."""
    __slots__ = ("name", "attrs", "idx")

    def __init__(self, name, attrs):
        self.name, self.attrs, self.idx = name, attrs, None


class _Boundary:
    """The gradient hook of a tensor between layers. Once the tensor's
    gradient is whole it closes the backward spans of the layers the
    tensor feeds, then opens those of the layers that made it."""
    __slots__ = ("closes", "opens")

    def __init__(self):
        self.closes: List[_Mark] = []
        self.opens: List[_Mark] = []

    def __call__(self, grad):
        closes, opens = self.closes, self.opens
        self.closes, self.opens = [], []  # one backward each
        for m in closes:
            TRACER.close(m.idx)
        for m in opens:
            m.idx = TRACER.open(m.name, m.attrs)


def _boundary(t: torch.Tensor) -> _Boundary:
    b = getattr(t, "_trace_boundary", None)
    if b is None:
        b = t._trace_boundary = _Boundary()
        t.register_hook(b)
    return b


def mark_in(x: torch.Tensor, name: str, **attrs) -> Optional[_Mark]:
    """The backward span ``name`` (``phase="backward"``, ``attrs``) of a
    layer whose input is ``x``; it closes once ``x``'s gradient is whole.
    None when tracing is off or ``x`` needs no gradient."""
    if not (TRACER.depth or _profiler_enabled()) or not (
            torch.is_grad_enabled() and x.requires_grad):
        return None
    mark = _Mark(name, dict(attrs, phase="backward"))
    _boundary(x).closes.append(mark)
    return mark


def mark_out(y: torch.Tensor, mark: Optional[_Mark]) -> torch.Tensor:
    """``y``, the layer's output: its backward span opens when autograd
    reaches ``y``'s gradient (nothing when ``mark`` is None)."""
    if mark is not None:
        _boundary(y).opens.append(mark)
    return y
