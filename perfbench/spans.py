"""The program's own spans and counters (``repro_torch.tracing``), as the
per-layer readers take them after the traced window.

The program turns its spans on while a profiler records, so the traced
window fills them and the untraced window, which is timed, runs with
them off. Each number is a sum over the window's spans divided by its
``train.step`` spans. Every function returns None where the program has
no tracer (an older checkout), the window no ``train.step`` span, or
the spans no device time."""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional


def summary() -> Optional[Dict[str, Any]]:
    """The tracer's summary, or None (no tracer, or no step traced)."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    out = tracing.summary()
    return out if out["steps"] else None


def device_ms_per_step(names: Iterable[str], key: str = "device_ms") -> Optional[float]:
    """The summed ``key`` (``device_ms`` or ``self_device_ms``) of the
    spans ``names`` over the traced steps; None where one of them did
    not run or has no device time."""
    s = summary()
    names = list(names)
    if s is None or not names or any(n not in s["spans"] for n in names):
        return None
    vals = [s["spans"][n][key] for n in names]
    if any(v is None for v in vals):
        return None
    return sum(vals) / s["steps"]


def span_names(prefix: str) -> list:
    """The names of the traced spans that start with ``prefix``."""
    s = summary()
    return [] if s is None else sorted(n for n in s["spans"] if n.startswith(prefix))


def counter_ratio_pct(num: str, den: str) -> Optional[float]:
    """100 x counter ``num`` over counter ``den`` in the traced window;
    None where ``den`` never counted."""
    s = summary()
    if s is None or not s["counters"].get(den):
        return None
    return 100.0 * s["counters"].get(num, 0) / s["counters"][den]
