"""What a ``torch.profiler`` trace of a window of whole steps says.

The window is the span of the CPU range ``WINDOW`` that the runner
opens around the traced steps (it ends after the device has finished).
Device events are the kernels, copies and sets the profiler saw on the
card (not the ranges of ``record_function``, which it mirrors there). The device is busy where any of them runs: the union of their
intervals, clipped to the window, not their sum. An idle gap is a stretch
of the window in which none runs; it is named by the innermost host
operation that was running in its middle.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

WINDOW = "perfbench.traced_steps"


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, arguments or templates."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:  # drop template arguments and parameter lists
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:width]


class Trace:
    """Device intervals, their union, gaps and per-name sums of one traced
    window. Times are in microseconds of the profiler's clock."""

    def __init__(self, prof, steps: int):
        from torch.autograd import DeviceType

        events = list(prof.events())
        host = [e for e in events if e.device_type == DeviceType.CPU]
        win = [e for e in host if e.name == WINDOW]
        if not win:
            raise RuntimeError(f"the trace has no {WINDOW!r} range")
        self.start, self.end = win[0].time_range.start, win[0].time_range.end
        self.steps = steps
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.name != WINDOW
               and e.time_range.end > self.start and e.time_range.start < self.end]
        self.device: List[Tuple[float, float, str]] = [
            (max(e.time_range.start, self.start), min(e.time_range.end, self.end), e.name)
            for e in dev]
        self._host = [(e.time_range.start, e.time_range.end, e.name) for e in host
                      if e.name != WINDOW]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def _union(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for a, b, _ in sorted(self.device):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle stretches of the window, longest first."""
        out, t = [], self.start
        for a, b in self._union():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return sorted(out, key=lambda g: g[0] - g[1])

    def by_name(self) -> Dict[str, float]:
        """Device seconds by event name."""
        out: Dict[str, float] = defaultdict(float)
        for a, b, name in self.device:
            out[name] += (b - a) / 1e6
        return dict(out)

    def named_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest idle gaps: ``[host operation, seconds]``."""
        if not self._host:
            return []
        starts = np.array([h[0] for h in self._host])
        ends = np.array([h[1] for h in self._host])
        out = []
        for a, b in self.gaps()[:n]:
            mid = 0.5 * (a + b)
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = "(no host operation)"
            if inside.size:
                k = inside[np.argmin(ends[inside] - starts[inside])]
                name = self._host[k][2]
            out.append([name[:96], (b - a) / 1e6])
        return out

    def breakdown(self, n: int = 10) -> Dict[str, List[List]]:
        """The ``n`` device operations that took most time (summed by
        their short names) and the ``n`` longest idle gaps."""
        short: Dict[str, float] = defaultdict(float)
        for name, s in self.by_name().items():
            short[short_name(name)] += s
        tops = sorted(short.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in tops],
                "idle_gaps": self.named_gaps(n)}
