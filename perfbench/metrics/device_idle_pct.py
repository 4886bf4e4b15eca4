"""``device_idle_pct``: the share of the traced window of whole steps in
which no kernel, copy or set ran on the card (the union of the
profiler's device intervals, not their sum)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
