"""``launches_per_step``: device kernels, copies and sets the profiler
saw in the traced window, per traced step."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return len(run.trace.device) / run.trace.steps
