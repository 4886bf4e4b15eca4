"""``attention_kernel_calls_pct``: the share of the attention half's core
calls (``models.layers._attention_core``) that took the hand-written
flash kernel: the program's counters ``attention.kernel_calls`` over
``attention.calls``, summed over the traced window. None where the
program has no such counters."""
from perfbench import spans


def read(run):
    return spans.counter_ratio_pct("attention.kernel_calls", "attention.calls")
