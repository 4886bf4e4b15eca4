"""``step_attention_ms``: device ms a step inside the program's
``block.attention`` spans (norm, attention and residual of every
attention half, forward and backward), over the traced window."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_step(["block.attention"])
