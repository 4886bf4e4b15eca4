"""``step_head_loss_ms``: device ms a step inside the program's
``head.loss`` spans (the last stage's final norm, LM head and
cross-entropy, forward and backward), over the traced window."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_step(["head.loss"])
