"""``step_moe_ms``: device ms a step inside the program's ``block.moe``
spans (norm, route, expert FFN and residual of every MoE half, forward
and backward), over the traced window."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_step(["block.moe"])
