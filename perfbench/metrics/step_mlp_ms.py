"""``step_mlp_ms``: device ms a step inside the program's ``block.mlp``
spans (every dense MLP half-block, the stage kernel or ``mlp_block``,
forward and backward), over the traced window."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_step(["block.mlp"])
