"""``mfu``: the whole step's share of the card's bf16 peak.

Model FLOPs of the window's steps (``yardstick.train_flops_per_token``:
no recomputation counted) over the window's wall time, over the dense
bf16 peak of the chips the cell uses. The window is the untraced one."""
from perfbench import yardstick


def read(run):
    return (100.0 * run.tokens_per_s * run.flops_per_token
            / (yardstick.BF16_FLOPS_PER_S * run.chips))
