"""``step_optimizer_ms``: device ms a step inside the program's
``optim.clip_norm`` (the global norm) and ``optim.update`` (AdamW's
update and its application) spans, over the traced window."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_step(["optim.clip_norm", "optim.update"])
