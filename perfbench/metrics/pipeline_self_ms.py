"""``pipeline_self_ms``: device ms a step of the pipeline's own work:
the self time (duration less its child spans) of every ``pipeline.*``
span: the hops' casts, the embedding lookup and its gradient's
scatter, the gradients' accumulation and the tree's assembly, over
the traced window."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_step(spans.span_names("pipeline."), "self_device_ms")
