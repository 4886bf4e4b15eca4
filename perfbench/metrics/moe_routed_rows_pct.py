"""``moe_routed_rows_pct``: the share of the dropless MoE layout's rows
that carry a routed choice: the program's counters ``moe.rows_routed``
(tokens x top-k) over ``moe.rows_computed`` (the layout's padded
rows), summed over the traced window."""
from perfbench import spans


def read(run):
    return spans.counter_ratio_pct("moe.rows_routed", "moe.rows_computed")
