"""``flash_attention_roofline``: the least time the traced window's
attention calls could take (``yardstick.flash_bound``, forward and
backward: the reachable causal pairs' products at the bf16 peak against
each tensor read or written once) over the device time of the flash
kernel's grids in the window. The calls are counted from the plan and the
traffic (the runner's ``attention_calls``), so the count is of the work,
whatever implements it; every call has the microbatch's rows. None where
those grids ran for no time, as where the plain route ran, and None where
the kernel's wrapper counted another number of calls in the window than
the plan's forwards and backwards (``trace_launches``), so that a change
of how many calls the work takes shows as a missing reading and never
rescales the share."""
import re

from perfbench import spec, yardstick

# the grids of csrc/flash_attention.cu on the tensor cores: the forward and
# the backward's D, dQ, dK/dV and group-sum passes
GRIDS = re.compile(r"\b(flash_fwd_tc|flash_bwd_delta|flash_bwd_dq_tc|flash_bwd_dkdv_tc"
                   r"|flash_bwd_sum_groups)\b")


def read(run):
    if run.trace is None:
        return None
    device_s = sum(s for name, s in run.trace.by_name().items() if GRIDS.search(name))
    if device_s <= 0:
        return None
    cfg, t, plan = run.mcfg, run.traffic, run.conf["plan"]
    fwd, bwd = spec.runner(t["kind"]).attention_calls(cfg, tuple(plan["boundaries"]),
                                                      t["microbatches"], plan["schedule"])
    if run.trace_launches.get("flash_attention", 0) != run.trace.steps * (fwd + bwd):
        return None
    elt = 2 if run.conf["dtypes"]["compute"] in ("bfloat16", "float16") else 4
    shape = (t["rows"] // t["microbatches"], t["seq"], cfg.num_heads, cfg.num_kv_heads,
             cfg.head_dim, elt)
    ms = (fwd * yardstick.flash_bound(*shape, False, cfg.attention_window)[0]
          + bwd * yardstick.flash_bound(*shape, True, cfg.attention_window)[0])
    return 100.0 * run.trace.steps * ms / 1e3 / device_s
