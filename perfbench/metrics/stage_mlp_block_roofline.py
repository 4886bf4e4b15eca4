"""``stage_mlp_block_roofline``: the least time the traced window's
``stage_mlp_block`` calls could take (``yardstick.stage_bound``: each
input byte read once, each output byte written once, the three products
at the bf16 peak) over the device time of the kernel's grids in the
window. The count is of the forward MLP half-block's work, whatever
implements it; every call of the window has the microbatch's rows."""
import re

from perfbench import yardstick

# the grids of csrc/stage_mlp_block.cu: the tensor-core body (rms_norm_rows,
# gemm_tc, split_k_sum) and the FMA body (rms_norm_rows, up_act, down_residual)
GRIDS = re.compile(r"\b(rms_norm_rows|gemm_tc|split_k_sum|up_act|down_residual)\b")


def read(run):
    calls = run.trace_launches.get("stage_mlp_block", 0) if run.trace else 0
    # grouped_moe_ffn has grids of the same names (up_act)
    if not calls or run.trace_launches.get("grouped_moe_ffn", 0):
        return None
    device_s = sum(s for name, s in run.trace.by_name().items() if GRIDS.search(name))
    if device_s <= 0:
        return None
    t = run.traffic
    rows = t["rows"] // t["microbatches"] * t["seq"]
    conf = run.conf
    x_elt = 2 if conf["dtypes"]["compute"] in ("bfloat16", "float16") else 4
    ms, _, _, _ = yardstick.stage_bound(rows, conf["hidden_size"], conf["intermediate_size"],
                                         True, x_elt, 4)
    return 100.0 * calls * ms / 1e3 / device_s
