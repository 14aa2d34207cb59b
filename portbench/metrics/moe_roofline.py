"""moe_roofline: the expert blocks' least time over their device time, in
%, over the traced slice's chunks: per layer the larger of the hit
experts' weights and the routed rows in and out over the HBM rate and the
expert products and router over the bf16 peak (``moe_yardstick``), from
the routing the program recorded for the chunk's last step, against that
step's ``moe.expert_ms``."""
from portbench import moe_yardstick


def read(ctx):
    return moe_yardstick.roofline(ctx)
