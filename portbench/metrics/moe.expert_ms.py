"""moe.expert_ms: device ms a decode step of the expert blocks, summed over
the layers, between the timing events the captured step records around
each layer's block (``trace.ExpertTap``), read after each chunk's host
transfer for the chunk's last step, mean over the chunks of the traced
slice; nothing on a program whose step has no expert tap."""
from portbench import moe_yardstick


def read(ctx):
    return moe_yardstick.expert_ms(ctx)
