"""moe.load_max_over_mean: the largest expert's routed rows over the mean
rows an expert, per layer, as the program counted them on the device for
each chunk's last step (``trace.RouteRecord``), mean over the layers and
the chunks of the traced slice (1.0 is a perfectly even load)."""
from portbench import moe_yardstick


def read(ctx):
    return moe_yardstick.load_max_over_mean(ctx)
