"""device.idle_share: the share of the traced slice in which no operation
ran on the device (one minus the union of the device activity intervals
over the slice's length)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
