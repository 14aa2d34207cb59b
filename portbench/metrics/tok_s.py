"""tok_s: output tokens the clients received in the window, over the
window's length (a closed loop: the card sets the pace)."""
from portbench import window


def read(ctx):
    if ctx.mix["loop"] != "closed":
        return None
    w0, w1 = ctx.window
    return window.tokens_in(ctx.records, w0, w1) / (w1 - w0)
