"""spec.accept_len: tokens committed a decoding row a step over the
window (1.0 when the draft heads never guess right)."""
from portbench import window


def read(ctx):
    steps = window.steps_in(ctx, *ctx.window)
    emitted = sum(int(s[5].sum()) for s in steps)
    rows = sum(int((s[5] > 0).sum()) for s in steps)
    return emitted / rows if rows else None
