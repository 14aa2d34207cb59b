"""sched.rows_busy: mean share of the bank's rows that decoded (emitted a
token) in a decode step of the window."""
from portbench import window


def read(ctx):
    steps = window.steps_in(ctx, *ctx.window)
    rows = sum(int((s[5] > 0).sum()) for s in steps)
    n = sum(s[2] for s in steps)
    return rows / (n * ctx.bank) if n else None
