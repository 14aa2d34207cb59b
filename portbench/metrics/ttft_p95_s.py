"""ttft_p95_s: 95th percentile of the time from a request's due time to
its first token, over every request due in the window; a request that
failed or never answered counts with its whole wait."""
from portbench import window


def read(ctx):
    recs = window.due_in(ctx.records, *ctx.window)
    if not recs:
        return None
    return window.pct(window.ttft(recs, ctx.t_end), 95)
