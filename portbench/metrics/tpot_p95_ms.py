"""tpot_p95_ms: 95th percentile, over the requests due in the window, of
(last token - first token) / (tokens - 1), in ms."""
from portbench import window


def read(ctx):
    recs = window.due_in(ctx.records, *ctx.window)
    vals = window.tpot(recs, ctx.t_end)
    return 1e3 * window.pct(vals, 95) if vals else None
