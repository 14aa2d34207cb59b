"""sched.admit_wait_p50_ms.chat: median wait, in ms, from a request's due
time to its admission into a bank row, over the requests due in the
window."""
from portbench import window


def read(ctx):
    w = [r.t_admit - r.due for r in window.due_in(ctx.records, *ctx.window)
         if r.t_admit is not None and r.state == "DONE"]
    return 1e3 * window.pct(w, 50) if w else None
