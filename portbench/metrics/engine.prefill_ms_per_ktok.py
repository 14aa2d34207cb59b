"""engine.prefill_ms_per_ktok: prompt processing over the window, in ms a
thousand prompt tokens: the spans around ``sched_prefill``, ``sched_admit``
and ``sched_extend`` (synchronised in the traced run) over the prompt
tokens they landed."""
from portbench import window


def read(ctx):
    spans = window.spans_in(ctx, window.PREFILL, *ctx.window)
    toks = sum(s[3].get("tokens", 0) for s in spans)
    return 1e3 * sum(s[2] - s[1] for s in spans) / (toks / 1e3) \
        if toks else None
