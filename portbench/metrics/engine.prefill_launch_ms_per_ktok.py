"""engine.prefill_launch_ms_per_ktok: the host's time in prompt processing
over the traced slice, in ms a thousand prompt tokens: the program's
``engine.prefill`` (``sched_prefill``/``sched_admit``) and
``engine.extend`` (``sched_extend``) spans over the prompt tokens they
landed.  The benchmark's own sync after each call lies outside them, so
this is the time to launch the work."""
from portbench import spans


def read(ctx):
    got = [s for s in spans.spans_in(ctx) or ()
           if s.name in ("engine.prefill", "engine.extend")]
    toks = sum(s.tokens for s in got)
    return sum(s.t1 - s.t0 for s in got) / 1e6 / (toks / 1e3) \
        if toks else None
