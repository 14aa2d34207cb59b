"""engine.launch_ms_per_step: the host's time in the decode chunks of the
traced slice, less their one host transfer, in ms a step: the program's
``engine.chunk`` spans (``runtime/engine.py::sched_step``) minus the
``engine.chunk.wait`` inside each, over the chunks' steps."""
from portbench import spans


def read(ctx):
    got = spans.spans_in(ctx, ("engine.chunk",))
    chunks = [s for s in got or () if s.name == "engine.chunk"]
    waits = [s for s in got or () if s.name == "engine.chunk.wait"]
    steps = sum(s.k for s in chunks)
    if not steps:
        return None
    ns = sum(s.t1 - s.t0 - sum(w.t1 - w.t0 for w in spans.inside(s, waits))
             for s in chunks)
    return ns / 1e6 / steps
