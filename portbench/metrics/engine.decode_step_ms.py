"""engine.decode_step_ms: the engine's decode chunks (the spans around
``sched_step``, each ending in the chunk's one host transfer) over the
window, in ms a step."""
from portbench import window


def read(ctx):
    steps = window.steps_in(ctx, *ctx.window)
    n = sum(s[2] for s in steps)
    return 1e3 * sum(s[1] - s[0] for s in steps) / n if n else None
