"""step_mfu: the decode steps' model FLOPs over their time at the H100's
dense bf16 peak, in %: 2 x active parameters over each decoding row's tree
tokens, plus attention over its context and the tree's ancestor pairs,
counted from the configuration and the tree; the time is the spans around
``sched_step`` over the window."""
from portbench import window


def read(ctx):
    y = ctx.yardstick
    flops, secs = 0.0, 0.0
    for t0, t1, K, c0, live0, ns in window.steps_in(ctx, *ctx.window):
        secs += t1 - t0
        c = c0.copy()
        for k in range(K):
            flops += y.step_flops(ctx.cfg, ctx.W, ctx.nnz,
                                  [int(x) for x in c[ns[k] > 0]])
            c = c + ns[k]
    return 100.0 * flops / (secs * y.PEAK_BF16_FLOPS) if secs else None
