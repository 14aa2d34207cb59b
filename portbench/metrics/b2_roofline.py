"""b2_roofline: B2, the fused paged verify (``csrc/paged_attention.cu``),
in the traced slice: the sum of each call's least time (its bytes over the
HBM rate or its operations over the bf16 peak, layer by layer; see
``yardstick.b2_bound_s``) over the device time of its kernels
(``paged_flash_kernel`` and its split merge), in %.  Calls: every decode
step over the whole bank and every chunked-prefill piece over its row,
of the engine calls whose spans lie in the slice; the kernels counted are
those that started inside those spans (all of the slice's when the
profiler's clock cannot be placed on the host's)."""
import bisect

from portbench import devtrace, window


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    y = ctx.yardstick
    steps = window.steps_in(ctx, tr["t0"], tr["t1"])
    pieces = window.spans_in(ctx, ("sched_extend",), tr["t0"], tr["t1"])
    bound = 0.0
    for t0, t1, K, c0, live0, ns in steps:
        c = c0.copy()
        for k in range(K):
            bound += y.b2_bound_s(ctx.cfg, ctx.W, ctx.nnz,
                                  [int(x) for x in c])
            c = c + ns[k]
    for _, _, _, info in pieces:
        W = info["W"]
        bound += y.b2_bound_s(ctx.cfg, W, W * (W + 1) // 2, [info["ctx"]])

    def is_b2(name):
        return any(k in name for k in devtrace.B2_KERNELS)

    if tr["placed"] is None:
        dev = sum(s for n, s in tr["by_name"].items() if is_b2(n))
    else:
        ivs = sorted([(s[0], s[1]) for s in steps]
                     + [(p[1], p[2]) for p in pieces])
        starts = [a for a, _ in ivs]
        dev = 0.0
        for name, t, d in tr["placed"]:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ivs[i][1] and is_b2(name):
                dev += d
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
