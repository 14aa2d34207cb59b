"""The program's own spans over the traced slice: the records of the
port's tracer (``repro_torch.runtime.trace``, on while the slice's
profiler runs), read by the metrics that split the slice's time by where
the work happens.

Span times are ``time.perf_counter_ns``; the slice (``ctx.trace``: ``t0``,
``t1``, the device activities ``placed`` on ``time.perf_counter``) is in
seconds.  A program without the tracer (an older checkout) has nothing
to read: ``snapshot`` returns None and the readers report nothing.

An idle stretch of the device is split among the innermost spans that
cover it, by time (``idle_by_class``): innermost is the covering span that
started last.  Its name's class: the decode chunk (``engine.chunk*``,
``graphs.*``), prefill (``engine.prefill*``, ``engine.extend*``), the
boundary outside engine calls (``sched.*``, ``server.*``); the rest (no
span, ``engine.reset``, ``engine.release``) is unlabelled.
"""
from __future__ import annotations

from portbench import devtrace

CLASSES = (("chunk", ("engine.chunk", "graphs.")),
           ("prefill", ("engine.prefill", "engine.extend")),
           ("boundary", ("sched.", "server.")))


def snapshot(ctx):
    """The tracer's records (``ctx.tracer`` when the caller gives them),
    or None when the program has no tracer or it recorded no span."""
    snap = getattr(ctx, "tracer", None)
    if snap is None:
        try:
            from repro_torch.runtime import trace
        except ImportError:
            return None
        snap = trace.snapshot()
    return snap if snap["spans"] else None


def spans_in(ctx, names=None):
    """The tracer's spans that lie in the traced slice, named ``names``
    (a name or a tuple of prefixes; all when None), or None when there is
    no slice or no tracer."""
    tr = ctx.trace
    snap = snapshot(ctx) if tr is not None else None
    if snap is None:
        return None
    lo, hi = tr["t0"] * 1e9, tr["t1"] * 1e9
    return [s for s in snap["spans"] if lo <= s.t0 and s.t1 <= hi
            and (names is None or s.name.startswith(names))]


def device_in(ctx):
    """The tracer's device-timed spans whose host span lies in the traced
    slice, or None when there is no slice or no tracer."""
    tr = ctx.trace
    snap = snapshot(ctx) if tr is not None else None
    if snap is None:
        return None
    lo, hi = tr["t0"] * 1e9, tr["t1"] * 1e9
    return [d for d in snap["device"] if lo <= d.t0 and d.t1 <= hi]


def inside(outer, spans) -> list:
    """The spans of ``spans`` that lie within ``outer`` on its thread."""
    return [s for s in spans if s.thread == outer.thread
            and outer.t0 <= s.t0 and s.t1 <= outer.t1]


def class_of(name: str):
    return next((c for c, pre in CLASSES if name.startswith(pre)), None)


def innermost(spans) -> list:
    """Disjoint (start, end, name) pieces of time, each labelled by the
    innermost span covering it: the one that started last."""
    edges = sorted([(s.t0, 1, i) for i, s in enumerate(spans)]
                   + [(s.t1, 0, i) for i, s in enumerate(spans)])
    open_, out, last = {}, [], None
    for t, starts, i in edges:
        if open_ and t > last:
            j = max(open_, key=lambda j: (spans[j].t0, -spans[j].t1))
            out.append((last, t, spans[j].name))
        if starts:
            open_[i] = True
        else:
            open_.pop(i, None)
        last = t
    return out


def idle_by_class(ctx):
    """Seconds of the slice's device idle time under each class of span
    (``chunk``, ``prefill``, ``boundary``, and ``rest``, unlabelled), and
    the slice's length; None when the device activities cannot be placed
    on the host's clock or there is no tracer."""
    tr = ctx.trace
    if tr is None or tr["placed"] is None:
        return None
    snap = snapshot(ctx)
    if snap is None:
        return None
    t0, t1 = tr["t0"], tr["t1"]
    busy = devtrace.union([(s, s + d) for _, s, d in tr["placed"]
                           if s + d > t0 and s < t1])
    idle, at = [], t0
    for s, e in busy:
        if s > at:
            idle.append((at, min(s, t1)))
        at = max(at, e)
    if at < t1:
        idle.append((at, t1))
    pieces = [(a / 1e9, b / 1e9, n) for a, b, n in
              innermost([s for s in snap["spans"]
                         if s.t1 / 1e9 > t0 and s.t0 / 1e9 < t1])]
    out = dict(chunk=0.0, prefill=0.0, boundary=0.0, rest=0.0)
    i = 0
    for a, b in idle:
        total = b - a
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            pa, pb, name = pieces[j]
            c = class_of(name)
            part = min(b, pb) - max(a, pa)
            if c is not None and part > 0:
                out[c] += part
                total -= part
            j += 1
        out["rest"] += total
    return out, t1 - t0


def idle_share(ctx, cls: str):
    got = idle_by_class(ctx)
    if got is None:
        return None
    by, length = got
    return by[cls] / length if length > 0 else None


def phase_ms(ctx, field: str):
    """Mean device ms a step of one phase of the captured decode step,
    over the chunks read in the slice; None without phase records."""
    tr = ctx.trace
    snap = snapshot(ctx) if tr is not None else None
    if snap is None:
        return None
    lo, hi = tr["t0"] * 1e9, tr["t1"] * 1e9
    vals = [getattr(p, field) for p in snap["phases"] if lo <= p.t <= hi]
    return sum(vals) / len(vals) if vals else None
