"""The window arithmetic the metric readers share.  Times are host-clock
seconds (``time.perf_counter``); a record is a ``cell.Rec``: its due time,
the (arrival time, count) of each token chunk its stream delivered, its
terminal state and its admission time."""
from __future__ import annotations

import numpy as np


def pct(values, q: float) -> float:
    """The ``q``-th percentile, linear between order statistics (numpy's
    default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def tokens_in(records, t0: float, t1: float) -> int:
    """Output tokens whose chunk arrived in [t0, t1)."""
    return sum(n for r in records for t, n in r.chunks if t0 <= t < t1)


def due_in(records, t0: float, t1: float) -> list:
    return [r for r in records if t0 <= r.due < t1]


def ttft(records, t_end: float) -> list:
    """Each record's time from due to its first token.  A request that never
    delivered one, or that failed, counts as missing: its time runs to
    ``t_end``, when the benchmark stopped waiting."""
    out = []
    for r in records:
        ok = r.first is not None and r.state == "DONE"
        out.append((r.first if ok else t_end) - r.due)
    return out


def tpot(records, t_end: float) -> list:
    """Each record's (last token - first token) / (tokens - 1); a missing
    request reads its wait to ``t_end`` over its asked tokens."""
    out = []
    for r in records:
        n = len(r.tokens)
        if r.state == "DONE" and n > 1:
            out.append((r.last - r.first) / (n - 1))
        elif r.state != "DONE":
            out.append((t_end - r.due) / max(r.o.n_tokens - 1, 1))
    return out


def steps_in(ctx, t0: float, t1: float) -> list:
    """Decode chunks whose span lies in [t0, t1]."""
    return [s for s in ctx.steps if s[0] >= t0 and s[1] <= t1]


def spans_in(ctx, names, t0: float, t1: float) -> list:
    return [s for s in ctx.spans
            if s[0] in names and s[1] >= t0 and s[2] <= t1]


PREFILL = ("sched_prefill", "sched_admit", "sched_extend")
