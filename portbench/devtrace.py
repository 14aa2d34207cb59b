"""The device trace of a ``--trace 1`` run, reduced: busy time as the
union of the device activity intervals, the idle share of the traced
slice, device time by kernel and by kernel class, and the longest idle
gaps labelled with what the host was doing.

The union arithmetic and the class table are frozen copies of the port's
``launch/profile_serve.py``.
"""
from __future__ import annotations

import collections
import time

CLASSES = (
    ("B1 verify", ("verify_flash_kernel", "verify_attention_kernel")),
    ("B2/B3 page walk", ("paged_flash_kernel", "paged_attention_kernel",
                         "cache_flash_kernel")),
    ("split merge and fold", ("merge_kernel", "carry_fold_kernel")),
    ("B4 tree partial", ("tree_warp_kernel", "tree_partial_kernel")),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")),
    ("copy/fill", ("memcpy", "memset", "copy", "fill")),
)
OTHER = "other (elementwise, reductions, indexing)"
# B2's device work in these cells: the fused page walk and its split merge
B2_KERNELS = ("paged_flash_kernel", "paged_attention_kernel", "merge_kernel")


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return OTHER


def union(intervals) -> list:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


class Clock:
    """Host clocks read together when the profiler starts, to place the
    profiler's device timestamps on ``time.perf_counter``."""

    def __init__(self):
        self.pc = time.perf_counter()
        self.bases = {"wall": time.time_ns(), "monotonic": time.monotonic_ns()}

    def base(self, first_ns: int):
        """The host clock's reading at ``pc`` in the profiler's
        nanoseconds, or None when the profiler's clock is neither of the
        host's."""
        return next((b for b in self.bases.values()
                     if abs(first_ns - b) < 60e9), None)


class Slice:
    """The traced slice: a ``torch.profiler`` over the device only, run
    from the event-loop thread.  It is started once on construction
    (set-up), so its own start-up stays out of the window; in the window
    it starts ``length`` seconds before the close, the close marks the
    slice's end, and it stops only once the server's worker has stopped
    (the activities past the mark are dropped by ``summary``)."""

    def __init__(self, length: float):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.length = length
        self._make = lambda: profile(activities=[ProfilerActivity.CUDA])
        with self._make():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        self.prof = self.clock = self.t0 = self.t1 = None

    def start(self):
        self.prof = self._make()
        self.prof.start()
        self.clock = Clock()
        self.t0 = self.clock.pc

    def mark_end(self):
        self.t1 = time.perf_counter()

    def stop(self):
        self.prof.stop()


def device_events(prof) -> list:
    """(name, start ns, duration ns) of every device activity."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def summary(events, t0: float, t1: float, clock: Clock, spans) -> dict:
    """Busy seconds, the slice's length, device seconds by kernel name, the
    ten longest idle gaps labelled by the host span around them, and (when
    the clocks align) each activity's start on the host clock."""
    base = clock.base(min(s for _, s, _ in events)) if events else None
    to_pc = None
    if base is not None:        # the activities inside [t0, t1], clipped
        def to_pc(ns):
            return clock.pc + (ns - base) / 1e9
        lo = base + (t0 - clock.pc) * 1e9
        hi = base + (t1 - clock.pc) * 1e9
        events = [(n, max(s, lo), min(s + d, hi) - max(s, lo))
                  for n, s, d in events if s < hi and s + d > lo]
    ivs = [(s, s + d) for _, s, d in events]
    u = union(ivs)
    by_name = collections.Counter()
    for name, _, d in events:
        by_name[name] += d / 1e9
    gaps = sorted(((u[i + 1][0] - u[i][1], u[i][1], u[i + 1][0])
                   for i in range(len(u) - 1)), reverse=True)[:10]
    labelled = collections.Counter()
    for g, a, b in gaps:
        label = "unaligned clocks"
        if to_pc is not None:
            mid = to_pc((a + b) / 2)
            label = next((sp[0] for sp in spans if sp[1] <= mid <= sp[2]),
                         "scheduler and server, outside engine calls")
        labelled[label] += g / 1e9
    placed = None if to_pc is None else \
        [(name, to_pc(s), d / 1e9) for name, s, d in events]
    return dict(busy_s=busy(ivs) / 1e9, window_s=t1 - t0, by_name=by_name,
                gaps=[[k, v] for k, v in labelled.most_common(10)],
                n_events=len(events), aligned=to_pc is not None,
                placed=placed, t0=t0, t1=t1)


def by_class(by_name) -> dict:
    out = collections.Counter()
    for name, s in by_name.items():
        out[kernel_class(name)] += s
    return dict(out)
