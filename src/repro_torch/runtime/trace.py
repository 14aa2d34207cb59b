"""The port's tracer: named host spans where the serving path does its
work, each with its thread's CPU time, and the device times the program
can read without a sync.

One process-wide ``Tracer`` (``TRACER``), off by default.  It records
while a ``torch.profiler`` session is active in the process (the
profiler's own enabled flag), or between ``enable()`` and ``disable()``.
Off, ``span()`` costs one check and returns the shared no-op ``NOOP``: no
clock is read and nothing is allocated.

A span record (``SpanRecord``) holds the name, the thread, the start and
end on ``time.perf_counter_ns`` and the thread's CPU time over the span
(``time.thread_time_ns``: wall minus CPU is the time the thread was off
the CPU, waiting on the interpreter lock or preempted), three integer
attributes, ``rows``, ``tokens`` and ``k`` (steps), and ``graphed``: on a
prefill call's span (``engine.prefill``, ``engine.extend``) 1 when a
captured piece landed its tokens and 0 when it ran eagerly, else None.  Spans nest by time
within a thread.  Records go to bounded buffers; what does not fit drops
the oldest and is counted (``snapshot()["dropped"]``).

Clock anchor: ``enable()``, and the first span more than a second after
the newest anchor (a profiler session's first), read ``perf_counter_ns``,
``time_ns`` and ``monotonic_ns`` together (``Anchor``), so a profiler
trace's device timestamps, on either of the last two clocks, can be
placed on the spans' clock (``to_span_clock``).

Device times, with no sync:

* a span opened with ``device=`` on a CUDA device records a timing event
  at its start, one at each ``mark()`` and one at its end; ``collect()``
  (called after each decode chunk's host transfer) turns the events that
  have completed into ``DeviceRecord``s: the span's name, its host start
  and end, its tokens and the device milliseconds between its events;
* ``PhaseMarks``: five timing events that the captured decode step
  records at its phase boundaries (start, after the draft, after the
  verify forward, after the accept walk, after the commit and emit).
  Every capture of the inline drafted step records them, traced or not,
  so tracing never changes a graph; ``after_transfer`` reads the last
  replay's four phase times into a ``PhaseRecord``;
* ``ExpertTap``: in the inline drafted step of a model with experts, two
  timing events a layer around its expert block (``PhaseRecord.moe``:
  their device ms summed over the layers; None for a model without
  experts, whose step holds no tap), and an (L, E) buffer into which the
  dispatch counts the rows each expert took.  ``after_transfer`` reads
  that buffer too, only while the tracer is on, into a ``RouteRecord``
  for the chunk's last step: per layer the rows routed, the experts hit
  and the largest expert's rows.

Names recorded by the serving path (who reads each: ``PERF.md`` §3):
``engine.chunk`` (``.h2d``, ``.load``, ``.replay``, ``.wait``),
``engine.prefill`` (``.forward``, ``.insert``), ``engine.extend``
(``.forward``, ``.splice``), ``engine.reset``, ``engine.release``,
``graphs.warmup``, ``graphs.piece_warmup``, ``graphs.capture``,
``sched.boundary`` (``sched.aborts``,
``sched.pieces``, ``sched.admit``, ``sched.flush``, ``sched.evict``),
``server.ingest``, ``server.publish``, ``server.wait``.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 16            # records kept of each kind
PENDING = 4096                # device-timed spans awaiting their events
ANCHOR_NS = 1_000_000_000     # a span this long after the newest anchor
#                               takes a new one


class SpanRecord(NamedTuple):
    name: str
    thread: int
    t0: int                   # perf_counter_ns
    t1: int
    cpu: int                  # thread CPU ns over the span
    rows: int
    tokens: int
    k: int
    graphed: Optional[int] = None


class DeviceRecord(NamedTuple):
    name: str
    t0: int                   # the host span's start and end
    t1: int
    tokens: int
    ms: Tuple[float, ...]     # device ms between the span's events


class PhaseRecord(NamedTuple):
    t: int                    # perf_counter_ns when it was read
    draft: float              # device ms of one replayed step's phases
    verify: float
    accept: float
    commit: float
    moe: Optional[float] = None   # the expert blocks' ms, within verify


class RouteRecord(NamedTuple):
    t: int                    # perf_counter_ns when it was read
    rows: Tuple[int, ...]     # per layer: the (token, choice) rows routed
    hit: Tuple[int, ...]      # the experts that took a row
    top: Tuple[int, ...]      # the largest expert's rows


class Anchor(NamedTuple):
    perf: int                 # perf_counter_ns, time_ns and monotonic_ns
    wall: int                 # read together
    mono: int


def _append(buf, item) -> int:
    """Append to the bounded ``buf``: 1 when that pushed a record out."""
    full = len(buf) == buf.maxlen
    buf.append(item)
    return int(full)


def _anchor() -> Anchor:
    return Anchor(time.perf_counter_ns(), time.time_ns(),
                  time.monotonic_ns())


def to_span_clock(anchor: Anchor, first_ns: int):
    """The offset (ns) that moves a profiler timestamp onto the spans'
    clock, given the trace's first timestamp: the profiler's clock is
    whichever of ``time_ns`` and ``monotonic_ns`` lies within a minute of
    it.  None when neither does."""
    for base in (anchor.wall, anchor.mono):
        if abs(first_ns - base) < 60_000_000_000:
            return anchor.perf - base
    return None


class _NoSpan:
    """The span handed out while the tracer is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def mark(self) -> None:
        pass


NOOP = _NoSpan()


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Span:
    __slots__ = ("tracer", "name", "rows", "tokens", "k", "device",
                 "graphed", "t0", "c0", "events")

    def __init__(self, tracer, name, rows, tokens, k, device, graphed=None):
        self.tracer, self.name = tracer, name
        self.rows, self.tokens, self.k = rows, tokens, k
        self.device, self.graphed = device, graphed
        self.events = None

    def __enter__(self):
        if self.device is not None and self.device.type == "cuda":
            self.events = [_event()]
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns()
        return self

    def mark(self) -> None:
        """A device timing event between the span's start and end."""
        if self.events is not None:
            self.events.append(_event())

    def __exit__(self, *exc):
        cpu = time.thread_time_ns() - self.c0
        t1 = time.perf_counter_ns()
        pending = None
        if self.events is not None:
            self.events.append(_event())
            pending = (self.name, self.t0, t1, self.tokens, self.events)
        self.tracer._record(SpanRecord(
            self.name, threading.get_ident(), self.t0, t1, cpu, self.rows,
            self.tokens, self.k, self.graphed), pending)
        return False


class PhaseMarks:
    """The captured decode step's five phase-boundary timing events
    (external: each is a node of the graph).  ``at(i)`` records event i on
    the current stream; ``elapsed_ms()`` gives the four phases of the last
    replay, once it has completed."""

    def __init__(self):
        self.events = [torch.cuda.Event(enable_timing=True, external=True)
                       for _ in range(5)]

    def at(self, i: int) -> None:
        self.events[i].record()

    def elapsed_ms(self) -> tuple:
        return tuple(a.elapsed_time(b)
                     for a, b in zip(self.events, self.events[1:]))


class ExpertTap:
    """The expert layers of a captured step: ``counts`` (L, E) int64, the
    rows each expert took in each layer, which the dispatch writes in
    place (``models/mlp.py::moe_dropless``); with ``timed``, two external
    timing events a layer, recorded around its expert block.  Without
    ``timed`` (the CPU's static-buffer step) only the counts."""

    def __init__(self, layers: int, experts: int, device, timed: bool):
        self.counts = torch.zeros((layers, experts), dtype=torch.int64,
                                  device=device)
        self.events = [torch.cuda.Event(enable_timing=True, external=True)
                       for _ in range(2 * layers)] if timed else None

    def begin(self, layer: int) -> None:
        if self.events is not None:
            self.events[2 * layer].record()

    def end(self, layer: int) -> None:
        if self.events is not None:
            self.events[2 * layer + 1].record()

    def elapsed_ms(self) -> Optional[float]:
        """The last replay's expert blocks, device ms summed over the
        layers, once it has completed; None without events."""
        if self.events is None:
            return None
        return sum(a.elapsed_time(b)
                   for a, b in zip(self.events[::2], self.events[1::2]))

    def read(self) -> tuple:
        """(rows, hit, top) of the last replay, each a tuple over the
        layers (one device-to-host copy)."""
        c = self.counts.cpu()
        return (tuple(c.sum(dim=1).tolist()),
                tuple((c > 0).sum(dim=1).tolist()),
                tuple(c.max(dim=1).values.tolist()))


class Tracer:
    """Bounded buffers of span, device, phase and route records, and the
    clock anchors; see the module docstring."""

    def __init__(self):
        self.forced = False
        self.dropped = 0
        self._lock = threading.Lock()
        self._spans = collections.deque(maxlen=CAPACITY)
        self._device = collections.deque(maxlen=CAPACITY)
        self._phases = collections.deque(maxlen=CAPACITY)
        self._routes = collections.deque(maxlen=CAPACITY)
        self._pending = collections.deque(maxlen=PENDING)
        self._anchors = collections.deque([_anchor()], maxlen=CAPACITY)

    def _record(self, rec: SpanRecord, pending) -> None:
        with self._lock:
            self.dropped += _append(self._spans, rec)
            if pending is not None:
                self.dropped += _append(self._pending, pending)
            if rec.t0 - self._anchors[-1].perf > ANCHOR_NS:
                self.dropped += _append(self._anchors, _anchor())

    def enable(self) -> None:
        self.forced = True
        with self._lock:
            self.dropped += _append(self._anchors, _anchor())

    def disable(self) -> None:
        self.forced = False

    def clear(self) -> None:
        """Drop every record and count (the anchors too, but a fresh
        one)."""
        with self._lock:
            for buf in (self._spans, self._device, self._phases,
                        self._routes, self._pending, self._anchors):
                buf.clear()
            self.dropped = 0
            self._anchors.append(_anchor())

    def collect(self) -> None:
        """Device records of the device-timed spans whose events have
        completed, oldest first; never waits for one."""
        with self._lock:
            pend = self._pending
            while pend and pend[0][-1][-1].query():
                name, t0, t1, tokens, evs = pend.popleft()
                self.dropped += _append(self._device, DeviceRecord(
                    name, t0, t1, tokens,
                    tuple(a.elapsed_time(b) for a, b in zip(evs, evs[1:]))))

    def after_transfer(self, marks: Optional[PhaseMarks],
                       tap: Optional[ExpertTap] = None) -> None:
        """After a decode chunk's host transfer: the last replay's phase
        times (``marks``, None when the chunk replayed no marked graph)
        with its expert blocks' time, its routing (``tap``, None when the
        chunk replayed no graph with experts), and the device-timed spans
        that have completed."""
        t = time.perf_counter_ns()
        phase = None if marks is None else PhaseRecord(
            t, *marks.elapsed_ms(), None if tap is None else tap.elapsed_ms())
        route = None if tap is None else RouteRecord(t, *tap.read())
        with self._lock:
            if phase is not None:
                self.dropped += _append(self._phases, phase)
            if route is not None:
                self.dropped += _append(self._routes, route)
        self.collect()

    def snapshot(self) -> dict:
        """Copies of the records (``spans``, ``device``, ``phases``,
        ``routes``, ``anchors``) and ``dropped``, the records the bounds
        pushed out."""
        with self._lock:
            return dict(spans=list(self._spans), device=list(self._device),
                        phases=list(self._phases), routes=list(self._routes),
                        anchors=list(self._anchors), dropped=self.dropped)


TRACER = Tracer()


def span(name: str, rows: int = 0, tokens: int = 0, k: int = 0,
         device=None, graphed: Optional[int] = None):
    """A context manager timing its block as ``name`` (``NOOP`` while
    off).  With a CUDA ``device`` the span also times its device work."""
    if not (TRACER.forced or _autograd_profiler._is_profiler_enabled):
        return NOOP
    return Span(TRACER, name, rows, tokens, k, device, graphed)


def after_transfer(marks: Optional[PhaseMarks],
                   tap: Optional[ExpertTap] = None) -> None:
    if TRACER.forced or _autograd_profiler._is_profiler_enabled:
        TRACER.after_transfer(marks, tap)


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def snapshot() -> dict:
    return TRACER.snapshot()
