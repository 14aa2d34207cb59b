"""Asyncio streaming front end over one ``ContinuousScheduler`` replica
(counterpart of ``repro/runtime/server.py``).  Each replica's worker
thread launches its engine's kernels on that thread's current CUDA stream
on the engine's device.

One ``AsyncEngineServer`` owns one scheduler (one engine bank) and runs
its boundary loop on a dedicated worker thread; the asyncio side talks
to it through thread-safe inbox/cancel queues and receives per-request
token streams flushed once per chunk boundary (the chunk's one host
sync is the natural streaming granularity: tokens cannot be observed
any earlier without a sync inside the K-step chunk).

Failure semantics
-----------------
* **Cancellation** (``cancel(req_id)`` or a client dropping the stream)
  is *boundary-asynchronous*: it is recorded immediately but takes
  effect at the scheduler's NEXT chunk boundary, where the request is
  finalized CANCELLED with the tokens emitted so far and — mid-flight —
  its row and reserved pages are released for the same boundary's
  admissions.
* **Deadlines** (``submit(..., deadline_s=)``) are measured on the
  replica's serve clock from submission; the first boundary past the
  deadline finalizes the request TIMED_OUT (queued requests time out
  without ever being admitted).
* **Backpressure**: ``queue_limit`` bounds queued-not-yet-admitted
  requests.  A submit over the limit (or to an unhealthy replica)
  resolves immediately with a typed REJECTED result — load is shed with
  a first-class answer, never an unbounded queue.
* **Replica crash** (injected ``ReplicaCrash`` or any unexpected engine
  fault): the worker finalizes every in-flight and queued request as
  FAILED via ``scheduler.fail_all`` (pages released — a dead replica
  leaks nothing), resolves their handles, and marks the server
  unhealthy; subsequent submits are REJECTED.  Recovery is the router's
  job (retry on another replica), not the replica's.

Every request therefore ends in exactly one typed terminal state
(DONE / CANCELLED / TIMED_OUT / FAILED / REJECTED) and every handle's
``result()`` future resolves — a consumer can never hang on a request
the scheduler forgot.
"""
from __future__ import annotations

import asyncio
import collections
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.runtime.continuous import (CANCELLED, FAILED, QUEUED,
                                            REJECTED, ContinuousScheduler,
                                            Request, RequestResult)


class RequestHandle:
    """Consumer view of one submitted request: a token stream plus the
    final typed result.  ``stream()`` yields lists of tokens (one list
    per chunk-boundary flush) and ends when the request reaches a
    terminal state; ``result()`` resolves to the ``RequestResult``."""

    def __init__(self, req_id: int, loop: asyncio.AbstractEventLoop):
        self.req_id = req_id
        self.state = QUEUED
        self._loop = loop
        self._chunks: asyncio.Queue = asyncio.Queue()
        self._result: asyncio.Future = loop.create_future()

    # ---- worker-thread side (always via call_soon_threadsafe) ----------
    def _push_threadsafe(self, tokens) -> None:
        self._loop.call_soon_threadsafe(self._chunks.put_nowait,
                                        list(tokens))

    def _finish_threadsafe(self, result: RequestResult) -> None:
        def _finish():
            self.state = result.state
            if not self._result.done():
                self._result.set_result(result)
            self._chunks.put_nowait(None)          # stream sentinel
        self._loop.call_soon_threadsafe(_finish)

    def _reject_local(self, result: RequestResult) -> None:
        """Resolve on the event-loop thread (backpressure path)."""
        self.state = result.state
        if not self._result.done():
            self._result.set_result(result)
        self._chunks.put_nowait(None)

    # ---- consumer side --------------------------------------------------
    async def stream(self):
        while True:
            item = await self._chunks.get()
            if item is None:
                return
            yield item

    async def result(self) -> RequestResult:
        return await asyncio.shield(self._result)


def _typed_result(req: Request, state: str, now: float) -> RequestResult:
    return RequestResult(req_id=req.req_id,
                         tokens=np.zeros((0,), np.int32), n_emitted=0,
                         arrival=now, t_admit=now, t_finish=now,
                         state=state)


class AsyncEngineServer:
    """One serving replica: a scheduler boundary loop on a worker thread,
    bridged to asyncio.  See the module docstring for failure semantics.

    The worker thread OWNS the scheduler — the asyncio side never calls
    scheduler methods directly; submissions and cancels go through
    thread-safe queues and are drained between boundaries, so the
    scheduler itself needs no locking."""

    def __init__(self, scheduler: ContinuousScheduler, *,
                 name: str = "replica0", eos: Optional[int] = None,
                 queue_limit: int = 64, poll_s: float = 0.005,
                 stall_timeout_s: float = 0.0):
        if queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        if stall_timeout_s < 0:
            raise ValueError("stall_timeout_s must be >= 0")
        self.scheduler = scheduler
        self.name = name
        self._eos = eos
        self.queue_limit = queue_limit
        self.poll_s = poll_s
        self._lock = threading.Lock()
        self._inbox: collections.deque = collections.deque()
        self._cancel_box: collections.deque = collections.deque()
        self._handles: dict = {}
        self._work = threading.Event()
        self._stopping = False
        self._crashed: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._load = 0                      # queued + resident (approx.)
        self.completed = 0
        self.rejected = 0
        # worker-published engine snapshots: the event-loop side (health,
        # router audits) must never touch the worker-owned scheduler, so
        # the worker refreshes these under the lock at every publish
        self._pool_ok = True
        self._drained = True
        # boundary-progress heartbeat: the worker refreshes the timestamp
        # at every ingest (loop liveness) and every publish (boundary
        # progress).  A replica with work whose heartbeat goes stale past
        # ``stall_timeout_s`` is STALLED — alive but stuck (a hung device
        # call, an injected stall) — and the router's liveness watcher
        # drains it proactively (``drain_stalled``) instead of letting
        # clients wait on a wedged worker.  0 disables stall detection.
        self.stall_timeout_s = stall_timeout_s
        self._beat_boundary = 0
        self._beat_t = time.perf_counter()
        self._stalled_out = False           # sticky: drained as stalled
        self.stall_drains = 0               # handles failed over by drains
        self._t0 = time.perf_counter()      # serve clock (loop-side twin
        #                                     of scheduler.now())

    # ---- lifecycle -------------------------------------------------------
    async def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError(f"{self.name} already started")
        self._loop = asyncio.get_running_loop()
        self.scheduler.start(eos=self._eos)
        self._t0 = time.perf_counter()
        with self._lock:
            self._beat_t = time.perf_counter()   # heartbeat epoch
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"engine-{self.name}")
        self._thread.start()

    async def stop(self) -> None:
        """Graceful drain: the worker exits once nothing is in flight."""
        self._stopping = True
        self._work.set()
        if self._thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._thread.join)

    @property
    def healthy(self) -> bool:
        with self._lock:
            stalled_out = self._stalled_out
        return (self._thread is not None and self._thread.is_alive()
                and self._crashed is None and not self._stopping
                and not stalled_out)

    @property
    def stalled(self) -> bool:
        """True when the worker is alive, has work, and its heartbeat is
        older than ``stall_timeout_s`` — no ingest and no boundary
        completed for that long.  Idle replicas never read as stalled
        (nothing obliges their heartbeat to move)."""
        if not self.stall_timeout_s or self._thread is None \
                or not self._thread.is_alive() or self._crashed is not None:
            return False
        with self._lock:
            busy = (self._load + len(self._inbox)) > 0
            age = time.perf_counter() - self._beat_t
        return busy and age > self.stall_timeout_s

    def heartbeat(self) -> dict:
        """Loop-side view of the worker's progress beat."""
        with self._lock:
            return {"boundary": self._beat_boundary,
                    "age_s": time.perf_counter() - self._beat_t}

    def drain_stalled(self) -> int:
        """Liveness drain of a stalled-but-alive replica, called from the
        EVENT LOOP (the stuck worker cannot run its own crash path):
        every outstanding handle resolves FAILED so the router retries it
        elsewhere, queued-but-not-ingested requests included, and the
        replica is marked unhealthy (sticky — it stays out of rotation
        even if the wedged worker later limps on; its late publishes land
        on popped handles and are dropped).  Returns the number of
        handles failed over."""
        with self._lock:
            handles = list(self._handles.values())
            self._handles.clear()
            self._inbox.clear()
            self._stalled_out = True
            self.stall_drains += len(handles)
        now = self._now()
        for h in handles:
            h._reject_local(RequestResult(
                req_id=h.req_id, tokens=np.zeros((0,), np.int32),
                n_emitted=0, arrival=now, t_admit=now, t_finish=now,
                state=FAILED))
        return len(handles)

    @property
    def load(self) -> int:
        with self._lock:
            return self._load + len(self._inbox)

    def _now(self) -> float:
        """Event-loop-side serve clock.  ``scheduler.now()`` belongs to
        the worker thread; the loop side keeps its own epoch (set when
        the scheduler starts) for timestamps on rejected requests."""
        return time.perf_counter() - self._t0

    def health(self) -> dict:
        stalled = self.stalled              # takes the lock itself
        with self._lock:
            completed, rejected = self.completed, self.rejected
            load = self._load + len(self._inbox)
            pool_ok = self._pool_ok
            beat_boundary = self._beat_boundary
            beat_age = time.perf_counter() - self._beat_t
            stall_drains = self.stall_drains
        return {"name": self.name, "healthy": self.healthy,
                "load": load, "completed": completed,
                "rejected": rejected,
                "crashed": repr(self._crashed) if self._crashed else None,
                "pool_conserved": pool_ok,
                "stalled": stalled, "boundary": beat_boundary,
                "beat_age_s": beat_age, "stall_drains": stall_drains}

    def pool_conserved(self) -> bool:
        """Engine page-leak audit, as of the last boundary (worker
        snapshot — safe to call from the event loop)."""
        with self._lock:
            return self._pool_ok

    def drained(self) -> bool:
        """True iff the engine pool was fully free at the last boundary
        (worker snapshot — safe to call from the event loop)."""
        with self._lock:
            return self._drained

    # ---- request plane ---------------------------------------------------
    async def submit(self, request: Request, *,
                     deadline_s: Optional[float] = None) -> RequestHandle:
        """Queue a request; returns its handle.  An unhealthy replica or a
        full admission queue resolves the handle REJECTED immediately."""
        handle = RequestHandle(request.req_id, self._loop)
        if not self.healthy or self.load >= self.queue_limit:
            with self._lock:
                self.rejected += 1
            handle._reject_local(
                _typed_result(request, REJECTED, self._now()))
            return handle
        with self._lock:
            self._handles[request.req_id] = handle
            self._inbox.append((request, deadline_s))
        self._work.set()
        return handle

    async def cancel(self, req_id: int) -> None:
        """Client cancellation: effective at the next chunk boundary."""
        with self._lock:
            self._cancel_box.append(req_id)
        self._work.set()

    # ---- worker thread ---------------------------------------------------
    def _ingest(self) -> None:
        sched = self.scheduler
        with self._lock:
            subs = list(self._inbox)
            self._inbox.clear()
            cans = list(self._cancel_box)
            self._cancel_box.clear()
            # keep drained submissions counted in ``load`` until the next
            # _publish recomputes it from the scheduler — otherwise a
            # burst of submits between ingest and publish reads load 0
            # and sails past queue_limit
            self._load += len(subs)
            self._beat_t = time.perf_counter()   # worker loop is spinning
        for req, deadline_s in subs:
            # arrivals/deadlines live on the replica's serve clock
            req.arrival = sched.now()
            req.deadline = None if deadline_s is None else \
                req.arrival + float(deadline_s)
            sched.submit(req)
        for req_id in cans:
            sched.abort(req_id, CANCELLED)

    def _publish(self, emitted, finished, boundary=None) -> None:
        # engine audits run here, on the worker thread that owns the
        # scheduler; the loop side reads the published snapshot
        eng = self.scheduler.engine
        pool_ok = eng.sched_pool_conserved() \
            if hasattr(eng, "sched_pool_conserved") else True
        drained = eng.sched_drained() \
            if hasattr(eng, "sched_drained") else True
        with self._lock:
            for req_id, toks in emitted.items():
                h = self._handles.get(req_id)
                if h is not None:
                    h._push_threadsafe(toks)
            for res in finished:
                h = self._handles.pop(res.req_id, None)
                if h is not None:
                    h._finish_threadsafe(res)
                self.completed += 1
            self._load = self.scheduler.load
            self._pool_ok = pool_ok
            self._drained = drained
            self._beat_t = time.perf_counter()   # boundary progressed
            if boundary is not None:
                self._beat_boundary = boundary

    def _run(self) -> None:
        sched = self.scheduler
        try:
            while True:
                self._ingest()
                if not sched.has_work:
                    if self._stopping:
                        break
                    self._work.clear()
                    # re-check after clearing: a submit may have landed
                    # between has_work and clear (classic lost wakeup)
                    with self._lock:
                        empty = not self._inbox and not self._cancel_box
                    if empty and not self._stopping:
                        self._work.wait(timeout=0.25)
                    continue
                report = sched.boundary()   # faults stall/crash inside
                self._publish(report.emitted, report.finished,
                              boundary=report.boundary)
                if report.idle:
                    # resident bank empty but requests queued (injected
                    # pool exhaustion / future arrivals): don't hot-spin
                    self._work.wait(timeout=self.poll_s)
        except BaseException as e:          # noqa: BLE001 — crash path
            self._crashed = e
            failed = sched.fail_all(e)
            self._publish({}, failed)
        finally:
            # whatever is left (post-crash stragglers in the inbox, or
            # handles a racing submit added) must still resolve: nobody
            # may await a dead replica forever
            with self._lock:
                leftovers = list(self._handles.values())
                self._handles.clear()
                inbox = list(self._inbox)
                self._inbox.clear()
                self._load = 0
            now = sched.now()
            for req, _ in inbox:
                h = next((x for x in leftovers if x.req_id == req.req_id),
                         None)
                if h is not None and not h._result.done():
                    h._finish_threadsafe(_typed_result(
                        req, REJECTED, now))
            for h in leftovers:
                if not h._result.done():
                    res = self.scheduler._results.get(h.req_id)
                    if res is not None:
                        h._finish_threadsafe(res)
