"""Multi-replica router: load balancing, retry with backoff, idempotent
re-streaming over ``AsyncEngineServer`` replicas.
(Counterpart of ``repro/runtime/router.py``, host only.)

The router is the client-facing plane: it picks the least-loaded healthy
replica for each request, streams its tokens, and absorbs replica
failures so the client sees exactly one typed terminal result per
request.

Failure semantics
-----------------
* **Routing / health**: every attempt goes to the least-loaded replica
  whose ``healthy`` flag is up (ties break by replica order); an
  optional background health watcher snapshots ``health()`` for
  observability.  With no healthy replica left the request resolves
  REJECTED without running.
* **Liveness probes**: the same watcher reads each replica's
  boundary-progress heartbeat.  A replica that is alive but stuck — no
  ingest and no boundary completed for ``stall_timeout_s`` while it has
  work — is drained proactively (``drain_stalled``): its outstanding
  handles resolve FAILED, which feeds straight into the retry path
  below, and the replica is marked unhealthy so routing skips it.
  Clients never wait out a wedged worker.
* **Retry**: a FAILED attempt (replica crashed mid-request) or a
  REJECTED one (backpressure) is retried up to ``max_retries`` times
  with exponential backoff plus deterministic per-(request, attempt)
  jitter, preferring a different replica than the one that just failed.
  DONE / CANCELLED / TIMED_OUT are terminal — a client cancellation or
  an expired deadline is never retried.
* **Idempotency guard**: the router counts tokens already delivered to
  the client; a retried request re-decodes from scratch on the new
  replica (decode is greedy, hence deterministic per prompt) and the
  router SKIPS the already-delivered prefix, so a retry never
  double-emits and the client's stream is a clean continuation.  The
  final result's tokens always equal the delivered stream.
* **Client disconnect injection**: with ``client_faults``
  (``faults.ClientFaults``), a request whose client is scheduled to
  hang up is cancelled on its replica once that many tokens were
  delivered — exercising the CANCELLED path end to end.

``replay()`` drives an open-loop arrival trace through the router
(arrival times honoured on the router's own clock) and aggregates
router-level stats: per-state counts, retries, goodput (tokens of DONE
requests per second of makespan) and latency percentiles.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.runtime.continuous import (DONE, FAILED, REJECTED,
                                            TERMINAL_STATES, Request,
                                            RequestResult)
from repro_torch.runtime.server import AsyncEngineServer


class ReplicaRouter:
    """Route requests across replicas; retry faults; never double-emit."""

    def __init__(self, replicas: Sequence[AsyncEngineServer], *,
                 max_retries: int = 2, backoff_base: float = 0.05,
                 backoff_cap: float = 1.0, jitter: float = 0.5,
                 seed: int = 0, client_faults=None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if max_retries < 0 or backoff_base < 0 or jitter < 0:
            raise ValueError("max_retries/backoff_base/jitter must be >= 0")
        self.replicas = list(replicas)
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.jitter = jitter
        self.seed = seed
        self.client_faults = client_faults
        self.retries = 0
        self.routed: Dict[str, int] = {r.name: 0 for r in self.replicas}
        self.health_log: List[list] = []
        self.stall_drains = 0               # handles failed over by probes
        self._health_task: Optional[asyncio.Task] = None

    # ---- replica plane ---------------------------------------------------
    async def start(self, *, health_every_s: float = 0.0) -> None:
        for r in self.replicas:
            await r.start()
        if health_every_s > 0:
            self._health_task = asyncio.ensure_future(
                self._watch(health_every_s))

    async def stop(self) -> None:
        if self._health_task is not None:
            self._health_task.cancel()
            self._health_task = None
        for r in self.replicas:
            await r.stop()

    async def _watch(self, every_s: float) -> None:
        """Health snapshots + liveness probes.  Runs on the event loop:
        ``stalled`` reads only loop-side state and ``drain_stalled``
        resolves handles loop-side, so the stuck worker thread is never
        touched — its late publishes land on popped handles."""
        try:
            while True:
                self.health_log.append(self.health())
                for r in self.replicas:
                    if r.stalled:
                        self.stall_drains += r.drain_stalled()
                await asyncio.sleep(every_s)
        except asyncio.CancelledError:
            pass

    def health(self) -> list:
        return [r.health() for r in self.replicas]

    def pages_conserved(self) -> bool:
        """Fleet-wide page-leak audit (True for dense engines).  Reads
        each replica's worker-published snapshot — the router runs on the
        event loop and must never touch a worker-owned scheduler."""
        return all(r.pool_conserved() for r in self.replicas)

    def drained(self) -> bool:
        """After everything terminal: every replica's pool fully free
        (as of each worker's last boundary snapshot)."""
        return all(r.drained() for r in self.replicas)

    def _pick(self, avoid=None) -> Optional[AsyncEngineServer]:
        healthy = [r for r in self.replicas if r.healthy]
        if not healthy:
            return None
        preferred = [r for r in healthy if r is not avoid] or healthy
        return min(preferred,
                   key=lambda r: (r.load, self.replicas.index(r)))

    def _backoff(self, req_id, attempt: int) -> float:
        delay = min(self.backoff_cap,
                    self.backoff_base * (2.0 ** (attempt - 1)))
        # deterministic per (seed, request, attempt): jitter decorrelates
        # retry bursts without making chaos runs unreplayable.  Request
        # ids are application-chosen and not necessarily integers, so
        # seed from a stable digest of the id's string form (crc32 is
        # stable across processes, unlike hash())
        rid = zlib.crc32(str(req_id).encode("utf-8"))
        rng = np.random.default_rng([self.seed, rid, attempt])
        return delay * (1.0 + self.jitter * float(rng.random()))

    # ---- request plane ---------------------------------------------------
    async def generate(self, request: Request, *,
                       deadline_s: Optional[float] = None) -> tuple:
        """Run one request to a terminal state; returns
        ``(delivered_tokens, RequestResult)``.  Tokens are delivered
        exactly once across all retry attempts (idempotency guard)."""
        delivered: List[int] = []
        disconnect_after = None
        if self.client_faults is not None:
            disconnect_after = self.client_faults.disconnect_after(
                request.req_id)
        attempt = 0
        avoid = None
        result = None
        while True:
            replica = self._pick(avoid=avoid)
            if replica is None:
                result = RequestResult(
                    req_id=request.req_id,
                    # reprolint: disable=R3 # torchlint: disable=T3 (host list)
                    tokens=np.asarray(delivered, np.int32),
                    n_emitted=len(delivered), arrival=0.0, t_admit=0.0,
                    t_finish=0.0, state=REJECTED)
                break
            self.routed[replica.name] += 1
            # the scheduler mutates Request in place (arrival, deadline,
            # age): every attempt gets a fresh copy so a retry replays the
            # original request, not the previous attempt's leftovers
            handle = await replica.submit(
                dataclasses.replace(request), deadline_s=deadline_s)
            seen = 0
            cancelled = False
            async for toks in handle.stream():
                for t in toks:
                    seen += 1
                    if seen > len(delivered):   # skip re-decoded prefix
                        delivered.append(int(t))
                if (disconnect_after is not None and not cancelled
                        and len(delivered) >= disconnect_after):
                    cancelled = True
                    await replica.cancel(handle.req_id)
            result = await handle.result()
            assert result.state in TERMINAL_STATES
            if result.state not in (REJECTED, FAILED):
                break                           # DONE/CANCELLED/TIMED_OUT
            if attempt >= self.max_retries:
                break
            attempt += 1
            self.retries += 1
            avoid = replica
            await asyncio.sleep(self._backoff(request.req_id, attempt))
        return delivered, result


async def replay(router: ReplicaRouter, requests: Sequence[Request], *,
                 deadline_s: Optional[float] = None) -> tuple:
    """Open-loop arrival replay through the router: each request is
    submitted at its ``arrival`` offset on the router's clock; returns
    ``(results_in_request_order, stats)``."""
    t0 = time.perf_counter()
    lat: Dict[int, float] = {}
    out: Dict[int, RequestResult] = {}
    tokens: Dict[int, list] = {}

    async def one(req: Request):
        wait = req.arrival - (time.perf_counter() - t0)
        if wait > 0:
            await asyncio.sleep(wait)
        t_sub = time.perf_counter()
        toks, res = await router.generate(req, deadline_s=deadline_s)
        lat[req.req_id] = time.perf_counter() - t_sub
        out[req.req_id] = res
        tokens[req.req_id] = toks

    await asyncio.gather(*(one(r) for r in requests))
    makespan = time.perf_counter() - t0
    ordered = [out[r.req_id] for r in requests]
    states: Dict[str, int] = {}
    for r in ordered:
        states[r.state] = states.get(r.state, 0) + 1
    total = sum(len(tokens[r.req_id]) for r in requests)
    good = sum(r.n_emitted for r in ordered if r.state == DONE)
    lats = np.asarray([lat[r.req_id] for r in requests])

    def pct(q):
        return float(np.percentile(lats, q)) if lats.size else 0.0

    stats = {
        "requests": len(ordered),
        "makespan_s": makespan,
        "delivered_total": total,
        "tok_s": total / makespan if makespan > 0 else float("inf"),
        "goodput_tok_s": good / makespan if makespan > 0 else float("inf"),
        "states": states,
        "terminal": all(r.state in TERMINAL_STATES for r in ordered),
        "retries": router.retries,
        "routed": dict(router.routed),
        "latency_mean_s": float(lats.mean()) if lats.size else 0.0,
        "latency_p50_s": pct(50),
        "latency_p95_s": pct(95),
        "latency_max_s": float(lats.max()) if lats.size else 0.0,
    }
    return ordered, stats
