"""Deterministic, seedable fault injection for the serving stack
(counterpart of ``repro/runtime/faults.py``, host only).

Every degradation path the fault-tolerant front end must survive is
injectable here, on a fixed seed, so chaos runs replay bit-identically
in tests, CI and ``benchmarks/sched_bench.py``'s ``record["faults"]``
arm:

* **replica crash** — ``ReplicaFaults.on_boundary`` raises
  ``ReplicaCrash`` at a scheduled boundary index.  The scheduler
  propagates it out of ``boundary()``; the async server catches it,
  finalizes every in-flight request as FAILED via
  ``ContinuousScheduler.fail_all`` (releasing the rows' pages — a
  crashed replica never leaks pool pages) and marks itself unhealthy so
  the router stops routing to it.
* **chunk-step stall / latency spike** — ``on_boundary`` sleeps
  ``stall_s`` with probability ``stall_rate`` before the chunk runs,
  modelling a slow device or a preempted core.  Purely timing: outputs
  are untouched.
* **admission-time pool exhaustion** — ``block_admission`` returns True
  with probability ``exhaust_rate``; the scheduler then defers every
  queued request for that boundary exactly like a genuinely exhausted
  page pool (queueing delay, never corruption or loss).
* **client disconnect** — ``ClientFaults.disconnect_after(req_id)``
  decides, deterministically PER REQUEST ID, whether that client hangs
  up mid-stream and after how many delivered tokens.  Keying on the id
  (not arrival order or wall clock) means a retried request keeps the
  same client behavior on every replica it lands on.

Failure semantics: all injectors are host-side and deterministic given
``(seed, replica name, boundary index / request id)``.  A crash is
terminal for its replica; stalls and exhaustion are transient; a
disconnect becomes a normal ``abort(req_id)`` → CANCELLED at the next
chunk boundary.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np


class ReplicaCrash(RuntimeError):
    """An injected (or detected) fatal replica fault: the engine behind a
    scheduler is gone and every in-flight request on it must fail."""


def _stable_key(name: str) -> int:
    """Seed component for a replica name — stable across processes
    (``hash(str)`` is salted per interpreter, crc32 is not)."""
    return zlib.crc32(name.encode("utf-8"))


@dataclasses.dataclass
class FaultPlan:
    """One seeded chaos schedule for a whole serving deployment.

    ``crash`` maps replica names to the boundary index at which they
    raise ``ReplicaCrash``; rates are per-boundary (stall/exhaust) or
    per-request (cancel) probabilities.  ``injector(name)`` derives the
    per-replica injector, ``client()`` the client-side one; both are
    deterministic functions of ``(seed, name)`` so two runs of the same
    plan inject the same faults at the same points.
    """
    seed: int = 0
    crash: Dict[str, int] = dataclasses.field(default_factory=dict)
    stall_rate: float = 0.0
    stall_s: float = 0.02
    exhaust_rate: float = 0.0
    cancel_rate: float = 0.0
    cancel_after: Tuple[int, int] = (1, 8)   # inclusive token range

    def __post_init__(self):
        for name, rate in (("stall_rate", self.stall_rate),
                           ("exhaust_rate", self.exhaust_rate),
                           ("cancel_rate", self.cancel_rate)):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        lo, hi = self.cancel_after
        if lo < 1 or hi < lo:
            raise ValueError("cancel_after must be (lo >= 1, hi >= lo)")

    def injector(self, name: str) -> "ReplicaFaults":
        return ReplicaFaults(self, name)

    def client(self) -> "ClientFaults":
        return ClientFaults(self)


class ReplicaFaults:
    """Per-replica injector, wired into ``ContinuousScheduler(faults=)``.

    ``on_boundary(i)`` runs at every boundary entry: it raises
    ``ReplicaCrash`` at the scheduled crash boundary and sleeps
    ``stall_s`` on a ``stall_rate`` draw.  ``block_admission()`` is
    consulted once per boundary by the admission loop."""

    def __init__(self, plan: FaultPlan, name: str):
        self.plan = plan
        self.name = name
        self.crash_boundary = plan.crash.get(name)
        base = [plan.seed, _stable_key(name)]
        self._stall_rng = np.random.default_rng(base + [1])
        self._exhaust_rng = np.random.default_rng(base + [2])
        self.injected: Dict[str, int] = {"stall": 0, "exhaust": 0,
                                         "crash": 0}

    def on_boundary(self, i: int) -> None:
        if self.crash_boundary is not None and i >= self.crash_boundary:
            self.injected["crash"] += 1
            raise ReplicaCrash(
                f"injected crash on {self.name} at boundary {i}")
        if self.plan.stall_rate and \
                self._stall_rng.random() < self.plan.stall_rate:
            self.injected["stall"] += 1
            time.sleep(self.plan.stall_s)

    def block_admission(self) -> bool:
        if self.plan.exhaust_rate and \
                self._exhaust_rng.random() < self.plan.exhaust_rate:
            self.injected["exhaust"] += 1
            return True
        return False


class ClientFaults:
    """Client-side injector (lives with the router, not a replica).

    ``disconnect_after(req_id)`` is a pure function of
    ``(plan.seed, req_id)``: None for a patient client, else the number
    of delivered tokens after which the client hangs up.  The router
    turns a hang-up into ``server.cancel(req_id)`` and the scheduler
    finalizes the request CANCELLED at its next boundary."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def disconnect_after(self, req_id: int) -> Optional[int]:
        if not self.plan.cancel_rate:
            return None
        rng = np.random.default_rng([self.plan.seed, 3, int(req_id)])
        if rng.random() >= self.plan.cancel_rate:
            return None
        lo, hi = self.plan.cancel_after
        return int(rng.integers(lo, hi + 1))
