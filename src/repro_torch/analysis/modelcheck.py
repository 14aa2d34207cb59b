"""T9: bounded exhaustive model check of the scheduler's boundary protocol
(the port's copy of ``repro/analysis/modelcheck.py``).

``SchedModel`` is a host-only mirror of the port's ``ContinuousScheduler``
(``runtime/continuous.py``) stepping a paged engine: the same boundary
phase order (abort sweep -> chunked-prefill extend -> admissions -> chunk
-> flush -> evict), the same FIFO-by-(arrival, req_id) queue, the same page
arithmetic (``pages_for(prompt + budget + overshoot)`` capped by
``max_pages`` and the pool), the same bootstrap bypass of
``sched_can_admit`` on the very first admission.  Tokens are modelled as
counts (sequential decode, ``eos=None``): an admission emits 1, a chunk
emits ``min(K, rem)`` per live row with ``K = _pow2_chunk(chunk, max
rem)`` (``runtime/engine.py::_pow2_chunk``).

``explore`` drives the model through EVERY interleaving of
``submit``/``abort``/``boundary``/crash (``fail_all``) up to the configured
request set, with the crash injectable at every reachable state, and
memoizes canonical states so the search is exhaustive yet finite.  After
each transition four invariants are checked:

  I1  page conservation: free + sum(held by resident rows) == n_pages,
      free >= 0, at every step (mid-crash cleanup included);
  I2  exactly-once typed terminals: each request is finalized at most
      once, always with a TERMINAL state, and every quiescent
      all-terminal state accounts for every submitted request;
  I3  release-before-admission: within one boundary, every page release
      of the abort sweep precedes every admission;
  I4  no admission after ``fail_all``: a crashed replica's scheduler admits
      nothing, ever (``fail_all`` drains the queue).

The default bound (3 requests, batch 2, a 5-page pool, one chunked
prefill, crash at every reachable state) is the reference's, so both
explore the same canonical states and transitions.  ``--max-seconds`` is a
hard wall-clock cap: an unfinished exploration fails, because it proves
nothing.  ``tests/test_torch_modelcheck.py`` replays identical action
traces on this model, the port's ``ContinuousScheduler`` over its paged
engine and the reference's, and compares terminal states, emission counts
and per-boundary pool occupancy.  Out of model scope: deadlines, EOS
stopping, capacity freezes (configs keep ``need <= min(max_pages,
n_pages)``), aging and priority policies.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

# lifecycle vocabulary, mirrored from repro_torch.runtime.continuous (kept
# local: the linter imports nothing of the code it checks)
QUEUED = "QUEUED"
PREFILLING = "PREFILLING"
DECODING = "DECODING"
DONE = "DONE"
CANCELLED = "CANCELLED"
TIMED_OUT = "TIMED_OUT"
FAILED = "FAILED"
TERMINAL_STATES = frozenset({DONE, CANCELLED, TIMED_OUT, FAILED})


def pages_for(n_tokens: int, page_size: int) -> int:
    return -(-int(n_tokens) // int(page_size))


def _pow2_chunk(k_max: int, need: int) -> int:
    """Mirror of ``repro_torch.runtime.engine._pow2_chunk``."""
    k = 1
    while k < need and k < k_max:
        k *= 2
    return min(k, k_max)


class ModelViolation(AssertionError):
    """An invariant (I1-I4) failed during a transition."""


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    batch: int = 2
    chunk: int = 2
    prefill_chunk: int = 2       # C: 0 disables chunked prefill
    page_size: int = 4
    n_pages: int = 5             # pool; tight enough to force deferral
    max_len: int = 64
    overshoot: int = 1           # sequential engine: one chain slot

    @property
    def max_pages(self) -> int:
        return pages_for(self.max_len, self.page_size)


@dataclasses.dataclass(frozen=True)
class ModelRequest:
    req_id: int
    prompt_len: int
    n_tokens: int


class SchedModel:
    """Host model of one scheduler stream over a paged engine."""

    def __init__(self, cfg: ModelConfig, reqs: Sequence[ModelRequest]):
        self.cfg = cfg
        self.reqs: Dict[int, ModelRequest] = {r.req_id: r for r in reqs}
        self.pending: List[int] = []            # sorted by req_id (arrival=0)
        self.slots: List[Optional[dict]] = [None] * cfg.batch
        self.free = cfg.n_pages
        self.results: Dict[int, Tuple[str, int]] = {}   # id -> (state, n)
        self.state_of: Dict[int, str] = {}
        self.aborts: Dict[int, str] = {}
        self.submitted: set = set()
        self.started = False                    # mirrors `_dev is not None`
        self.failed = False                     # fail_all() happened
        self.boundary_events: List[str] = []    # last boundary, for I3/I4

    # ---- canonical state (memoization key for the explorer) -------------
    def snapshot(self) -> tuple:
        return (
            tuple(self.pending),
            tuple(None if s is None else
                  (s["id"], s["out"], s["rem"], s["done"],
                   s["left"], s["pages"]) for s in self.slots),
            self.free,
            tuple(sorted(self.results.items())),
            tuple(sorted(self.state_of.items())),
            tuple(sorted(self.aborts.items())),
            frozenset(self.submitted),
            self.started,
            self.failed,
        )

    @classmethod
    def from_snapshot(cls, cfg: ModelConfig, reqs: Sequence[ModelRequest],
                      snap: tuple) -> "SchedModel":
        m = cls(cfg, reqs)
        (pending, slots, free, results, state_of, aborts,
         submitted, started, failed) = snap
        m.pending = list(pending)
        m.slots = [None if s is None else
                   {"id": s[0], "out": s[1], "rem": s[2], "done": s[3],
                    "left": s[4], "pages": s[5]} for s in slots]
        m.free = free
        m.results = dict(results)
        m.state_of = dict(state_of)
        m.aborts = dict(aborts)
        m.submitted = set(submitted)
        m.started = started
        m.failed = failed
        return m

    # ---- internals ------------------------------------------------------
    def _finalize(self, req_id: int, n_emitted: int, state: str) -> None:
        if req_id in self.results:
            raise ModelViolation(
                f"I2: request {req_id} finalized twice "
                f"(was {self.results[req_id][0]}, now {state})")
        if state not in TERMINAL_STATES:
            raise ModelViolation(
                f"I2: request {req_id} finalized with non-terminal "
                f"state {state!r}")
        self.results[req_id] = (state, n_emitted)
        self.state_of.pop(req_id, None)

    def _release(self, slot: dict, kind: str) -> None:
        self.free += slot["pages"]
        slot["pages"] = 0
        self.boundary_events.append(kind)

    def _need_pages(self, req: ModelRequest) -> int:
        c = self.cfg
        return min(pages_for(req.prompt_len + req.n_tokens + c.overshoot,
                             c.page_size),
                   c.max_pages, c.n_pages)

    def _check_conservation(self) -> None:
        held = sum(s["pages"] for s in self.slots if s is not None)
        if self.free < 0 or self.free + held != self.cfg.n_pages:
            raise ModelViolation(
                f"I1: page conservation broken — free={self.free} "
                f"held={held} pool={self.cfg.n_pages}")

    def _check_boundary_order(self) -> None:
        ev = self.boundary_events
        if self.failed and "admit" in ev:
            raise ModelViolation(
                "I4: admission event inside a boundary after fail_all")
        first_admit = next((i for i, e in enumerate(ev) if e == "admit"),
                           None)
        if first_admit is not None and any(
                e == "abort_release" for e in ev[first_admit:]):
            raise ModelViolation(
                "I3: abort release ordered AFTER an admission within one "
                "boundary")

    # ---- the stepping API -----------------------------------------------
    def submit(self, req_id: int) -> None:
        if req_id in self.state_of or req_id in self.submitted:
            raise ValueError(f"req_id {req_id} already submitted")
        self.submitted.add(req_id)
        self.state_of[req_id] = QUEUED
        bisect.insort(self.pending, req_id)   # arrivals all 0: FIFO == id
        self._check_conservation()

    def abort(self, req_id: int, state: str = CANCELLED) -> None:
        if state not in TERMINAL_STATES:
            raise ValueError(f"not a terminal state: {state!r}")
        if req_id not in self.results:
            self.aborts.setdefault(req_id, state)

    def boundary(self) -> Dict[int, int]:
        """One admit/chunk/evict iteration; returns {req_id: tokens
        flushed this boundary} for trace-equivalence tests."""
        c = self.cfg
        self.boundary_events = []
        flushed: Dict[int, int] = {}
        # ---- abort sweep (releases land BEFORE admissions) --------------
        if self.aborts:
            aborts, self.aborts = self.aborts, {}
            rows = {s["id"]: b for b, s in enumerate(self.slots)
                    if s is not None}
            for req_id, state in aborts.items():
                if req_id in self.results:
                    continue
                if req_id in rows:
                    s = self.slots[rows[req_id]]
                    kept = min(s["out"], self.reqs[req_id].n_tokens)
                    self._finalize(req_id, kept, state)
                    self._release(s, "abort_release")
                    self.slots[rows[req_id]] = None
                elif req_id in self.pending:
                    self.pending.remove(req_id)
                    self._finalize(req_id, 0, state)
        # ---- chunked prefill: one piece per row per boundary ------------
        for s in self.slots:
            if s is None or s["left"] is None:
                continue
            piece = min(c.prefill_chunk, s["left"])
            s["left"] -= piece
            if s["left"] == 0:            # last piece: the row goes live
                s["left"] = None
                s["out"] = 1
                s["done"] = False
                s["rem"] = max(self.reqs[s["id"]].n_tokens - 1, 0)
                self.state_of[s["id"]] = DECODING
        # ---- admissions (FIFO; bootstrap bypasses can_admit) ------------
        for b in range(c.batch):
            if self.slots[b] is not None or not self.pending:
                continue
            req = self.reqs[self.pending[0]]
            need = self._need_pages(req)
            bootstrap = not self.started
            if not bootstrap and self.free < need:
                break                     # pick() returned None: defer
            self.pending.pop(0)
            self.free -= need
            self.started = True
            chunked = bool(c.prefill_chunk) and \
                req.prompt_len > c.prefill_chunk
            if chunked:
                self.slots[b] = {"id": req.req_id, "out": 0, "rem": 0,
                                 "done": True,
                                 "left": req.prompt_len - c.prefill_chunk,
                                 "pages": need}
                self.state_of[req.req_id] = PREFILLING
            else:
                self.slots[b] = {"id": req.req_id, "out": 1,
                                 "rem": max(req.n_tokens - 1, 0),
                                 "done": False, "left": None,
                                 "pages": need}
                self.state_of[req.req_id] = DECODING
            self.boundary_events.append("admit")
        occupied = [b for b in range(c.batch) if self.slots[b] is not None]
        if not occupied:
            self._check_boundary_order()
            self._check_conservation()
            return flushed
        # ---- one chunk over the bank ------------------------------------
        live = [b for b in occupied
                if not self.slots[b]["done"] and self.slots[b]["rem"] > 0]
        if live:
            K = _pow2_chunk(c.chunk,
                            max(self.slots[b]["rem"] for b in live))
            for b in live:
                s = self.slots[b]
                m = min(K, s["rem"])
                s["rem"] -= m
                s["out"] += m
                if s["rem"] <= 0:
                    s["done"] = True
        # ---- flush (model: everything new up to the budget) -------------
        for b in occupied:
            s = self.slots[b]
            if s is None or s["left"] is not None:
                continue
            avail = min(s["out"], self.reqs[s["id"]].n_tokens)
            prev = s.get("flushed", 0)
            if avail > prev:
                flushed[s["id"]] = avail - prev
                s["flushed"] = avail
        # ---- evictions ---------------------------------------------------
        for b in occupied:
            s = self.slots[b]
            if s is None or s["left"] is not None:
                continue
            budget = self.reqs[s["id"]].n_tokens
            if not (s["done"] or s["rem"] <= 0 or s["out"] >= budget):
                continue
            self._finalize(s["id"], min(s["out"], budget), DONE)
            self._release(s, "evict_release")
            self.slots[b] = None
        self._check_boundary_order()
        self._check_conservation()
        return flushed

    def fail_all(self) -> None:
        """Replica-crash cleanup: everything in flight or queued fails."""
        self.failed = True
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            kept = min(s["out"], self.reqs[s["id"]].n_tokens)
            self._finalize(s["id"], kept, FAILED)
            self._release(s, "fail_release")
            self.slots[b] = None
        for req_id in self.pending:
            self._finalize(req_id, 0, FAILED)
        self.pending = []
        self.aborts = {}
        self._check_conservation()

    # ---- quiescence ------------------------------------------------------
    def all_terminal(self) -> bool:
        return (bool(self.submitted)
                and not self.pending and not self.state_of
                and all(s is None for s in self.slots))

    def terminal_problems(self) -> List[str]:
        """I2 completeness + drained pool, checked at quiescent states."""
        out = []
        for req_id in sorted(self.submitted):
            got = self.results.get(req_id)
            if got is None:
                out.append(f"I2: request {req_id} submitted but never "
                           f"finalized")
            elif got[0] not in TERMINAL_STATES:
                out.append(f"I2: request {req_id} ended in non-terminal "
                           f"state {got[0]!r}")
        if self.free != self.cfg.n_pages:
            out.append(f"I1: pool not drained at quiescence — "
                       f"free={self.free} of {self.cfg.n_pages}")
        return out


# --------------------------------------------------------------------------
# exhaustive interleaving explorer
# --------------------------------------------------------------------------
Action = Tuple  # ("submit", id) | ("abort", id) | ("boundary",) | ("crash",)


@dataclasses.dataclass
class ExploreResult:
    states: int
    transitions: int
    violations: List[Tuple[Tuple[Action, ...], str]]
    complete: bool

    @property
    def ok(self) -> bool:
        return self.complete and not self.violations


def _enabled(m: SchedModel, all_ids: Sequence[int]) -> List[Action]:
    acts: List[Action] = [("boundary",)]
    if not m.failed:
        for rid in all_ids:
            if rid not in m.submitted:
                acts.append(("submit", rid))
        for rid in sorted(m.state_of):
            if rid not in m.aborts:
                acts.append(("abort", rid))
        acts.append(("crash",))
    return acts


def _apply(m: SchedModel, act: Action) -> None:
    if act[0] == "submit":
        m.submit(act[1])
    elif act[0] == "abort":
        m.abort(act[1])
    elif act[0] == "boundary":
        m.boundary()
    elif act[0] == "crash":
        m.fail_all()
    else:  # pragma: no cover - explorer bug
        raise ValueError(f"unknown action {act!r}")


def explore(reqs: Sequence[ModelRequest], cfg: ModelConfig,
            max_seconds: Optional[float] = None,
            max_states: int = 2_000_000) -> ExploreResult:
    """DFS over every interleaving of the stepping API (crash injected at
    every reachable state), deduplicated on canonical model state."""
    all_ids = sorted(r.req_id for r in reqs)
    root = SchedModel(cfg, reqs)
    snap0 = root.snapshot()
    visited: set = {snap0}
    stack: List[Tuple[tuple, Tuple[Action, ...]]] = [(snap0, ())]
    violations: List[Tuple[Tuple[Action, ...], str]] = []
    transitions = 0
    complete = True
    deadline = (time.perf_counter() + max_seconds
                if max_seconds is not None else None)
    while stack:
        if deadline is not None and time.perf_counter() > deadline:
            complete = False
            break
        if len(visited) > max_states:
            complete = False
            break
        snap, path = stack.pop()
        m0 = SchedModel.from_snapshot(cfg, reqs, snap)
        for act in _enabled(m0, all_ids):
            m = SchedModel.from_snapshot(cfg, reqs, snap)
            transitions += 1
            try:
                _apply(m, act)
            except ModelViolation as e:
                violations.append((path + (act,), str(e)))
                continue
            if m.all_terminal():
                for msg in m.terminal_problems():
                    violations.append((path + (act,), msg))
            nxt = m.snapshot()
            if nxt not in visited:
                visited.add(nxt)
                stack.append((nxt, path + (act,)))
    return ExploreResult(states=len(visited), transitions=transitions,
                         violations=violations, complete=complete)


# --------------------------------------------------------------------------
# the documented default bound: 3 requests, pool pressure, chunked prefill
# --------------------------------------------------------------------------
DEFAULT_CONFIG = ModelConfig(batch=2, chunk=2, prefill_chunk=2,
                             page_size=4, n_pages=5, max_len=64,
                             overshoot=1)
DEFAULT_REQUESTS = (
    ModelRequest(req_id=1, prompt_len=3, n_tokens=2),   # whole-prompt
    ModelRequest(req_id=2, prompt_len=5, n_tokens=3),   # chunked prefill
    ModelRequest(req_id=3, prompt_len=2, n_tokens=2),   # fits beside #1
)


def render_trace(path: Sequence[Action]) -> str:
    return " -> ".join(
        act[0] if len(act) == 1 else f"{act[0]}({act[1]})" for act in path)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.modelcheck",
        description="Exhaustively model-check the scheduler boundary "
                    "protocol (pages, terminals, ordering, crash safety).")
    ap.add_argument("--max-seconds", type=float, default=120.0,
                    help="wall-clock cap; an unfinished exploration FAILS")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = explore(DEFAULT_REQUESTS, DEFAULT_CONFIG,
                  max_seconds=args.max_seconds)
    dt = time.perf_counter() - t0
    print(f"modelcheck: {res.states} states, {res.transitions} transitions "
          f"in {dt:.2f}s ({len(DEFAULT_REQUESTS)} requests, batch="
          f"{DEFAULT_CONFIG.batch}, pool={DEFAULT_CONFIG.n_pages} pages, "
          f"crash at every reachable state)")
    if not res.complete:
        print("modelcheck: FAIL — exploration did not finish inside the "
              "wall-clock cap; the bound was NOT verified")
        return 1
    if res.violations:
        for path, msg in res.violations[:20]:
            print(f"modelcheck: VIOLATION {msg}")
            print(f"  trace: {render_trace(path)}")
        more = len(res.violations) - 20
        if more > 0:
            print(f"modelcheck: ... and {more} more")
        return 1
    print("modelcheck: OK — all invariants hold over the full bound")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
