"""Continuous-batching scheduler: iteration-level admission/eviction on top
of the chunked engines (Orca-style scheduling, vLLM-style slot reuse).
Counterpart of ``repro/runtime/scheduler.py``, driving the port's engines.

The module is named ``continuous.py``, not ``scheduler.py``: the repo's
lint explores the scheduler protocol only when exactly one file ending in
``scheduler.py`` holds a ``ContinuousScheduler``, and a second one would
switch the reference's check off.

Engine output reaches this module as host values only: ``sched_step``
returns numpy ``done``/``rem``/tokens/counts (the engine's one transfer per
boundary), and the first tokens that ``sched_admit``/``sched_extend`` leave
on the device as unsynced scalars are brought to the host together, once
per boundary (``_host_firsts``), before any of them is read.

The engines decode a fixed bank of B rows device-resident, K steps per host
sync.  This module turns those rows into *slots* a request stream flows
through:

  queue --admit--> slot b --chunks--> done --evict--> slot b free --admit-->

Slot lifecycle
--------------
* **admit** (chunk boundary, row free, request arrived): the prompt is
  prefilled at B=1 and the row is spliced into the resident state with the
  engine's ``sched_insert`` (``cache.insert_rows``: per-row KV write,
  ``pos[b]`` and ``key_pos[b]`` taken from the fresh prefill, done-mask
  cleared).  The K-step chunk driver never changes: admission is pure
  data movement, so it is reused across the whole request stream.
* **decode**: every chunk runs the full bank; free/finished rows ride along
  masked by the chunk's done-mask (no emission, no commit).  Chunk length
  is clamped to the largest remaining budget (power-of-two schedule).
* **evict** (chunk boundary, row done): EOS, per-request token budget, or
  KV-capacity freeze ends a sequence; its outputs are finalized and the row
  is freed.  If a queued request takes the slot at the same boundary the
  admission insert overwrites the whole row (it copies every slot of the
  fresh B=1 prefill, ``key_pos`` included); rows that stay empty are
  cleared in one batched ``sched_reset`` (``cache.reset_rows``:
  ``key_pos`` -> -1, ``pos`` -> 0, state zeroed).  With the speculative
  engine the reset is durable — masked rows commit nothing, so no stale
  KV/state outlives its request.  ``BatchEngine``'s chunk body decodes
  every row unconditionally, so a freed row re-accumulates masked scratch
  (derived from the dead request's last token) until the next admission
  overwrites it; its emission stays masked throughout.

Capacity semantics: a request whose prompt+budget exceed the engine's
``max_len`` is not rejected — the chunk driver freezes it at the capacity
boundary (see runtime/engine.py) and it returns fewer tokens, reported via
``RequestResult.n_emitted``.

Paged engines add a reservation step: admission asks ``sched_can_admit``
whether the page pool can fund ``ceil((prompt + budget + overshoot) /
page_size)`` pages and DEFERS the request while it cannot; eviction
returns the row's pages via ``sched_release`` before the device-side
reset, so a freed reservation funds the same boundary's admissions.  Pool
exhaustion therefore shows up as queueing delay, never as a failed or
corrupted request.

Admission policies
------------------
*Which* queued request a freed row takes is a pluggable
``AdmissionPolicy`` (``policy=`` — ``"fifo"`` default, ``"sjf"``,
``"lpt"``, or any object with the ``pick`` protocol):

* **fifo** — strict arrival order; a request the pool cannot fund blocks
  everything behind it (head-of-line).  Bit-compatible with the pre-policy
  scheduler: same requests, same engine calls, same outputs.
* **sjf** — shortest job first by ``engine.sched_footprint`` (reserved
  pages when paged, else slots): among ARRIVED requests, the smallest one
  the pool can fund is admitted, skipping past a deferred head-of-line
  request.  Cuts queueing delay for the short-budget bulk of a mixed
  trace.  CAVEAT: SJF is starvation-prone — a stream of small requests
  can postpone a large one indefinitely; it never *loses* the large
  request (every policy admits it once the bank drains, because an empty
  bank always funds the pool's worth), but its latency is unbounded under
  sustained load.  FIFO remains the fairness-preserving default.
* **lpt** — longest footprint first (reverse of SJF): packs big
  reservations early; same skip-past-deferred rule, same starvation
  caveat with the roles reversed.

``age_limit=N`` (0 = off) bounds SJF/LPT starvation: every boundary an
ARRIVED request is PASSED OVER — another request admitted past it, or a
free row left empty because its own reservation could not be funded —
increments its ``age`` (waiting behind a full bank ages nobody, so
ordinary saturation never triggers the bound); once ``age >= age_limit``
the oldest such request is promoted to FIFO-HEAD priority — the
size-ordered ranking is suspended and, exactly like FIFO, nothing may be
admitted past the starved request while its reservation cannot be funded
(skipping past it is what made the starvation unbounded).  A deferred
request is therefore passed over at most ``age_limit`` times before it
gets FIFO's own worst case.  FIFO ignores ``age_limit`` (strict arrival
order cannot starve).

Per-request OUTPUT is policy-independent: a policy only reorders
admission; decode math is untouched (the fuzz suite pins per-request
parity with solo B=1 runs across policies).

Chunked prefill
---------------
``prefill_chunk=N`` (0 = off) admits a long prompt PIECEWISE instead of
in one prompt-sized prefill dispatch (Sarathi/vLLM-style chunked prefill):

* admission inserts only the first N prompt tokens (the normal fused
  ``sched_admit``, reservation sized to the WHOLE prompt via
  ``reserve_len``), and the row joins the bank done-masked;
* each following chunk boundary runs ``engine.sched_extend`` once per
  prefilling row: the next N-token piece is pushed through the causal
  verify path against the row's resident cache and spliced in at the
  row's offset (``cache.write_row_at``) — paged pieces are paginated
  incrementally, so the paged path's dense prefill transient is bounded
  by the piece size, never the prompt;
* the LAST piece's final logits produce the request's first token and the
  row goes live (``done`` cleared, budget armed) — from then on the slot
  is indistinguishable from a whole-prompt admission.

The resident bank keeps decoding between pieces, so one long prompt no
longer stalls every resident sequence for a prompt-sized dispatch.  Only
attention-family engines support it (``engine.sched_chunked_ok``);
recurrent families and prompts <= N fall back to whole-prompt admission.

Adaptive speculation
--------------------
``adaptive=`` arms runtime strategy selection over a ``DecodeEngine``
bank (measured ARCA, paper §III-C run *online* instead of once at
startup — the Dovetail observation that the best width moves with the
workload).  Pass the ``{width: arca.Strategy}`` table that
``arca.choose_strategy`` returns — ideally with the MEASURED ``time_fn``
from ``arca.profile_engine`` — or a pre-built ``AdaptiveSpeculation``.
The scheduler then:

* tracks a windowed EMA of the acceptance length actually observed on the
  bank (per-step accepted counts from the chunk raw, free rows excluded);
* at an eviction/admission boundary, rescales every candidate width's
  ESTIMATED acceptance by the observed/estimated ratio of the active
  width (width 1 stays exactly 1) and switches the bank's strategy when
  the ``AL / step_time`` argmax moves (``engine.set_strategy``);
* logs every switch as a ``("switch", from_width, to_width)`` event and
  in ``stats["strategy_switches"]``.

Switching is output-neutral: greedy tree verification commits exactly the
greedy chain whatever the tree, so a mid-request width change alters speed,
never tokens (the strategy-parity tests pin this).  Candidate strategies
are registered with the engine up front (``register_strategies``), which
builds each once and ratchets the paged reservation overshoot to the
deepest candidate tree.

Request lifecycle
-----------------
Every request moves through a typed state machine::

    QUEUED -> PREFILLING -> DECODING -> { DONE, CANCELLED, TIMED_OUT,
                                          FAILED, REJECTED }

``serve()`` only ever produces DONE, but the scheduler also runs as a
*stepping* core for the async front end (``runtime/server.py``):
``start()`` / ``submit()`` / ``abort()`` / ``boundary()`` / ``finish()``
expose one admit/chunk/evict iteration at a time, and ``serve()`` is a
thin loop over them (the fuzz suite pins bit-identical outputs).  A
client cancellation (``abort(req_id)``) or an expired per-request
``deadline`` takes effect at the NEXT chunk boundary: the request's
partial tokens are finalized with a typed terminal state and — the core
robustness change — the row's reserved pages go back to the pool
mid-flight via ``engine.sched_abort`` (releasing a live row is safe
because the allocator is host state and the row is reset, clearing its
block table, before any later chunk can touch the freed pages; an
admission at the SAME boundary may therefore fund itself from the
aborted row's reservation).  ``fail_all()`` is the replica-crash cleanup:
every in-flight and queued request is finalized FAILED and pages are
released, so a crashed replica never leaks pool pages.  Surviving
residents are untouched by an abort — their tokens stay bit-identical to
solo runs (pinned by the abort parity test).

Arrivals are wall-clock: a request is admissible once ``arrival`` seconds
(relative to ``serve()`` entry) have elapsed, which is how ``serve.py
--arrivals poisson`` and ``benchmarks/sched_bench.py`` replay traces.
``serve_static`` is the baseline the bench compares against: requests are
grouped into fixed batches in arrival order, each batch runs to completion
(its rows cannot be refilled) before the next one starts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.runtime.engine import _eos_scalar, _pow2_chunk

# ---- request lifecycle states --------------------------------------------
QUEUED = "QUEUED"            # submitted, waiting for a slot
PREFILLING = "PREFILLING"    # resident, prompt still landing piecewise
DECODING = "DECODING"        # resident, emitting tokens
DONE = "DONE"                # ran to natural completion (EOS/budget/freeze)
CANCELLED = "CANCELLED"      # client abort took effect at a boundary
TIMED_OUT = "TIMED_OUT"      # per-request deadline expired at a boundary
FAILED = "FAILED"            # replica/engine fault while in flight
REJECTED = "REJECTED"        # shed by backpressure before ever running
TERMINAL_STATES = frozenset({DONE, CANCELLED, TIMED_OUT, FAILED, REJECTED})


@dataclasses.dataclass
class Request:
    """One generation request in the replayed stream."""
    req_id: int
    tokens: np.ndarray           # (S,) int32 prompt
    n_tokens: int                # generation budget (includes first token)
    arrival: float = 0.0         # seconds after serve() start
    deadline: Optional[float] = None  # absolute (serve-clock) deadline; the
                                 # request TIMES OUT at the first boundary
                                 # past it, queued or resident
    age: int = 0                 # boundaries this request was passed over
                                 # (scheduler-managed; fuels age_limit)


@dataclasses.dataclass
class RequestResult:
    req_id: int
    tokens: np.ndarray           # real emitted tokens (length n_emitted)
    n_emitted: int
    arrival: float
    t_admit: float               # when the request got a slot
    t_finish: float              # when its outputs were finalized
    state: str = DONE            # terminal lifecycle state (TERMINAL_STATES)

    @property
    def latency(self) -> float:
        return self.t_finish - self.arrival

    @property
    def queue_wait(self) -> float:
        return self.t_admit - self.arrival


def _host_firsts(slots) -> None:
    """Bring every first token still on the device (an unsynced scalar
    from ``sched_admit``/``sched_extend``, always ``out[0]``) to the host,
    all of them in one transfer."""
    held = [s for s in slots if s is not None and s["out"]
            and isinstance(s["out"][0], torch.Tensor)]
    if held:
        vals = torch.stack([s["out"][0] for s in held]).cpu().tolist()
        for s, v in zip(held, vals):
            s["out"][0] = int(v)


def _aggregate(results: Sequence[RequestResult], makespan: float) -> dict:
    lats = np.asarray([r.latency for r in results])
    waits = np.asarray([r.queue_wait for r in results])
    total = int(sum(r.n_emitted for r in results))
    # goodput counts only requests that ran to natural completion: a
    # cancelled/timed-out/failed request's partial tokens were wasted work
    good = int(sum(r.n_emitted for r in results if r.state == DONE))
    states: Dict[str, int] = {}
    for r in results:
        states[r.state] = states.get(r.state, 0) + 1

    def pct(a, q):
        return float(np.percentile(a, q)) if a.size else 0.0

    # mean alone hides the tail the admission policies target: p50/p95 are
    # first-class alongside it (p90 kept for older consumers)
    return {
        "requests": len(results),
        "makespan_s": makespan,
        "emitted_total": total,
        "tok_s": total / makespan if makespan > 0 else float("inf"),
        "goodput_tok_s": good / makespan if makespan > 0 else float("inf"),
        "states": states,
        "latency_mean_s": float(lats.mean()) if lats.size else 0.0,
        "latency_p50_s": pct(lats, 50),
        "latency_p90_s": pct(lats, 90),
        "latency_p95_s": pct(lats, 95),
        "latency_max_s": float(lats.max()) if lats.size else 0.0,
        "queue_wait_mean_s": float(waits.mean()) if waits.size else 0.0,
        "queue_wait_p50_s": pct(waits, 50),
        "queue_wait_p95_s": pct(waits, 95),
    }


# --------------------------------------------------------------------------
# Admission policies: which queued request a freed row takes.
#
# ``pick`` sees the pending list in FIFO order (sorted by (arrival,
# req_id)) and returns an index into it, or None to leave the remaining
# free rows empty this boundary.  ``can_admit(req)`` is the engine's page-
# reservation gate (always admissible when the engine is dense);
# ``footprint(req)`` is ``engine.sched_footprint`` — reserved pages when
# paged, else slots.  ``bootstrap`` is True for the very first admission
# of a serve(): the bank (and paged allocator) are rebuilt from scratch,
# so the reservation gate must not apply (a depleted allocator left by an
# aborted run cannot wedge a fresh serve, and a request larger than the
# whole pool is admitted alone and freezes with a shortfall rather than
# being lost).
# --------------------------------------------------------------------------
class AdmissionPolicy:
    """Protocol + FIFO base: strict arrival order, defer-blocks-the-line.

    ``age_limit`` (0 = off) is the starvation bound the size-ordered
    policies honour; FIFO cannot starve and ignores it."""

    name = "fifo"

    def __init__(self, age_limit: int = 0):
        if age_limit < 0:
            raise ValueError("age_limit must be >= 0")
        self.age_limit = age_limit

    def pick(self, pending: Sequence["Request"], now: float,
             can_admit: Callable, footprint: Callable,
             bootstrap: bool) -> Optional[int]:
        if pending[0].arrival > now:
            return None
        if not bootstrap and not can_admit(pending[0]):
            # pool exhausted: DEFER head-of-line until evictions free pages
            return None
        return 0


class _SizeOrderedPolicy(AdmissionPolicy):
    """Shared SJF/LPT machinery: rank ARRIVED requests by footprint and
    admit the best-ranked one the pool can fund — i.e. admission may skip
    past a deferred head-of-line request whenever a differently-sized one
    fits.  Ties break FIFO (arrival, req_id).

    Aging: a request whose ``age`` (boundaries it was passed over,
    scheduler-maintained) reaches ``age_limit`` is promoted to FIFO-head
    priority — the ranking is suspended and, like FIFO, NOTHING may be
    admitted past the starved request while it cannot be funded; skipping
    past it is exactly what made the starvation unbounded."""

    reverse = False

    def pick(self, pending, now, can_admit, footprint, bootstrap):
        if self.age_limit:
            aged = [i for i, r in enumerate(pending)
                    if r.arrival <= now and r.age >= self.age_limit]
            if aged:                  # oldest starved request, FIFO order
                i = aged[0]
                return i if (bootstrap or can_admit(pending[i])) else None
        sign = -1 if self.reverse else 1
        ranked = sorted(
            (sign * footprint(r), r.arrival, r.req_id, i)
            for i, r in enumerate(pending) if r.arrival <= now)
        for *_, i in ranked:
            if bootstrap or can_admit(pending[i]):
                return i
        return None


class SJFPolicy(_SizeOrderedPolicy):
    """Shortest reserved footprint first.  Starvation-prone under
    sustained small-request load (see module docstring) unless
    ``age_limit`` bounds the deferral."""
    name = "sjf"


class LPTPolicy(_SizeOrderedPolicy):
    """Longest footprint first (packs big reservations early)."""
    name = "lpt"
    reverse = True


POLICIES = {"fifo": AdmissionPolicy, "sjf": SJFPolicy, "lpt": LPTPolicy}


def get_policy(policy, age_limit: int = 0) -> AdmissionPolicy:
    """Resolve a policy name (constructed with ``age_limit``) or pass
    through an AdmissionPolicy instance (which keeps its own)."""
    if isinstance(policy, str):
        try:
            return POLICIES[policy](age_limit=age_limit)
        except KeyError:
            raise ValueError(f"unknown admission policy {policy!r} "
                             f"(have: {sorted(POLICIES)})") from None
    return policy


# --------------------------------------------------------------------------
# Adaptive speculation: measured-ARCA width selection at runtime.
# --------------------------------------------------------------------------
class AdaptiveSpeculation:
    """Runtime decode-strategy selection for a ``DecodeEngine`` bank.

    Wraps the ``{width: arca.Strategy}`` table ``choose_strategy`` returns
    — each entry carries the candidate tree, its ESTIMATED acceptance
    length (calibration accuracies) and a step time, ideally MEASURED via
    ``arca.profile_engine`` — plus a windowed EMA of the acceptance length
    actually observed on the bank.

    The observed signal only exists for the width that actually RAN, so
    candidate ALs are compared by rescaling every width's estimate with an
    observed/estimated ratio, anchored so width 1 stays exactly AL=1
    (``al_hat(w) = 1 + (est(w) - 1) * ratio(w)``).  Ratios are tracked PER
    WIDTH: a width the bank has observed uses its own measured ratio
    (``ratios[w]``); a never-observed width falls back to the active
    width's ratio (the legacy single-ratio rescaling).  Ratios are only
    updated while a width > 1 is active — width 1 observes AL == 1 by
    construction and carries no draft-quality information, so while it is
    active every ratio instead RELAXES toward the calibration prior at
    rate ``probe`` per boundary: width 1 is never absorbing, the bank
    periodically re-probes the best drafted width and drops back if the
    observation still disagrees.

    ``probe_every=K`` (0 = off) additionally schedules ONLINE acceptance
    probes on non-active widths: every K-th boundary the controller
    switches the bank to the next non-active drafted width (round-robin)
    for ``probe_boundaries`` boundaries, so that width's ratio is
    re-measured instead of forever being extrapolated from the active
    width's — a width whose real acceptance diverges from the active
    width's ratio is caught.  Probing is output-neutral like any strategy
    switch (greedy verification commits the greedy chain whatever the
    tree); when the probe window closes the argmax re-decides from the
    freshly de-biased per-width ratios.

    ``pick`` (called by the scheduler at an eviction/admission boundary)
    returns the new width when the ``al_hat / step_time`` argmax moved
    (or a scheduled probe fires), else None.  ``switch_every`` throttles
    how often a switch may happen; ``min_steps`` delays the first
    observation-driven switch until the EMA has seen that many accepted
    steps.  A switch resets the observation window (the EMA is read
    against the ACTIVE width's estimate, so stale cross-width samples
    would corrupt the ratio and flap the argmax); the normalized ratios
    themselves persist across switches.
    """

    def __init__(self, strategies, *, ema: float = 0.3,
                 switch_every: int = 2, min_steps: int = 8,
                 probe: float = 0.05, probe_every: int = 0,
                 probe_boundaries: int = 2):
        if not strategies:
            raise ValueError("adaptive mode needs candidate strategies")
        self.strategies = {int(w): s for w, s in strategies.items()}
        self.ema, self.switch_every = ema, switch_every
        self.min_steps = min_steps
        self.probe = probe
        if probe_every < 0 or probe_boundaries < 1:
            raise ValueError("probe_every must be >= 0 and "
                             "probe_boundaries >= 1")
        self.probe_every = probe_every
        self.probe_boundaries = probe_boundaries
        self.reset()

    def reset(self) -> None:
        """Back to the calibration prior: observation EMA, ratios, counters,
        probe state and the switch log all cleared.  ``serve()`` calls this
        on entry so a reused controller never carries one stream's
        observations (or switch events) into the next run's decisions and
        stats."""
        self.al_obs: Optional[float] = None   # EMA of observed AL
        self.ratio = 1.0                      # active-width obs/est, anchored
        self.ratios: Dict[int, float] = {}    # per-width measured ratios
        self.steps_seen = 0
        self.boundaries = 0
        self.switches: List[tuple] = []       # (boundary, from_w, to_w)
        self._probing: Optional[int] = None   # width under a scheduled probe
        self._probe_left = 0
        self._probe_cycle = 0                 # round-robin over probe targets

    def observe(self, ns, width: int) -> None:
        """Feed one chunk's per-step accepted counts (``ns (K, B)``; zeros
        = masked/free rows, dropped).  Width-1 chunks carry no signal."""
        if width <= 1 or width not in self.strategies:
            return
        ns = np.asarray(ns).ravel()
        ns = ns[ns > 0]
        if not ns.size:
            return
        al = float(ns.mean())
        self.al_obs = al if self.al_obs is None else \
            (1.0 - self.ema) * self.al_obs + self.ema * al
        est = self.strategies[width].acceptance
        self.ratio = max(self.al_obs - 1.0, 0.0) / max(est - 1.0, 1e-9)
        self.ratios[width] = self.ratio       # this width now self-reports
        self.steps_seen += int(ns.size)

    def al_hat(self, width: int) -> float:
        """Rescaled acceptance estimate (width 1 is exactly 1); a width the
        bank has observed (directly or via a scheduled probe) uses its own
        measured ratio."""
        r = self.ratios.get(width, self.ratio)
        return 1.0 + (self.strategies[width].acceptance - 1.0) * r

    def _switch_to(self, old: int, new: int) -> None:
        self.switches.append((self.boundaries, old, new))
        # fresh observation window for the new width: the AL EMA is read
        # against the ACTIVE width's estimate, so stale samples from the
        # old width would corrupt the ratio (an inflated ratio right after
        # a downswitch flips the argmax straight back — flapping).  The
        # ratios themselves persist: they are the width-normalized
        # draft-quality signal and stay comparable across switches.
        self.al_obs = None
        self.steps_seen = 0

    def _decide(self, width: int) -> Optional[int]:
        best = max(sorted(self.strategies),
                   key=lambda w: self.al_hat(w)
                   / self.strategies[w].step_time)
        if best == width:
            return None
        self._switch_to(width, best)
        return best

    def pick(self, width: int) -> Optional[int]:
        """New width when the measured AL/step_time argmax moved (or a
        scheduled probe fires), else None.  Call at an eviction/admission
        boundary only."""
        self.boundaries += 1
        if width <= 1:
            # width 1 observes AL == 1 by construction (no signal), so it
            # would be an ABSORBING state once the ratio hits 0.  Relax
            # every ratio toward the calibration prior (1.0) instead:
            # after enough signal-free boundaries the argmax re-probes the
            # best drafted width, and a still-bad observation sends it
            # straight back down — bounded-duty-cycle probing, no pinned
            # serve.
            self.ratio += self.probe * (1.0 - self.ratio)
            for w in self.ratios:
                self.ratios[w] += self.probe * (1.0 - self.ratios[w])
        # ---- scheduled probe in progress: hold, then re-decide -----------
        if self._probing is not None:
            if width != self._probing:        # external interference ends it
                self._probing = None
            else:
                self._probe_left -= 1
                if self._probe_left > 0:
                    return None               # keep measuring the probe width
                self._probing = None
                return self._decide(width)    # fresh per-width ratios
        # ---- start a scheduled probe of a non-active width ---------------
        if self.probe_every and self.boundaries % self.probe_every == 0:
            others = [w for w in sorted(self.strategies)
                      if w > 1 and w != width]
            if others:
                target = others[self._probe_cycle % len(others)]
                self._probe_cycle += 1
                self._probing = target
                self._probe_left = self.probe_boundaries
                self._switch_to(width, target)
                return target
        if width > 1 and self.steps_seen < self.min_steps:
            return None                       # EMA not warmed up yet
        if self.boundaries % self.switch_every:
            return None
        return self._decide(width)


@dataclasses.dataclass
class BoundaryReport:
    """What one ``boundary()`` produced for the streaming front end."""
    emitted: Dict[int, list]        # req_id -> tokens newly available
    finished: List[RequestResult]   # requests finalized this boundary
    idle: bool                      # nothing resident, nothing admitted
    next_arrival: Optional[float]   # earliest queued arrival (idle only)
    boundary: int                   # 1-based boundary index


class ContinuousScheduler:
    """Per-sequence admission/eviction over an engine's B-row slot bank.

    Works with any engine implementing the slot protocol
    (``sched_prefill`` / ``sched_blank`` / ``sched_insert`` /
    ``sched_reset`` / ``sched_step`` / ``sched_emitted`` plus the paged
    reservation hooks ``sched_can_admit`` / ``sched_release`` /
    ``sched_abort`` / ``sched_footprint`` and, for ``prefill_chunk``, the
    piecewise admission hook ``sched_extend`` gated by
    ``sched_chunked_ok`` — the unified ``DecodeEngine`` implements all of
    it once; ``BatchEngine`` / ``SpeculativeEngine`` are its aliases).

    ``policy`` picks which queued request a freed row takes (``"fifo"`` /
    ``"sjf"`` / ``"lpt"`` or an ``AdmissionPolicy``); ``age_limit=N``
    bounds SJF/LPT starvation (a request deferred for more than N
    boundaries is promoted to FIFO-head priority); ``prefill_chunk=N``
    admits prompts longer than N in N-token pieces; ``adaptive=`` arms
    measured-ARCA runtime strategy switching (a ``{width: arca.Strategy}``
    table or an ``AdaptiveSpeculation`` — drafted engines only).  See the
    module docstring for all four.

    Besides the blocking ``serve()`` replay the scheduler runs as a
    STEPPING core for the async front end: ``start()`` arms a stream,
    ``submit()`` / ``abort()`` feed it between boundaries, ``boundary()``
    runs exactly one admit/chunk/evict iteration and reports incremental
    tokens + finalized results, ``finish()`` closes the stream, and
    ``fail_all()`` is the crash path (every in-flight request finalized
    FAILED, pages released).  ``faults=`` accepts a
    ``faults.ReplicaFaults`` injector: its ``on_boundary`` hook runs at
    every boundary entry (stalls sleep, crashes raise out of
    ``boundary()``), and ``block_admission`` simulates admission-time
    pool exhaustion (requests defer exactly like a real exhausted pool —
    queueing delay, never corruption).
    """

    def __init__(self, engine, *, batch: int = 8,
                 chunk: Optional[int] = None, policy="fifo",
                 prefill_chunk: int = 0, age_limit: int = 0,
                 adaptive=None, faults=None):
        self.engine = engine
        self.batch = batch
        self.chunk = chunk or engine.chunk
        self.policy = get_policy(policy, age_limit)
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        # chunked prefill: 0 = whole-prompt admission; N = admit long
        # prompts in N-token pieces (attention-family engines only — other
        # families silently use whole-prompt admission)
        self.prefill_chunk = prefill_chunk if getattr(
            engine, "sched_chunked_ok", False) else 0
        self.adaptive: Optional[AdaptiveSpeculation] = None
        self._strategy_table = {}
        if adaptive is not None:
            if getattr(engine, "strategy", None) is None or \
                    engine.strategy.draft != "medusa":
                raise ValueError("adaptive speculation needs a drafted "
                                 "DecodeEngine (strategy.draft == 'medusa')")
            self.adaptive = adaptive if isinstance(
                adaptive, AdaptiveSpeculation) else \
                AdaptiveSpeculation(adaptive)
            # build each candidate DecodeStrategy once (switches reuse the
            # pytrees) and ratchet the paged reservation overshoot to the
            # deepest candidate tree
            self._strategy_table = engine.register_strategies(
                {w: s.tree for w, s in self.adaptive.strategies.items()})
        self.faults = faults
        # introspection for tests / debugging, populated by serve()
        self.last_state = None
        self.events: List[tuple] = []
        # streaming-core state (armed by start(); empty defaults so load /
        # has_work are safe to read before a stream begins)
        self._pending: List[Request] = []
        self._slots: list = []
        self._results: Dict[int, RequestResult] = {}
        self._state_of: Dict[int, str] = {}   # ACTIVE requests only
        self._aborts: Dict[int, str] = {}
        self._dirty: set = set()
        self._dev = None
        self._t0 = time.perf_counter()
        self._boundary_i = 0
        self._n_chunks = 0
        self._n_steps = 0
        self._n_pieces = 0
        self._max_resident = 0
        self._eos = None
        self._eos_val = int(_eos_scalar(None))

    # ------------------------------------------------------------------
    # stepping API: start / submit / abort / boundary / finish
    # ------------------------------------------------------------------
    def now(self) -> float:
        """Seconds since ``start()`` — the stream's arrival/deadline clock."""
        return time.perf_counter() - self._t0

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or any(
            s is not None for s in self._slots)

    @property
    def load(self) -> int:
        """Queued + resident requests (the router's balance signal)."""
        return len(self._pending) + sum(
            s is not None for s in self._slots)

    def request_state(self, req_id: int) -> Optional[str]:
        """Lifecycle state of a known request (terminal states from the
        result log), or None for an unknown id."""
        if req_id in self._results:
            return self._results[req_id].state
        return self._state_of.get(req_id)

    def start(self, requests: Sequence[Request] = (), *,
              eos: Optional[int] = None) -> None:
        """Arm a stream: reset all per-serve state and start the clock.
        ``requests`` seeds the queue; ``submit()`` adds more later."""
        B = self.batch
        self._eos = eos
        self._eos_val = int(_eos_scalar(eos))
        # pending stays in FIFO order; policies index into it
        self._pending = sorted(requests, key=lambda r: (r.arrival, r.req_id))
        for r in self._pending:
            r.age = 0                 # aging state is per-stream
        if self.adaptive is not None:
            self.adaptive.reset()     # so is the observation window
        self._slots = [None] * B          # per-row {req, out, t, pending,
        self._done_np = np.ones((B,), bool)  # flushed}; free rows masked
        self._rem_np = np.zeros((B,), np.int32)
        self._dev = None
        self._results = {}
        self._state_of = {r.req_id: QUEUED for r in self._pending}
        self._aborts = {}
        self.events = []
        self._max_resident = 0
        self._n_chunks = 0
        self._n_steps = 0                 # decode steps run on the device
        self._n_pieces = 0                # chunked-prefill pieces run
        self._boundary_i = 0
        self._dirty = set()               # evicted rows not yet reset
        self._t0 = time.perf_counter()

    def submit(self, request: Request) -> None:
        """Queue a request mid-stream (between boundaries).  The server
        thread owns the scheduler: calls must come from that thread."""
        if request.req_id in self._state_of:
            raise ValueError(f"req_id {request.req_id} is already active")
        request.age = 0
        self._state_of[request.req_id] = QUEUED
        self._pending.append(request)
        self._pending.sort(key=lambda r: (r.arrival, r.req_id))

    def abort(self, req_id: int, state: str = CANCELLED) -> None:
        """Request cancellation: takes effect at the NEXT boundary, where
        the request (queued or resident) is finalized with ``state`` and a
        resident row's reserved pages return to the pool mid-flight.
        Unknown or already-terminal ids are a no-op."""
        if state not in TERMINAL_STATES:
            raise ValueError(f"not a terminal state: {state!r}")
        if req_id not in self._results:
            self._aborts.setdefault(req_id, state)

    def _finalize(self, req: Request, tokens, t_admit: float,
                  state: str) -> RequestResult:
        toks = np.asarray(tokens, np.int32) if len(tokens) else \
            np.zeros((0,), np.int32)
        res = RequestResult(
            req_id=req.req_id, tokens=toks, n_emitted=len(toks),
            arrival=req.arrival, t_admit=t_admit, t_finish=self.now(),
            state=state)
        self._results[req.req_id] = res
        self._state_of.pop(req.req_id, None)
        return res

    def _abort_row(self, b: int, state: str, emitted: dict,
                   finished: list) -> None:
        """Release a LIVE row mid-flight: partial tokens finalized with a
        typed state, pages back to the pool NOW (the dirty reset clears
        the row's block table before any later chunk, so a same-boundary
        admission may safely reuse the freed pages)."""
        s = self._slots[b]
        req = s["req"]
        _host_firsts([s])
        kept = s["out"][:req.n_tokens]
        tail = kept[s["flushed"]:]
        if tail:
            emitted[req.req_id] = [int(t) for t in tail]
        finished.append(self._finalize(req, kept, s["t"], state))
        eng = self.engine
        getattr(eng, "sched_abort", eng.sched_release)(b)
        self._dirty.add(b)
        self._slots[b] = None
        self._done_np[b] = True
        self._rem_np[b] = 0
        self.events.append(("abort", req.req_id, b))

    def _apply_aborts(self, t_now: float, emitted: dict,
                      finished: list) -> None:
        """Boundary-start lifecycle sweep: expired deadlines join the
        pending cancellations, then every abort lands — queued requests
        finalize with zero tokens, resident rows release mid-flight."""
        for s in self._slots:
            if s is not None and s["req"].deadline is not None \
                    and t_now > s["req"].deadline:
                self._aborts.setdefault(s["req"].req_id, TIMED_OUT)
        for r in self._pending:
            if r.deadline is not None and t_now > r.deadline:
                self._aborts.setdefault(r.req_id, TIMED_OUT)
        if not self._aborts:
            return
        aborts, self._aborts = self._aborts, {}
        rows = {s["req"].req_id: b for b, s in enumerate(self._slots)
                if s is not None}
        for req_id, state in aborts.items():
            if req_id in self._results:
                continue                  # already terminal: no-op
            if req_id in rows:
                self._abort_row(rows[req_id], state, emitted, finished)
                continue
            i = next((j for j, r in enumerate(self._pending)
                      if r.req_id == req_id), None)
            if i is None:
                continue                  # unknown id: no-op
            req = self._pending.pop(i)
            finished.append(self._finalize(req, [], self.now(), state))
            self.events.append(("abort", req_id, -1))

    def boundary(self) -> BoundaryReport:
        """Run ONE admit/chunk/evict iteration and report what it emitted.
        Never sleeps: an idle report carries the earliest queued arrival
        so the caller decides whether to wait (``serve()``) or keep the
        event loop spinning (the async server)."""
        eng, B, C = self.engine, self.batch, self.prefill_chunk
        eos, eos_val = self._eos, self._eos_val
        slots, done_np, rem_np = self._slots, self._done_np, self._rem_np
        emitted: Dict[int, list] = {}
        finished: List[RequestResult] = []
        self._boundary_i += 1
        if self.faults is not None:
            # stalls sleep here; an injected crash raises out of boundary()
            self.faults.on_boundary(self._boundary_i)
        # ---- cancels / expired deadlines take effect at the boundary ----
        self._apply_aborts(self.now(), emitted, finished)

        def can_admit(r):
            return eng.sched_can_admit(len(r.tokens), r.n_tokens)

        def footprint(r):
            return eng.sched_footprint(len(r.tokens), r.n_tokens)

        # ---- advance chunked prefills: one piece per row/boundary ----
        for b in range(B):
            s = slots[b]
            if s is None or s.get("pending") is None:
                continue
            rest = s["pending"]
            piece = rest[:C]
            padded = np.zeros((1, C), np.int32)
            padded[0, :len(piece)] = piece
            self._dev, last = eng.sched_extend(self._dev, b, padded,
                                               len(piece))
            self._n_pieces += 1
            self.events.append(("extend", s["req"].req_id, b))
            if len(rest) > C:
                s["pending"] = rest[C:]
            else:                     # last piece: the row goes LIVE
                s["pending"] = None
                s["out"] = [last]     # unsynced device scalar, like
                done_np[b] = (eos is not None  # an admission's `first`
                              and int(last) == eos_val)
                rem_np[b] = max(s["req"].n_tokens - 1, 0)
                self._state_of[s["req"].req_id] = DECODING
                self.events.append(("prefill_done", s["req"].req_id, b))

        # ---- admit arrived requests into free rows (policy order) ----
        # ONE arrival cutoff for the whole boundary: pick and the
        # aging filter below must agree on who was visible, or a
        # request arriving mid-dispatch would be aged (and promoted)
        # without ever having been passed over
        t_bound = self.now()
        admitted_n, free_rows = 0, False
        # injected admission-time pool exhaustion: defer everything this
        # boundary, exactly like a real exhausted pool would
        blocked = (self.faults is not None and bool(self._pending)
                   and self.faults.block_admission())
        if blocked:
            free_rows = any(s is None for s in slots)
        for b in range(B):
            if blocked or slots[b] is not None or not self._pending:
                continue
            idx = self.policy.pick(self._pending, t_bound, can_admit,
                                   footprint, self._dev is None)
            if idx is None:           # nothing arrived / nothing the
                free_rows = True      # pool can fund: leave rows empty
                break
            req = self._pending.pop(idx)
            # reprolint: disable=R3 (req.tokens is a host list, no sync)
            prompt_np = np.asarray(req.tokens, np.int32)
            S = len(prompt_np)
            chunked = bool(C) and S > C
            prompt = (prompt_np[:C] if chunked else prompt_np)[None]
            if self._dev is None:     # bootstrap the bank once
                row = eng.sched_prefill({"tokens": prompt})
                self._dev = eng.sched_blank(row, B)
                self._dev = eng.sched_insert(self._dev, b, row,
                                             prompt_len=S,
                                             n_tokens=req.n_tokens)
                first = eng.sched_first(row)
            else:                     # ONE fused prefill+insert dispatch
                self._dev, first = eng.sched_admit(self._dev, b,
                                                   {"tokens": prompt},
                                                   n_tokens=req.n_tokens,
                                                   reserve_len=S)
            self._dirty.discard(b)    # insert overwrote the whole row
            if chunked:               # rest of the prompt lands piece-
                slots[b] = {"req": req, "out": [], "t": self.now(),
                            "pending": prompt_np[C:], "flushed": 0}
                done_np[b] = True     # masked until the last piece
                rem_np[b] = 0
                self._state_of[req.req_id] = PREFILLING
            else:
                # `first` may be an unsynced device scalar — only force
                # it when EOS filtering needs the value now
                slots[b] = {"req": req, "out": [first], "t": self.now(),
                            "pending": None, "flushed": 0}
                done_np[b] = eos is not None and int(first) == eos_val
                rem_np[b] = max(req.n_tokens - 1, 0)
                self._state_of[req.req_id] = DECODING
            admitted_n += 1
            self.events.append(("admit", req.req_id, b))
        # aging counts boundaries a request was PASSED OVER: another
        # request was admitted past it, or a free row stayed empty
        # because its own reservation could not be funded.  Waiting
        # behind a FULL bank ages nobody — otherwise ordinary
        # saturation would push every request past age_limit and
        # permanently degrade SJF/LPT to FIFO.
        if admitted_n or free_rows:
            for r in self._pending:
                if r.arrival <= t_bound:
                    r.age += 1
        if self._dirty and self._dev is not None:
            # rows left empty: one batched reset (clears aborted rows'
            # block tables BEFORE the next chunk can touch freed pages)
            self._dev = eng.sched_reset(self._dev, sorted(self._dirty))
            self._dirty.clear()
        occupied = [b for b in range(B) if slots[b] is not None]
        self._max_resident = max(self._max_resident, len(occupied))
        if not occupied:
            nxt = self._pending[0].arrival if self._pending else None
            return BoundaryReport(emitted, finished, True, nxt,
                                  self._boundary_i)

        # ---- run one chunk over the whole bank -----------------------
        live = [b for b in occupied if not done_np[b] and rem_np[b] > 0]
        if live:
            K = _pow2_chunk(self.chunk, int(rem_np[live].max()))
            self._dev, done, rem, raw = eng.sched_step(
                self._dev, done_np, rem_np, K, eos_val)
            # the boundary's budgeted sync: done/rem cross with the chunk
            # reprolint: disable=R3 (intended boundary sync)
            done_np = self._done_np = np.asarray(done).copy()
            # reprolint: disable=R3 (intended boundary sync)
            rem_np = self._rem_np = np.asarray(rem).copy()
            per_row = eng.sched_emitted(raw)
            self._n_chunks += 1
            self._n_steps += K
            for b in occupied:
                if slots[b]["pending"] is None:
                    slots[b]["out"].extend(per_row[b])
            if self.adaptive is not None:
                # raw[1] = (K, B) per-step accepted counts; masked/free
                # rows are 0 and dropped by the EMA
                self.adaptive.observe(raw[1], eng.strategy.width)

        # ---- flush newly available tokens (the streaming boundary) ---
        _host_firsts(slots)
        for b in occupied:
            s = slots[b]
            if s is None or s["pending"] is not None:
                continue
            avail = min(len(s["out"]), s["req"].n_tokens)
            if avail > s["flushed"]:
                emitted[s["req"].req_id] = [
                    int(t) for t in s["out"][s["flushed"]:avail]]
                s["flushed"] = avail

        # ---- evict finished rows (EOS / budget / capacity freeze) ----
        for b in occupied:
            s = slots[b]
            if s is None or s["pending"] is not None:
                continue              # aborted / still prefilling
            budget = s["req"].n_tokens
            if not (done_np[b] or rem_np[b] <= 0
                    or len(s["out"]) >= budget):
                continue
            kept = s["out"][:budget]
            finished.append(self._finalize(s["req"], kept, s["t"], DONE))
            eng.sched_release(b)      # paged: pages back to the pool NOW
            self._dirty.add(b)        # reset lazily unless re-admitted
            slots[b] = None
            done_np[b] = True
            rem_np[b] = 0
            self.events.append(("evict", s["req"].req_id, b))

        # ---- adaptive: re-decide the decode strategy at the boundary -
        if self.adaptive is not None and live:
            new_w = self.adaptive.pick(eng.strategy.width)
            if new_w is not None:
                old_w = eng.strategy.width
                eng.set_strategy(self._strategy_table[new_w])
                self.events.append(("switch", old_w, new_w))
        return BoundaryReport(emitted, finished, False, None,
                              self._boundary_i)

    def fail_all(self, error=None) -> List[RequestResult]:
        """Replica-crash cleanup: finalize EVERY in-flight and queued
        request as FAILED and release resident pages (the allocator is
        host state, so it survives an engine fault and must stay
        conserved).  Device state is left as-is — a crashed replica's
        engine is never stepped again."""
        finished = []
        for b, s in enumerate(self._slots):
            if s is None:
                continue
            req = s["req"]
            try:
                _host_firsts([s])
                kept = list(s["out"][:req.n_tokens])
                np.asarray(kept, np.int32)
            except Exception:         # device output unreadable post-fault
                kept = []
            finished.append(self._finalize(req, kept, s["t"], FAILED))
            try:
                eng = self.engine
                getattr(eng, "sched_abort", eng.sched_release)(b)
            except Exception:
                pass
            self._slots[b] = None
            self._done_np[b] = True
            self._rem_np[b] = 0
            self.events.append(("fail", req.req_id, b))
        for req in self._pending:
            finished.append(self._finalize(req, [], self.now(), FAILED))
            self.events.append(("fail", req.req_id, -1))
        self._pending = []
        self._aborts = {}
        return finished

    def finish(self, requests: Optional[Sequence[Request]] = None) -> tuple:
        """Close the stream: final batched reset, aggregate stats.  With
        ``requests`` the results come back in that order (serve());
        otherwise in finalization order (the async server)."""
        if self._dirty and self._dev is not None:
            self._dev = self.engine.sched_reset(self._dev,
                                                sorted(self._dirty))
            self._dirty.clear()
        makespan = self.now()
        self.last_state = self._dev
        if requests is not None:
            ordered = [self._results[r.req_id] for r in requests]
        else:
            ordered = sorted(self._results.values(),
                             key=lambda r: r.t_finish)
        stats = _aggregate(ordered, makespan)
        stats.update(admitted=len(ordered), chunks=self._n_chunks,
                     device_steps=self._n_steps,
                     extend_pieces=self._n_pieces,
                     max_resident=self._max_resident, batch=self.batch,
                     chunk=self.chunk, policy=self.policy.name,
                     age_limit=getattr(self.policy, "age_limit", 0),
                     prefill_chunk=self.prefill_chunk)
        if self.adaptive is not None:
            stats.update(
                strategy_switches=[
                    {"boundary": n, "from": f, "to": t}
                    for n, f, t in self.adaptive.switches],
                width_final=self.engine.strategy.width,
                al_observed=self.adaptive.al_obs)
        # HCMP boundary accounting: when the engine ran the disaggregated
        # overlap schedule, surface its executor placement and how many
        # chunk boundaries reused vs discarded the cross-chunk pre-draft
        # (a quiet boundary keeps it; any admission/reset/switch bumps
        # the bank epoch and forces a redraft)
        hcmp = getattr(self.engine, "hcmp_stats", None)
        if hcmp is not None:
            stats["hcmp"] = hcmp
        return ordered, stats

    def serve(self, requests: Sequence[Request], *, eos: Optional[int] = None
              ) -> tuple:
        """Replay ``requests`` (admitting each no earlier than its arrival)
        and return ``(results, stats)`` with results in request order.
        A thin loop over the stepping core — same engine calls, same
        outputs as the pre-stepping scheduler (fuzz-pinned)."""
        self.start(requests, eos=eos)
        while self.has_work:
            report = self.boundary()
            if report.idle:
                if not self._pending:
                    break
                wait = self._pending[0].arrival - self.now()
                if wait > 0:
                    time.sleep(wait)
        return self.finish(requests)


def serve_static(engine, requests: Sequence[Request], *, batch: int = 8,
                 eos: Optional[int] = None) -> tuple:
    """Static-batching baseline: fixed groups of ``batch`` requests in
    arrival order; a group prefills only after ALL its members have arrived
    (batch formation) and runs until EVERY member finishes (per-sequence
    budgets mask early finishers, but their rows cannot be reused), then the
    next group starts.  Prompts within a group must share one length."""
    reqs = sorted(requests, key=lambda r: (r.arrival, r.req_id))
    results = {}
    device_steps = 0
    t0 = time.perf_counter()

    def now():
        return time.perf_counter() - t0

    for i in range(0, len(reqs), batch):
        group = reqs[i:i + batch]
        wait = max(r.arrival for r in group) - now()
        if wait > 0:
            time.sleep(wait)
        prompts = np.stack([np.asarray(r.tokens, np.int32) for r in group])
        budgets = np.asarray([r.n_tokens for r in group], np.int32)
        t_admit = now()
        out, stats = engine.generate({"tokens": prompts}, budgets, eos=eos)
        device_steps += stats["device_steps"]
        if out.ndim == 1:                     # B=1 tail group
            out = out[None]
        t_fin = now()
        for j, r in enumerate(group):
            n = int(stats["n_emitted"][j])
            results[r.req_id] = RequestResult(
                req_id=r.req_id, tokens=out[j, :n].copy(), n_emitted=n,
                arrival=r.arrival, t_admit=t_admit, t_finish=t_fin)

    makespan = now()
    ordered = [results[r.req_id] for r in requests]
    stats = _aggregate(ordered, makespan)
    stats.update(batch=batch, device_steps=device_steps)
    return ordered, stats


def poisson_arrivals(n: int, rate: float, *, seed: int = 0) -> np.ndarray:
    """Cumulative Poisson-process arrival times (rate = requests/second)."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))
