"""The port's fault-tolerant serving plane on the torch engine: the
lifecycle cases of ``tests/test_serving.py`` on ``repro_torch``'s
scheduler stepping API (``runtime/continuous.py``) and its asyncio
server/router front end (``runtime/server.py``, ``runtime/router.py``,
``runtime/faults.py``), with the reference's assertions.  Each request's
solo run is the port engine's own ``generate``.

Invariants:
  * a mid-flight ``abort()`` finalizes ONLY the victim — with the tokens
    emitted so far, a bit-identical PREFIX of its solo run — releases its
    reserved pages at that same boundary (available pages strictly
    increase while neighbors stay resident), and every surviving request
    still finishes bit-identical to its solo run;
  * a queued abort finalizes with zero tokens; deadlines finalize
    TIMED_OUT whether the request is queued or resident; ``fail_all``
    (the crash path) FAILs everything and returns every page;
  * the async server streams exactly the tokens of the final result,
    sheds load with typed REJECTED results at ``queue_limit``, and
    resolves every handle even through an injected replica crash;
  * the router retries FAILED/REJECTED attempts on another replica and
    never double-emits: delivered tokens across all attempts equal the
    solo run exactly once; with no healthy replica left it resolves
    REJECTED; the fleet's page pools stay conserved through all of it.

Async tests run under a ``signal.alarm`` hard timeout (pytest-timeout is
not available in the container): a deadlocked event loop fails loudly
instead of hanging tier-1.
"""
import asyncio
import signal
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.api import get_model
from repro_torch.runtime.continuous import (CANCELLED, DECODING, DONE,
                                            FAILED, REJECTED,
                                            TERMINAL_STATES, TIMED_OUT,
                                            ContinuousScheduler, Request)
from repro_torch.runtime.engine import BatchEngine
from repro_torch.runtime.faults import FaultPlan, ReplicaCrash
from repro_torch.runtime.router import ReplicaRouter
from repro_torch.runtime.server import AsyncEngineServer

MAX_LEN = 64
PAGE_SIZE = 8
POOL_PAGES = 12
_ENGINES = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    test workers share the machine's cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hard_timeout():
    """Hard per-test wall clock: a hung worker thread or event loop must
    fail the test, not the whole tier-1 run."""
    def _boom(signum, frame):
        raise RuntimeError("serving test exceeded the hard timeout")
    old = signal.signal(signal.SIGALRM, _boom)
    signal.alarm(300)                  # generous
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _engine(name="a"):
    """Cached paged BatchEngine per replica name (replicas must not share
    a bank: each server thread steps its own engine)."""
    if name not in _ENGINES:
        cfg = get_config("qwen2-0.5b").reduced()
        model = get_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0))
        _ENGINES[name] = (cfg, BatchEngine(
            model, params, max_len=MAX_LEN, chunk=4, paged=True,
            page_size=PAGE_SIZE, pool_pages=POOL_PAGES))
    return _ENGINES[name]


def _requests(cfg, n, budget, prompt_len=6, seed=3):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, prompt_len)).astype(np.int32)
    return [Request(req_id=i, tokens=toks[i], n_tokens=budget)
            for i in range(n)]


def _solo(eng, req):
    out, _ = eng.generate({"tokens": req.tokens[None]}, req.n_tokens)
    return np.atleast_2d(out)[0]


# ---------------------------------------------------------------------------
# scheduler stepping API: abort / deadline / crash lifecycle
# ---------------------------------------------------------------------------

def test_abort_midflight_parity_and_page_release():
    """Cancel one resident request mid-decode: its pages come back at that
    same boundary, its partial tokens are a solo prefix, and the SURVIVING
    residents finish bit-identical to their solo runs (the parity pin for
    the whole abort path)."""
    cfg, eng = _engine()
    reqs = _requests(cfg, 3, budget=20)    # 5 boundaries: prefill emits too
    sched = ContinuousScheduler(eng, batch=2)
    sched.start(reqs[:2])                  # rows full, nothing queued
    sched.boundary()                       # admit 2, prefill + first chunk
    sched.boundary()                       # second chunk: mid-flight now
    assert sched.request_state(1) == DECODING
    avail = eng._alloc.available
    sched.abort(1)                         # takes effect next boundary
    rep = sched.boundary()
    got = [r for r in rep.finished if r.req_id == 1]
    assert got and got[0].state == CANCELLED
    assert eng._alloc.available > avail    # pages released MID-FLIGHT
    assert sched.request_state(0) == DECODING      # neighbor untouched
    sched.submit(reqs[2])                  # freed row + pages fund this
    sched.boundary()
    assert ("admit", 2, 1) in sched.events         # recycled the row
    while sched.has_work:
        sched.boundary()
    results, stats = sched.finish(reqs)
    assert [r.req_id for r in results] == [0, 1, 2]
    for r, req in zip(results, reqs):
        solo = _solo(eng, req)
        if r.req_id == 1:
            assert r.state == CANCELLED
            assert 0 < r.n_emitted < req.n_tokens  # partial, not empty
        else:
            assert r.state == DONE and r.n_emitted == req.n_tokens
        np.testing.assert_array_equal(r.tokens, solo[:r.n_emitted],
                                      err_msg=f"req {r.req_id}")
    assert ("abort", 1, 1) in sched.events         # row 1 was the victim
    assert eng.sched_drained() and eng.sched_pool_conserved()
    assert stats["states"] == {"DONE": 2, "CANCELLED": 1}


def test_abort_queued_and_deadlines():
    """A queued abort never runs (zero tokens); a deadline finalizes
    TIMED_OUT from the queue (never admitted) and mid-flight (partial
    solo-prefix tokens, pages released)."""
    cfg, eng = _engine()
    reqs = _requests(cfg, 3, budget=24)
    reqs[2].deadline = 0.0                 # already expired when serving
    sched = ContinuousScheduler(eng, batch=1)
    sched.start(reqs)
    rep = sched.boundary()                 # req 0 admitted; req 2 swept
    timed = {r.req_id: r for r in rep.finished}
    assert timed[2].state == TIMED_OUT and timed[2].n_emitted == 0
    sched.abort(1)                         # still queued behind req 0
    rep = sched.boundary()
    got = {r.req_id: r for r in rep.finished}
    assert got[1].state == CANCELLED and got[1].n_emitted == 0
    assert ("abort", 1, -1) in sched.events        # -1: never admitted
    reqs[0].deadline = sched.now()         # expire the RESIDENT request
    rep = sched.boundary()
    got = {r.req_id: r for r in rep.finished}
    assert got[0].state == TIMED_OUT
    assert 0 < got[0].n_emitted < reqs[0].n_tokens
    np.testing.assert_array_equal(
        got[0].tokens, _solo(eng, reqs[0])[:got[0].n_emitted])
    assert not sched.has_work
    results, stats = sched.finish(reqs)
    assert all(r.state in TERMINAL_STATES for r in results)
    admits = [e for e in sched.events if e[0] == "admit"]
    assert [e[1] for e in admits] == [0]   # only req 0 ever held a row
    assert eng.sched_drained() and eng.sched_pool_conserved()


def test_fail_all_releases_everything():
    """The crash path: every in-flight and queued request lands FAILED
    with solo-prefix tokens and the page pool is fully conserved — a dead
    replica leaks nothing."""
    cfg, eng = _engine()
    reqs = _requests(cfg, 3, budget=24)
    sched = ContinuousScheduler(eng, batch=2)
    sched.start(reqs)
    sched.boundary()
    sched.boundary()
    failed = sched.fail_all(RuntimeError("boom"))
    assert sorted(r.req_id for r in failed) == [0, 1, 2]
    for r in failed:
        assert r.state == FAILED
        req = reqs[r.req_id]
        np.testing.assert_array_equal(
            r.tokens, _solo(eng, req)[:r.n_emitted])
    assert not sched.has_work
    assert eng.sched_drained() and eng.sched_pool_conserved()


# ---------------------------------------------------------------------------
# async server + router
# ---------------------------------------------------------------------------

def test_server_stream_matches_result():
    """The streamed chunks concatenate to exactly the final result's
    tokens, which match the solo run; the handle resolves DONE."""
    cfg, eng = _engine()
    req = _requests(cfg, 1, budget=12)[0]

    async def go():
        srv = AsyncEngineServer(ContinuousScheduler(eng, batch=2),
                                name="s0")
        await srv.start()
        handle = await srv.submit(req)
        streamed = []
        async for toks in handle.stream():
            streamed.extend(toks)
        res = await handle.result()
        await srv.stop()
        return streamed, res

    streamed, res = asyncio.run(go())
    assert res.state == DONE
    np.testing.assert_array_equal(streamed, res.tokens)
    np.testing.assert_array_equal(res.tokens, _solo(eng, req)[:12])
    assert eng.sched_drained()


def test_server_backpressure_rejected():
    """Load over ``queue_limit`` is shed with an immediate typed REJECTED
    result; the admitted request is unaffected."""
    cfg, eng = _engine()
    reqs = _requests(cfg, 2, budget=12)

    async def go():
        srv = AsyncEngineServer(ContinuousScheduler(eng, batch=2),
                                name="s0", queue_limit=1)
        await srv.start()
        h0 = await srv.submit(reqs[0])     # load >= 1 from this instant
        h1 = await srv.submit(reqs[1])     # over the limit: shed
        r1 = await h1.result()
        r0 = await h0.result()
        await srv.stop()
        return r0, r1, srv.rejected

    r0, r1, rejected = asyncio.run(go())
    assert r1.state == REJECTED and r1.n_emitted == 0 and rejected == 1
    assert r0.state == DONE and r0.n_emitted == 12


def test_server_cancel_mid_stream():
    """A client cancel lands at the next chunk boundary: CANCELLED with a
    solo-prefix of the tokens delivered so far."""
    cfg, eng = _engine()
    req = _requests(cfg, 1, budget=56)[0]

    async def go():
        srv = AsyncEngineServer(ContinuousScheduler(eng, batch=2),
                                name="s0")
        await srv.start()
        handle = await srv.submit(req)
        streamed = []
        async for toks in handle.stream():
            streamed.extend(toks)
            if len(streamed) >= 4:         # hang up after the first chunk
                await srv.cancel(req.req_id)
        res = await handle.result()
        await srv.stop()
        return streamed, res

    streamed, res = asyncio.run(go())
    assert res.state == CANCELLED
    assert 0 < res.n_emitted < req.n_tokens
    np.testing.assert_array_equal(streamed, res.tokens)
    np.testing.assert_array_equal(res.tokens, _solo(eng, req)[:res.n_emitted])
    assert eng.sched_drained() and eng.sched_pool_conserved()


def test_server_deadline_times_out():
    cfg, eng = _engine()
    req = _requests(cfg, 1, budget=56)[0]

    async def go():
        srv = AsyncEngineServer(ContinuousScheduler(eng, batch=2),
                                name="s0")
        await srv.start()
        handle = await srv.submit(req, deadline_s=0.02)
        res = await handle.result()
        await srv.stop()
        return res

    res = asyncio.run(go())
    assert res.state == TIMED_OUT
    assert res.n_emitted < req.n_tokens
    assert eng.sched_drained()


def test_router_crash_retry_never_double_emits():
    """Replica ra crashes mid-request; the router retries on rb and the
    client's delivered stream is the solo run EXACTLY ONCE (the retried
    attempt's re-decoded prefix is skipped); ra is unhealthy afterwards
    and neither replica leaks pages."""
    cfg, ea = _engine("ra")
    _, eb = _engine("rb")
    req = _requests(cfg, 1, budget=24)[0]
    plan = FaultPlan(seed=5, crash={"ra": 2})

    async def go():
        servers = [
            AsyncEngineServer(ContinuousScheduler(
                ea, batch=2, faults=plan.injector("ra")), name="ra"),
            AsyncEngineServer(ContinuousScheduler(eb, batch=2), name="rb"),
        ]
        router = ReplicaRouter(servers, max_retries=2, backoff_base=0.01,
                               seed=5)
        await router.start()
        delivered, res = await router.generate(req)
        health = [s.healthy for s in servers]
        conserved = router.pages_conserved() and router.drained()
        await router.stop()
        return delivered, res, health, conserved, router.retries

    delivered, res, health, conserved, retries = asyncio.run(go())
    assert res.state == DONE and retries >= 1
    assert health == [False, True]         # ra crashed, rb survived
    np.testing.assert_array_equal(delivered, _solo(ea, req)[:24])
    np.testing.assert_array_equal(res.tokens, delivered)
    assert conserved


def test_router_no_healthy_replica_rejects():
    """Every replica crashes on its first boundary: after the retry
    budget the router resolves REJECTED rather than hanging, and the dead
    replicas' pools are still conserved (fail_all cleanup)."""
    cfg, ea = _engine("ra2")
    _, eb = _engine("rb2")
    req = _requests(cfg, 1, budget=24)[0]
    plan = FaultPlan(seed=6, crash={"ra2": 1, "rb2": 1})

    async def go():
        servers = [
            AsyncEngineServer(ContinuousScheduler(
                e, batch=2, faults=plan.injector(n)), name=n)
            for n, e in (("ra2", ea), ("rb2", eb))]
        router = ReplicaRouter(servers, max_retries=3, backoff_base=0.01,
                               seed=6)
        await router.start()
        _, res = await router.generate(req)
        conserved = router.pages_conserved() and router.drained()
        healthy = any(s.healthy for s in servers)
        await router.stop()
        return res, conserved, healthy

    res, conserved, healthy = asyncio.run(go())
    assert res.state == REJECTED and not healthy and conserved


def test_backoff_accepts_string_request_ids():
    """Regression: ``_backoff`` seeded ``np.random.default_rng`` with the
    raw ``req_id`` — any application-chosen non-int id (uuid-style
    strings) crashed the retry path at the first backoff.  Ids now seed
    through a stable digest of ``str(req_id)``: deterministic per
    (seed, id, attempt), identical for ``7`` and ``"7"``, and accepting
    any stringifiable id."""
    class _Stub:
        name = "r0"
    router = ReplicaRouter([_Stub()], seed=3)
    d = router._backoff("req-00c4-uuid", 1)
    assert 0.0 < d <= router.backoff_cap * (1.0 + router.jitter)
    assert d == router._backoff("req-00c4-uuid", 1)       # deterministic
    assert router._backoff(7, 2) == router._backoff("7", 2)
    # attempt growth still caps at backoff_cap regardless of id type
    assert router._backoff("x", 9) <= \
        router.backoff_cap * (1.0 + router.jitter)


def test_router_retry_with_string_request_id():
    """End-to-end regression for the backoff fix: a crash-forced retry of
    a request with a STRING id must reach DONE through the backoff path
    (previously a TypeError inside ``_backoff``) and never double-emit."""
    cfg, ea = _engine("rs_a")
    _, eb = _engine("rs_b")
    base = _requests(cfg, 1, budget=16)[0]
    req = Request(req_id="job/alpha-7", tokens=base.tokens,
                  n_tokens=base.n_tokens)
    plan = FaultPlan(seed=5, crash={"rs_a": 2})

    async def go():
        servers = [
            AsyncEngineServer(ContinuousScheduler(
                ea, batch=2, faults=plan.injector("rs_a")), name="rs_a"),
            AsyncEngineServer(ContinuousScheduler(eb, batch=2),
                              name="rs_b"),
        ]
        router = ReplicaRouter(servers, max_retries=2, backoff_base=0.01,
                               seed=5)
        await router.start()
        delivered, res = await router.generate(req)
        conserved = router.pages_conserved() and router.drained()
        await router.stop()
        return delivered, res, conserved, router.retries

    delivered, res, conserved, retries = asyncio.run(go())
    assert res.state == DONE and retries >= 1
    assert res.req_id == "job/alpha-7"
    np.testing.assert_array_equal(delivered, _solo(ea, base)[:16])
    np.testing.assert_array_equal(res.tokens, delivered)
    assert conserved


def test_router_liveness_probe_drains_stalled_replica():
    """Replica rs is alive but WEDGED (every boundary stalls far longer
    than ``stall_timeout_s``): its boundary-progress heartbeat goes
    stale, the router's liveness watcher drains it proactively — the
    outstanding handle fails over to rs2 and the client still gets the
    solo stream exactly once — and rs is sticky-unhealthy so routing
    skips it from then on.  Without the probe this request would sit on
    the wedged worker for the stall's full duration."""
    cfg, ea = _engine("rs")
    _, eb = _engine("rs2")
    req = _requests(cfg, 1, budget=12)[0]
    # prewarm both engines' scheduler paths: a slow first boundary is
    # indistinguishable from a stall and would trip the probe on the
    # HEALTHY replica too
    for e in (ea, eb):
        warm = ContinuousScheduler(e, batch=2)
        warm.start([], eos=None)
        warm.submit(_requests(cfg, 1, budget=12, seed=9)[0])
        while warm.has_work:
            warm.boundary()
        warm.finish()
    plan = FaultPlan(seed=7, stall_rate=1.0, stall_s=2.0)

    async def go():
        servers = [
            AsyncEngineServer(ContinuousScheduler(
                ea, batch=2, faults=plan.injector("rs")), name="rs",
                stall_timeout_s=0.5),
            AsyncEngineServer(ContinuousScheduler(eb, batch=2),
                              name="rs2", stall_timeout_s=0.5),
        ]
        router = ReplicaRouter(servers, max_retries=2, backoff_base=0.01,
                               seed=7)
        await router.start(health_every_s=0.05)
        delivered, res = await router.generate(req)
        health = [s.healthy for s in servers]
        seen_stalled = any(h["name"] == "rs" and h["stalled"]
                           for snap in router.health_log for h in snap)
        conserved = router.pages_conserved()
        await router.stop()               # joins rs once its decode ends
        drained = router.drained()
        return (delivered, res, health, seen_stalled, conserved,
                drained, router.retries, router.stall_drains)

    (delivered, res, health, seen_stalled, conserved, drained, retries,
     stall_drains) = asyncio.run(go())
    assert res.state == DONE and retries >= 1
    assert stall_drains >= 1               # the probe did the failover
    assert health == [False, True]         # rs sticky-unhealthy, rs2 fine
    assert seen_stalled                    # health() surfaced the stall
    np.testing.assert_array_equal(delivered, _solo(ea, req)[:12])
    np.testing.assert_array_equal(res.tokens, delivered)
    assert conserved and drained           # wedged != leaking


def test_fault_plan_validation_and_determinism():
    with pytest.raises(ValueError):
        FaultPlan(cancel_rate=1.5)
    with pytest.raises(ValueError):
        FaultPlan(cancel_after=(0, 4))
    plan = FaultPlan(seed=11, cancel_rate=0.5, exhaust_rate=0.4)
    # client behavior is a pure function of (seed, req_id)
    a = [plan.client().disconnect_after(i) for i in range(32)]
    b = [plan.client().disconnect_after(i) for i in range(32)]
    assert a == b and any(x is not None for x in a)
    # replica injectors replay identically for the same (seed, name)
    def draws(name):
        inj = plan.injector(name)
        return [inj.block_admission() for _ in range(30)]
    seq = draws("r0")
    assert seq == draws("r0") and any(seq)
    assert draws("r1") == draws("r1")
    with pytest.raises(ReplicaCrash):
        FaultPlan(crash={"r0": 1}).injector("r0").on_boundary(1)


def test_loop_observability_uses_worker_snapshots():
    """The event-loop side (``health()``, the router's pool audits, the
    reject path of ``submit``) must never call into the worker-owned
    scheduler or engine: every scheduler/engine call during a serving
    session originates on the worker thread, and the loop reads only
    worker-published snapshots (regression test for the R4
    thread-discipline fixes in server.py/router.py)."""
    cfg, eng = _engine("rlock")
    reqs = _requests(cfg, 2, budget=12)
    calls = []

    def _spy(obj, name):
        orig = getattr(obj, name)

        def wrap(*a, **k):
            calls.append((name, threading.get_ident()))
            return orig(*a, **k)

        setattr(obj, name, wrap)

    sched = ContinuousScheduler(eng, batch=2)
    for n in ("now", "submit", "abort", "boundary", "fail_all"):
        _spy(sched, n)
    for n in ("sched_pool_conserved", "sched_drained"):
        _spy(eng, n)

    async def go():
        srv = AsyncEngineServer(sched, name="rlock", queue_limit=1)
        router = ReplicaRouter([srv])
        await router.start()
        h0 = await srv.submit(reqs[0])
        h1 = await srv.submit(reqs[1])     # shed: loop-side reject path
        health = srv.health()              # loop-side observability
        r1 = await h1.result()
        r0 = await h0.result()
        audits = router.pages_conserved(), router.drained()
        await router.stop()
        return srv._thread.ident, health, audits, r0, r1

    try:
        worker, health, audits, r0, r1 = asyncio.run(go())
    finally:
        for n in ("sched_pool_conserved", "sched_drained"):
            del eng.__dict__[n]            # engine is cached across tests

    assert r0.state == DONE and r1.state == REJECTED
    assert worker is not None and worker != threading.get_ident()
    offenders = sorted({n for n, t in calls if t != worker})
    assert not offenders, \
        f"scheduler/engine touched off the worker thread: {offenders}"
    assert health["pool_conserved"] and audits == (True, True)
