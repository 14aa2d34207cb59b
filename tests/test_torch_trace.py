"""The port's tracer (``repro_torch/runtime/trace.py``) on the CPU: off it
hands out the shared no-op and records nothing; inside ``torch.profiler``
a small serve through ``AsyncEngineServer`` records the serving path's
spans, nested and ordered, each with no more thread CPU time than wall
time; its buffers are bounded and count what they drop; its clock anchor
places a profiler timestamp on the spans' clock; and the scheduler keeps a
bounded tail of its lifecycle events.  The captured step's phase events
run only on the card (``tests/test_torch_card.py``)."""
import asyncio
import collections
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.speculative import tree as T
from repro_torch.core.speculative.medusa import init_medusa
from repro_torch.models.api import get_model
from repro_torch.runtime import continuous, trace
from repro_torch.runtime.continuous import ContinuousScheduler, Request
from repro_torch.runtime.engine import DecodeEngine, DecodeStrategy
from repro_torch.runtime.server import AsyncEngineServer


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """Each test starts with an empty tracer, off, and leaves it so."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.TRACER.clear()
    yield
    trace.disable()
    trace.TRACER.clear()
    torch.set_num_threads(n)


def _serve(n_requests=3, prefill_chunk=8):
    """A drafted paged engine on the static-buffer step (the card's
    captured step, called once a replay), served through the async server
    with chunked prefill; returns the streamed tokens."""
    cfg = get_config("qwen2-0.5b-smoke")
    gen = torch.Generator().manual_seed(0)
    model = get_model(cfg)
    params, heads = model.init_params(gen), init_medusa(cfg, gen)
    tree = T.build_tree(T.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                        4)
    eng = DecodeEngine(model, params, heads=heads,
                       strategy=DecodeStrategy.medusa(tree, "cpu"),
                       max_len=96, chunk=4, paged=True, page_size=4)
    eng._graphed = True
    sched = ContinuousScheduler(eng, batch=2, chunk=4,
                                prefill_chunk=prefill_chunk)
    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i, n_tokens=9, tokens=rng.integers(
        0, cfg.vocab_size, 12 + 3 * i).astype(np.int32))
        for i in range(n_requests)]

    async def go():
        srv = AsyncEngineServer(sched, name="traced")
        await srv.start()
        handles = [await srv.submit(r) for r in reqs]
        out = []
        for h in handles:
            out.append([t async for toks in h.stream() for t in toks])
        await srv.stop()
        return out

    return asyncio.run(go())


def _thread_clock_step() -> int:
    """The step (ns) in which this host's thread CPU clock advances (ns on
    most hosts, 10 ms on some others): a span's CPU time may exceed its
    wall time by less than one step."""
    a = time.thread_time_ns()
    while (b := time.thread_time_ns()) == a:
        pass
    return b - a


def test_off_records_nothing_and_hands_out_the_noop():
    sp = trace.span("engine.chunk", rows=4, k=8, device=torch.device("cpu"))
    assert sp is trace.NOOP
    with sp as inner:
        inner.mark()
    trace.after_transfer(None)
    toks = _serve(n_requests=2)
    assert all(len(t) == 9 for t in toks)
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["device"] == [] \
        and snap["phases"] == [] and snap["dropped"] == 0


def test_profiled_serve_records_the_named_spans_nested_and_ordered():
    with profile(activities=[ProfilerActivity.CPU]):
        toks = _serve()
    with trace.span("after the profiler"):
        pass
    assert all(len(t) == 9 for t in toks)
    snap = trace.snapshot()
    spans = snap["spans"]
    names = collections.Counter(s.name for s in spans)
    assert "after the profiler" not in names       # off again
    for name in ("server.ingest", "server.publish", "sched.boundary",
                 "sched.aborts", "sched.pieces", "sched.admit",
                 "sched.flush", "sched.evict", "engine.chunk",
                 "engine.chunk.h2d", "engine.chunk.load",
                 "engine.chunk.replay", "engine.chunk.wait",
                 "engine.prefill", "engine.prefill.forward",
                 "engine.prefill.insert", "engine.extend",
                 "engine.extend.forward", "engine.extend.splice",
                 "engine.release", "graphs.warmup"):
        assert names[name] > 0, name
    # one worker thread, not the test's
    assert {s.thread for s in spans} != {threading.get_ident()}
    assert len({s.thread for s in spans}) == 1
    tick = _thread_clock_step()
    for s in spans:
        assert s.t0 <= s.t1 and 0 <= s.cpu <= s.t1 - s.t0 + tick, s

    def within(child, parent_names):
        return [p for p in spans if p.name in parent_names
                and p.t0 <= child.t0 and child.t1 <= p.t1]

    parent = {"engine.chunk.": ("engine.chunk",),
              "engine.prefill.": ("engine.prefill",),
              "engine.extend.": ("engine.extend",),
              "engine.chunk": ("sched.boundary",),
              "engine.extend": ("sched.pieces",),
              "engine.release": ("sched.evict",),
              "sched.aborts": ("sched.boundary",),
              "sched.pieces": ("sched.boundary",),
              "sched.admit": ("sched.boundary",),
              "sched.flush": ("sched.boundary",),
              "sched.evict": ("sched.boundary",),
              "graphs.warmup": ("engine.chunk",)}
    for s in spans:
        key = next((k for k in parent if s.name.startswith(k)), None)
        if key is not None:
            assert len(within(s, parent[key])) == 1, s
    # a chunk: h2d, then the warm-up, or the load of its graph (none
    # when the graph is new) and K replays, then the wait
    loads = 0
    for c in (s for s in spans if s.name == "engine.chunk"):
        kids = sorted((s for s in spans if s.name.startswith(
            ("engine.chunk.", "graphs.")) and c.t0 <= s.t0 <= s.t1 <= c.t1),
            key=lambda s: s.t0)
        order = [s.name for s in kids]
        assert order[0] == "engine.chunk.h2d" and \
            order[-1] == "engine.chunk.wait", order
        mid = order[1:-1]
        if mid != ["graphs.warmup"]:
            loads += mid[0] == "engine.chunk.load"
            mid = mid[1:] if mid[0] == "engine.chunk.load" else mid
            assert mid == ["engine.chunk.replay"] * c.k, order
    assert loads > 0
    # a boundary's parts in protocol order
    for b in (s for s in spans if s.name == "sched.boundary"):
        kids = [s.name for s in sorted(spans, key=lambda s: s.t0)
                if s.name in ("sched.aborts", "sched.pieces", "sched.admit",
                              "sched.flush", "sched.evict")
                and b.t0 <= s.t0 and s.t1 <= b.t1]
        assert kids in (["sched.aborts", "sched.pieces", "sched.admit"],
                        ["sched.aborts", "sched.pieces", "sched.admit",
                         "sched.flush", "sched.evict"]), kids
    # the admissions' and pieces' tokens are the prompts' (pieces of 8)
    assert sum(s.tokens for s in spans if s.name in
               ("engine.prefill", "engine.extend")) == 12 + 15 + 18
    # a CPU run times no device work
    assert snap["device"] == [] and snap["phases"] == []
    assert snap["dropped"] == 0


def test_enable_and_disable_record_between_them():
    trace.enable()
    with trace.span("engine.reset", rows=3):
        time.sleep(0.001)
    trace.disable()
    with trace.span("engine.reset"):
        pass
    snap = trace.snapshot()
    assert [(s.name, s.rows) for s in snap["spans"]] == [("engine.reset", 3)]
    assert snap["spans"][0].t1 - snap["spans"][0].t0 >= 1_000_000
    a = snap["anchors"][-1]
    assert a.perf <= snap["spans"][0].t0


def test_buffer_bound_counts_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    tr = trace.Tracer()
    tr.enable()
    for i in range(10):
        with trace.Span(tr, f"s{i}", 0, 0, 0, None):
            pass
    snap = tr.snapshot()
    assert [s.name for s in snap["spans"]] == ["s6", "s7", "s8", "s9"]
    assert snap["dropped"] == 6
    tr.clear()
    assert tr.snapshot()["dropped"] == 0 and tr.snapshot()["spans"] == []


def test_anchor_places_either_profiler_clock():
    a = trace.Anchor(perf=5_000, wall=1_700_000_000_000_000_000,
                     mono=90_000_000_000)
    assert trace.to_span_clock(a, a.wall + 123) == 5_000 - a.wall
    assert trace.to_span_clock(a, a.mono - 7) == 5_000 - a.mono
    assert trace.to_span_clock(a, 10 ** 12) is None


def test_scheduler_keeps_a_bounded_tail_of_events(monkeypatch):
    monkeypatch.setattr(continuous, "EVENTS_KEPT", 3)
    cfg = get_config("qwen2-0.5b-smoke")
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    from repro_torch.runtime.engine import BatchEngine
    eng = BatchEngine(model, params, max_len=64, chunk=4)
    sched = ContinuousScheduler(eng, batch=2)
    rng = np.random.default_rng(1)
    reqs = [Request(req_id=i, n_tokens=3, tokens=rng.integers(
        0, cfg.vocab_size, 6).astype(np.int32)) for i in range(4)]
    results, stats = sched.serve(reqs)
    assert stats["admitted"] == 4
    assert len(sched.events) == 3
    assert list(sched.events)[-1][0] == "evict"


def test_profile_serve_places_the_device_on_the_spans_clock():
    """``launch/profile_serve.py::span_summary`` on made-up records: the
    device activities, on the profiler's wall clock, placed by the
    tracer's anchor; idle time under the innermost span; each chunk's
    device-to-host copy against its wait span."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from repro_torch.launch.profile_serve import span_summary
    us = 1_000
    anchor = trace.Anchor(perf=1_000 * us, wall=10 ** 18, mono=5 * 10 ** 9)

    def ev(name, start_us, dur_us):        # on the wall clock
        return SimpleNamespace(
            name=lambda: name, start_ns=lambda: anchor.wall + (
                start_us - 1_000) * us, duration_ns=lambda: dur_us * us,
            device_type=lambda: DeviceType.CUDA)

    def rec(name, a_us, b_us, cpu_us=0):
        return trace.SpanRecord(name, 1, a_us * us, b_us * us, cpu_us * us,
                                0, 0, 0)

    spans = [rec("sched.boundary", 1_000, 1_400, cpu_us=300),
             rec("engine.chunk", 1_100, 1_350, cpu_us=200),
             rec("engine.chunk.wait", 1_300, 1_350, cpu_us=50)]
    # busy 1,000-1,150 and 1,200-1,330 (the copy 1,320-1,330 ends it)
    events = [ev("gemm", 1_000, 150), ev("gemm", 1_200, 120),
              ev("Memcpy DtoH (Device -> Pageable)", 1_320, 10)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    snap = dict(spans=spans, anchors=[anchor], dropped=0)
    got = span_summary(prof, snap)
    assert got["host"]["engine.chunk"] == pytest.approx([1, 0.25, 0.2])
    # idle: 1,150-1,200 under the chunk, 1,330-1,350 under its wait,
    # 1,350-1,400 under the boundary
    assert got["idle"] == pytest.approx({"engine.chunk": 0.05,
                                         "engine.chunk.wait": 0.02,
                                         "sched.boundary": 0.05})
    assert got["chunks"] == 1
    assert got["kernel_us"] == 0.0 and got["copy_us"] == 0.0
    # a copy record 30 us late ends outside the wait by 30 us; the last
    # kernel, 10 us late, by 10 us
    late = [ev("gemm", 1_000, 150), ev("gemm", 1_200, 160),
            ev("Memcpy DtoH (Device -> Pageable)", 1_350, 30)]
    prof.profiler.kineto_results.events = lambda: late
    got = span_summary(prof, snap)
    assert got["copy_us"] == pytest.approx(30.0)
    assert got["kernel_us"] == pytest.approx(10.0)
