"""The readers of the program's own spans (``portbench/spans.py`` and the
metrics that use it) on a made-up traced slice: the port's tracer records
of a worker thread and another thread, device-timed calls, phase times,
and device activities placed on the host clock.  The idle split sums to
``device.idle_share``; a program with no tracer reads nothing."""
from types import SimpleNamespace

import pytest

from portbench import spans, spec
from repro_torch.runtime.trace import DeviceRecord, PhaseRecord, SpanRecord

S = 1_000_000_000          # ns a second
W, OTHER = 101, 202        # the worker's thread and another


def sp(name, a, b, cpu=None, thread=W, tokens=0, k=0):
    """A span from ``a`` to ``b`` seconds; CPU time defaults to its
    wall."""
    cpu = b - a if cpu is None else cpu
    return SpanRecord(name, thread, round(a * S), round(b * S),
                      round(cpu * S), 0, tokens, k)


SPANS = [
    sp("engine.chunk", 9.0, 9.2, k=8),                # before the slice
    sp("sched.boundary", 10.0, 10.5, cpu=0.3),
    sp("engine.extend", 10.05, 10.08, tokens=512),
    sp("engine.chunk", 10.1, 10.4, cpu=0.25, k=4),
    sp("engine.chunk.wait", 10.3, 10.4, cpu=0.1),
    sp("sched.flush", 10.42, 10.45, cpu=0.03),
    sp("server.publish", 10.5, 10.55, cpu=0.05),
    sp("sched.boundary", 10.58, 10.9, cpu=0.2),
    sp("engine.prefill", 10.6, 10.8, cpu=0.15, tokens=500),
    sp("engine.reset", 10.85, 10.88, cpu=0.02),
    sp("server.wait", 10.95, 10.99, cpu=0.0),
    sp("sched.boundary", 10.0, 10.9, cpu=0.0, thread=OTHER),
]
DEVICE = [
    DeviceRecord("engine.extend", round(10.05 * S), round(10.08 * S), 512,
                 (40.0, 5.0)),
    DeviceRecord("engine.prefill", round(10.6 * S), round(10.8 * S), 500,
                 (150.0, 10.0)),
    DeviceRecord("engine.prefill", round(9.0 * S), round(9.1 * S), 100,
                 (1e3, 1e3)),                          # before the slice
]
PHASES = [
    PhaseRecord(round(10.4 * S), 1.0, 10.0, 0.5, 2.0),
    PhaseRecord(round(10.9 * S), 3.0, 12.0, 0.7, 2.2),
    PhaseRecord(round(9.2 * S), 99.0, 99.0, 99.0, 99.0),  # before
]
# busy [10.0, 10.2), [10.35, 10.62), [10.7, 10.86): 0.63 of the 1 s slice
PLACED = [("k0", 10.0, 0.15), ("k1", 10.1, 0.1), ("k2", 10.35, 0.27),
          ("k3", 10.7, 0.16)]


def ctx(spans_=SPANS, placed=PLACED):
    tr = dict(t0=10.0, t1=11.0, placed=placed, busy_s=0.63, window_s=1.0)
    return SimpleNamespace(trace=tr, tracer=dict(
        spans=list(spans_), device=DEVICE, phases=PHASES, anchors=[],
        dropped=0))


def read(name, c):
    return spec.reader(name).read(c)


def test_idle_split_by_innermost_span_sums_to_the_idle_share():
    # idle [10.2, 10.35): the chunk (then its wait) -> chunk 0.15
    # idle [10.62, 10.7): engine.prefill -> prefill 0.08
    # idle [10.86, 11.0): engine.reset to 10.88 (unlabelled), the worker's
    # boundary to 10.9 (the other thread's started earlier), no span to
    # 10.95, server.wait to 10.99, no span
    c = ctx()
    by, length = spans.idle_by_class(c)
    assert length == pytest.approx(1.0)
    assert by == pytest.approx(dict(chunk=0.15, prefill=0.08,
                                    boundary=0.06, rest=0.08))
    got = {k: read(f"device.idle_{k}_share", c)
           for k in ("chunk", "prefill", "boundary")}
    assert got == pytest.approx(dict(chunk=0.15, prefill=0.08,
                                     boundary=0.06))
    assert sum(got.values()) + by["rest"] == \
        pytest.approx(read("device.idle_share", c))


def test_idle_split_is_by_time_not_by_midpoint():
    # one gap [10.2, 11.0): a quarter under the chunk, three quarters
    # under the boundary (whose midpoint would take it all)
    s = [sp("sched.boundary", 10.0, 11.0), sp("engine.chunk", 10.1, 10.4)]
    by, _ = spans.idle_by_class(ctx(s, [("k", 10.0, 0.2)]))
    assert by == pytest.approx(dict(chunk=0.2, prefill=0.0, boundary=0.6,
                                    rest=0.0))


def test_launch_and_prefill_readers():
    c = ctx()
    # the chunk in the slice: 0.3 s less its 0.1 s wait over 4 steps
    assert read("engine.launch_ms_per_step", c) == pytest.approx(50.0)
    # 0.03 + 0.2 s of host time over 1,012 prompt tokens
    assert read("engine.prefill_launch_ms_per_ktok", c) == \
        pytest.approx(230.0 / 1.012)
    # 45 + 160 device ms over the same tokens
    assert read("engine.prefill_device_ms_per_ktok", c) == \
        pytest.approx(205.0 / 1.012)


def test_worker_offcpu_share_leaves_out_the_waits():
    # outermost worker spans: boundary 0.5 (cpu 0.3), publish 0.05
    # (0.05), boundary 0.32 (0.2), server.wait 0.04 (0); less the chunk's
    # wait 0.1 (0.1) and server.wait: wall 0.77, cpu 0.45
    assert read("sched.worker_offcpu_share", ctx()) == \
        pytest.approx((0.77 - 0.45) / 0.77)


def test_phase_readers_average_the_slice():
    c = ctx()
    assert read("spec.draft_ms", c) == pytest.approx(2.0)
    assert read("step.verify_ms", c) == pytest.approx(11.0)
    assert read("spec.accept_ms", c) == pytest.approx(0.6)
    assert read("spec.commit_ms", c) == pytest.approx(2.1)


NEW = ("engine.launch_ms_per_step", "engine.prefill_launch_ms_per_ktok",
       "engine.prefill_device_ms_per_ktok", "sched.worker_offcpu_share",
       "device.idle_chunk_share", "device.idle_prefill_share",
       "device.idle_boundary_share", "spec.draft_ms", "step.verify_ms",
       "spec.accept_ms", "spec.commit_ms")


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_reads_none(name, monkeypatch):
    empty = SimpleNamespace(trace=ctx().trace, tracer=dict(
        spans=[], device=[], phases=[], anchors=[], dropped=0))
    assert read(name, empty) is None
    assert read(name, SimpleNamespace(trace=None)) is None
    # a program without the tracer: the import fails, nothing is read
    import builtins
    real = builtins.__import__

    def no_tracer(mod, *a, **kw):
        if mod == "repro_torch.runtime" or mod.startswith(
                "repro_torch.runtime.trace"):
            raise ImportError(mod)
        return real(mod, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert read(name, SimpleNamespace(trace=ctx().trace)) is None


def test_new_metrics_are_the_decode_cells_per_layer_entries():
    bench = spec.load_benchmark()
    by = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = by[name]
        assert m["workloads"] == ["mistral-7b.decode"]
        assert m["moves"] == "tok_s"
