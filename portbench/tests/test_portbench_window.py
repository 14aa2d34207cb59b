"""The window arithmetic: tokens a second, the tails over every request
due (a failed one counts with its whole wait), and the union-of-intervals
idle share."""
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import devtrace, spec, window
from portbench.cell import Rec
from portbench.traffic import Offered


def rec(due, chunks, state="DONE", n_tokens=None):
    toks = [7] * sum(n for _, n in chunks)
    o = Offered(idx=0, prompt=np.zeros(4, np.int32),
                n_tokens=n_tokens or len(toks), due=0.0)
    return Rec(o=o, rid=0, due=due, chunks=list(chunks), tokens=toks,
               state=state)


def ctx(records, w=(10.0, 20.0), t_end=30.0, loop="closed"):
    return SimpleNamespace(records=records, window=w, t_end=t_end,
                           mix={"loop": loop})


def test_tok_s_counts_only_chunks_inside_the_window():
    rs = [rec(9.0, [(9.5, 8), (10.0, 8), (19.99, 8), (20.0, 8)]),
          rec(12.0, [(15.0, 4)], state="CANCELLED")]
    assert spec.reader("tok_s").read(ctx(rs)) == pytest.approx(20 / 10)
    assert spec.reader("tok_s").read(ctx(rs, loop="open")) is None


def test_ttft_p95_counts_a_failed_request_as_its_whole_wait():
    ok = [rec(10.0 + i * 0.1, [(10.5 + i * 0.1, 1), (11.0 + i * 0.1, 4)])
          for i in range(19)]
    failed = rec(15.0, [], state="FAILED", n_tokens=5)
    late = rec(21.0, [(40.0, 1)])                # due after the window
    v = spec.reader("ttft_p95_s").read(ctx(ok + [failed, late]))
    expect = np.percentile([0.5] * 19 + [30.0 - 15.0], 95)
    assert v == pytest.approx(expect)
    assert window.ttft([failed], 30.0) == [15.0]


def test_tpot_p95_per_request_and_missing_ones():
    a = rec(10.0, [(11.0, 1), (12.0, 4)])          # 1 s over 4 gaps
    b = rec(11.0, [(11.5, 1), (13.5, 8)])          # 2 s over 8 gaps
    lost = rec(12.0, [(12.5, 1)], state="CANCELLED", n_tokens=11)
    assert window.tpot([a, b], 30.0) == pytest.approx([0.25, 0.25])
    assert window.tpot([lost], 30.0) == pytest.approx([(30.0 - 12.0) / 10])
    v = spec.reader("tpot_p95_ms").read(ctx([a, b, lost]))
    assert v == pytest.approx(1e3 * np.percentile([0.25, 0.25, 1.8], 95))


def test_union_of_intervals_and_idle_share():
    ivs = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 10)]
    assert devtrace.union(ivs) == [[0, 3], [5, 6], [8, 10]]
    assert devtrace.busy(ivs) == pytest.approx(6.0)
    tr = {"busy_s": 6.0, "window_s": 10.0}
    c = SimpleNamespace(trace=tr)
    assert spec.reader("device.idle_share").read(c) == pytest.approx(0.4)
    assert spec.reader("device.idle_share.chat").read(c) == pytest.approx(0.4)
    assert spec.reader("device.idle_share").read(
        SimpleNamespace(trace=None)) is None


def test_kernel_classes():
    assert devtrace.kernel_class("void paged_flash_kernel<bf16>") \
        == "B2/B3 page walk"
    assert devtrace.kernel_class("nvjet_tst_256x128") == "matmul"
    assert devtrace.kernel_class("elementwise_kernel") == devtrace.OTHER


def test_step_readers_over_the_window():
    B = 4
    ns = np.array([[1, 1, 0, 0], [1, 1, 0, 0]])            # K=2, 2 live rows
    steps = [(11.0, 11.1, 2, np.array([10, 20, 0, 5]),
              np.array([True, True, False, False]), ns),
             (25.0, 25.1, 2, np.zeros(B, int), np.zeros(B, bool), ns)]
    spans = [("sched_admit", 12.0, 12.5, {"tokens": 500}),
             ("sched_extend", 13.0, 13.5, {"tokens": 500, "ctx": 500,
                                           "W": 512}),
             ("sched_step", 11.0, 11.1, {"K": 2})]
    c = SimpleNamespace(steps=steps, spans=spans, window=(10.0, 20.0),
                        bank=B, records=[])
    assert spec.reader("sched.rows_busy").read(c) == pytest.approx(0.5)
    assert spec.reader("spec.accept_len").read(c) == pytest.approx(1.0)
    assert spec.reader("engine.decode_step_ms").read(c) == pytest.approx(50)
    assert spec.reader("engine.prefill_ms_per_ktok").read(c) \
        == pytest.approx(1000.0)


def test_the_traced_slice_keeps_only_its_own_activities():
    c = devtrace.Clock()
    b = c.bases["monotonic"]
    ev = [("paged_flash_kernel", b + int(0.5e9), int(0.2e9)),
          ("gemm", b + int(1.9e9), int(0.3e9)),       # runs past the end
          ("gemm", b - int(1e9), int(0.1e9))]         # before the start
    spans = [("sched_step", c.pc + 0.6, c.pc + 1.95, {})]
    r = devtrace.summary(ev, c.pc + 0.4, c.pc + 2.0, c, spans)
    assert r["aligned"] and r["n_events"] == 2
    assert r["busy_s"] == pytest.approx(0.3)
    assert r["window_s"] == pytest.approx(1.6)
    assert r["gaps"] == [["sched_step", pytest.approx(1.2)]]
