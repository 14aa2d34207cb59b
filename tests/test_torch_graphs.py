"""The compiled chunk's bookkeeping (``repro_torch/runtime/graphs.py``) on
the CPU, where no graph can be captured: the engines drive the static-
buffer step that the card captures, called once a replay
(``ChunkGraphs(..., capture=False)``), and every token stream must equal
the eager chunk's (``np.array_equal``).  Also: the launch-count tally of a
capture under threads, the port's ``measure_acceptance`` against the JAX
one, ``time_step``, and that no CUDA source sets a kernel's shared-memory
attribute outside ``attention_common.cuh::raise_smem``.

The weights are the boosted ones of ``tests/test_torch_engine.py``, so
rows accept chains of different lengths and positions diverge.
"""
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.speculative import tree as JT
from repro.runtime.engine import SpeculativeEngine as JSpec
from repro.runtime.engine import measure_acceptance as j_measure
from repro_torch.core.speculative import tree as TT
from repro_torch.kernels import launch
from repro_torch.runtime import continuous as TS
from repro_torch.runtime.engine import BatchEngine as TBatch
from repro_torch.runtime.engine import SpeculativeEngine as TSpec
from repro_torch.runtime.engine import _prefill_state, eager
from repro_torch.runtime.engine import measure_acceptance as t_measure
from test_torch_engine import ARCHS, _setup
from test_torch_sched import _reqs, _trace

CSRC = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
        / "kernels" / "csrc")
N = 20

# engine modes: label -> (draft kind, engine keywords)
MODES = {
    "dense": ("spec", {}),
    "paged bf16": ("spec", dict(paged=True, page_size=4, kv_dtype="bf16")),
    "paged int8": ("spec", dict(paged=True, page_size=4, kv_dtype="int8")),
    "int8 sparse": ("spec", dict(paged=True, page_size=4, kv_dtype="int8",
                                 tree_kernel="sparse")),
    "sequential": ("seq", {}),
    "paged sequential": ("seq", dict(paged=True, page_size=4)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    test workers share the machine's cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(kind, kw, *, graphed, arch=ARCHS[1], max_len=None, chunk=4):
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = _setup(arch)
    max_len = max_len or toks.shape[1] + N + tspec.max_depth
    if kind == "spec":
        eng = TSpec(tm, th, tp, tspec, max_len=max_len, chunk=chunk, **kw)
    else:
        eng = TBatch(tm, tp, max_len=max_len, chunk=chunk, **kw)
    # the card's path on the CPU: the static-buffer step, without capture
    eng._graphed = graphed
    return eng


@pytest.mark.parametrize("label", list(MODES))
def test_static_step_equals_eager_chunks(label):
    """Two ``generate`` calls on one engine: the first chunk of the key is
    the eager warm-up, the rest replay the static-buffer step; the second
    call's prefill brings new K/V, so the key's graph is rebuilt on them.
    Tokens and counts equal the eager engine's."""
    kind, kw = MODES[label]
    toks = _setup(ARCHS[1])[-1]
    budgets = np.array([N, N - 7], np.int32)
    graphed = _engine(kind, kw, graphed=True, chunk=2)
    plain = _engine(kind, kw, graphed=False, chunk=2)
    for _ in range(2):
        go, gs = graphed.generate({"tokens": toks}, budgets)
        po, ps = plain.generate({"tokens": toks}, budgets)
        np.testing.assert_array_equal(go, po)
        np.testing.assert_array_equal(gs["n_emitted"], ps["n_emitted"])
        assert gs["device_steps"] == ps["device_steps"]
        assert gs["replay_steps"] > 0 and ps["replay_steps"] == 0
    st = graphed.graph_stats
    assert st["graphs"] == 1 and st["captures"] == 2
    assert st["warmup_steps"] + st["replays"] == 2 * gs["device_steps"]
    assert plain.graph_stats["replays"] == 0


def test_eager_block_runs_the_eager_chunks():
    """Inside ``eager()`` an engine on the graph path builds no graph."""
    eng = _engine("spec", {}, graphed=True)
    toks = _setup(ARCHS[1])[-1]
    with eager():
        out, _ = eng.generate({"tokens": toks}, N)
    assert eng.graph_stats["captures"] == 0
    ref, _ = _engine("spec", {}, graphed=False).generate({"tokens": toks}, N)
    np.testing.assert_array_equal(out, ref)


# (draft kind, layout keywords, policy, prefill chunk, bank rows, trace seed)
SCHED_CASES = [
    ("spec", {}, "sjf", 4, 3, 2),
    ("seq", {}, "fifo", 4, 3, 4),
    ("spec", dict(paged=True, page_size=8, pool_pages=8), "fifo", 4, 3, 6),
    ("seq", dict(paged=True, page_size=8, pool_pages=8), "lpt", 4, 3, 8),
    ("spec", dict(paged=True, page_size=8, pool_pages=8, kv_dtype="int8"),
     "sjf", 0, 2, 11),
]


@pytest.mark.parametrize("kind,kw,policy,prefill_chunk,B,seed", SCHED_CASES)
def test_static_step_through_the_scheduler(kind, kw, policy, prefill_chunk,
                                           B, seed):
    """The continuous scheduler over the static-buffer step: admissions,
    row resets, chunked-prefill pieces and new block tables land between
    chunks and are copied into the static inputs before the replays.
    Every request's tokens equal the eager engine's, and the pools drain."""
    cfg = _setup(ARCHS[0])[0]
    trace = _trace(seed, cfg.vocab_size)
    runs = []
    for graphed in (True, False):
        eng = _engine(kind, kw, graphed=graphed, arch=ARCHS[0], max_len=64)
        res, stats = TS.ContinuousScheduler(
            eng, batch=B, policy=policy,
            prefill_chunk=prefill_chunk).serve(_reqs(TS, trace))
        assert eng.sched_pool_conserved() and eng.sched_drained()
        runs.append((eng, res))
    (geng, gres), (_, pres) = runs
    assert [r.req_id for r in gres] == [r.req_id for r in pres]
    for g, p in zip(gres, pres):
        assert g.state == p.state == "DONE"
        np.testing.assert_array_equal(g.tokens, p.tokens)
    assert geng.graph_stats["replays"] > 0


def test_static_scheduler_over_the_static_step():
    """``serve_static``: one ``generate`` a group, each a new prefill."""
    rng = np.random.default_rng(21)
    trace = [dict(req_id=i, tokens=rng.integers(0, 200, 6).astype(np.int32),
                  n_tokens=int(rng.choice((2, 5, 9))), arrival=0.01 * i)
             for i in range(5)]
    out = []
    for graphed in (True, False):
        eng = _engine("spec", dict(paged=True, page_size=8), graphed=graphed,
                      arch=ARCHS[0], max_len=64)
        res, _ = TS.serve_static(eng, _reqs(TS, trace), batch=2)
        out.append([r.tokens for r in res])
    for g, p in zip(*out):
        np.testing.assert_array_equal(g, p)


def _same_shape_specs(mod):
    """Two trees of one shape (width, depths, paths), different ranks."""
    return (mod.spec_from_nodes([(-1, 0, 0), (0, 1, 0), (1, 2, 0)]),
            mod.spec_from_nodes([(-1, 0, 0), (0, 1, 1), (1, 2, 0)]))


def test_same_shape_trees_share_the_static_step():
    """Chunks alternate between two same-shape trees set with
    ``set_strategy``, and between EOS values: one graph serves them all
    (the tree is copied into its static tree, EOS into its static
    scalar), and every chunk equals the eager chunk under the same tree
    and EOS."""
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = _setup(ARCHS[0])
    a, b = _same_shape_specs(TT)
    engines = [TSpec(tm, th, tp, a, max_len=64, chunk=4)
               for _ in range(2)]
    engines[0]._graphed = True
    carry = []
    for _ in engines:
        state = _prefill_state(tm, tp, th, {"tokens": torch.from_numpy(toks)},
                               max_len=64, window=0)
        carry.append([state, torch.zeros(toks.shape[0], dtype=torch.bool),
                      torch.full((toks.shape[0],), 40, dtype=torch.int32)])
    for tree, eos in ((a, -1), (a, -1), (b, -1), (a, 9), (b, 9), (b, -1)):
        outs = []
        for eng, c in zip(engines, carry):
            eng.set_strategy(tree)
            state, done, rem, tk, ns = eng._run_chunk(4, eng.strategy, *c,
                                                      eos)
            c[:] = [state, done, rem]
            outs.append((tk.clone(), ns.clone()))
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
        torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=0)
    st = engines[0].graph_stats
    assert st["graphs"] == 1 and st["captures"] == 1 and st["replays"] == 20


def test_capture_tally_and_replays_keep_counts_exact_under_threads():
    """Threads count launches directly, inside their own capture tallies
    (which must not reach the counts) and through replays of those
    tallies, while another thread reads the counts: every count ends
    exact."""
    w1 = launch.Counted(lambda: None)
    w2 = launch.Counted(lambda: None)
    w1.launches = w2.launches = 0
    n_threads, direct, replays = 8, 200, 50
    errors = []

    def worker():
        try:
            for _ in range(direct):
                launch.count(w1)
            with launch.CaptureTally() as tally:
                for _ in range(3):
                    launch.count(w1)
                for _ in range(2):
                    launch.count(w2)
            assert tally.counts == {w1: 3, w2: 2}
            for _ in range(replays):
                tally.replayed()
        except Exception as e:          # reported by the main thread
            errors.append(e)

    stop = threading.Event()

    def reader():
        while not stop.is_set():
            assert w1.launches >= 0 and w2.launches >= 0

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        r = threading.Thread(target=reader)
        r.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        r.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads + [r])
    assert not errors, errors
    assert w1.launches == n_threads * (direct + 3 * replays)
    assert w2.launches == n_threads * 2 * replays
    with launch.CaptureTally():
        with pytest.raises(RuntimeError):
            launch.CaptureTally().__enter__()


def test_measure_acceptance_equals_jax():
    """Two same-shape trees measured on one engine each side (the
    reference's ``tests/test_engine_batched.py`` reuse): the acceptance
    lengths equal the JAX ones exactly, and on the port's graph path both
    trees replay one captured step."""
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = _setup(ARCHS[0])
    prompts = [{"tokens": toks}, {"tokens": toks[:1]}]
    ja, jb = _same_shape_specs(JT)
    ta, tb = _same_shape_specs(TT)
    jeng = JSpec(jm, jh, jp, ja, max_len=64)
    teng = TSpec(tm, th, tp, ta, max_len=64)
    teng._graphed = True
    for js, ts in ((ja, ta), (jb, tb)):
        want = j_measure(jm, jh, jp, js, prompts, n_tokens=10, engine=jeng)
        got = t_measure(tm, th, tp, ts, prompts, n_tokens=10, engine=teng)
        assert got == want
        assert 1.0 <= got <= ts.max_depth
    st = teng.graph_stats
    assert st["graphs"] == 2 and st["replays"] > 0     # B = 2 and B = 1
    assert t_measure(tm, th, tp, ta, prompts[:1], n_tokens=10,
                     max_len=64) == j_measure(jm, jh, jp, ja, prompts[:1],
                                              n_tokens=10, max_len=64)


@pytest.mark.parametrize("paged", [False, True])
def test_time_step_times_the_chunk_and_restores(paged):
    """A finite positive time per step through the engine's chunk (the
    static-buffer step here); the strategy and tree kernel come back as
    they were; the overlap partition times too and the mode comes back;
    the measurement's graphs are released once timed."""
    kw = dict(paged=True, page_size=4, kv_dtype="int8") if paged else {}
    eng = _engine("spec", kw, graphed=True, arch=ARCHS[0], max_len=48,
                  chunk=2)
    strategy, kernel = eng.strategy, eng.tree_kernel
    other = eng.strategy_for(TT.build_tree(TT.default_accs(4, 4), 4))
    t = eng.time_step(other, batch=2, prompt_len=8, reps=2,
                      tree_kernel="sparse" if paged else None,
                      hcmp="inline")
    assert np.isfinite(t) and t > 0
    assert eng.strategy is strategy and eng.tree_kernel == kernel
    assert eng.graph_stats["replays"] == 2 * 3       # capture, then 2 reps
    assert eng.graph_stats["graphs"] == 0
    t = eng.time_step(batch=2, prompt_len=8, reps=2, hcmp="overlap")
    assert np.isfinite(t) and t > 0
    assert eng.hcmp == "inline" and eng.tree_kernel == kernel
    assert eng.strategy is strategy
    assert eng.hcmp_stats["chunks"] == 2 + 2          # warm-up, capture, reps
    assert eng.graph_stats["replays"] == 2 * 3 * 2
    assert eng.graph_stats["graphs"] == 0


def _strip_comments(src):
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    return re.sub(r"//[^\n]*", "", src)


def test_no_smem_attribute_call_outside_raise_smem():
    """Every kernel's dynamic shared-memory attribute is raised by
    ``attention_common.cuh::raise_smem`` (once per instance and device, one
    fixed value): no CUDA source calls ``cudaFuncSetAttribute`` anywhere
    else, so no launch sets it per call, races another thread's setting,
    or makes that call inside a stream capture."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    assert {p.name for p in sources} >= {
        "verify_attention.cu", "paged_attention.cu", "tree_partial.cu",
        "attention_common.cuh", "flash_common.cuh"}
    sites = {}
    for p in sources:
        code = _strip_comments(p.read_text())
        sites[p.name] = [m.start() for m in
                         re.finditer(r"\bcudaFuncSetAttribute\b", code)]
        if p.name == "attention_common.cuh":
            head = code.index("inline cudaError_t raise_smem(")
            body = code[head:code.index("\n}\n", head)]
            assert len(sites[p.name]) == 1
            assert head < sites[p.name][0] < head + len(body)
        else:
            assert sites[p.name] == [], p.name
        if p.suffix == ".cu":
            assert "raise_smem(" in code, p.name
