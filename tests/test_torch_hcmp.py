"""The port's HCMP executor split (``repro_torch/core/hcmp/executors.py``
and the engine's routing) against the inline engine and against the JAX
overlap engine, case for case with ``tests/test_hcmp.py``: on the CPU the
two executors are one serial executor, so these hold the schedule's
semantics (tokens, pre-draft lifecycle, page accounting, profiling,
guards); the second stream runs only on the card
(``tests/test_torch_card.py``).

Token streams must be equal (``np.array_equal``) and the pre-draft hit and
discard counts must equal the JAX runner's over the same call sequence.
The weights are the boosted ones of ``tests/test_torch_engine.py``, so
rows accept chains of different lengths.  ``graphed`` engines drive the
static-buffer overlap step the card captures (``ChunkGraphs(...,
capture=False)``).
"""
import numpy as np
import pytest
import torch

from repro.core import arca as JA
from repro.core.speculative import tree as JT
from repro.runtime import scheduler as JS
from repro.runtime.engine import SpeculativeEngine as JSpec
from repro_torch.core import arca as TA
from repro_torch.core.hcmp.executors import HcmpOverlapRunner, executor_pair
from repro_torch.core.speculative import tree as TT
from repro_torch.runtime import continuous as TS
from repro_torch.runtime.engine import BatchEngine as TBatch
from repro_torch.runtime.engine import SpeculativeEngine as TSpec
from test_torch_engine import ARCHS, _setup
from test_torch_sched import _reqs, _same_results, _trace

LAYOUTS = {"dense": {}, "paged fp32": dict(paged=True, page_size=8),
           "paged int8": dict(paged=True, page_size=8, kv_dtype="int8")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    test workers share the machine's cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(cfg, width):
    return (JT.build_tree(JT.default_accs(cfg.medusa_heads,
                                          cfg.medusa_top_k), width),
            TT.build_tree(TT.default_accs(cfg.medusa_heads,
                                          cfg.medusa_top_k), width))


def _pair(width, hcmp, *, graphed=False, **kw):
    """(JAX engine, torch engine) on the boosted smoke weights."""
    cfg, jm, jp, jh, tm, tp, th, _, _, _ = _setup(ARCHS[0])
    js, ts = _specs(cfg, width)
    jeng = JSpec(jm, jh, jp, js, hcmp=hcmp, **kw)
    teng = TSpec(tm, th, tp, ts, hcmp=hcmp, **kw)
    teng._graphed = graphed
    return jeng, teng


def _counts(stats):
    return {k: stats[k] for k in ("chunks", "steps", "predraft_hits",
                                  "predraft_discards")}


# --------------------------------------------------------------------------
# overlap == inline == the JAX overlap engine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_overlap_generate_matches_inline_and_jax(layout, graphed):
    """The overlapped draft/verify emits the inline engine's tokens and the
    JAX overlap engine's, dense, paged fp32 and paged int8; its pre-draft
    counts equal the JAX runner's; the inline engine builds no runner."""
    cfg, _, _, _, tm, tp, th, _, tspec, toks = _setup(ARCHS[0])
    kw = dict(max_len=64, chunk=4, **LAYOUTS[layout])
    jeng, over = _pair(8, "overlap", graphed=graphed, **kw)
    inline = TSpec(tm, th, tp, tspec, **kw)
    inline._graphed = graphed
    want, wst = jeng.generate({"tokens": toks}, 20)
    out_i, st_i = inline.generate({"tokens": toks}, 20)
    out_o, st_o = over.generate({"tokens": toks}, 20)
    np.testing.assert_array_equal(out_i, out_o)
    np.testing.assert_array_equal(out_o, np.asarray(want))
    np.testing.assert_array_equal(st_o["n_emitted"], st_i["n_emitted"])
    assert st_o["acceptance_length"] > 1.5        # multi-token commits ran
    hs = over.hcmp_stats
    assert hs["mode"] == "overlap" and hs["executors"] == 1
    assert hs["chunks"] >= 1 and hs["steps"] >= hs["chunks"]
    assert _counts(hs) == _counts(jeng.hcmp_stats)
    assert inline.hcmp_stats is None                # runner never built
    if graphed:
        g = over.graph_stats
        assert g["captures"] == 1 and g["replays"] > 0


def test_static_overlap_step_equals_eager_overlap_chunks():
    """The static-buffer overlap step (the one the card captures) against
    the overlap chunks run op by op, over two ``generate`` streams (the
    second's new K/V rebuild the key's graph) and a same-shape tree swap:
    equal tokens, equal pre-draft counts, and the graph keyed on the
    overlap partition."""
    cfg, _, _, _, tm, tp, th, _, _, toks = _setup(ARCHS[0])
    kw = dict(max_len=64, chunk=2, paged=True, page_size=8)
    _, eager_eng = _pair(8, "overlap", **kw)
    _, graph_eng = _pair(8, "overlap", graphed=True, **kw)
    other = TT.build_tree(TT.default_accs(cfg.medusa_heads, 3), 8)
    for step in range(3):
        if step == 2:
            for eng in (eager_eng, graph_eng):
                eng.set_tree(other)
        a, sa = eager_eng.generate({"tokens": toks}, 18)
        b, sb = graph_eng.generate({"tokens": toks}, 18)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sa["n_emitted"], sb["n_emitted"])
    assert _counts(eager_eng.hcmp_stats) == _counts(graph_eng.hcmp_stats)
    g = graph_eng.graph_stats
    assert g["graphs"] >= 1 and g["replays"] > 0 and g["captures"] >= 2
    assert all(k[0] == "overlap" for k in graph_eng._graphs._graphs)


def test_overlap_adaptive_switches_match_inline_and_jax():
    """Mid-stream strategy switches on an overlap engine stay output-
    neutral, the scheduler surfaces the runner's stats, the admissions and
    evictions force pre-draft discards, and every count equals the JAX
    overlap engine's under the same trace and table."""
    cfg, jm, jp, jh, tm, tp, th, _, _, _ = _setup(ARCHS[0])
    specs = {"jax": {}, "torch": {}}
    for w in (2, 8):
        specs["jax"][w], specs["torch"][w] = _specs(cfg, w)
    max_len = 64 + max(sp.max_depth for sp in specs["jax"].values())

    def table(arca):
        # each package's own Strategy table over a steep synthetic timer
        return arca.choose_strategy(
            cfg, JT.default_accs(cfg.medusa_heads, cfg.medusa_top_k), ctx=8,
            widths=(2, 8), time_fn=lambda c, w, ctx, s: 1e-3 * w)

    kw = dict(max_len=max_len, chunk=4, paged=True, page_size=8,
              hcmp="overlap")
    jeng = JSpec(jm, jh, jp, specs["jax"][8], **kw)
    teng = TSpec(tm, th, tp, specs["torch"][8], **kw)
    trace = [dict(r, arrival=0.0) for r in _trace(31, cfg.vocab_size, n=5)]
    for r in trace:
        r["n_tokens"] = 9
    runs = {}
    for name, mod, arca, eng in (("jax", JS, JA, jeng),
                                 ("torch", TS, TA, teng)):
        strategies = table(arca)
        assert all(isinstance(v, arca.Strategy) for v in strategies.values())
        sched = mod.ContinuousScheduler(
            eng, batch=2, adaptive=mod.AdaptiveSpeculation(
                strategies, min_steps=4, switch_every=1))
        runs[name] = sched.serve(_reqs(mod, trace))
    (jres, jstats), (tres, tstats) = runs["jax"], runs["torch"]
    _same_results(tres, jres, "overlap adaptive")
    assert tstats["strategy_switches"], "no switch happened: dead test"
    assert tstats["strategy_switches"] == jstats["strategy_switches"]
    assert tstats["hcmp"]["mode"] == "overlap"
    assert tstats["hcmp"]["predraft_discards"] >= 1
    assert _counts(tstats["hcmp"]) == _counts(jstats["hcmp"])
    solo = TSpec(tm, th, tp, specs["torch"][8], max_len=max_len, chunk=4)
    for r, req in zip(tres, _reqs(TS, trace)):
        out, _ = solo.generate({"tokens": req.tokens[None]}, req.n_tokens)
        np.testing.assert_array_equal(
            r.tokens, np.atleast_2d(out)[0][:req.n_tokens],
            err_msg=f"req {r.req_id} diverged under overlap+adaptive")


# --------------------------------------------------------------------------
# pre-draft lifecycle
# --------------------------------------------------------------------------
@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_predraft_reuse_and_invalidation_like_jax(graphed):
    """Quiet chunk boundaries inside one stream REUSE the dangling
    pre-draft; a new stream (bank epoch bump) DISCARDS it; the counts
    equal the JAX runner's after each stream."""
    cfg, _, _, _, _, _, _, _, _, _ = _setup(ARCHS[0])
    jeng, teng = _pair(4, "overlap", graphed=graphed, max_len=96, chunk=2)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32)
    for stream in range(2):
        want, _ = jeng.generate({"tokens": toks}, 24)
        got, _ = teng.generate({"tokens": toks}, 24)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert _counts(teng.hcmp_stats) == _counts(jeng.hcmp_stats)
        if stream == 0:
            hs1 = dict(teng.hcmp_stats)
            assert hs1["predraft_hits"] >= 1
            assert hs1["predraft_discards"] == 0    # nothing moved the bank
    hs2 = teng.hcmp_stats
    assert hs2["predraft_discards"] == hs1["predraft_discards"] + 1
    assert hs2["predraft_hits"] > hs1["predraft_hits"]


def test_runner_take_predraft_tags():
    """The slot is consumed once, and only an exact (epoch, strategy shape,
    batch) match is a hit."""
    cfg, _, _, _, tm, tp, th, _, tspec, _ = _setup(ARCHS[0])
    eng = TSpec(tm, th, tp, tspec, max_len=32, hcmp="overlap")
    r = HcmpOverlapRunner(tm, th)
    s8 = eng.strategy
    s4 = eng.strategy_for(TT.build_tree(TT.default_accs(4, 4), 4))
    tok = torch.zeros((2, 8), dtype=torch.int64)
    for epoch, strat, B, hit in ((1, s8, 2, True), (2, s8, 2, False),
                                 (1, s4, 2, False), (1, s8, 3, False)):
        r._predraft = (1, s8.shape(), 2, tok)
        got = r._take_predraft(epoch, strat, B)
        assert (got is tok) == hit and r._predraft is None
        assert r._take_predraft(epoch, strat, B) is None   # consumed
    assert (r.predraft_hits, r.predraft_discards) == (1, 3)


def test_overlap_abort_midflight_conserves_pages():
    """abort() lands at a chunk boundary while a pre-draft is dangling:
    the sweep releases every page, the stale pre-draft is discarded, the
    surviving requests' outputs are untouched, and the port's runner counts
    what the JAX runner counts over the same boundaries."""
    cfg, jm, jp, jh, tm, tp, th, _, _, _ = _setup(ARCHS[0])
    kw = dict(max_len=64, chunk=2, paged=True, page_size=8, hcmp="overlap")
    jeng, teng = _pair(4, **kw)
    trace = [dict(r, arrival=0.0) for r in _trace(41, cfg.vocab_size, n=3)]
    for r, n in zip(trace, (20, 8, 8)):
        r["n_tokens"] = n
    out = {}
    for name, mod, eng in (("jax", JS, jeng), ("torch", TS, teng)):
        reqs = _reqs(mod, trace)
        sched = mod.ContinuousScheduler(eng, batch=2, chunk=2)
        sched.start(reqs)
        i = 0
        while sched.has_work:
            i += 1
            assert i < 200, "abort trace did not converge"
            if i == 2:
                sched.abort(0)                       # mid-decode of req 0
            sched.boundary()
        out[name] = sched.finish(reqs)
    (jres, _), (tres, _) = out["jax"], out["torch"]
    assert tres[0].state == jres[0].state == "CANCELLED"
    _same_results(tres[1:], jres[1:], "survivors after abort")
    assert teng.sched_pool_conserved() and teng.sched_drained()
    assert teng._alloc.available == teng._alloc.n_pages
    assert teng.hcmp_stats["predraft_discards"] >= 1
    assert _counts(teng.hcmp_stats) == _counts(jeng.hcmp_stats)
    solo = TSpec(tm, th, tp, _specs(cfg, 4)[1], max_len=64, chunk=2)
    for r, req in zip(tres[1:], _reqs(TS, trace)[1:]):
        want, _ = solo.generate({"tokens": req.tokens[None]}, req.n_tokens)
        np.testing.assert_array_equal(r.tokens,
                                      np.atleast_2d(want)[0][:req.n_tokens])


# --------------------------------------------------------------------------
# ARCA partition profiling + engine guards
# --------------------------------------------------------------------------
@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_profile_engine_times_both_partitions(graphed):
    """An overlap-capable engine is profiled under BOTH partitions; the
    measured winner lands on ``Strategy.hcmp`` via choose_strategy;
    time_step's override always restores the engine's mode, and the
    measurement's graphs are released once timed."""
    cfg, _, _, _, _, _, _, _, _, _ = _setup(ARCHS[0])
    accs = TT.default_accs(cfg.medusa_heads, cfg.medusa_top_k)
    spec = TT.candidate_spec(accs, 2)
    _, eng = _pair(2, "overlap", graphed=graphed, max_len=64, chunk=2)
    tf = TA.profile_engine(eng, (2,), accs=accs, batch=1, prompt_len=8,
                           reps=1)
    assert tf.hcmp_modes == ("inline", "overlap")
    assert eng.hcmp == "overlap"                 # override restored
    key = (spec.width, spec.max_depth, spec.n_paths, 1)
    assert key + ("inline",) in tf.times and key + ("overlap",) in tf.times
    assert all(np.isfinite(t) and t > 0 for t in tf.times.values())
    part = tf.partition_for(spec)
    assert part == min(("inline", "overlap"),
                       key=lambda m: tf.times[key + (m,)])
    strategies = TA.choose_strategy(cfg, accs, ctx=8, widths=(2,),
                                    time_fn=tf)
    assert strategies[2].hcmp == part
    synth = TA.choose_strategy(cfg, accs, ctx=8, widths=(2,),
                               time_fn=lambda c, w, ctx, s: 1e-3)
    assert synth[2].hcmp == "inline"
    if graphed:
        assert eng.graph_stats["replays"] > 0 and eng.graph_stats[
            "graphs"] == 0                       # released once timed


def test_profile_engine_times_both_kernels_per_partition():
    """A sparse paged overlap engine: each (partition, kernel) pair is
    timed, each partition keeps its best kernel's time, and the engine's
    kernel and partition come back as they were."""
    cfg, _, _, _, _, _, _, _, _, _ = _setup(ARCHS[0])
    accs = TT.default_accs(cfg.medusa_heads, cfg.medusa_top_k)
    _, eng = _pair(4, "overlap", max_len=64, chunk=2, paged=True,
                   page_size=8, tree_kernel="sparse")
    tf = TA.profile_engine(eng, (4,), accs=accs, batch=2, prompt_len=8,
                           reps=1)
    assert tf.tree_kernels == ("dense", "sparse")
    spec = TT.candidate_spec(accs, 4)
    key = (spec.width, spec.max_depth, spec.n_paths, 2)
    for mode in ("inline", "overlap"):
        per = [tf.times[key + (mode, tk)] for tk in ("dense", "sparse")]
        assert tf.times[key + (mode,)] == min(per)
    assert (tf.partition_for(spec), tf.kernel_for(spec)) == min(
        ((m, k) for m in ("inline", "overlap") for k in ("dense", "sparse")),
        key=lambda mk: tf.times[key + mk])
    assert eng.tree_kernel == "sparse" and eng.hcmp == "overlap"


def test_overlap_guards():
    """No draft source -> no overlap; bogus modes rejected; profiling the
    overlap partition on a sequential engine is a typed error; on the CPU
    the executor pair is one serial executor, like the reference's single
    device."""
    cfg, jm, jp, jh, tm, tp, th, _, tspec, _ = _setup(ARCHS[0])
    seq = TBatch(tm, tp, max_len=32)
    assert not seq.hcmp_capable
    with pytest.raises(ValueError):
        seq.set_hcmp("overlap")
    with pytest.raises(ValueError):
        TA.profile_engine(seq, hcmp_modes=("overlap",))
    with pytest.raises(ValueError):
        TA.profile_engine(seq, tree_kernels=("sparse",))
    eng = TSpec(tm, th, tp, tspec, max_len=32)
    with pytest.raises(ValueError):
        eng.set_hcmp("fused")
    with pytest.raises(ValueError):
        TSpec(tm, th, tp, tspec, max_len=32, hcmp="fused")
    with pytest.raises(ValueError):
        HcmpOverlapRunner(tm, th).run_chunk(
            tp, seq.strategy, None, None, None, 1, -1, 0)
    v, d = executor_pair("cpu")
    assert v == d == torch.device("cpu")
    eng.set_hcmp("overlap")
    assert eng.hcmp_executors == ("cpu", "cpu")
    assert eng.hcmp_stats["executors"] == 1
