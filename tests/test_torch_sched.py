"""The port's continuous-batching scheduler (``repro_torch/runtime/
continuous.py``) on the torch engine against the JAX ``ContinuousScheduler``
on the JAX engine, on the same traces and bridged weights.

The traces are drawn as ``tests/test_sched_fuzz.py`` draws them (random
prompt lengths, budgets and arrivals, a bank of 2 or 3 rows, a pool of 8
pages so a third concurrent reservation is deferred).  Every request must
emit exactly the JAX scheduler's tokens (``np.array_equal``) and the same
``n_emitted``, and both pools must drain and stay conserved.  The weights
are boosted as in ``tests/test_torch_engine.py``, so acceptance runs above
1 and rows commit chains of different lengths.  int8 pools serve
unchunked, as the reference's fuzz does: frozen-first-write scales make
the quantized values depend on the piece boundaries.
"""
import types

import numpy as np
import pytest
import torch

from repro.core.speculative import tree as JT
from repro.runtime import scheduler as JS
from repro.runtime.engine import BatchEngine as JBatch
from repro.runtime.engine import SpeculativeEngine as JSpec
from repro_torch.core.speculative import tree as TT
from repro_torch.runtime import continuous as TS
from repro_torch.runtime.engine import BatchEngine as TBatch
from repro_torch.runtime.engine import SpeculativeEngine as TSpec
from test_torch_engine import ARCHS, _setup

MAX_LEN, PAGE_SIZE, POOL_PAGES = 64, 8, 8
PROMPT_LENS = (3, 6, 14)
BUDGETS = (1, 2, 5, 9)
LAYOUTS = {"dense": (False, None), "paged": (True, None),
           "int8": (True, "int8")}
_ENGINES = {}

# (draft kind, layout, policy, prefill chunk, bank rows B, trace seed)
CASES = [
    ("seq", "dense", "fifo", 0, 2, 1),
    ("spec", "dense", "sjf", 4, 3, 2),
    ("spec", "dense", "lpt", 0, 2, 3),
    ("seq", "dense", "lpt", 4, 3, 4),
    ("seq", "paged", "sjf", 4, 2, 5),
    ("spec", "paged", "fifo", 4, 3, 6),
    ("spec", "paged", "lpt", 0, 2, 7),
    ("seq", "paged", "lpt", 4, 3, 8),
    ("spec", "paged", "sjf", 0, 2, 9),
    ("seq", "int8", "fifo", 0, 3, 10),
    ("spec", "int8", "sjf", 0, 2, 11),
    ("spec", "int8", "lpt", 0, 3, 12),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    test workers share the machine's cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(kind, layout):
    """(JAX engine, torch engine) of one configuration, built once."""
    key = (kind, layout)
    if key not in _ENGINES:
        cfg, jm, jp, jh, tm, tp, th, spec, tspec, _ = _setup(ARCHS[0])
        paged, kv_dtype = LAYOUTS[layout]
        kw = dict(max_len=MAX_LEN, chunk=4, paged=paged,
                  page_size=PAGE_SIZE,
                  pool_pages=POOL_PAGES if paged else None,
                  kv_dtype=kv_dtype)
        if kind == "spec":
            pair = (JSpec(jm, jh, jp, spec, **kw), TSpec(tm, th, tp, tspec,
                                                         **kw))
        else:
            pair = JBatch(jm, jp, **kw), TBatch(tm, tp, **kw)
        _ENGINES[key] = pair
    return _ENGINES[key]


def _trace(seed, vocab, n=None):
    rng = np.random.default_rng(seed)
    n = n or int(rng.integers(3, 7))
    out = []
    for i in range(n):
        plen = int(rng.choice(PROMPT_LENS))
        out.append(dict(
            req_id=i, tokens=rng.integers(0, vocab, plen).astype(np.int32),
            n_tokens=int(rng.choice(BUDGETS)),
            arrival=float(rng.choice([0.0, 0.02, 0.05]))))
    return out


def _reqs(mod, trace):
    return [mod.Request(**dict(r, tokens=r["tokens"].copy())) for r in trace]


def _same_results(tres, jres, what):
    assert [r.req_id for r in tres] == [r.req_id for r in jres]
    for t, j in zip(tres, jres):
        assert t.state == j.state == "DONE", (what, t.req_id)
        assert t.n_emitted == j.n_emitted, (what, t.req_id)
        assert len(t.tokens) == t.n_emitted
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens),
                                      err_msg=f"{what} req {t.req_id}")


@pytest.mark.parametrize("kind,layout,policy,prefill_chunk,B,seed", CASES)
def test_continuous_matches_jax(kind, layout, policy, prefill_chunk, B,
                                seed):
    jeng, teng = _engines(kind, layout)
    trace = _trace(seed, _setup(ARCHS[0])[0].vocab_size)
    jres, jstats = JS.ContinuousScheduler(
        jeng, batch=B, policy=policy,
        prefill_chunk=prefill_chunk).serve(_reqs(JS, trace))
    tres, tstats = TS.ContinuousScheduler(
        teng, batch=B, policy=policy,
        prefill_chunk=prefill_chunk).serve(_reqs(TS, trace))
    _same_results(tres, jres, (kind, layout, policy, prefill_chunk, B))
    assert tstats["admitted"] == jstats["admitted"] == len(trace)
    assert tstats["prefill_chunk"] == jstats["prefill_chunk"]
    for eng in (teng, jeng):
        assert eng.sched_pool_conserved() and eng.sched_drained()


@pytest.mark.parametrize("kind,layout", [("seq", "paged"),
                                         ("spec", "dense")])
def test_static_matches_jax(kind, layout):
    """``serve_static``: fixed groups in arrival order, one length per
    group, each group a ``generate`` call."""
    jeng, teng = _engines(kind, layout)
    rng = np.random.default_rng(21)
    trace = [dict(req_id=i, tokens=rng.integers(0, 200, 6).astype(np.int32),
                  n_tokens=int(rng.choice(BUDGETS)), arrival=0.01 * i)
             for i in range(5)]
    jres, _ = JS.serve_static(jeng, _reqs(JS, trace), batch=2)
    tres, tstats = TS.serve_static(teng, _reqs(TS, trace), batch=2)
    _same_results(tres, jres, ("static", kind, layout))
    assert tstats["device_steps"] > 0


def test_adaptive_switches_like_jax():
    """``AdaptiveSpeculation`` with a pre-built strategy set whose step
    times make the argmax leave the active width once the (boosted-heads)
    observation lands: both schedulers switch at the same boundaries and
    every request's tokens still equal the JAX run's."""
    cfg, jm, jp, jh, tm, tp, th, _, _, _ = _setup(ARCHS[0])
    specs = {pkg: {w: T.build_tree(T.default_accs(cfg.medusa_heads,
                                                  cfg.medusa_top_k), w)
                   for w in (2, 8)}
             for pkg, T in (("jax", JT), ("torch", TT))}

    def table(pkg):
        return {w: types.SimpleNamespace(
            width=w, tree=sp, acceptance=1.0 + 0.2 * w,
            step_time=1e-3 * w) for w, sp in specs[pkg].items()}

    max_len = MAX_LEN + max(sp.max_depth for sp in specs["jax"].values())
    jeng = JSpec(jm, jh, jp, specs["jax"][8], max_len=max_len, chunk=4)
    teng = TSpec(tm, th, tp, specs["torch"][8], max_len=max_len, chunk=4)
    trace = [dict(r, arrival=0.0) for r in _trace(31, cfg.vocab_size, n=5)]
    for r in trace:
        r["n_tokens"] = 9
    runs = {}
    for name, mod, eng in (("jax", JS, jeng), ("torch", TS, teng)):
        sched = mod.ContinuousScheduler(
            eng, batch=2, adaptive=mod.AdaptiveSpeculation(
                table(name), min_steps=4, switch_every=1))
        runs[name] = sched.serve(_reqs(mod, trace))
    (jres, jstats), (tres, tstats) = runs["jax"], runs["torch"]
    _same_results(tres, jres, "adaptive")
    assert tstats["strategy_switches"], "no switch happened: dead test"
    assert tstats["strategy_switches"] == jstats["strategy_switches"]
    assert tstats["width_final"] == jstats["width_final"]
    assert tstats["al_observed"] == pytest.approx(jstats["al_observed"])
