"""The captured prefill calls (``repro_torch/runtime/graphs.py``
``PieceGraphs``) on the CPU, where no graph can be captured: an engine with
``_graphed`` set runs the same static-buffer pieces, called once a replay,
and every bank row they leave must equal the eager path's (block table,
``key_pos``, ``pos``, pool entries, ``cur_token``, ``hidden``), as must
the scheduler's token streams.  Also: the warm-up writes only the trash
page, a first token outlives later replays, the calls that must stay eager
do (``piece_eager``), and the benchmark's reader of the ``graphed`` span
attribute.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.speculative import tree as T
from repro_torch.core.speculative.medusa import init_medusa
from repro_torch.models.api import get_model
from repro_torch.runtime import continuous as TS
from repro_torch.runtime import trace
from repro_torch.runtime.engine import BatchEngine, SpeculativeEngine, eager
from repro_torch.runtime.graphs import piece_widths

ARCH, MOE = "qwen2-0.5b-smoke", "qwen3-moe-30b-a3b-smoke"
C = 8                       # the scheduler's piece width: widths 2, 4, 8
B = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = get_config(arch)
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    heads = init_medusa(cfg, torch.Generator().manual_seed(1))
    return cfg, model, params, heads


def _engine(*, graphed, arch=ARCH, drafted=True, width=C, **kw):
    cfg, model, params, heads = _model(arch)
    kw = dict(dict(max_len=64, chunk=2, paged=True, page_size=4), **kw)
    if drafted:
        spec = T.build_tree(T.default_accs(cfg.medusa_heads,
                                           cfg.medusa_top_k), 4)
        eng = SpeculativeEngine(model, heads, params, spec, **kw)
    else:
        eng = BatchEngine(model, params, **kw)
    eng._graphed = graphed       # the card's path, without capture
    eng.sched_piece_width(width)
    return eng


def _prompt(rng, S):
    return rng.integers(0, 500, (1, S)).astype(np.int32)


def _bank(eng, seed=0):
    """A bank of B rows bootstrapped as the scheduler does, row 0 live."""
    p = _prompt(np.random.default_rng(seed), 6)
    row = eng.sched_prefill({"tokens": p})
    bank = eng.sched_blank(row, B)
    return eng.sched_insert(bank, 0, row, prompt_len=6, n_tokens=8)


def _row(state, b):
    """Row ``b`` of a paged bank: its bookkeeping, carry and pool pages."""
    kv = state.cache.kv
    pages = kv.block_table[b]
    pages = pages[pages >= 0].long()
    return dict(block_table=kv.block_table[b], key_pos=kv.key_pos[b],
                pos=kv.pos[b], cur_token=state.cur_token[b],
                hidden=None if state.hidden is None else state.hidden[b],
                k=kv.pool_k[:, pages], v=kv.pool_v[:, pages])


def _same_rows(a, b):
    for name in ("block_table", "key_pos", "pos", "cur_token"):
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0,
                                   msg=name)
    for name in ("hidden", "k", "v"):
        if a[name] is None:
            assert b[name] is None
            continue
        torch.testing.assert_close(a[name], b[name], rtol=2e-5, atol=2e-5,
                                   msg=name)


def _both(fn, **kw):
    """``fn(engine, rng)`` on a graphed and an eager engine, from the same
    seed: their results."""
    return [fn(_engine(graphed=g, **kw), np.random.default_rng(7))
            for g in (True, False)]


# the admission at each width: 1 token, each width's edge, one past it
@pytest.mark.parametrize("drafted", [True, False])
@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 8])
def test_admission_at_each_width_leaves_the_row_as_eager(S, drafted):
    def run(eng, rng):
        bank = _bank(eng)
        bank, first = eng.sched_admit(bank, 1, {"tokens": _prompt(rng, S)},
                                      n_tokens=6, reserve_len=S)
        return eng, bank, first

    (g, gs, gf), (e, es, ef) = _both(run, drafted=drafted)
    _same_rows(_row(gs, 1), _row(es, 1))
    _same_rows(_row(gs, 0), _row(es, 0))
    assert int(gf) == int(ef)
    # the first engaging call built every width and the piece, once
    assert len(g._pieces) == len(piece_widths(C)) + 1
    assert g.graph_stats["captures"] == len(g._pieces)
    assert g.graph_stats["piece_replays"] == 1
    assert g.graph_stats["piece_eager"] == e.graph_stats["piece_eager"] - 1
    assert int(gs.cache.kv.pos[1]) == S


# extension pieces: a full one and a padded tail
@pytest.mark.parametrize("drafted", [True, False])
@pytest.mark.parametrize("tail", [C, 3, 1])
def test_extension_pieces_leave_the_row_as_eager(tail, drafted):
    def run(eng, rng):
        bank = _bank(eng)
        prompt = _prompt(rng, 2 * C + tail)
        bank, _ = eng.sched_admit(bank, 2, {"tokens": prompt[:, :C]},
                                  n_tokens=6, reserve_len=prompt.shape[1])
        lasts = []
        for lo in (C, 2 * C):
            piece = np.zeros((1, C), np.int32)
            n = min(C, prompt.shape[1] - lo)
            piece[0, :n] = prompt[0, lo:lo + n]
            bank, last = eng.sched_extend(bank, 2, piece, n)
            lasts.append(int(last))
        return eng, bank, lasts

    (g, gs, gl), (e, es, el) = _both(run, drafted=drafted)
    _same_rows(_row(gs, 2), _row(es, 2))
    _same_rows(_row(gs, 0), _row(es, 0))
    assert gl == el
    assert int(gs.cache.kv.pos[2]) == 2 * C + tail
    assert g.graph_stats["piece_replays"] == 3
    assert g.graph_stats["captures"] == len(piece_widths(C)) + 1


@pytest.mark.parametrize("drafted,width,policy,seed", [
    (True, 8, "fifo", 1), (False, 8, "sjf", 2), (True, 4, "lpt", 3)])
def test_scheduler_streams_equal_the_eager_engine(drafted, width, policy,
                                                  seed):
    """Greedy streams through ``ContinuousScheduler`` with chunked prefill
    (whole-prompt admissions at each width, first pieces and padded
    tails) equal the eager engine's, and the pools drain."""
    rng = np.random.default_rng(seed)
    reqs = [dict(req_id=i, tokens=rng.integers(0, 500, int(S)).astype(
        np.int32), n_tokens=int(n), arrival=0.0)
        for i, (S, n) in enumerate(zip(rng.integers(1, 3 * width, 9),
                                       rng.integers(2, 7, 9)))]
    runs = []
    for graphed in (True, False):
        eng = _engine(graphed=graphed, drafted=drafted, width=0)
        res, stats = TS.ContinuousScheduler(
            eng, batch=B, policy=policy, prefill_chunk=width).serve(
                [TS.Request(**dict(r, tokens=r["tokens"].copy()))
                 for r in reqs])
        assert eng.sched_pool_conserved() and eng.sched_drained()
        runs.append((eng, res))
    (geng, gres), (peng, pres) = runs
    for g, p in zip(gres, pres):
        assert g.state == p.state == "DONE"
        np.testing.assert_array_equal(g.tokens, p.tokens)
    gs = geng.graph_stats
    # every call but the bank's bootstrap replayed a piece
    assert gs["piece_eager"] == 1 and gs["piece_replays"] == \
        peng.graph_stats["piece_eager"] - 1
    assert geng._piece_C == width


def test_warm_up_touches_only_the_trash_page():
    """Building the pieces (each warmed up with a real length of 0) leaves
    every reservable page of the pool and the bank's rows as they were."""
    eng = _engine(graphed=True)
    bank = _bank(eng)
    kv = bank.cache.kv
    before = (kv.pool_k[:, :-1].clone(), kv.pool_v[:, :-1].clone())
    rows = {f: getattr(kv, f).clone() for f in ("block_table", "key_pos",
                                                  "pos")}
    eng._pieces.build(eng._piece_fns(C), bank, C)
    assert eng.graph_stats["captures"] == len(piece_widths(C)) + 1
    torch.testing.assert_close(kv.pool_k[:, :-1], before[0], rtol=0, atol=0)
    torch.testing.assert_close(kv.pool_v[:, :-1], before[1], rtol=0, atol=0)
    for f, t in rows.items():
        torch.testing.assert_close(getattr(kv, f), t, rtol=0, atol=0)
    assert eng.graph_stats["piece_replays"] == 0


def test_first_token_survives_later_replays():
    """An admission's first token, an unsynced device scalar the scheduler
    reads after the chunk, is not overwritten by the next admission's or
    piece's replay of the same graph."""
    def run(eng, rng):
        bank = _bank(eng)
        bank, first = eng.sched_admit(bank, 1, {"tokens": _prompt(rng, 3)},
                                      n_tokens=6, reserve_len=3)
        bank, _ = eng.sched_admit(bank, 2, {"tokens": _prompt(rng, 4)},
                                  n_tokens=6, reserve_len=12)
        piece = np.zeros((1, C), np.int32)
        piece[0, :5] = _prompt(rng, 5)
        bank, _ = eng.sched_extend(bank, 2, piece, 5)
        return eng, bank, first

    (g, gs, gf), (_, es, ef) = _both(run)
    assert g.graph_stats["piece_replays"] == 3
    assert int(gf) == int(ef) == int(gs.cur_token[1])
    _same_rows(_row(gs, 1), _row(es, 1))
    _same_rows(_row(gs, 2), _row(es, 2))


def _vlm_batch(rng, S):
    cfg = _model("llava-next-mistral-7b-smoke")[0]
    return {"tokens": _prompt(rng, S), "patch_embeds": torch.from_numpy(
        rng.standard_normal((1, 2, cfg.d_model)).astype(np.float32))}


# calls that stay eager: (label, engine keywords, admitted prompt length,
# batch maker)
EAGER_CASES = {
    "int8 pool": (dict(kv_dtype="int8"), 4, None),
    "embed batch": (dict(arch="llava-next-mistral-7b-smoke"), 4, _vlm_batch),
    "recurrent family": (dict(arch="zamba2-7b-smoke"), 4, None),
    "longer than C": ({}, C + 3, None),
    "eager()": ({}, 4, None),
}


@pytest.mark.parametrize("label", list(EAGER_CASES))
def test_calls_that_stay_eager(label):
    """int8 pools, embed batches, recurrent families, admissions longer
    than C and calls inside ``eager()`` replay nothing: each counts as
    ``piece_eager`` and leaves the bank as the engine without graphs
    does."""
    kw, S, batch = EAGER_CASES[label]

    def run(eng, rng):
        bank = _bank(eng)
        ctx = eager() if label == "eager()" else _nothing()
        with ctx:
            b = batch(rng, S) if batch else {"tokens": _prompt(rng, S)}
            bank, first = eng.sched_admit(bank, 1, b, n_tokens=6,
                                          reserve_len=S + 2)
        return eng, bank, first

    (g, gs, gf), (e, es, ef) = _both(run, **kw)
    assert g.graph_stats["piece_replays"] == 0
    assert g.graph_stats["captures"] == 0
    assert g.graph_stats["piece_eager"] == e.graph_stats["piece_eager"] == 2
    assert int(gf) == int(ef)
    if gs.cache.kv is not None and kw.get("arch") != "zamba2-7b-smoke":
        _same_rows(_row(gs, 1), _row(es, 1))


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# a model with experts: admissions padded to the next width (1 -> 2,
# 3 -> 4, 5 -> 8) and one at a width's size, each followed by a padded piece
@pytest.mark.parametrize("S", [1, 3, 5, 8])
def test_a_padded_moe_admission_replays_and_equals_eager(S):
    """A model with experts routes every choice of every token, the pad's
    too, so the pad changes no real token's output: its admission pads to
    the next width and replays as the dense model's does, and so does its
    padded piece; the rows and tokens equal the eager engine's."""
    def run(eng, rng):
        bank = _bank(eng)
        bank, first = eng.sched_admit(bank, 1, {"tokens": _prompt(rng, S)},
                                      n_tokens=6, reserve_len=S + 5)
        piece = np.zeros((1, C), np.int32)
        piece[0, :5] = _prompt(rng, 5)
        bank, last = eng.sched_extend(bank, 1, piece, 5)
        return eng, bank, (int(first), int(last))

    (g, gs, gt), (e, es, et) = _both(run, arch=MOE)
    assert g.graph_stats["piece_replays"] == 2
    assert g.graph_stats["piece_eager"] == e.graph_stats["piece_eager"] - 2
    assert gt == et
    _same_rows(_row(gs, 1), _row(es, 1))
    _same_rows(_row(gs, 0), _row(es, 0))


def test_prefill_spans_carry_the_graphed_attribute():
    """The tracer's ``engine.prefill``/``engine.extend`` spans say whether
    a replayed piece landed their tokens, and the benchmark's reader of
    ``engine.prefill_graphed_share`` turns them into the share of tokens."""
    from portbench import spec
    eng = _engine(graphed=True)
    rng = np.random.default_rng(3)
    trace.TRACER.clear()
    trace.enable()
    try:
        bank = _bank(eng)                                  # eager, 6 tokens
        bank, _ = eng.sched_admit(bank, 1, {"tokens": _prompt(rng, 8)},
                                  n_tokens=6, reserve_len=12)
        piece = np.zeros((1, C), np.int32)
        bank, _ = eng.sched_extend(bank, 1, piece, 4)
    finally:
        trace.disable()
    snap = trace.snapshot()
    got = [(s.name, s.tokens, s.graphed) for s in snap["spans"]
           if s.name in ("engine.prefill", "engine.extend")]
    assert got == [("engine.prefill", 6, 0), ("engine.prefill", 8, 1),
                   ("engine.extend", 4, 1)]
    assert all(s.graphed is None for s in snap["spans"]
               if s.name not in ("engine.prefill", "engine.extend"))
    read = spec.reader("engine.prefill_graphed_share").read
    ctx = SimpleNamespace(trace=dict(t0=0.0, t1=1e12), tracer=snap)
    assert read(ctx) == pytest.approx(12 / 18)
    # a program whose spans carry no such attribute reads nothing
    old = [s._replace(graphed=None) for s in snap["spans"]]
    assert read(SimpleNamespace(trace=ctx.trace,
                                tracer=dict(snap, spans=old))) is None
