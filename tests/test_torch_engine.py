"""The port's serving engines against the JAX engines: greedy token streams
must be identical (``np.array_equal``) on the same prompts and bridged
weights, at smoke size in fp32.

The weights are the reference's random init with one boost applied in numpy
to both copies: embedding column 0 is set to 1 and a weight from it to token
7 is raised in the LM head and in every Medusa head, so the heads often
guess the model's next tokens and acceptance runs well above 1 (rows accept
chains of different lengths, so cache positions diverge).
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.core.speculative import tree as JT
from repro.core.speculative.medusa import init_medusa as j_init_medusa
from repro.models.api import get_model as j_get_model
from repro.runtime.engine import BatchEngine as JBatch
from repro.runtime.engine import SpeculativeEngine as JSpec
from repro_torch.bridge import heads_from_jax, params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.speculative import tree as TT
from repro_torch.data.pipeline import MarkovDataset
from repro_torch.models.api import get_model as t_get_model
from repro_torch.runtime.engine import BatchEngine as TBatch
from repro_torch.runtime.engine import SpeculativeEngine as TSpec

BOOST = 4.0
ARCHS = ["qwen2-0.5b-smoke", "vicuna-7b-smoke"]
_SETUPS = {}


def _setup(arch, boost=BOOST):
    """(cfg, JAX model, params, heads, port model, params, heads, JAX and
    port W=8 trees, prompts), built once per (arch, boost)."""
    key = (arch, boost)
    if key not in _SETUPS:
        cfg = get_config(arch)
        jm = j_get_model(cfg)
        jp = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(0)))
        jh = jax.tree.map(np.array, j_init_medusa(cfg, jax.random.PRNGKey(1)))
        jp["embed"][:, 0] = 1.0
        if cfg.tie_embeddings:
            jp["embed"][7, 0] += boost
        else:
            jp["lm_head"][0, 7] += boost
        jh["out"][:, 0, 7] += boost
        tcfg = t_get_config(arch)
        tm = t_get_model(tcfg)
        tp = params_from_jax(tcfg, jp, device="cpu")
        th = heads_from_jax(tcfg, jh, device="cpu")
        spec = JT.build_tree(JT.default_accs(cfg.medusa_heads,
                                             cfg.medusa_top_k), 8)
        tspec = TT.build_tree(TT.default_accs(tcfg.medusa_heads,
                                              tcfg.medusa_top_k), 8)
        assert np.array_equal(spec.mask, tspec.mask)
        toks = MarkovDataset(cfg.vocab_size, seed=1).sample(
            2, 12, seed=7)[:, :-1].astype(np.int32)
        _SETUPS[key] = (cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks)
    return _SETUPS[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_engine_tokens_equal_jax(arch):
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = _setup(arch)
    N = 20
    max_len = toks.shape[1] + N + spec.max_depth
    jo, js = JSpec(jm, jh, jp, spec, max_len=max_len, chunk=4).generate(
        {"tokens": toks}, N)
    to, ts = TSpec(tm, th, tp, tspec, max_len=max_len, chunk=4).generate(
        {"tokens": toks}, N)
    assert np.array_equal(np.asarray(jo), to)
    np.testing.assert_array_equal(ts["n_emitted"], np.asarray(js["n_emitted"]))
    assert ts["acceptance_length"] == pytest.approx(js["acceptance_length"])
    assert ts["steps"] == js["steps"]
    assert ts["acceptance_length"] > 1.5          # multi-token commits ran


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_engine_tokens_equal_jax(arch):
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = _setup(arch)
    N = 20
    max_len = toks.shape[1] + N
    jo, js = JBatch(jm, jp, max_len=max_len, chunk=4).generate(
        {"tokens": toks}, N)
    to, ts = TBatch(tm, tp, max_len=max_len, chunk=4).generate(
        {"tokens": toks}, N)
    assert np.array_equal(np.asarray(jo), to)
    np.testing.assert_array_equal(ts["n_emitted"], np.asarray(js["n_emitted"]))


@pytest.mark.parametrize("engine", ["speculative", "batch"])
def test_capacity_freeze_matches_jax(engine):
    """A cache too small for the budget freezes rows at the capacity
    boundary; tokens and ``n_emitted`` shortfall equal the reference's."""
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = _setup(ARCHS[1])
    N, max_len = 24, toks.shape[1] + 10
    budgets = np.array([N, N - 5], np.int32)
    if engine == "speculative":
        jeng = JSpec(jm, jh, jp, spec, max_len=max_len, chunk=4)
        teng = TSpec(tm, th, tp, tspec, max_len=max_len, chunk=4)
    else:
        jeng = JBatch(jm, jp, max_len=max_len, chunk=4)
        teng = TBatch(tm, tp, max_len=max_len, chunk=4)
    jo, js = jeng.generate({"tokens": toks}, budgets)
    to, ts = teng.generate({"tokens": toks}, budgets)
    assert np.array_equal(np.asarray(jo), to)
    np.testing.assert_array_equal(ts["n_emitted"], np.asarray(js["n_emitted"]))
    assert (ts["n_emitted"] < budgets).all()       # the freeze did bite


def test_speculative_equals_sequential_on_the_port():
    """Greedy verification is lossless: the port's speculative stream is the
    port's sequential stream, and B=1 returns the 1-D legacy shape."""
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = _setup(ARCHS[0])
    N = 20
    so, ss = TSpec(tm, th, tp, tspec, max_len=toks.shape[1] + N
                   + tspec.max_depth, chunk=8).generate({"tokens": toks}, N)
    bo, _ = TBatch(tm, tp, max_len=toks.shape[1] + N, chunk=8).generate(
        {"tokens": toks}, N)
    assert np.array_equal(so, bo)
    assert ss["device_steps"] < N - 1             # speculation saved steps
    one, _ = TSpec(tm, th, tp, tspec, max_len=toks.shape[1] + N
                   + tspec.max_depth, chunk=8).generate(
                       {"tokens": toks[:1]}, N)
    assert one.shape == (N,) and np.array_equal(one, bo[0])


@pytest.mark.parametrize("engine", ["speculative", "batch"])
@pytest.mark.parametrize("option", ["eos", "window"])
def test_eos_and_sliding_window_match_jax(engine, option):
    """EOS truncation (each row stops at its first EOS, the tail padded
    with it) and a sliding-window ring smaller than prompt + budget (the
    prefill keeps the ring's tail, decode wraps) give the reference's
    tokens and counts."""
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = _setup(ARCHS[1])
    N = 16
    kw = {"max_len": toks.shape[1] + N + spec.max_depth, "chunk": 4}
    run = {}
    if option == "window":
        kw["window"] = 8
    else:
        probe, _ = TBatch(tm, tp, max_len=kw["max_len"]).generate(
            {"tokens": toks}, N)
        run["eos"] = int(probe[0, N // 2])     # a token row 0 emits
    if engine == "speculative":
        jeng = JSpec(jm, jh, jp, spec, **kw)
        teng = TSpec(tm, th, tp, tspec, **kw)
    else:
        jeng = JBatch(jm, jp, **kw)
        teng = TBatch(tm, tp, **kw)
    jo, js = jeng.generate({"tokens": toks}, N, **run)
    to, ts = teng.generate({"tokens": toks}, N, **run)
    assert np.array_equal(np.asarray(jo), to)
    np.testing.assert_array_equal(ts["n_emitted"], np.asarray(js["n_emitted"]))
    if option == "eos":
        assert ts["n_emitted"][0] <= N // 2 + 1


def test_sequential_step_freezes_done_rows_like_jax():
    """A done row still decodes, but its ``key_pos``/``pos`` and carry are
    restored: the cache bookkeeping after one masked step equals the
    reference's."""
    import jax.numpy as jnp
    import torch
    from repro.core.speculative.verify import SpecState as JState
    from repro.runtime.engine import _prefill_state as j_prefill
    from repro.runtime.engine import _seq_step as j_seq_step
    from repro_torch.runtime.engine import _prefill_state as t_prefill
    from repro_torch.runtime.engine import _seq_step as t_seq_step
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = _setup(ARCHS[1])
    active = np.array([True, False])
    js = j_prefill(jm, jp, None, {"tokens": jnp.asarray(toks)}, max_len=16,
                   window=0)
    ts = t_prefill(tm, tp, None, {"tokens": torch.from_numpy(toks)},
                   max_len=16, window=0)
    for _ in range(2):
        js, jtok, jn = j_seq_step(jm, jp, js, backend="ref",
                                  active=jnp.asarray(active))
        ts, ttok, tn = t_seq_step(tm, tp, ts, active=torch.from_numpy(active))
    assert isinstance(js, JState)
    np.testing.assert_array_equal(ts.cache.kv.key_pos.numpy(),
                                  np.asarray(js.cache.kv.key_pos))
    np.testing.assert_array_equal(ts.cache.kv.pos.numpy(),
                                  np.asarray(js.cache.kv.pos))
    np.testing.assert_array_equal(ts.cur_token.numpy(),
                                  np.asarray(js.cur_token))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(ts.cache.kv.pos[1]) == toks.shape[1]      # frozen row


def test_set_strategy_switches_tree_like_jax():
    """``set_strategy`` takes a TreeSpec of the engine's draft kind (the
    reference's runtime switch) and refuses to change the draft kind."""
    from repro_torch.runtime.engine import DecodeStrategy
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = _setup(ARCHS[0])
    N = 12
    accs = JT.default_accs(cfg.medusa_heads, cfg.medusa_top_k)
    small = JT.build_tree(accs, 4)
    kw = {"max_len": toks.shape[1] + N + spec.max_depth, "chunk": 4}
    jeng, teng = JSpec(jm, jh, jp, spec, **kw), TSpec(tm, th, tp, tspec, **kw)
    jeng.set_strategy(small)
    teng.set_strategy(TT.build_tree(TT.default_accs(cfg.medusa_heads,
                                                    cfg.medusa_top_k), 4))
    assert teng.strategy.width == 4
    jo, _ = jeng.generate({"tokens": toks}, N)
    to, _ = teng.generate({"tokens": toks}, N)
    assert np.array_equal(np.asarray(jo), to)
    with pytest.raises(ValueError):
        teng.set_strategy(DecodeStrategy.sequential("cpu"))
