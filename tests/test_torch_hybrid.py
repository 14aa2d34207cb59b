"""The port's hybrid family (Zamba2: Mamba2 layers and a weight-shared
attention block) against the JAX reference (``zamba2-7b`` smoke config,
float32, CPU), with the helpers of ``tests/test_torch_moe.py``.

Mamba2 (``models/mamba2.py``): ``mamba_step`` and the chunked
``mamba_prefill`` within 2e-5 of the reference's, and the chunked prefill
against its own time scan as ``tests/test_mamba_chunked.py`` holds the
reference's (2e-3, state carried across calls).  Recurrent verify
(``models/recurrent_verify.py``): ``path_verify`` and
``select_committed_state`` within 2e-5.  The model through prefill,
verify, commit and decode: logits within 2e-5.  Greedy streams equal the
JAX engines' on the dense and paged engines, the static-buffer graph step
and the continuous scheduler, whose evicted rows keep a zeroed recurrent
state (``tests/test_scheduler.py:117``); the HCMP overlap engine equals
the inline one and a tree swap of another shape re-sizes the per-depth
states.  ``lm_loss`` grads within 5e-5 x max|g| (see
``test_training_parity``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.speculative import tree as JT
from repro.models import mamba2 as jmb
from repro.models import recurrent_verify as jrv
from repro.models.api import get_model as j_get_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.speculative import tree as TT
from repro_torch.models import hybrid as thy
from repro_torch.models import mamba2 as tmb
from repro_torch.models import recurrent_verify as trv
from repro_torch.runtime import cache as tcache
from repro_torch.runtime import continuous as TS
from repro_torch.runtime.engine import SpeculativeEngine as TSpec
from test_torch_moe import (N, continuous_equal_jax, engine_pair,
                            engines_equal_jax, family_setup, int8_verify_gap,
                            logits_match, lm_loss_and_grads_match)
from test_torch_sched import _reqs

ARCH = "zamba2-7b-smoke"
TOL = 2e-5
HYBRID_GRAD_TOL = 5e-5         # x the leaf's max |g|; see test_training_parity


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


_MAMBA = {}


def _mamba():
    """(cfg, JAX layer params, the port's, the port cfg) of one Mamba2
    layer, and a seeded state."""
    if not _MAMBA:
        cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
        jp = jax.tree.map(np.array, jmb.mamba_init(cfg,
                                                   jax.random.PRNGKey(3)))
        # nonzero biases and decays, so every term of the step is exercised
        rng = np.random.default_rng(0)
        for k in ("A_log", "dt_bias", "conv_bx", "conv_bbc"):
            jp[k] = (0.3 * rng.standard_normal(jp[k].shape)).astype(
                jp[k].dtype)
        di, nh, hd, N_ = jmb.dims(cfg)
        st = {"ssm": rng.standard_normal((3, nh, hd, N_)).astype(np.float32),
              "conv": rng.standard_normal((3, cfg.ssm_conv - 1, di + 2 * N_))
              .astype(np.float32)}
        _MAMBA.update(cfg=cfg, tcfg=tcfg, jp=jp,
                      tp=params_from_jax(tcfg, jp, device="cpu"), st=st)
    m = _MAMBA
    return m["cfg"], m["tcfg"], m["jp"], m["tp"], m["st"]


def _jst(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def _tst(st):
    return {k: _t(v) for k, v in st.items()}


# --------------------------------------------------------------------------
# Mamba2
# --------------------------------------------------------------------------
def test_mamba_step_matches_reference():
    cfg, tcfg, jp, tp, st = _mamba()
    x = np.random.default_rng(1).standard_normal(
        (3, cfg.d_model)).astype(np.float32)
    jo, jst = jmb.mamba_step(cfg, jax.tree.map(jnp.asarray, jp),
                             jnp.asarray(x), _jst(st))
    to, tst = tmb.mamba_step(tcfg, tp, _t(x), _tst(st))
    _close(to, jo)
    _close(tst["ssm"], jst["ssm"])
    _close(tst["conv"], jst["conv"])
    # the same step writing its state into a given slot
    slot = {"ssm": torch.empty_like(tst["ssm"]),
            "conv": torch.empty_like(tst["conv"])}
    to2, tst2 = tmb.mamba_step(tcfg, tp, _t(x), _tst(st), out=slot)
    assert tst2["ssm"] is slot["ssm"]
    assert torch.equal(to2, to) and torch.equal(slot["ssm"], tst["ssm"])


@pytest.mark.parametrize("S,chunk,seed", [(3, 4, 0), (17, 8, 1),
                                          (40, 16, 2), (33, 8, 3)])
def test_mamba_prefill_matches_reference_and_scan(S, chunk, seed):
    """The chunked prefill from a carried state: within 2e-5 of the
    reference's chunked prefill, and within the reference's own 2e-3 of
    the port's time scan (``tests/test_mamba_chunked.py``)."""
    cfg, tcfg, jp, tp, st = _mamba()
    x = np.random.default_rng(seed).standard_normal(
        (3, S, cfg.d_model)).astype(np.float32)
    jy, jst = jmb.mamba_prefill(cfg, jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(x), _jst(st), chunk=chunk)
    ty, tst = tmb.mamba_prefill(tcfg, tp, _t(x), _tst(st), chunk=chunk)
    _close(ty, jy)
    _close(tst["ssm"], jst["ssm"], 1e-4)
    _close(tst["conv"], jst["conv"])
    sy, sst = tmb.mamba_prefill(dataclasses.replace(tcfg,
                                                    mamba_chunked=False),
                                tp, _t(x), _tst(st))
    assert float((sy - ty).abs().max()) < 2e-3
    assert float((sst["ssm"] - tst["ssm"]).abs().max()) < 2e-3


def test_mamba_prefill_state_continuation():
    cfg, tcfg, jp, tp, _ = _mamba()
    x = _t(np.random.default_rng(1).standard_normal(
        (2, 30, cfg.d_model)).astype(np.float32))
    scan = dataclasses.replace(tcfg, mamba_chunked=False)
    y_full, _ = tmb.mamba_prefill(scan, tp, x)
    y1, st1 = tmb.mamba_prefill(tcfg, tp, x[:, :13], chunk=8)
    y2, _ = tmb.mamba_prefill(tcfg, tp, x[:, 13:], state=st1, chunk=8)
    assert float((torch.cat([y1, y2], 1) - y_full).abs().max()) < 2e-3


# --------------------------------------------------------------------------
# recurrent verify
# --------------------------------------------------------------------------
def _tree(width=8):
    cfg = get_config(ARCH)
    return JT.build_tree(JT.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                         width)


def test_path_verify_matches_reference():
    cfg, tcfg, jp, tp, st = _mamba()
    spec = _tree()
    x = np.random.default_rng(2).standard_normal(
        (3, spec.width, cfg.d_model)).astype(np.float32)
    jpp = jax.tree.map(jnp.asarray, jp)
    jy, jdst = jrv.path_verify(
        lambda x_t, s: jmb.mamba_step(cfg, jpp, x_t, s), jnp.asarray(x),
        _jst(st), jnp.asarray(spec.paths), jnp.asarray(spec.node_path),
        jnp.asarray(spec.node_depth))
    ttree = TT.Tree.from_spec(spec, "cpu")
    ty, tdst = trv.path_verify(
        lambda x_t, s, slot: tmb.mamba_step(tcfg, tp, x_t, s, out=slot),
        _t(x), _tst(st), ttree.paths, ttree.node_path, ttree.node_depth)
    _close(ty, jy)
    for k in ("ssm", "conv"):
        assert tuple(tdst[k].shape) == tuple(jdst[k].shape)
        _close(tdst[k], jdst[k], 1e-4)
    # a step that returns new tensors has them copied into the slots
    ty2, tdst2 = trv.path_verify(
        lambda x_t, s, slot: tmb.mamba_step(tcfg, tp, x_t, s), _t(x),
        _tst(st), ttree.paths, ttree.node_path, ttree.node_depth)
    _close(ty2, ty, 1e-6)
    _close(tdst2["ssm"], tdst["ssm"], 1e-6)


def test_select_committed_state_matches_reference():
    rng = np.random.default_rng(4)
    D, B, P = 4, 3, 5
    states = {"ssm": rng.standard_normal((D, B * P, 2, 3)).astype(np.float32),
              "conv": rng.standard_normal((D, B * P, 4)).astype(np.float32)}
    path_idx = np.array([4, 0, 2], np.int32)
    n_accept = np.array([2, 4, 0], np.int32)      # row 2 wraps to D - 1
    want = jrv.select_committed_state(_jst(states), jnp.asarray(path_idx),
                                      jnp.asarray(n_accept), B, P)
    got = trv.select_committed_state(_tst(states), _t(path_idx),
                                     _t(n_accept), B, P)
    for k in states:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_logits_match_reference():
    assert logits_match(ARCH) < TOL


def test_init_cache_and_sites():
    cfg = get_config(ARCH)
    tcfg = t_get_config(ARCH)
    jc = jax.tree.map(np.asarray, j_get_model(cfg).prefill(
        j_get_model(cfg).init_params(jax.random.PRNGKey(0)),
        {"tokens": jnp.zeros((2, 5), jnp.int32)}, max_len=9)[2])
    tc = thy.init_cache(tcfg, 2, 9, device="cpu")
    assert thy.n_sites(tcfg) == 1
    for got, want in ((tc.kv.k, jc.kv.k), (tc.mamba.ssm, jc.mamba.ssm),
                      (tc.mamba.conv, jc.mamba.conv)):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == want.dtype.name
    full = t_get_config("zamba2-7b")
    assert thy.n_sites(full) == 13
    assert tmb.dims(full) == (7168, 112, 64, 64)


def test_chunked_prefill_takes_kv_only_caches():
    """Recurrent caches are admitted whole: the chunked-prefill row views
    refuse them and the engine says so."""
    cache = thy.init_cache(t_get_config(ARCH), 2, 8, device="cpu")
    with pytest.raises(ValueError, match="KV-only"):
        tcache.slice_row(cache, 0)
    with pytest.raises(ValueError, match="KV-only"):
        tcache.write_row_at(cache, 0, torch.zeros(1, 2, 2, 64),
                            torch.zeros(1, 2, 2, 64), 0, 2)
    _, teng, _ = engine_pair(ARCH, "spec", paged=True, page_size=4)
    assert not teng.sched_chunked_ok


# --------------------------------------------------------------------------
# engines and the scheduler
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kind", ["spec", "batch"])
def test_engines_equal_jax(kind, layout):
    engines_equal_jax(ARCH, kind, layout)


@pytest.mark.parametrize("kind,layout", [("spec", "dense"),
                                         ("spec", "paged"),
                                         ("batch", "paged")])
def test_static_graph_step_equals_jax(kind, layout):
    engines_equal_jax(ARCH, kind, layout, graphed=True)


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("kind,layout", [("spec", "paged"),
                                         ("spec", "dense"),
                                         ("batch", "paged")])
def test_continuous_scheduler_equals_jax(kind, layout, graphed):
    continuous_equal_jax(ARCH, kind, layout, graphed=graphed)


@pytest.mark.parametrize("graphed", [False, True])
def test_eviction_zeroes_recurrent_state(graphed):
    """``tests/test_scheduler.py::test_eviction_frees_recurrent_state``:
    budgets differ, so one row runs chunks after the other was evicted;
    frozen rows commit nothing, so the reset row's state stays zero."""
    _, teng, _ = engine_pair(ARCH, "spec")
    teng._graphed = graphed
    cfg = family_setup(ARCH)[0]
    rng = np.random.default_rng(3)
    trace = [dict(req_id=i, tokens=rng.integers(0, cfg.vocab_size, 8)
                  .astype(np.int32), n_tokens=b, arrival=0.0)
             for i, b in enumerate((4, 16))]
    sched = TS.ContinuousScheduler(teng, batch=2)
    results, _ = sched.serve(_reqs(TS, trace))
    for r, req in zip(results, trace):
        solo, _ = teng.generate({"tokens": req["tokens"][None]},
                                req["n_tokens"])
        np.testing.assert_array_equal(r.tokens,
                                      np.atleast_2d(solo)[0][:r.n_emitted])
        assert r.n_emitted == req["n_tokens"]
    cache = sched.last_state.cache
    assert bool((cache.mamba.ssm == 0).all())
    assert bool((cache.mamba.conv == 0).all())
    assert bool((cache.kv.key_pos == -1).all())


def test_overlap_equals_inline_and_tree_swap_resizes_depth_states():
    """The HCMP overlap schedule on a hybrid engine emits the inline
    engine's tokens; ``set_tree`` to a tree of another shape (P and D
    change) then serves as a fresh engine built on that tree does, on the
    static-buffer graph step too; ``time_step`` and ``measure_acceptance``
    run."""
    from repro_torch.runtime.engine import measure_acceptance
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = family_setup(ARCH)
    kw = dict(max_len=toks.shape[1] + N + 8, chunk=2)
    batch = {"tokens": toks}
    inline = TSpec(tm, th, tp, tspec, **kw)
    over = TSpec(tm, th, tp, tspec, hcmp="overlap", **kw)
    io, _ = inline.generate(batch, N)
    oo, _ = over.generate(batch, N)
    np.testing.assert_array_equal(oo, io)
    small = TT.build_tree(TT.default_accs(cfg.medusa_heads,
                                          cfg.medusa_top_k), 4)
    assert small.shape() != tspec.shape()
    fresh = TSpec(tm, th, tp, small, **kw)
    want, _ = fresh.generate(batch, N)
    for graphed in (False, True):
        eng = TSpec(tm, th, tp, tspec, **kw)
        eng._graphed = graphed
        eng.generate(batch, N)
        eng.set_tree(small)
        got, _ = eng.generate(batch, N)
        np.testing.assert_array_equal(got, want)
    assert eng.time_step(batch=2, prompt_len=6, reps=1) > 0
    al = measure_acceptance(tm, th, tp, tspec, [batch], N, engine=eng)
    assert al >= 1.0


def test_paged_int8_sites_dequantize():
    """The port hands an int8 pool's scales to every site's page walk, so
    a verify over the int8 pool stays within quantization error of the
    dense verify.  The reference hands the pool over without its scales
    (``src/repro/models/hybrid.py:68-70``): its int8 verify reads raw
    codes (ROADMAP C)."""
    errs = int8_verify_gap(ARCH)
    assert errs["port"] < 0.05, errs
    assert errs["reference"] > 10 * errs["port"], errs


def test_training_parity():
    """The Mamba2 leaves' grads spread further than the attention
    stack's: up to 2.0e-5 x max|g| (``A_log``; the shared block's stay
    under 3e-6), the fp32 rounding of the SSD chunk's decays, which both
    packages compute in fp32 whatever the params' dtype (float64 params
    bring every leaf within 3.1e-6): ``tools/family_parity.py``."""
    loss, ce, aux = lm_loss_and_grads_match(ARCH, grad_tol=HYBRID_GRAD_TOL)
    assert aux == 0.0 and loss == pytest.approx(ce)
