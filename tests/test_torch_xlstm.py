"""The port's xLSTM family (sLSTM and mLSTM layers, no KV cache) against the
JAX reference (``xlstm-125m`` smoke config, float32, CPU), with the helpers
of ``tests/test_torch_moe.py``.

The blocks (``models/xlstm.py``): ``mlstm_step``, ``slstm_step`` and both
prefills within 2e-5 of the reference's; the chunked mLSTM prefill within
2e-3 of its own scan over ragged lengths and chunks of 4, 8 and 16, with
the state carried across calls (``tests/test_xlstm_chunked.py``).  The
model (``models/xlstm_model.py``) through prefill, verify, commit and
decode: logits within 2e-5; the reference's decode-vs-prefill and
verify-chain checks (``tests/test_models.py``).  Greedy streams equal the
JAX engines' on the dense and paged engines (the paged layout holds no
pages) and the static-buffer graph step, and the continuous scheduler's,
whose evicted rows keep an all-zero state (``tests/test_scheduler.py``).
The tree walker (``repro_torch/tree.py``) carries the tuple of layers
through the bridge, AdamW, ``train_step`` and the checkpoint file, which
equals the reference's byte for byte.  ``lm_loss`` grads within 5e-5 x
max|g|.
"""
import dataclasses
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import xlstm as jxl
from repro.models.api import get_model as j_get_model
from repro.training import checkpoint as jck
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch import tree as ptree
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.speculative import tree as TT
from repro_torch.data.pipeline import MarkovDataset
from repro_torch.models import xlstm as txl
from repro_torch.models import xlstm_model as txm
from repro_torch.models.api import get_model as t_get_model
from repro_torch.runtime import cache as tcache
from repro_torch.runtime import continuous as TS
from repro_torch.runtime.engine import SpeculativeEngine as TSpec
from repro_torch.runtime.graphs import ChunkGraphs
from repro_torch.training import checkpoint as tck
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain
from test_torch_moe import (N, continuous_equal_jax, engine_pair,
                            engines_equal_jax, family_setup, logits_match,
                            lm_loss_and_grads_match)
from test_torch_sched import _reqs
from test_torch_training import _get, _jb, _paths

ARCH = "xlstm-125m-smoke"
TOL = 2e-5
SCAN_TOL = 2e-3                # chunked against scan, as the reference's
GRAD_TOL = 5e-5                # x the leaf's max |g|, the hybrid's
TRAJ_RTOL = 1e-4               # loss trajectories, as the training test's


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


_BLOCKS = {}


def _block(kind):
    """(cfg, port cfg, JAX params, port params, seeded state) of one
    block: "mlstm" or "slstm" (the sLSTM's recurrence made nonzero, so
    every term of its step is exercised)."""
    if kind not in _BLOCKS:
        cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
        rng = np.random.default_rng(0)
        if kind == "mlstm":
            jp = jax.tree.map(np.array, jxl.mlstm_init(
                cfg, jax.random.PRNGKey(3)))
            di, nh, hd = jxl.mlstm_dims(cfg)
            st = {"C": rng.standard_normal((3, nh, hd, hd)),
                  "n": rng.standard_normal((3, nh, hd)),
                  "m": rng.standard_normal((3, nh))}
        else:
            jp = jax.tree.map(np.array, jxl.slstm_init(
                cfg, jax.random.PRNGKey(4)))
            for g in ("i", "f", "z", "o"):
                jp["r" + g] = (0.05 * rng.standard_normal(
                    jp["r" + g].shape)).astype(np.float32)
                jp["b" + g] = (0.3 * rng.standard_normal(
                    jp["b" + g].shape)).astype(np.float32)
            st = {k: rng.standard_normal((3, cfg.d_model))
                  for k in ("c", "n", "h", "m")}
            st["n"] = np.abs(st["n"]) + 0.5
        st = {k: v.astype(np.float32) for k, v in st.items()}
        _BLOCKS[kind] = (cfg, tcfg, jp, params_from_jax(tcfg, jp,
                                                         device="cpu"), st)
    return _BLOCKS[kind]


def _jst(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def _tst(st):
    return {k: _t(v) for k, v in st.items()}


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_step_matches_reference(kind):
    cfg, tcfg, jp, tp, st = _block(kind)
    x = np.random.default_rng(1).standard_normal(
        (3, cfg.d_model)).astype(np.float32)
    jstep = jxl.mlstm_step if kind == "mlstm" else jxl.slstm_step
    tstep = txl.mlstm_step if kind == "mlstm" else txl.slstm_step
    jo, jst = jstep(cfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                    _jst(st))
    to, tst = tstep(tcfg, tp, _t(x), _tst(st))
    _close(to, jo)
    assert tst.keys() == jst.keys()
    for k in jst:
        _close(tst[k], jst[k])
    if kind == "mlstm":
        # the step writing its matrix memory into a given slot
        slot = {"C": torch.empty_like(tst["C"])}
        to2, tst2 = txl.mlstm_step(tcfg, tp, _t(x), _tst(st), out=slot)
        assert tst2["C"] is slot["C"]
        assert torch.equal(to2, to) and torch.equal(slot["C"], tst["C"])


@pytest.mark.parametrize("S,chunk,seed", [(3, 4, 0), (17, 8, 1),
                                          (40, 16, 2), (33, 8, 3),
                                          (16, 16, 4), (9, 4, 5)])
def test_mlstm_prefill_matches_reference_and_scan(S, chunk, seed):
    """The chunked prefill from a carried state: within 2e-5 of the
    reference's chunked prefill, and within the reference's own 2e-3 of
    the port's scan (ragged tails included)."""
    cfg, tcfg, jp, tp, st = _block("mlstm")
    x = np.random.default_rng(seed).standard_normal(
        (3, S, cfg.d_model)).astype(np.float32)
    jy, jst = jxl.mlstm_prefill(cfg, jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(x), _jst(st), chunk=chunk)
    ty, tst = txl.mlstm_prefill(tcfg, tp, _t(x), _tst(st), chunk=chunk)
    _close(ty, jy)
    for k in ("C", "n", "m"):
        _close(tst[k], jst[k], 1e-4)
    sy, sst = txl.mlstm_prefill_scan(tcfg, tp, _t(x), _tst(st))
    assert float((sy - ty).abs().max()) < SCAN_TOL
    for k in ("C", "n", "m"):
        assert float((sst[k] - tst[k]).abs().max()) < SCAN_TOL
    # the config's switch selects the scan
    cy, _ = txl.mlstm_prefill(dataclasses.replace(tcfg, mlstm_chunked=False),
                              tp, _t(x), _tst(st), chunk=chunk)
    assert torch.equal(cy, sy)


def test_mlstm_prefill_state_continuation():
    """``tests/test_xlstm_chunked.py::test_state_continuation`` on the
    port: two calls carrying the state equal one."""
    _, tcfg, _, tp, _ = _block("mlstm")
    x = _t(np.random.default_rng(1).standard_normal(
        (2, 30, tcfg.d_model)).astype(np.float32))
    y_full, _ = txl.mlstm_prefill(tcfg, tp, x, chunk=8)
    y1, st1 = txl.mlstm_prefill(tcfg, tp, x[:, :13], chunk=8)
    y2, _ = txl.mlstm_prefill(tcfg, tp, x[:, 13:], state=st1, chunk=8)
    assert float((torch.cat([y1, y2], 1) - y_full).abs().max()) < SCAN_TOL


def test_slstm_prefill_matches_reference():
    cfg, tcfg, jp, tp, st = _block("slstm")
    x = np.random.default_rng(2).standard_normal(
        (3, 11, cfg.d_model)).astype(np.float32)
    jy, jst = jxl.slstm_prefill(cfg, jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(x), _jst(st))
    ty, tst = txl.slstm_prefill(tcfg, tp, _t(x), _tst(st))
    _close(ty, jy)
    for k in jst:
        _close(tst[k], jst[k])


def test_init_states_match_reference():
    """States are float32, the stabilizer starts at -1e30; the mLSTM head
    width is 2 d_model / heads (384 at full width), not ``head_dim``."""
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    for jfn, tfn in ((jxl.mlstm_init_state, txl.mlstm_init_state),
                     (jxl.slstm_init_state, txl.slstm_init_state)):
        want, got = jfn(cfg, 2), tfn(tcfg, 2, device="cpu")
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    full = t_get_config("xlstm-125m")
    assert txl.mlstm_dims(full) == (1536, 4, 384) and full.head_dim == 192


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_logits_match_reference():
    assert logits_match(ARCH) < TOL


def test_params_keep_the_tuple_of_layers():
    """Both inits and the bridge keep ``layers`` a tuple of per-layer
    dicts, the sLSTM's shapes beside the mLSTM's."""
    tcfg = t_get_config(ARCH)
    jp = j_get_model(get_config(ARCH)).init_params(jax.random.PRNGKey(0))
    for tree in (t_get_model(tcfg).init_params(torch.Generator()
                                               .manual_seed(0)),
                 params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")):
        assert isinstance(tree["layers"], tuple)
        assert [sorted(lp["block"]) for lp in tree["layers"]] == \
            [sorted(lp["block"]) for lp in jp["layers"]]
        for lp, jlp in zip(tree["layers"], jp["layers"]):
            for k, v in jlp["block"].items():
                assert tuple(lp["block"][k].shape) == v.shape, k
                assert str(lp["block"][k].dtype).split(".")[-1] == \
                    v.dtype.name, k


def _model_setup(B=2, S=12):
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    jm, tm = j_get_model(cfg), t_get_model(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    return tm, tp, toks


def test_decode_matches_prefill():
    """``tests/test_models.py::test_decode_matches_prefill`` on the port."""
    tm, tp, toks = _model_setup()
    full, _, _ = tm.prefill(tp, {"tokens": _t(toks)}, max_len=16)
    _, _, cache = tm.prefill(tp, {"tokens": _t(toks[:, :8])}, max_len=16)
    assert cache.kv is None
    outs = []
    for i in range(8, 12):
        lg, cache = tm.decode(tp, cache, _t(toks[:, i:i + 1]))
        outs.append(lg[:, 0])
    assert float((torch.stack(outs, 1) - full[:, 8:12]).abs().max()) < 5e-2
    np.testing.assert_array_equal(cache.xlstm.pos.numpy(), [12, 12])


def test_verify_chain_matches_teacher_forcing():
    """``tests/test_models.py::test_verify_chain_matches_teacher_forcing``
    on the port: a chain tree of the true continuation, 3 of 4 committed,
    then a decode."""
    tm, tp, toks = _model_setup()
    full, _, _ = tm.prefill(tp, {"tokens": _t(toks)}, max_len=20)
    _, _, cache = tm.prefill(tp, {"tokens": _t(toks[:, :8])}, max_len=20)
    tr = TT.Tree.from_spec(TT.spec_from_nodes(
        [(-1, 0, 0), (0, 1, 0), (1, 2, 0), (2, 3, 0)]), "cpu")
    vlog, extras = tm.verify(tp, cache, _t(toks[:, 8:12]), tr)
    assert float((vlog - full[:, 8:12]).abs().max()) < 5e-2
    B = toks.shape[0]
    cache = tm.commit(cache, extras, tr,
                      torch.arange(4).expand(B, 4),
                      torch.full((B,), 3, dtype=torch.int32),
                      torch.zeros((B,), dtype=torch.int64))
    lg, _ = tm.decode(tp, cache, _t(toks[:, 11:12]))
    assert float((lg[:, 0] - full[:, 11]).abs().max()) < 5e-2


def test_cache_without_kv():
    """No KV: the paged layout leaves the cache as it is, the budget is
    unbounded, the row surgery maps the xLSTM leaves (batch on axis 0)
    and chunked prefill refuses it."""
    tcfg = t_get_config(ARCH)
    cache = txm.init_cache(tcfg, 2, device="cpu")
    assert cache.kv is None and cache.pos.shape == (2,)
    assert tcache.paginate_cache(cache, torch.zeros((2, 3), dtype=torch
                                                    .int32), page_size=4,
                                 n_pages=6) is cache
    assert bool((tcache.capacity_left(cache) >= 1 << 30).all())
    row = txm.init_cache(tcfg, 1, device="cpu")
    row.xlstm.layers[0]["C"].fill_(2.0)
    bank = tcache.tile_rows(row, 3)
    assert bank.xlstm.layers[0]["C"].shape[0] == 3
    assert bool((bank.xlstm.layers[0]["C"] == 2.0).all())
    assert tcache.blank_paged_rows(row, 3, page_size=4, n_pages=6,
                                   max_len=8).kv is None
    bank = tcache.insert_rows(bank, 1, txm.init_cache(tcfg, 1, device="cpu"),
                              pages=torch.zeros(2, dtype=torch.int32))
    assert bool((bank.xlstm.layers[0]["C"][1] == 0).all())
    assert bool((bank.xlstm.layers[0]["C"][0] == 2.0).all())
    bank = tcache.reset_rows(bank, torch.tensor([True, False, False]))
    assert bool((bank.xlstm.layers[0]["C"][0] == 0).all())
    assert bool((bank.xlstm.layers[1]["m"][0] == 0).all())
    assert bool((bank.xlstm.layers[0]["C"][2] == 2.0).all())
    for fn, args in ((tcache.slice_row, (cache, 0)),
                     (tcache.write_row_at, (cache, 0, None, None, 0, 1))):
        with pytest.raises(ValueError, match="KV-only"):
            fn(*args)


# --------------------------------------------------------------------------
# engines, the graph step and the scheduler
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kind", ["spec", "batch"])
def test_engines_equal_jax(kind, layout):
    engines_equal_jax(ARCH, kind, layout)


@pytest.mark.parametrize("kind,layout", [("spec", "dense"),
                                         ("spec", "paged"),
                                         ("batch", "dense")])
def test_static_graph_step_equals_jax(kind, layout):
    engines_equal_jax(ARCH, kind, layout, graphed=True)


def test_state_survives_the_replayed_step():
    """The static-buffer step carries the xLSTM state: after K replays
    from a prefilled state, the state the graph hands back equals K eager
    steps' from the same state (every leaf, ``pos`` included), and a new
    state of the same shapes is copied in: there is no big tensor to
    adopt, so the graph holds it."""
    _, teng, batch = engine_pair(ARCH, "spec")
    from repro_torch.runtime.engine import _prefill_state
    st0 = _prefill_state(teng.model, teng.params, teng.heads,
                         teng._batch(batch), max_len=teng.max_len, window=0)
    B = int(st0.cur_token.shape[0])
    done = torch.zeros((B,), dtype=torch.bool)
    rem = torch.full((B,), 100, dtype=torch.int64)

    def clone(st):
        return dataclasses.replace(st, cache=dataclasses.replace(
            st.cache, xlstm=tcache.XLSTMState(
                layers=ptree.tree_map(torch.clone, st.cache.xlstm.layers),
                pos=st.cache.xlstm.pos.clone())),
            cur_token=st.cur_token.clone(), hidden=st.hidden.clone())

    want = teng._eager_chunk(3, teng.strategy, clone(st0), done, rem, -1)
    graphs = ChunkGraphs(teng._graphs.step_fn, "cpu", capture=False)
    graphs.run(1, teng.strategy, clone(st0), done, rem, -1,
               teng.tree_kernel, teng._eager_chunk)          # warm-up
    got = graphs.run(3, teng.strategy, clone(st0), done, rem, -1,
                     teng.tree_kernel, teng._eager_chunk)
    assert graphs.last == "capture" and graphs.stats["replays"] == 3
    for g_leaf, w_leaf in zip(ptree.leaves(got[0].cache.xlstm.layers),
                              ptree.leaves(want[0].cache.xlstm.layers)):
        assert torch.equal(g_leaf, w_leaf)
    assert torch.equal(got[0].cache.xlstm.pos, want[0].cache.xlstm.pos)
    np.testing.assert_array_equal(got[3].numpy(), want[3].numpy())
    # a new state of the key: copied in, the same graph replays
    again = graphs.run(3, teng.strategy, clone(st0), done, rem, -1,
                       teng.tree_kernel, teng._eager_chunk)
    assert graphs.last == "replay" and len(graphs) == 1
    np.testing.assert_array_equal(again[3].numpy(), want[3].numpy())


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("kind,layout", [("spec", "dense"),
                                         ("spec", "paged"),
                                         ("batch", "paged")])
def test_continuous_scheduler_equals_jax(kind, layout, graphed):
    continuous_equal_jax(ARCH, kind, layout, graphed=graphed)


@pytest.mark.parametrize("graphed", [False, True])
def test_eviction_zeroes_recurrent_state(graphed):
    """``tests/test_scheduler.py::test_eviction_frees_recurrent_state``:
    budgets differ, so one row runs chunks after the other was evicted;
    a frozen row commits nothing, so every leaf of the reset rows' states
    stays zero, the stabilizer included."""
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
    assert cache.kv is None
    for leaf in ptree.leaves(cache.xlstm.layers):
        assert bool((leaf == 0).all())


def test_chunked_prefill_gated_off():
    """``tests/test_scheduler.py::test_chunked_prefill_gated_off_for_
    recurrent_families`` on the port: whole-prompt admission, no extend
    events, every pool drained."""
    _, teng, _ = engine_pair(ARCH, "spec", paged=True, page_size=4)
    assert not teng.sched_chunked_ok
    cfg = family_setup(ARCH)[0]
    rng = np.random.default_rng(4)
    trace = [dict(req_id=i, tokens=rng.integers(0, cfg.vocab_size, 12)
                  .astype(np.int32), n_tokens=5, arrival=0.0)
             for i in range(2)]
    sched = TS.ContinuousScheduler(teng, batch=2, prefill_chunk=4)
    assert sched.prefill_chunk == 0
    results, _ = sched.serve(_reqs(TS, trace))
    assert not any(ev == "extend" for ev, _, _ in sched.events)
    assert all(r.n_emitted == 5 for r in results)
    assert teng.sched_pool_conserved() and teng.sched_drained()


def test_overlap_equals_inline():
    """The HCMP overlap schedule on an xLSTM engine (the draft beside the
    state commit) emits the inline engine's tokens, eager and on the
    static-buffer step."""
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = family_setup(ARCH)
    kw = dict(max_len=toks.shape[1] + N + 8, chunk=2)
    batch = {"tokens": toks}
    io, _ = TSpec(tm, th, tp, tspec, **kw).generate(batch, N)
    for graphed in (False, True):
        over = TSpec(tm, th, tp, tspec, hcmp="overlap", **kw)
        over._graphed = graphed
        oo, _ = over.generate(batch, N)
        np.testing.assert_array_equal(oo, io)


# --------------------------------------------------------------------------
# the tree walker, training and checkpoints over the tuple of layers
# --------------------------------------------------------------------------
def _jparams():
    cfg = get_config(ARCH)
    return jax.tree.map(np.asarray, j_get_model(cfg).init_params(
        jax.random.PRNGKey(0)))


def test_tree_walker_matches_jax():
    """``paths`` walks JAX's flatten order (sorted keys, tuples in order)
    and ``treedef_str`` prints JAX's treedef, one-element tuples and empty
    ones included; ``tree_map`` and ``unflatten`` keep tuples."""
    jp = _jparams()
    tp = params_from_jax(t_get_config(ARCH), jp, device="cpu")
    leaves, treedef = jax.tree_util.tree_flatten(jp)
    got = [t for _, t in ptree.paths(tp)]
    assert len(got) == len(leaves)
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(a.numpy(), b)
    assert ptree.treedef_str(tp) == str(treedef)
    for t in ({"a": (1,), "b": ()}, (1, {"z": 2, "y": (3, 4)})):
        assert ptree.treedef_str(t) == str(jax.tree_util.tree_structure(t))
    doubled = ptree.tree_map(lambda x: 2 * x, tp)
    assert isinstance(doubled["layers"], tuple)
    back = ptree.unflatten(tp, ptree.leaves(doubled))
    assert torch.equal(back["layers"][1]["block"]["wi"],
                       2 * tp["layers"][1]["block"]["wi"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_file_equals_reference_file(dtype, tmp_path):
    """``tests/test_torch_checkpoint.py::
    test_port_file_equals_reference_file`` on the tuple of layers: every
    member of the port's ``.npz`` equals the reference's; the reference
    restores the port's float32 file and the port restores both."""
    jdt = jnp.dtype(dtype)
    jp = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt)), _jparams())
    tp = params_from_jax(t_get_config(ARCH), jp, device="cpu",
                         dtype=getattr(torch, dtype))
    jck.save(str(tmp_path / "ref.npz"), jax.tree.map(jnp.asarray, jp))
    tck.save(str(tmp_path / "port.npz"), tp)

    def members(path):
        with zipfile.ZipFile(path) as zf:
            return {n: zf.read(n) for n in zf.namelist()}
    ref, port = members(tmp_path / "ref.npz"), members(tmp_path / "port.npz")
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert port[name] == ref[name], name
    zeros = ptree.tree_map(torch.zeros_like, tp)
    for path in ("ref.npz", "port.npz"):
        got = tck.restore(str(tmp_path / path), zeros)
        assert isinstance(got["layers"], tuple)
        for (_, a), (_, b) in zip(ptree.paths(got), ptree.paths(tp)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    if dtype == "float32":
        back = jck.restore(str(tmp_path / "port.npz"),
                           jax.tree.map(jnp.zeros_like, jp))
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_training_parity():
    """The sLSTM's input-gate bias ``bi`` gets a zero grad in exact
    arithmetic: a shift of every i_t by one constant scales c and n alike
    and n >= 1 always (the first step sets it to 1, each later one adds
    to a decayed n or to 1), so h = o c / max(n, 1) does not move; both
    packages return rounding noise there (~1e-9), held under 1e-6 x the
    largest grad."""
    loss, ce, aux = lm_loss_and_grads_match(ARCH, grad_tol=GRAD_TOL,
                                            zero_grads=("bi",))
    assert aux == 0.0 and loss == pytest.approx(ce)


def test_train_step_and_adamw_match_reference():
    """Two ``train_step``s (forward, backward, AdamW over the tuple of
    layers) from the same params on two Markov batches: the losses within
    1e-4 relative, and the first step's moments within 1e-4 x each leaf's
    largest moment of the reference's (AdamW's first update,
    g / (|g| + eps), turns a grad near zero into a full step of either
    sign, so the params are held through the second loss); the sLSTM's
    ``bi``, whose grad is zero in exact arithmetic (``test_training_
    parity``), has moments under 1e-6 x the largest on both sides (its
    update, which no loss can see, is not compared)."""
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    jm, tm = j_get_model(cfg), t_get_model(tcfg)
    jp = _jparams()
    batches = list(MarkovDataset(cfg.vocab_size, seed=1).batches(2, 16, 2))
    step = jax.jit(lambda p, o, b: jtrain.train_step(cfg, jm, p, o, b,
                                                     lr=3e-3))
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jopt.adamw_init(jparams)
    tparams = params_from_jax(tcfg, jp, device="cpu")
    tstate = topt.adamw_init(tparams)
    jl, tl = [], []
    for i, b in enumerate(batches):
        jparams, jstate, jmet = step(jparams, jstate, _jb(b))
        tparams, tstate, tmet = ttrain.train_step(tcfg, tm, tparams, tstate,
                                                  b, lr=3e-3)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        if i == 0:
            for tree_t, tree_j in ((tstate.mu, jstate.mu),
                                   (tstate.nu, jstate.nu)):
                top = max(float(np.max(np.abs(np.asarray(v))))
                          for _, v in _paths(tree_j))
                for path, jv in _paths(tree_j):
                    jv = np.asarray(jv)
                    tv = _get(tree_t, path).numpy()
                    if path[-1] == "bi":
                        assert max(float(np.max(np.abs(jv))), float(
                            np.max(np.abs(tv)))) <= 1e-6 * top, path
                        continue
                    scale = float(np.max(np.abs(jv)))
                    err = float(np.max(np.abs(tv - jv)))
                    assert err <= TRAJ_RTOL * scale, (path, err, scale)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL)
    assert isinstance(tparams["layers"], tuple) and tstate.step == 2
