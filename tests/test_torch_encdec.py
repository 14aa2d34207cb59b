"""The port's enc-dec family (SeamlessM4T: a bidirectional encoder over
stubbed audio frames, a decoder with self- and cross-attention) against
the JAX reference (``seamless-m4t-medium`` smoke config, float32, CPU),
with the helpers of ``tests/test_torch_moe.py``.

The pieces (``models/attention.py``): the bidirectional prefill, the
cross-attention and its K/V memory within 2e-5 of the reference's; the
encoder too.  The model (``models/encdec.py``) through prefill, verify,
commit and decode: logits, the KV and the cross memory within 2e-5; the
reference's decode-vs-prefill and verify-chain checks
(``tests/test_models.py``).  Greedy streams equal the JAX engines' on the
dense and paged engines and the static-buffer graph step, which adopts the
cross memory like K/V (a new prefill takes a new graph; a step that
rebuilt it raises).  The frames are not decoder positions.  A paged verify
never splits.  Over an int8 pool the port's verify stays within 0.05 of
its float verify; the reference's, handed the pool without its scales,
does not (ROADMAP C).  ``lm_loss`` grads within 5e-5 x max|g|, two
``train_step``s against the reference's, and the train launcher with its
zero frames.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models.api import get_model as j_get_model
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.speculative import tree as TT
from repro_torch.data.pipeline import MarkovDataset
from repro_torch.kernels import dispatch
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models.api import get_model as t_get_model
from repro_torch.runtime import cache as tcache
from repro_torch.runtime.engine import SpeculativeEngine as TSpec
from repro_torch.runtime.engine import _prefill_state, _prompt_len
from repro_torch.runtime.graphs import ChunkGraphs, StepGraph
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain
from test_torch_moe import (N, engine_pair, engines_equal_jax, family_batch,
                            family_setup, int8_verify_gap, logits_match,
                            lm_loss_and_grads_match)
from test_torch_training import ENV, ROOT, _jb

ARCH = "seamless-m4t-medium-smoke"
TOL = 2e-5
GRAD_TOL = 5e-5                # x the leaf's max |g|, the hybrid's
TRAJ_RTOL = 1e-4


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


def _models():
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    jm, tm = j_get_model(cfg), t_get_model(tcfg)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return cfg, tcfg, jm, tm, jp, params_from_jax(tcfg, jp, device="cpu")


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------
def test_attention_pieces_match_reference():
    """The bidirectional prefill (out and rope'd K/V), the cross K/V
    memory and the cross-attention over it."""
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    p = jax.tree.map(np.array, jattn.attn_init(cfg, jax.random.PRNGKey(5)))
    tp = params_from_jax(tcfg, p, device="cpu")
    jp = jax.tree.map(jnp.asarray, p)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jo, (jk, jv) = jattn.attn_prefill(cfg, jp, jnp.asarray(x), causal=False)
    to, (tk, tv) = tattn.attn_prefill(tcfg, tp, _t(x), causal=False)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)
    # bidirectional: the first position sees the last
    co, _ = tattn.attn_prefill(tcfg, tp, _t(x))
    assert float((co[:, 0] - to[:, 0]).abs().max()) > 1e-3
    jck, jcv = jattn.cross_kv_init(cfg, jp, jnp.asarray(enc))
    tck, tcv = tattn.cross_kv_init(tcfg, tp, _t(enc))
    _close(tck, jck)
    _close(tcv, jcv)
    _close(tattn.attn_cross(tcfg, tp, _t(x), tck, tcv),
           jattn.attn_cross(cfg, jp, jnp.asarray(x), jck, jcv))


def test_encode_and_cross_memory_match_reference():
    cfg, tcfg, jm, tm, jp, tp = _models()
    frames = np.random.default_rng(1).standard_normal(
        (2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    jenc = jed.encode(cfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(frames))
    tenc = ted.encode(tcfg, tp, _t(frames))
    _close(tenc, jenc)
    jk, jv = jed._cross_memory(cfg, jax.tree.map(jnp.asarray, jp), jenc)
    tk, tv = ted.cross_memory(tcfg, tp, tenc)
    assert tuple(tk.shape) == jk.shape == (tcfg.num_layers, 2,
                                           cfg.encoder_seq_len,
                                           cfg.num_kv_heads, cfg.head_dim)
    _close(tk, jk)
    _close(tv, jv)
    # a batch may carry the encoder's output in place of the frames
    toks = _t(np.arange(6, dtype=np.int32)[None].repeat(2, 0))
    lf, _, cf = tm.prefill(tp, {"tokens": toks, "frame_embeds": _t(frames)})
    le, _, ce = tm.prefill(tp, {"tokens": toks, "enc_out": tenc})
    assert torch.equal(lf, le) and torch.equal(cf.cross_k, ce.cross_k)
    with pytest.raises(ValueError, match="frame_embeds"):
        tm.prefill(tp, {"tokens": toks})


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_logits_match_reference():
    assert logits_match(ARCH) < TOL


def _model_setup(B=2, S=12):
    cfg, tcfg, jm, tm, jp, tp = _models()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    frames = _t(family_batch(cfg, toks)["frame_embeds"])
    return tm, tp, toks, frames


def test_decode_matches_prefill():
    """``tests/test_models.py::test_decode_matches_prefill`` on the port,
    the cross memory cached at prefill and carried by every decode."""
    tm, tp, toks, frames = _model_setup()
    full, _, _ = tm.prefill(tp, {"tokens": _t(toks), "frame_embeds": frames},
                            max_len=16)
    _, _, cache = tm.prefill(tp, {"tokens": _t(toks[:, :8]),
                                  "frame_embeds": frames}, max_len=16)
    ck = cache.cross_k
    outs = []
    for i in range(8, 12):
        lg, cache = tm.decode(tp, cache, _t(toks[:, i:i + 1]))
        outs.append(lg[:, 0])
    assert float((torch.stack(outs, 1) - full[:, 8:12]).abs().max()) < 5e-2
    assert cache.cross_k is ck
    np.testing.assert_array_equal(cache.kv.pos.numpy(), [12, 12])


def test_verify_chain_matches_teacher_forcing():
    """``tests/test_models.py::test_verify_chain_matches_teacher_forcing``
    on the port."""
    tm, tp, toks, frames = _model_setup()
    full, _, _ = tm.prefill(tp, {"tokens": _t(toks), "frame_embeds": frames},
                            max_len=20)
    _, _, cache = tm.prefill(tp, {"tokens": _t(toks[:, :8]),
                                  "frame_embeds": frames}, max_len=20)
    tr = TT.Tree.from_spec(TT.spec_from_nodes(
        [(-1, 0, 0), (0, 1, 0), (1, 2, 0), (2, 3, 0)]), "cpu")
    vlog, extras = tm.verify(tp, cache, _t(toks[:, 8:12]), tr)
    assert float((vlog - full[:, 8:12]).abs().max()) < 5e-2
    B = toks.shape[0]
    cache = tm.commit(cache, extras, tr, torch.arange(4).expand(B, 4),
                      torch.full((B,), 3, dtype=torch.int32),
                      torch.zeros((B,), dtype=torch.int64))
    lg, _ = tm.decode(tp, cache, _t(toks[:, 11:12]))
    assert float((lg[:, 0] - full[:, 11]).abs().max()) < 5e-2


def test_frames_are_not_decoder_positions():
    """The frames feed the encoder: the prompt's length, the KV's ``pos``
    and a paged row's reservation count the tokens alone; a bf16 frame
    tensor is cast to the model's dtype; the cache's row surgery maps the
    cross memory (batch on axis 1) with the KV, and chunked prefill
    refuses it."""
    tm, tp, toks, frames = _model_setup()
    batch = {"tokens": _t(toks), "frame_embeds": frames}
    assert _prompt_len(batch) == toks.shape[1]
    _, _, cache = tm.prefill(tp, batch, max_len=20)
    np.testing.assert_array_equal(cache.kv.pos.numpy(), [12, 12])
    lo, _, _ = tm.prefill(tp, {"tokens": _t(toks),
                               "frame_embeds": frames.to(torch.bfloat16)})
    assert lo.dtype == torch.float32 and bool(torch.isfinite(lo).all())
    _, teng, _ = engine_pair(ARCH, "spec", paged=True, page_size=4)
    tables, _ = teng._reserve_tables(2, _prompt_len(batch),
                                     np.array([N, N]))
    want = tcache.pages_for(toks.shape[1] + N + teng._overshoot, 4)
    assert (tables >= 0).sum(dim=1).tolist() == [want, want]
    assert not teng.sched_chunked_ok
    row = tcache.Cache(kv=dataclasses.replace(
        cache.kv, k=cache.kv.k[:, :1].clone(), v=cache.kv.v[:, :1].clone(),
        key_pos=cache.kv.key_pos[:1], pos=cache.kv.pos[:1]),
        cross_k=cache.cross_k[:, :1].clone(),
        cross_v=cache.cross_v[:, :1].clone())
    bank = tcache.tile_rows(row, 3)
    assert bank.cross_k.shape[1] == 3 and torch.equal(bank.cross_k[:, 2],
                                                      row.cross_k[:, 0])
    ck = bank.cross_k
    bank = tcache.reset_rows(bank, torch.tensor([False, True, False]))
    assert bank.cross_k is ck and bool((ck[:, 1] == 0).all())
    bank = tcache.insert_rows(bank, 1, row)
    assert bank.cross_k is ck and torch.equal(ck[:, 1], row.cross_k[:, 0])
    with pytest.raises(ValueError, match="KV-only"):
        tcache.slice_row(cache, 0)


# --------------------------------------------------------------------------
# engines and the graph step
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


def _prefilled(teng, batch):
    return _prefill_state(teng.model, teng.params, teng.heads,
                          teng._batch(batch), max_len=teng.max_len, window=0)


def test_cross_memory_rides_the_graph():
    """The static-buffer step adopts the cross memory like K/V: K
    replays equal K eager steps and leave it untouched; a new prefill
    (new frames: a new cross memory) of the same key takes a new graph,
    whose tokens equal the eager ones; a step that rebuilt the cross
    memory raises."""
    _, teng, batch = engine_pair(ARCH, "spec")
    B = batch["tokens"].shape[0]
    done = torch.zeros((B,), dtype=torch.bool)
    rem = torch.full((B,), 100, dtype=torch.int64)
    graphs = ChunkGraphs(teng._graphs.step_fn, "cpu", capture=False)
    graphs.run(1, teng.strategy, _prefilled(teng, batch), done, rem, -1,
               teng.tree_kernel, teng._eager_chunk)          # warm-up
    st = _prefilled(teng, batch)
    ck = st.cache.cross_k.clone()
    want = teng._eager_chunk(3, teng.strategy, _prefilled(teng, batch),
                             done, rem, -1)
    got = graphs.run(3, teng.strategy, st, done, rem, -1, teng.tree_kernel,
                     teng._eager_chunk)
    assert graphs.last == "capture"
    assert got[0].cache.cross_k is st.cache.cross_k
    assert torch.equal(got[0].cache.cross_k, ck)
    np.testing.assert_array_equal(got[3].numpy(), want[3].numpy())
    other = dict(batch, frame_embeds=batch["frame_embeds"][::-1].copy())
    st2 = _prefilled(teng, other)
    want2 = teng._eager_chunk(3, teng.strategy, _prefilled(teng, other),
                              done, rem, -1)
    got2 = graphs.run(3, teng.strategy, st2, done, rem, -1,
                      teng.tree_kernel, teng._eager_chunk)
    assert graphs.last == "capture" and len(graphs) == 1
    assert graphs.stats["captures"] == 2
    np.testing.assert_array_equal(got2[3].numpy(), want2[3].numpy())

    def rebuilds(*args):
        out = teng._graphs.step_fn(*args)
        state = out[0]
        return (dataclasses.replace(state, cache=dataclasses.replace(
            state.cache, cross_k=state.cache.cross_k.clone())),) + out[1:]
    g = StepGraph(rebuilds, teng.strategy, _prefilled(teng, batch), done,
                  rem, -1, teng.tree_kernel)
    with pytest.raises(RuntimeError, match="cross_k"):
        g.replay()


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_slot_protocol_admits_frames(layout, graphed):
    """The scheduler's slot protocol with frame embeds in the batch (the
    reference's scheduler admits tokens alone): a bank bootstrapped from
    row 0's prefill, row 1 admitted with its own frames, the chunks
    stepped to the budgets; each row's stream equals its solo
    ``generate``, the cross memory is spliced row by row in place, and the
    rows' pages come back to the pool."""
    from test_torch_moe import LAYOUTS
    _, teng, batch = engine_pair(ARCH, "spec", **LAYOUTS[layout])
    teng._graphed = graphed
    rows = [{k: v[b:b + 1] for k, v in batch.items()} for b in range(2)]
    plen = rows[0]["tokens"].shape[1]
    row = teng.sched_prefill(rows[0])
    state = teng.sched_blank(row, 2)
    state = teng.sched_insert(state, 0, row, prompt_len=plen, n_tokens=N)
    ck = state.cache.cross_k
    state, first = teng.sched_admit(state, 1, rows[1], n_tokens=N)
    assert state.cache.cross_k is ck
    outs = [[teng.sched_first(row)], [int(first)]]
    done, rem = np.zeros(2, bool), np.full(2, N - 1)
    while np.any(~done & (rem > 0)):
        state, done, rem, raw = teng.sched_step(state, done, rem, 2, -1)
        for b, toks in enumerate(teng.sched_emitted(raw)):
            outs[b].extend(toks)
    for b in range(2):
        solo, _ = teng.generate(rows[b], N)
        np.testing.assert_array_equal(np.asarray(outs[b][:N]), solo)
        teng.sched_release(b)
    assert teng.sched_pool_conserved() and teng.sched_drained()


def test_paged_verify_never_splits(monkeypatch):
    """``tree_kernel="sparse"`` is dropped, as the reference's ``_encdec``
    drops it: a paged verify is always the fused page walk (B2)."""
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = family_setup(ARCH)
    batch = family_batch(cfg, toks)
    kw = dict(max_len=toks.shape[1] + N + 8, chunk=4, paged=True,
              page_size=4)
    want, _ = TSpec(tm, th, tp, tspec, **kw).generate(batch, N)

    def refuse(*a, **k):
        raise AssertionError("the enc-dec verify split")
    monkeypatch.setattr(dispatch, "paged_cache_attention", refuse)
    monkeypatch.setattr(dispatch, "sparse_tree_attention_partial", refuse)
    got, _ = TSpec(tm, th, tp, tspec, tree_kernel="sparse",
                   **kw).generate(batch, N)
    np.testing.assert_array_equal(got, want)


def test_paged_int8_verify_dequantizes():
    """The port hands an int8 pool's scales to every decoder layer's page
    walk, so a verify over the int8 pool stays within quantization error
    of the float verify.  The reference hands the pool over without its
    scales (``src/repro/models/encdec.py:117-133``): its int8 verify reads
    raw codes (ROADMAP C records the gap)."""
    errs = int8_verify_gap(ARCH)
    assert errs["port"] < 0.05, errs
    assert errs["reference"] > 10 * errs["port"], errs


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
def test_training_parity():
    loss, ce, aux = lm_loss_and_grads_match(ARCH, grad_tol=GRAD_TOL)
    assert aux == 0.0 and loss == pytest.approx(ce)


def test_train_steps_match_reference():
    """Two ``train_step``s (the encoder, the cross memory and the decoder
    under one backward, then AdamW) from the same params and frames:
    losses within 1e-4 relative."""
    cfg, tcfg, jm, tm, jp, tp = _models()
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate, tstate = jopt.adamw_init(jparams), topt.adamw_init(tp)
    step = jax.jit(lambda p, o, b: jtrain.train_step(cfg, jm, p, o, b,
                                                     lr=3e-3))
    jl, tl = [], []
    for b in MarkovDataset(cfg.vocab_size, seed=1).batches(2, 16, 2):
        b = family_batch(cfg, b["tokens"]) | {"labels": b["labels"]}
        jparams, jstate, jmet = step(jparams, jstate, _jb(b))
        tp, tstate, tmet = ttrain.train_step(tcfg, tm, tp, tstate, b,
                                             lr=3e-3)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL)


def test_train_launcher_feeds_zero_frames_on_cpu():
    """``launch/train.py`` on the enc-dec arch: zero frame embeds of
    (batch, encoder_seq_len, d_model) with every batch, as the reference's
    launcher feeds its stubbed frontend; the loss is finite."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16"],
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("[train] step    0 loss=")
    assert lines[-1].startswith("[train] step    1 loss=")
    loss = float(lines[-1].split("loss=")[1].split()[0])
    assert np.isfinite(loss) and loss > 0
