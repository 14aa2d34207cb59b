"""The port's MoE family against the JAX reference (``qwen3-moe-30b-a3b``
smoke config, float32, CPU), and the parity helpers that
``tests/test_torch_vlm.py`` and ``tests/test_torch_hybrid.py`` share.

``moe_apply`` (the capacity form, which training takes) on the same numpy
inputs and bridged weights: within 2e-5 in the dropless branch (groups of
at most 32 tokens) and in the capacity branch, one case of which drops
choices (a router biased to one expert), with the auxiliary loss equal;
the forward that keeps no cache over 64 tokens takes that branch too.
The model through prefill, verify, commit and decode: logits within 2e-5
(every routed call at most 32 tokens, where the reference drops nothing
and the port's served, dropless form is the reference's); a 64-token
verify, where the reference would drop, against the plain dropless
reference instead.  Greedy streams equal the JAX engines'
(``np.array_equal``) on the dense and paged engines, the continuous
scheduler and the static-buffer graph step, on the boosted weights of
``tests/test_torch_engine.py`` (a boost of 8 here: at 4 the random
model's argmax is not the heads' boosted guess, and acceptance stays 1).
``lm_loss`` and its grads equal ``jax.value_and_grad``'s (grads within
2e-6 x the leaf's max |g|) with a nonzero auxiliary loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.speculative import tree as JT
from repro.models import mlp as jmlp
from repro.models.api import get_model as j_get_model
from repro.runtime import cache as jcache
from repro.runtime import scheduler as JS
from repro.runtime.engine import BatchEngine as JBatch
from repro.runtime.engine import SpeculativeEngine as JSpec
from repro.training import train as jtrain
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.speculative import tree as TT
from repro_torch.data.pipeline import MarkovDataset
from repro_torch.models import mlp as tmlp
from repro_torch.models.api import get_model as t_get_model
from repro_torch.runtime import cache as tcache
from repro_torch.runtime import continuous as TS
from repro_torch.runtime.engine import BatchEngine as TBatch
from repro_torch.runtime.engine import SpeculativeEngine as TSpec
from test_torch_engine import BOOST, _setup
from test_torch_sched import _reqs, _same_results
from test_torch_training import _get, _jb, _paths

ARCH = "qwen3-moe-30b-a3b-smoke"
TOL = 2e-5                     # logits and MoE outputs, fp32
GRAD_TOL = 2e-6                # x the leaf's max |g|
N = 12                         # tokens a row in the engine runs
# at the default boost of 4 the xLSTM and enc-dec models accept every
# draft (acceptance 4.0: streams of token 7 alone); these give mixed
# acceptance (1.36 and 2.22)
BOOSTS = {ARCH: 8.0, "xlstm-125m-smoke": 2.25,
          "seamless-m4t-medium-smoke": 2.0}
# engine layouts: label -> engine keywords
LAYOUTS = {"dense": {}, "paged": dict(paged=True, page_size=4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    test workers share the machine's cores: one torch thread each."""
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


# --------------------------------------------------------------------------
# shared helpers (the VLM and hybrid tests import these)
# --------------------------------------------------------------------------
def family_setup(arch):
    """``test_torch_engine._setup`` at the family's boost."""
    return _setup(arch, BOOSTS.get(arch, BOOST))


def family_batch(cfg, toks, seed=3):
    """The prefill batch dict: the tokens and, for the VLM family, seeded
    patch embeds of the config's prefix length (the enc-dec family: frame
    embeds of its encoder length)."""
    batch = {"tokens": toks}
    extra = {"vision": ("patch_embeds", cfg.num_frontend_tokens),
             "audio": ("frame_embeds", cfg.encoder_seq_len)}.get(cfg.frontend)
    if extra is not None:
        name, n = extra
        batch[name] = np.random.default_rng(seed).standard_normal(
            (toks.shape[0], n, cfg.d_model)).astype(np.float32)
    return batch


def logits_match(arch, *, B=3, P=10, width=8, rounds=2):
    """Prefill, ``rounds`` verify + commit rounds at tree width ``width``
    (rows committing 0 to max_depth tokens, so positions diverge and a
    frozen row commits nothing), then a decode step: the port's logits,
    hidden states and cache against the reference's.  Returns the largest
    logit error."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    jm, tm = j_get_model(cfg), t_get_model(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    batch = family_batch(cfg, toks)
    spec = JT.build_tree(JT.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                         width)
    jtree = JT.Tree.from_spec(spec)
    ttree = TT.Tree.from_spec(spec, "cpu")
    max_len = P + cfg.num_frontend_tokens + rounds * spec.max_depth + 2

    lj, ej, cj = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                            max_len=max_len)
    lt, et, ct = tm.prefill(tp, {k: _t(v) for k, v in batch.items()},
                            max_len=max_len)
    errs = [float(np.max(np.abs(lt.numpy() - np.asarray(lj))))]
    _close(lt, lj)
    assert float(et["aux_loss"]) == pytest.approx(float(ej["aux_loss"]),
                                                  rel=1e-5, abs=1e-9)
    for rnd in range(rounds):
        tt = rng.integers(0, cfg.vocab_size, (B, spec.width)).astype(np.int32)
        lj, ej = jm.verify(jp, cj, jnp.asarray(tt), jtree)
        lt, et = tm.verify(tp, ct, _t(tt), ttree)
        errs.append(float(np.max(np.abs(lt.numpy() - np.asarray(lj)))))
        _close(lt, lj)
        _close(et["hidden"], ej["hidden"])
        paths = spec.paths[rng.integers(0, spec.n_paths, B)].astype(np.int32)
        n = rng.integers(0, spec.max_depth + 1, B).astype(np.int32)
        n[rnd % B] = 0                                 # a frozen row
        last = paths[np.arange(B), np.maximum(n - 1, 0)]
        path_idx = spec.node_path[last].astype(np.int32)
        cj = jm.commit(cj, ej, jtree, jnp.asarray(paths), jnp.asarray(n),
                       jnp.asarray(path_idx))
        ct = tm.commit(ct, et, ttree, _t(paths), _t(n), _t(path_idx))
        _same_cache(ct, cj)
    step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    lj, cj = jm.decode(jp, cj, jnp.asarray(step))
    lt, ct = tm.decode(tp, ct, _t(step))
    errs.append(float(np.max(np.abs(lt.numpy() - np.asarray(lj)))))
    _close(lt, lj)
    _same_cache(ct, cj)
    return max(errs)


def _same_cache(t, j):
    assert (t.kv is None) == (j.kv is None)
    if j.kv is not None:
        np.testing.assert_array_equal(t.kv.pos.numpy(), np.asarray(j.kv.pos))
        np.testing.assert_array_equal(t.kv.key_pos.numpy(),
                                      np.asarray(j.kv.key_pos))
        _close(t.kv.k, j.kv.k)
        _close(t.kv.v, j.kv.v)
    for f in ("cross_k", "cross_v"):
        assert (getattr(t, f) is None) == (getattr(j, f) is None)
        if getattr(j, f) is not None:
            _close(getattr(t, f), getattr(j, f))
    assert (t.xlstm is None) == (j.xlstm is None)
    if j.xlstm is not None:
        np.testing.assert_array_equal(t.xlstm.pos.numpy(),
                                      np.asarray(j.xlstm.pos))
        for tl, jl in zip(t.xlstm.layers, j.xlstm.layers, strict=True):
            assert tl.keys() == jl.keys()
            for k in jl:
                _close(tl[k], jl[k], 1e-4)
    if j.mamba is not None:
        _close(t.mamba.ssm, j.mamba.ssm, 1e-4)
        _close(t.mamba.conv, j.mamba.conv)
        np.testing.assert_array_equal(t.mamba.pos.numpy(),
                                      np.asarray(j.mamba.pos))


def engine_pair(arch, kind, **kw):
    """(JAX engine, port engine) of one kind ("spec" | "batch") on the
    family's boosted weights, and the prefill batch."""
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = family_setup(arch)
    kw = dict({"max_len": toks.shape[1] + cfg.num_frontend_tokens + N
               + spec.max_depth, "chunk": 4}, **kw)
    if kind == "spec":
        pair = JSpec(jm, jh, jp, spec, **kw), TSpec(tm, th, tp, tspec, **kw)
    else:
        pair = JBatch(jm, jp, **kw), TBatch(tm, tp, **kw)
    return pair + (family_batch(cfg, toks),)


def engines_equal_jax(arch, kind, layout, *, graphed=False):
    """One ``generate`` on each engine: equal tokens, counts and
    acceptance.  ``graphed`` drives the port's static-buffer graph step
    (the card's path, without capture) and checks it replayed.  Returns
    the port's stats."""
    # chunks of 2 with the graph: warm-up, capture, then replays
    jeng, teng, batch = engine_pair(arch, kind, **LAYOUTS[layout],
                                    chunk=2 if graphed else 4)
    teng._graphed = graphed
    budgets = np.array([N, N - 5], np.int32)
    jo, js = jeng.generate(batch, budgets)
    to, ts = teng.generate(batch, budgets)
    np.testing.assert_array_equal(to, np.asarray(jo))
    np.testing.assert_array_equal(ts["n_emitted"], np.asarray(js["n_emitted"]))
    np.testing.assert_array_equal(ts["n_emitted"], budgets)
    assert ts["acceptance_length"] == pytest.approx(js["acceptance_length"])
    if kind == "spec":
        assert ts["acceptance_length"] > 1.3          # multi-token commits
    if graphed:
        assert ts["replay_steps"] > 0
    return ts


def sched_requests(cfg, n=5, budgets=(5, 9, 3), plen=6, seed=3):
    """Text requests with staggered arrivals (a bank of 2 rows admits mid
    run and reuses evicted rows)."""
    rng = np.random.default_rng(seed)
    return [dict(req_id=i,
                 tokens=rng.integers(0, cfg.vocab_size, plen).astype(
                     np.int32),
                 n_tokens=int(budgets[i % len(budgets)]),
                 arrival=0.01 * i) for i in range(n)]


def continuous_equal_jax(arch, kind, layout, *, graphed=False, B=2):
    """The continuous scheduler over the port's engine against the JAX
    scheduler over the JAX engine: equal tokens per request, every pool
    drained.  Returns the port's scheduler."""
    jeng, teng, _ = engine_pair(arch, kind, **LAYOUTS[layout])
    teng._graphed = graphed
    trace = sched_requests(family_setup(arch)[0])
    jres, _ = JS.ContinuousScheduler(jeng, batch=B).serve(_reqs(JS, trace))
    tsched = TS.ContinuousScheduler(teng, batch=B)
    tres, _ = tsched.serve(_reqs(TS, trace))
    _same_results(tres, jres, (arch, kind, layout, graphed))
    for eng in (teng, jeng):
        assert eng.sched_pool_conserved() and eng.sched_drained()
    return tsched


def lm_loss_and_grads_match(arch, *, seq=16, batch_size=2,
                            grad_tol=GRAD_TOL, zero_grads=()):
    """``lm_loss`` and its grads against ``jax.value_and_grad`` of the
    reference's on one Markov batch (the VLM batch with its patch
    embeds, the enc-dec's with its frames): grads within ``grad_tol`` x
    each leaf's max |g|.  A leaf named in ``zero_grads`` has a grad that
    is exactly zero in exact arithmetic (its value is rounding noise on
    both sides): both sides must stay under 1e-6 x the largest grad of
    any leaf instead.  Returns the port's (loss, ce, aux)."""
    from repro_torch.training import train as ttrain
    cfg, tcfg = get_config(arch), t_get_config(arch)
    jm, tm = j_get_model(cfg), t_get_model(tcfg)
    jp = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(0)))
    batch = next(iter(MarkovDataset(cfg.vocab_size, seed=1).batches(
        batch_size, seq, 1)))
    batch = family_batch(cfg, batch["tokens"]) | {"labels": batch["labels"]}
    batch["labels"] = batch["labels"].copy()
    batch["labels"][0, :3] = -100

    def jloss(p):
        return jtrain.lm_loss(cfg, jm, p, _jb(batch))

    (jl, jce), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    tp = params_from_jax(tcfg, jp, device="cpu")
    (tl, tce), tg = ttrain.lm_value_and_grad(tcfg, tm, tp, batch)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(tce) == pytest.approx(float(jce), rel=1e-5)
    top = max(float(np.max(np.abs(np.asarray(g, np.float32))))
              for _, g in _paths(jg))
    for path, g in _paths(jg):
        g = np.asarray(g, np.float32)
        t = _get(tg, path).float().numpy()
        if path[-1] in zero_grads:
            assert max(float(np.max(np.abs(g))),
                       float(np.max(np.abs(t)))) <= 1e-6 * top, path
            continue
        err = float(np.max(np.abs(t - g)))
        assert err <= grad_tol * float(np.max(np.abs(g))), (path, err)
    _, extras, _ = tm.prefill(tp, {k: _t(v) for k, v in batch.items()
                                   if k != "labels"}, return_cache=False)
    return float(tl), float(tce), float(extras["aux_loss"])


def int8_verify_gap(arch):
    """Largest |verify logits over an int8 pool - the float verify's| of
    the port and of the reference, on the same seeded prompt (B=2, 12
    tokens), tree (W=8) and pool (8 pages of 4): ``{"port": e, "reference":
    e}``.  The families whose reference verify hands the pool over without
    its scales read raw codes there."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    jm, tm = j_get_model(cfg), t_get_model(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    batch = family_batch(cfg, toks)
    spec = JT.build_tree(JT.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                         8)
    tt = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                           (2, spec.width)).astype(np.int32)
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    errs = {}
    for name, m, params, tree, arr, mod, int8 in (
            ("port", tm, tp, TT.Tree.from_spec(spec, "cpu"), _t, tcache,
             torch.int8),
            ("reference", jm, jp, JT.Tree.from_spec(spec), jnp.asarray,
             jcache, "int8")):
        _, _, c = m.prefill(params, {k: arr(v) for k, v in batch.items()},
                            max_len=1)
        dense, _ = m.verify(params, c, arr(tt), tree)
        paged = mod.paginate_cache(c, arr(tables), page_size=4, n_pages=8,
                                   kv_dtype=int8)
        q, _ = m.verify(params, paged, arr(tt), tree)
        errs[name] = float(np.max(np.abs(np.asarray(q) - np.asarray(dense))))
    return errs


# --------------------------------------------------------------------------
# moe_apply
# --------------------------------------------------------------------------
# (B, S, router bias toward expert 0): groups of 8 and 32 run dropless;
# 64 and 150 (the largest divisor of 300 under 256) take the capacity
# factor, and the biased router sends every token's first choice to
# expert 0, past its buffer of 40
MOE_CASES = {"dropless g=8": (1, 8, 0.0), "dropless g=32": (4, 8, 0.0),
             "capacity g=64": (2, 32, 0.0), "drops g=64": (2, 32, 50.0),
             "capacity g=150": (1, 300, 0.0)}


def _dropped(cfg, router, x):
    """Choices past their expert's capacity, counted in numpy."""
    B, S, d = x.shape
    g, G, cap = tmlp.moe_groups(cfg, B * S)
    logits = x.reshape(G, g, d).astype(np.float64) @ router
    idx = np.argsort(-logits, axis=-1, kind="stable")[..., :cfg.experts_per_token]
    n = 0
    for grp in idx:
        seen = np.zeros(cfg.num_experts, int)
        for e in grp.reshape(-1):
            n += seen[e] >= cap
            seen[e] += 1
    return n


@pytest.mark.parametrize("label", list(MOE_CASES))
def test_moe_apply_matches_reference(label):
    B, S, bias = MOE_CASES[label]
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    p = jax.tree.map(np.array, jmlp.moe_init(cfg, jax.random.PRNGKey(4)))
    p["router"][:, 0] += bias / cfg.d_model
    rng = np.random.default_rng(B * S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if bias:
        x += 1.0                               # the bias needs a mean > 0
    jo, jaux = jmlp.moe_apply(cfg, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x))
    to, taux = tmlp.moe_apply(tcfg, params_from_jax(tcfg, p, device="cpu"),
                              _t(x))
    _close(to, jo)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    assert taux.dtype == torch.float32
    g, _, cap = tmlp.moe_groups(tcfg, B * S)
    assert (cap == g) == (g <= 32)
    if bias:
        assert _dropped(cfg, p["router"], x) > 0


@pytest.mark.parametrize("T,g,cap", [(8, 8, 8), (32, 32, 32), (64, 64, 40),
                                     (300, 150, 93), (2044, 146, 91),
                                     (97, 97, 60)])
def test_moe_groups(T, g, cap):
    """g is the largest divisor of T up to 256; cap = g up to 32 tokens,
    else max(K, int(g K / E x 1.25)) (E=4, K=2 at smoke size)."""
    assert tmlp.moe_groups(t_get_config(ARCH), T) == (g, T // g, cap)


def test_moe_init_draws_one_layer_at_a_time():
    """The expert stacks are (L, E, d, f) in the model's dtype, the router
    (L, d, E) in float32."""
    tcfg = dataclasses.replace(t_get_config(ARCH), dtype="bfloat16")
    params = t_get_model(tcfg).init_params(torch.Generator().manual_seed(0))
    moe = params["layers"]["moe"]
    L, E, d, f = (tcfg.num_layers, tcfg.num_experts, tcfg.d_model,
                  tcfg.d_ff)
    assert moe["w_gate"].shape == (L, E, d, f)
    assert moe["w_down"].shape == (L, E, f, d)
    assert moe["w_up"].dtype == torch.bfloat16
    assert moe["router"].shape == (L, d, E)
    assert moe["router"].dtype == torch.float32
    assert "mlp" not in params["layers"]


def test_bridge_keeps_float32_leaves():
    """A bfloat16 config's reference params cross with their dtypes: the
    router stays float32."""
    cfg = dataclasses.replace(get_config(ARCH), dtype="bfloat16")
    jp = jax.tree.map(np.asarray,
                      j_get_model(cfg).init_params(jax.random.PRNGKey(0)))
    tp = params_from_jax(cfg, jp, device="cpu")
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    assert tp["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    assert tp["layers"]["moe"]["w_up"].shape == \
        jp["layers"]["moe"]["w_up"].shape
    np.testing.assert_array_equal(tp["layers"]["moe"]["router"].numpy(),
                                  jp["layers"]["moe"]["router"])


# --------------------------------------------------------------------------
# the model, the engines, the scheduler, training
# --------------------------------------------------------------------------
def test_logits_match_reference():
    assert logits_match(ARCH) < TOL


def test_training_forward_over_32_tokens_takes_the_capacity_branch():
    """64 tokens routed together (B=4 rows of 16) through the forward that
    keeps no cache, as training calls it: one group of 64 at the capacity
    factor, in the reference as in the port; logits and the auxiliary
    loss equal."""
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    jm, tm = j_get_model(cfg), t_get_model(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    g, _, cap = tmlp.moe_groups(tcfg, toks.size)
    assert (g, cap) == (64, 40)
    lj, ej, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                           return_cache=False)
    lt, et, _ = tm.prefill(tp, {"tokens": _t(toks)}, return_cache=False)
    _close(lt, lj)
    assert float(et["aux_loss"]) == pytest.approx(float(ej["aux_loss"]),
                                                  rel=1e-5)


def test_verify_over_32_tokens_routes_dropless():
    """B=4 rows of a W=16 tree verify 64 tokens in one routed call: the
    served verify keeps every choice, so each node's logits are the plain
    dropless reference's (``portbench/reference/model.py::Ref``) over the
    row's prompt and the node's path, on the bridged weights."""
    from portbench.reference.model import Ref
    from test_torch_moe_dropless import LOGIT_TOL, ref_config
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    tm = t_get_model(tcfg)
    tp = params_from_jax(tcfg, jax.tree.map(
        np.asarray, j_get_model(cfg).init_params(jax.random.PRNGKey(0))),
        device="cpu")
    ref = Ref(ref_config(tcfg), tp, heads=None)
    rng = np.random.default_rng(2)
    B, P = 4, 10
    toks = _t(rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32))
    spec = TT.build_tree(TT.default_accs(tcfg.medusa_heads,
                                         tcfg.medusa_top_k), 16)
    assert spec.width == 16
    _, _, cache = tm.prefill(tp, {"tokens": toks}, max_len=P + 8)
    tt = _t(rng.integers(0, cfg.vocab_size, (B, spec.width)).astype(
        np.int32))
    lt, _ = tm.verify(tp, cache, tt, TT.Tree.from_spec(spec, "cpu"))
    for b in range(B):
        for j in range(spec.width):
            path, node = [], j
            while node >= 0:
                path.append(int(tt[b, node]))
                node = int(spec.parent[node])
            seq = torch.cat([toks[b].long(), torch.tensor(path[::-1])])
            want, _ = ref.forward(seq, len(seq) - 1)
            err = float((lt[b, j] - want[0]).abs().max())
            assert err <= LOGIT_TOL, (b, j, err)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ["spec", "batch"])
def test_engines_equal_jax(kind, layout):
    engines_equal_jax(ARCH, kind, layout)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_static_graph_step_equals_jax(layout):
    engines_equal_jax(ARCH, "spec", layout, graphed=True)


@pytest.mark.parametrize("kind,layout", [("spec", "paged"),
                                         ("batch", "dense")])
def test_continuous_scheduler_equals_jax(kind, layout):
    continuous_equal_jax(ARCH, kind, layout)


def test_training_parity_with_aux_loss():
    loss, ce, aux = lm_loss_and_grads_match(ARCH)
    assert aux > 0.0 and loss == pytest.approx(ce + aux, rel=1e-6)
