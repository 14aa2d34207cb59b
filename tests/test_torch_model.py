"""The port's numeric core, dense cache and dense decoder against the JAX
reference, on the same numpy inputs and bridged weights (fp32 smoke
configs).

Tolerances: elementwise ops and attention partials 1e-5 (atol = rtol; the
largest error seen is 4.8e-7); model logits and hidden states 1e-4 over two
layers of fp32 matmuls (largest seen 5.2e-6); cache positions are exact and
cached K/V within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.speculative import tree as JT
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.models.api import get_model as j_get_model
from repro.runtime import cache as jcache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.speculative import tree as TT
from repro_torch.models import common as tcm
from repro_torch.models.api import get_model as t_get_model
from repro_torch.runtime import cache as tcache

ATOL_OP = 1e-5
ATOL_LOGITS = 1e-4


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# common ops
# --------------------------------------------------------------------------
def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(tcm.rmsnorm(_t(x), _t(scale), 1e-6),
           jcm.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6), ATOL_OP)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    _close(tcm.apply_rope(_t(x), _t(pos), 10000.0),
           jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), ATOL_OP)


def test_attention_partials_and_merge_match_reference():
    rng = np.random.default_rng(1)
    B, S, T, Hq, Hkv, hd = 2, 5, 9, 4, 2, 8
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    mask = rng.random((B, 1, S, T)) < 0.6
    mask[0, 0, 2] = False                      # an all-masked row
    parts_j = [jcm.gqa_attend_partial(jnp.asarray(q), jnp.asarray(k[:, a:b]),
                                      jnp.asarray(v[:, a:b]),
                                      jnp.asarray(mask[..., a:b]), 0.3)
               for a, b in ((0, 4), (4, 9))]
    parts_t = [tcm.gqa_attend_partial(_t(q), _t(k[:, a:b]), _t(v[:, a:b]),
                                      _t(mask[..., a:b]), 0.3)
               for a, b in ((0, 4), (4, 9))]
    for pj, pt in zip(parts_j, parts_t):
        for aj, at in zip(pj, pt):
            _close(at, aj, ATOL_OP)
    _close(tcm.merge_partials(parts_t), jcm.merge_partials(parts_j), ATOL_OP)
    _close(tcm.merge_partials_carry(parts_t[0], parts_t[1])[0],
           jcm.merge_partials_carry(parts_j[0], parts_j[1])[0], ATOL_OP)
    _close(tcm.gqa_attend(_t(q), _t(k), _t(v), _t(mask), 0.3),
           jcm.gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(mask), 0.3), ATOL_OP)


# --------------------------------------------------------------------------
# dense cache writes (exact)
# --------------------------------------------------------------------------
def _caches(L, B, S, Hkv, hd, pos, window, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, S, Hkv, hd)).astype(np.float32)
    key_pos = np.full((B, S), -1, np.int32)
    for b, p in enumerate(pos):
        for a in range(max(0, p - S), p):
            key_pos[b, a % S] = a
    pos = np.asarray(pos, np.int32)
    j = jcache.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                       key_pos=jnp.asarray(key_pos), pos=jnp.asarray(pos),
                       window=window)
    t = tcache.KVCache(k=_t(k), v=_t(v), key_pos=_t(key_pos), pos=_t(pos),
                       window=window)
    return j, t


def _same_cache(t, j):
    for name in ("k", "v", "key_pos", "pos"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)


@pytest.mark.parametrize("S,window,pos,n_accept,D", [
    (16, 0, [3, 9, 5], [4, 1, 0], 4),          # plain ring, frozen row
    (6, 6, [4, 10, 7], [5, 3, 0], 5),          # window ring wraps
    (4, 4, [3, 9, 2], [6, 2, 5], 6),           # chain longer than the ring
])
def test_kv_commit_matches_reference(S, window, pos, n_accept, D):
    L, B, W, Hkv, hd = 2, 3, 8, 2, 4
    j, t = _caches(L, B, S, Hkv, hd, pos, window, seed=S)
    rng = np.random.default_rng(S + 1)
    kn = rng.standard_normal((L, B, W, Hkv, hd)).astype(np.float32)
    vn = rng.standard_normal((L, B, W, Hkv, hd)).astype(np.float32)
    nodes = rng.integers(0, W, (B, D)).astype(np.int32)
    n = np.asarray(n_accept, np.int32)
    want = jcache.kv_commit(j, jnp.asarray(kn), jnp.asarray(vn),
                            jnp.asarray(nodes), jnp.asarray(n), D)
    got = tcache.kv_commit(t, _t(kn), _t(vn), _t(nodes), _t(n), D)
    _same_cache(got, want)
    cap_j = jcache.capacity_left(jcache.Cache(kv=want))
    cap_t = tcache.capacity_left(tcache.Cache(kv=got))
    np.testing.assert_array_equal(cap_t.numpy(), np.asarray(cap_j))


@pytest.mark.parametrize("window", [0, 5])
def test_masks_match_reference(window):
    rng = np.random.default_rng(window)
    key_pos = rng.integers(-1, 30, (3, 16)).astype(np.int32)
    q_pos = rng.integers(0, 30, (3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tcache.batched_decode_mask(_t(key_pos), _t(q_pos), window).numpy(),
        np.asarray(jcache.batched_decode_mask(jnp.asarray(key_pos),
                                              jnp.asarray(q_pos), window)))
    np.testing.assert_array_equal(tcache.prefill_mask(9, window).numpy(),
                                  np.asarray(jcache.prefill_mask(9, window)))


def test_attn_decode_matches_reference():
    """The W=1 decode attention block on one layer of bridged weights."""
    from repro.models.attention import attn_decode as j_attn_decode
    from repro_torch.models.attention import attn_decode as t_attn_decode
    cfg, tcfg = get_config("qwen2-0.5b-smoke"), t_get_config("qwen2-0.5b-smoke")
    jp = j_get_model(cfg).init_params(jax.random.PRNGKey(3))
    lp = jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"]["attn"])
    tlp = params_from_jax(tcfg, lp, device="cpu")
    j, t = _caches(1, 3, 12, cfg.num_kv_heads, cfg.head_dim, [5, 9, 12], 0,
                   seed=4)
    x = np.random.default_rng(5).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)
    jo, (jk, _) = j_attn_decode(cfg, lp, jnp.asarray(x), ck=j.k[0], cv=j.v[0],
                                key_pos=j.key_pos, pos=j.pos)
    to, (tk, _) = t_attn_decode(tcfg, tlp, _t(x), ck=t.k[0], cv=t.v[0],
                                key_pos=t.key_pos, pos=t.pos)
    _close(to, jo, ATOL_OP)
    _close(tk, jk, ATOL_OP)


@pytest.mark.parametrize("S,window,S_new,diverged", [
    (16, 0, 5, False),                         # prefill into a fresh ring
    (6, 6, 9, False),                          # prompt longer than the ring
    (8, 8, 1, True),                           # per-row decode write, wraps
    (4, 4, 6, True),                           # per-row run longer than ring
])
def test_bulk_write_matches_reference(S, window, S_new, diverged):
    L, B, Hkv, hd = 2, 3, 2, 4
    pos = [7, 2, 12] if diverged else [0, 0, 0]
    j, t = _caches(L, B, S, Hkv, hd, pos, window, seed=S + S_new)
    rng = np.random.default_rng(S_new)
    ks = rng.standard_normal((L, B, S_new, Hkv, hd)).astype(np.float32)
    vs = rng.standard_normal((L, B, S_new, Hkv, hd)).astype(np.float32)
    start_j = j.pos if diverged else 0
    start_t = t.pos if diverged else 0
    want = jtf._bulk_write(j, jnp.asarray(ks), jnp.asarray(vs), start_j)
    got = tcache.bulk_write(t, _t(ks), _t(vs), start_t)
    _same_cache(got, want)


# --------------------------------------------------------------------------
# dense decoder on bridged weights
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-0.5b-smoke", "vicuna-7b-smoke"])
def test_prefill_verify_commit_decode_logits_match_reference(arch):
    cfg, tcfg = get_config(arch), t_get_config(arch)
    jm, tm = j_get_model(cfg), t_get_model(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(2)
    B, P = 3, 10
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    spec = JT.build_tree(JT.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                         8)
    jtree = JT.Tree.from_spec(spec)
    ttree = TT.Tree.from_spec(spec, "cpu")
    max_len = P + 3 * spec.max_depth + 1

    lj, _, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    lt, _, ct = tm.prefill(tp, {"tokens": _t(toks)}, max_len=max_len)
    errs = [float(np.max(np.abs(lt.numpy() - np.asarray(lj))))]
    _close(lt, lj, ATOL_LOGITS)
    np.testing.assert_allclose(ct.kv.k.numpy(), np.asarray(cj.kv.k),
                               atol=ATOL_OP, rtol=ATOL_OP)
    np.testing.assert_array_equal(ct.kv.key_pos.numpy(),
                                  np.asarray(cj.kv.key_pos))

    # two verify + commit rounds: positions diverge across the batch
    for rnd in range(2):
        tree_tokens = rng.integers(0, cfg.vocab_size,
                                   (B, spec.width)).astype(np.int32)
        lj, ej = jm.verify(jp, cj, jnp.asarray(tree_tokens), jtree)
        lt, et = tm.verify(tp, ct, _t(tree_tokens), ttree)
        errs.append(float(np.max(np.abs(lt.numpy() - np.asarray(lj)))))
        _close(lt, lj, ATOL_LOGITS)
        _close(et["hidden"], ej["hidden"], ATOL_LOGITS)
        paths = spec.paths[rng.integers(0, spec.n_paths, B)].astype(np.int32)
        n = rng.integers(1, spec.max_depth + 1, B).astype(np.int32)
        last = paths[np.arange(B), n - 1]
        path_idx = spec.node_path[last].astype(np.int32)
        cj = jm.commit(cj, ej, jtree, jnp.asarray(paths), jnp.asarray(n),
                       jnp.asarray(path_idx))
        ct = tm.commit(ct, et, ttree, _t(paths), _t(n), _t(path_idx))
        np.testing.assert_array_equal(ct.kv.pos.numpy(), np.asarray(cj.kv.pos))
        np.testing.assert_array_equal(ct.kv.key_pos.numpy(),
                                      np.asarray(cj.kv.key_pos))
        np.testing.assert_allclose(ct.kv.v.numpy(), np.asarray(cj.kv.v),
                                   atol=ATOL_OP, rtol=ATOL_OP)

    step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    lj, cj = jm.decode(jp, cj, jnp.asarray(step))
    lt, ct = tm.decode(tp, ct, _t(step))
    errs.append(float(np.max(np.abs(lt.numpy() - np.asarray(lj)))))
    _close(lt, lj, ATOL_LOGITS)
    np.testing.assert_array_equal(ct.kv.key_pos.numpy(),
                                  np.asarray(cj.kv.key_pos))
    assert max(errs) < ATOL_LOGITS, errs
