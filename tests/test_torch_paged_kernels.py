"""The port's paged kernel paths against the reference, on the CPU.

On a CPU tensor each wrapper runs its plain version: the fused page walk
``paged_tree_attention_plain``, the cache-only walk
``paged_cache_attention_plain`` and the tree partial
``sparse_tree_attention_partial_plain``.  They are held against the JAX
oracles of ``repro.kernels.ref`` and the Pallas kernels in interpret mode
(``repro.kernels.ops``, ``INTERPRET`` = True) on the same numpy inputs:

* the window-0 rows of the reference's dense sweep (``CASES``, copied from
  ``tests/test_kernels.py``) turned into paged layouts: shuffled tables
  across the pool, a trailing unreserved (-1) entry per row and a partial
  last page;
* the reference's int8 sweep (``PAGED_INT8_CASES``), fragmented random
  reservations with partial fills.

Tolerances are the reference's own: fp32 2e-5, bf16 2e-2 (atol = rtol).
The CUDA kernels are compared with these plain versions on the card by
``test_torch_card.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jcm
from repro_torch.kernels import dispatch
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import plain
from repro_torch.kernels import tree_partial as tp
from repro_torch.models import common as cm

# tests/test_kernels.py CASES with window 0: B, W, Hq, Hkv, hd, S, pos, dtype;
# page size 8 or 16
CASES = [
    (1, 1, 4, 4, 64, 32, 17, 16, "float32"),       # plain decode
    (2, 8, 4, 2, 64, 40, 33, 16, "float32"),       # GQA tree, partial page
    (1, 16, 8, 1, 128, 128, 100, 16, "float32"),   # MQA, wide tree
    (1, 8, 4, 2, 64, 64, 64, 16, "bfloat16"),      # bf16, full ring
    (1, 32, 2, 2, 16, 8, 6, 8, "float32"),         # tiny cache, big tree
    (4, 8, 4, 2, 32, 24, 20, 8, "float32"),        # B=4 diverged pos
]
# tests/test_kernels.py PAGED_INT8_CASES: B, W, Hq, Hkv, hd, ps, n_pages, maxp
PAGED_INT8_CASES = [
    (1, 1, 4, 4, 32, 8, 6, 2),
    (2, 8, 4, 2, 64, 16, 10, 3),
    (3, 4, 8, 1, 32, 4, 12, 4),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _rand_tree_mask(W, seed=0):
    rng = np.random.default_rng(seed)
    parent = np.full(W, -1)
    for i in range(1, W):
        parent[i] = rng.integers(0, i)
    mask = np.zeros((W, W), bool)
    depth = np.zeros(W, np.int32)
    for i in range(W):
        j = i
        while j >= 0:
            mask[i, j] = True
            j = parent[j]
        d, j = 0, i
        while parent[j] >= 0:
            d, j = d + 1, parent[j]
        depth[i] = d
    return mask, depth


def _ring_key_pos(pos, S):
    base = np.arange(S)
    if pos >= S:
        return pos - S + ((base - (pos % S)) % S)
    return np.where(base < pos, base, -1)


def dense_case(B, W, Hq, Hkv, hd, S, pos, ps):
    """A CASES row as a paged layout: each row's ring of S slots spread over
    shuffled pool pages, then one unreserved (-1) table entry.  Returns a
    dict of numpy arrays (float32 pools, no scales)."""
    rng = np.random.default_rng(B * W + S)
    maxp = -(-S // ps) + 1
    n_pages = B * maxp + 2
    P = n_pages + 1
    pos_b = np.array([max(pos - 2 * b, 1) for b in range(B)], np.int32)
    key_pos = np.full((B, maxp * ps), -1, np.int32)
    key_pos[:, :S] = np.stack([_ring_key_pos(p, S) for p in pos_b])
    table = np.full((B, maxp), -1, np.int32)
    table[:, :maxp - 1] = rng.permutation(n_pages)[:B * (maxp - 1)].reshape(
        B, maxp - 1)
    mask, depth = _rand_tree_mask(W, seed=S)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(q=randn(B, W, Hq, hd), pool_k=randn(P, ps, Hkv, hd),
                pool_v=randn(P, ps, Hkv, hd), scale_k=None, scale_v=None,
                k_new=randn(B, W, Hkv, hd), v_new=randn(B, W, Hkv, hd),
                block_table=table, key_pos=key_pos,
                q_pos=(pos_b[:, None] + depth[None, :]).astype(np.int32),
                lo=np.full((B, W), -1, np.int32), tree_mask=mask,
                pos=pos_b, depth=depth)


def int8_case(B, W, Hq, Hkv, hd, ps, n_pages, maxp):
    """A PAGED_INT8_CASES row, generated as ``tests/test_kernels.py`` does:
    a symmetric per-page int8 pool, random fragmented reservations, a
    partial fill per row."""
    rng = np.random.default_rng(B * W + n_pages)
    P = n_pages + 1
    pool = rng.normal(size=(2, P, ps, Hkv, hd)).astype(np.float32)
    scale = (np.abs(pool).max(axis=(2, 4)) / 127.0).astype(np.float32)
    qpool = np.clip(np.round(pool / np.maximum(
        scale, 1e-30)[:, :, None, :, None]), -127, 127).astype(np.int8)
    q = rng.normal(size=(B, W, Hq, hd)).astype(np.float32)
    kn = rng.normal(size=(B, W, Hkv, hd)).astype(np.float32)
    vn = rng.normal(size=(B, W, Hkv, hd)).astype(np.float32)
    table = np.full((B, maxp), -1, np.int32)
    key_pos = np.full((B, maxp * ps), -1, np.int32)
    fills = []
    for b in range(B):
        n_res = int(rng.integers(1, maxp + 1))
        table[b, :n_res] = rng.choice(n_pages, n_res, replace=False)
        fills.append(int(rng.integers(1, n_res * ps + 1)))
        key_pos[b, :fills[-1]] = np.arange(fills[-1])
    mask, depth = _rand_tree_mask(W, seed=ps)
    pos_b = np.asarray(fills, np.int32)
    return dict(q=q, pool_k=qpool[0], pool_v=qpool[1], scale_k=scale[0],
                scale_v=scale[1], k_new=kn, v_new=vn, block_table=table,
                key_pos=key_pos,
                q_pos=(pos_b[:, None] + depth[None, :]).astype(np.int32),
                lo=np.full((B, W), -1, np.int32), tree_mask=mask,
                pos=pos_b, depth=depth)


FLOATS = ("q", "k_new", "v_new")
WALK = ("block_table", "key_pos", "q_pos", "lo")


def _to_jax(c, dtype):
    dt = getattr(jnp, dtype)
    out = {}
    for k, v in c.items():
        if v is None:
            out[k] = None
        elif k in FLOATS or (k.startswith("pool") and v.dtype != np.int8):
            out[k] = jnp.asarray(v, dt)
        else:
            out[k] = jnp.asarray(v)
    return out


def _to_torch(c, dtype):
    dt = getattr(torch, dtype)
    out = {}
    for k, v in c.items():
        if v is None:
            out[k] = None
        elif k in FLOATS or (k.startswith("pool") and v.dtype != np.int8):
            out[k] = torch.from_numpy(v).to(dt)
        else:
            out[k] = torch.from_numpy(v)
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _all_cases():
    out = [pytest.param("dense", c, id=f"case{i}")
           for i, c in enumerate(CASES)]
    out += [pytest.param("int8", c, id=f"int8-{i}")
            for i, c in enumerate(PAGED_INT8_CASES)]
    return out


def _build(kind, case):
    if kind == "dense":
        B, W, Hq, Hkv, hd, S, pos, ps, dtype = case
        return dense_case(B, W, Hq, Hkv, hd, S, pos, ps), dtype
    return int8_case(*case), "float32"


@pytest.mark.parametrize("kind,case", _all_cases())
def test_paged_tree_attention_matches_oracle_and_pallas(kind, case):
    c, dtype = _build(kind, case)
    j, t = _to_jax(c, dtype), _to_torch(c, dtype)
    ref = jref.paged_tree_attention_ref(
        j["q"], j["pool_k"], j["pool_v"], j["scale_k"], j["scale_v"],
        j["k_new"], j["v_new"], *(j[k] for k in WALK), j["tree_mask"])
    pallas = jops.paged_tree_attention(
        j["q"], j["pool_k"], j["pool_v"], j["k_new"], j["v_new"],
        j["block_table"], j["key_pos"], j["pos"], j["depth"],
        j["tree_mask"], scale_k=j["scale_k"], scale_v=j["scale_v"])
    n = pa.paged_tree_attention.launches
    got = pa.paged_tree_attention(
        t["q"], t["pool_k"], t["pool_v"], t["scale_k"], t["scale_v"],
        t["k_new"], t["v_new"], *(t[k] for k in WALK), t["tree_mask"])
    disp = dispatch.paged_tree_attention(
        t["q"], t["pool_k"], t["pool_v"], t["k_new"], t["v_new"],
        t["block_table"], t["key_pos"], t["pos"], t["depth"],
        t["tree_mask"], scale_k=t["scale_k"], scale_v=t["scale_v"])
    assert pa.paged_tree_attention.launches == n      # CPU: no launch
    assert got.dtype == t["q"].dtype and got.shape == t["q"].shape
    assert torch.equal(got, disp)
    tol = TOL[dtype]
    _close(got.float(), ref, tol)
    _close(got.float(), pallas, tol)


@pytest.mark.parametrize("kind,case", _all_cases())
def test_split_partials_match_oracle_pallas_and_fused(kind, case):
    """The cache-only walk and the tree partial each equal their oracle and
    Pallas kernel; merged by Eq. 1 they equal the fused page walk."""
    c, dtype = _build(kind, case)
    j, t = _to_jax(c, dtype), _to_torch(c, dtype)
    tol = TOL[dtype]
    cache_ref = jref.paged_cache_attention_ref(
        j["q"], j["pool_k"], j["pool_v"], j["scale_k"], j["scale_v"],
        *(j[k] for k in WALK))
    cache_pallas = jops.paged_cache_attention(
        j["q"], j["pool_k"], j["pool_v"], j["block_table"], j["key_pos"],
        j["pos"], j["depth"], scale_k=j["scale_k"], scale_v=j["scale_v"])
    tree_ref = jref.sparse_tree_attention_partial_ref(
        j["q"], j["k_new"], j["v_new"], j["tree_mask"])
    tree_pallas = jops.sparse_tree_attention_partial(
        j["q"], j["k_new"], j["v_new"], j["tree_mask"])
    n = (pa.paged_cache_attention.launches,
         tp.sparse_tree_attention_partial.launches)
    cache_part = pa.paged_cache_attention(
        t["q"], t["pool_k"], t["pool_v"], t["scale_k"], t["scale_v"],
        *(t[k] for k in WALK))
    tree_part = tp.sparse_tree_attention_partial(
        t["q"], t["k_new"], t["v_new"], t["tree_mask"])
    assert (pa.paged_cache_attention.launches,
            tp.sparse_tree_attention_partial.launches) == n
    disp_cache = dispatch.paged_cache_attention(
        t["q"], t["pool_k"], t["pool_v"], t["block_table"], t["key_pos"],
        t["pos"], t["depth"], scale_k=t["scale_k"], scale_v=t["scale_v"])
    disp_tree = dispatch.sparse_tree_attention_partial(
        t["q"], t["k_new"], t["v_new"], t["tree_mask"])
    for parts, refs in ((cache_part, (cache_ref, cache_pallas, disp_cache)),
                        (tree_part, (tree_ref, tree_pallas, disp_tree))):
        assert [p.dtype for p in parts] == [torch.float32] * 3
        for want in refs:
            for a, b in zip(parts, want):
                _close(a, b, tol)
    merged = cm.merge_partials([cache_part, tree_part])
    fused = plain.paged_tree_attention_plain(
        t["q"], t["pool_k"], t["pool_v"], t["scale_k"], t["scale_v"],
        t["k_new"], t["v_new"], *(t[k] for k in WALK), t["tree_mask"])
    _close(merged, fused.float(), tol)
    _close(merged, jcm.merge_partials([cache_pallas, tree_pallas]), tol)


def test_all_masked_cache_rows_drop_out_of_the_merge():
    """A row with no filled slot: l = 0 and m clamped to NEG_INF / 2, as the
    reference's m_safe, so the merge returns the tree half alone."""
    c = dense_case(2, 4, 4, 2, 32, 24, 20, 8)
    c["key_pos"][1] = -1
    t = _to_torch(c, "float32")
    o, m, l = pa.paged_cache_attention(
        t["q"], t["pool_k"], t["pool_v"], None, None, *(t[k] for k in WALK))
    assert torch.all(l[1] == 0) and torch.all(o[1] == 0)
    assert torch.all(m[1] == cm.NEG_INF / 2)
    tree = tp.sparse_tree_attention_partial(t["q"], t["k_new"], t["v_new"],
                                            t["tree_mask"])
    merged = cm.merge_partials([(o, m, l), tree])
    alone = cm.merge_partials([tree])
    assert torch.allclose(merged[1], alone[1], atol=1e-6, rtol=1e-6)


def _valid():
    return _to_torch(int8_case(2, 8, 4, 2, 64, 16, 10, 3), "float32")


def _args(t):
    return (t["q"], t["pool_k"], t["pool_v"], t["scale_k"], t["scale_v"],
            *(t[k] for k in WALK), t["k_new"], t["v_new"], t["tree_mask"])


@pytest.mark.parametrize("breaks,why", [
    (lambda t: t.update(pool_v=t["pool_v"][:, :, :1]), "shape"),
    (lambda t: t.update(block_table=t["block_table"].long()), "int32"),
    (lambda t: t.update(scale_k=None), "scales"),
    (lambda t: t.update(scale_v=t["scale_v"].double()), "float32"),
    (lambda t: t.update(q=t["q"].double()), "q dtype"),
    (lambda t: t.update(pool_k=t["pool_k"].to(torch.int16),
                        pool_v=t["pool_v"].to(torch.int16)), "pool dtype"),
    (lambda t: t.update(tree_mask=t["tree_mask"].int()), "bool"),
    (lambda t: t.update(key_pos=t["key_pos"][:, :-1]), "key_pos"),
    (lambda t: t.update(q=t["q"].transpose(0, 1).contiguous()
                        .transpose(0, 1)), "contiguous"),
])
def test_paged_wrapper_rejects_what_the_kernel_does_not_take(breaks, why):
    t = _valid()
    assert pa._check(*_args(t)) == (2, 8, 4, 2, 64, 16, 3)
    breaks(t)
    with pytest.raises((ValueError, TypeError)):
        pa._check(*_args(t))


def test_int8_pool_needs_head_dim_multiple_of_16():
    t = _to_torch(int8_case(1, 1, 4, 4, 32, 8, 6, 2), "float32")
    for k in ("pool_k", "pool_v"):
        t[k] = torch.zeros(t[k].shape[:3] + (24,), dtype=torch.int8)
    for k in ("q", "k_new", "v_new"):
        t[k] = torch.zeros(t[k].shape[:3] + (24,))
    with pytest.raises(ValueError, match="multiple of 16"):
        pa._check(*_args(t))


def test_tree_partial_wrapper_checks():
    t = _valid()
    args = [t["q"], t["k_new"], t["v_new"], t["tree_mask"]]
    assert tp._check(*args) == (2, 8, 4, 2, 64)
    for i, bad in ((1, t["k_new"].double()), (3, t["tree_mask"].int()),
                   (2, t["v_new"][:, :4])):
        broken = list(args)
        broken[i] = bad
        with pytest.raises((ValueError, TypeError)):
            tp._check(*broken)


def test_wrappers_run_on_cuda_or_cpu_only():
    t = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
         for k, v in _valid().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_tree_attention(t["q"], t["pool_k"], t["pool_v"],
                                t["scale_k"], t["scale_v"], t["k_new"],
                                t["v_new"], *(t[k] for k in WALK),
                                t["tree_mask"])
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_cache_attention(t["q"], t["pool_k"], t["pool_v"],
                                 t["scale_k"], t["scale_v"],
                                 *(t[k] for k in WALK))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tp.sparse_tree_attention_partial(t["q"], t["k_new"], t["v_new"],
                                         t["tree_mask"])
