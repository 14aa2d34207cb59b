"""The port's paged KV pool against the reference, on the CPU.

* ``PageAllocator`` hands out the same page ids as the JAX allocator.
* ``paged_kv_write``, ``paged_kv_commit`` and ``paginate_cache`` leave the
  same pools, scales, tables, ``key_pos`` and ``pos`` as the JAX functions,
  for float32, bfloat16 and int8 pools.  The trash page is left out: every
  masked write lands on its last slot, and with duplicate indices an
  indexed store keeps an arbitrary one.  int8 codes may differ by at most 1
  and scales by at most 1 ulp: the scale is ``amax / 127`` and the code
  ``round(x / scale)``, and XLA may evaluate either division as a multiply
  by the reciprocal, which can move the quotient by an ulp and a code that
  sits on a rounding boundary by one.
* The paged engines (float and int8, fused and split verify) emit the
  port's dense engines' tokens and the JAX paged engines' tokens, on
  ``qwen2-0.5b-smoke`` and ``vicuna-7b-smoke`` in fp32 with bridged,
  boosted weights (``tests/test_torch_engine.py``), so acceptance runs
  above 1 and rows commit chains of different lengths.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import cache as JC
from repro.runtime.engine import BatchEngine as JBatch
from repro.runtime.engine import SpeculativeEngine as JSpec
from repro_torch.data.pipeline import MarkovDataset
from repro_torch.runtime import cache as TC
from repro_torch.runtime.engine import BatchEngine as TBatch
from repro_torch.runtime.engine import SpeculativeEngine as TSpec
from test_torch_engine import ARCHS, _setup

BUDGETS = np.asarray([6, 11, 9], np.int32)
MAX_LEN, CHUNK, PAGE = 64, 4, 8


# --------------------------------------------------------------------------
# allocator
# --------------------------------------------------------------------------
def _alloc_trace(C):
    """The alloc/free sequences of tests/test_paged.py, as a log."""
    log = []

    def attempt(fn, *a):
        try:
            log.append(fn(*a))
        except RuntimeError:
            log.append("raised")

    a = C.PageAllocator(6)
    p0, p1 = a.alloc(2), a.alloc(3)
    log += [p0, p1, a.available]
    a.free(p0)
    log += [a.available, a.alloc(3)]
    attempt(a.alloc, 1)
    log.append(a.alloc_upto(4))
    b = C.PageAllocator(8)
    rows = {r: b.alloc(2) for r in range(4)}
    b.free(rows.pop(1))
    b.free(rows.pop(3))
    big = b.alloc(4)
    log += [big, b.outstanding, b.conserved]
    b.free(big)
    b.free(rows.pop(0))
    b.free(rows.pop(2))
    log += [b.available, b.conserved]
    attempt(b.free, [0])
    attempt(b.alloc, 9)
    b.free([-1])                       # unreserved entries are skipped
    log.append(b.alloc_upto(3))
    return log


def test_allocator_gives_the_reference_page_ids():
    log = _alloc_trace(TC)
    assert log == _alloc_trace(JC)
    assert log[4] == [0, 1, 5] and log[7] == [2, 3, 6, 7]


# --------------------------------------------------------------------------
# cache primitives
# --------------------------------------------------------------------------
L, B, HKV, HD, PS, S_PROMPT = 2, 3, 2, 16, 4, 6
N_PAGES = 10
TABLES = np.asarray([[7, 2, -1, -1], [0, 5, 9, -1], [3, -1, -1, -1]],
                    np.int32)                 # fragmented, partial


def _both_states(pool_dtype):
    """A dense prefilled cache paginated into the same pool by both
    packages, then one bulk write (a decode step; row 2 overflows its
    single page into the trash page) and one commit of tree KVs."""
    rng = np.random.default_rng(5)
    k = (rng.normal(size=(L, B, S_PROMPT, HKV, HD)) * 2).astype(np.float32)
    v = rng.normal(size=(L, B, S_PROMPT, HKV, HD)).astype(np.float32)
    key_pos = np.broadcast_to(np.arange(S_PROMPT, dtype=np.int32),
                              (B, S_PROMPT)).copy()
    key_pos[2, :2] = -1                       # an unfilled dense slot
    pos = np.full((B,), S_PROMPT, np.int32)
    ks = (rng.normal(size=(L, B, 1, HKV, HD)) * 3).astype(np.float32)
    kn = rng.normal(size=(L, B, 5, HKV, HD)).astype(np.float32)
    nodes = rng.integers(0, 5, size=(B, 3)).astype(np.int32)
    n_acc = np.asarray([1, 3, 2], np.int32)
    kv_dtype = None if pool_dtype == "float32" else pool_dtype

    jd = JC.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                    key_pos=jnp.asarray(key_pos), pos=jnp.asarray(pos))
    jkv = JC.paginate_cache(JC.Cache(kv=jd), jnp.asarray(TABLES),
                            page_size=PS, n_pages=N_PAGES,
                            kv_dtype=None if kv_dtype is None
                            else getattr(jnp, kv_dtype)).kv
    jstates = [jkv]
    jkv = JC.paged_kv_write(jkv, jnp.asarray(ks), jnp.asarray(ks) * 0.5,
                            jkv.pos)
    jstates.append(jkv)
    jkv = JC.kv_commit(jkv, jnp.asarray(kn), jnp.asarray(kn) * 2,
                       jnp.asarray(nodes), jnp.asarray(n_acc), 3)
    jstates.append(jkv)

    td = TC.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                    key_pos=torch.from_numpy(key_pos),
                    pos=torch.from_numpy(pos))
    tkv = TC.paginate_cache(TC.Cache(kv=td), torch.from_numpy(TABLES),
                            page_size=PS, n_pages=N_PAGES,
                            kv_dtype=None if kv_dtype is None
                            else getattr(torch, kv_dtype)).kv
    # the pool is updated in place: snapshot each state
    tstates = [_snapshot(tkv)]
    tks = torch.from_numpy(ks)
    tkv = TC.bulk_write(tkv, tks, tks * 0.5, tkv.pos)
    tstates.append(_snapshot(tkv))
    tkn = torch.from_numpy(kn)
    tkv = TC.kv_commit(tkv, tkn, tkn * 2, torch.from_numpy(nodes).long(),
                       torch.from_numpy(n_acc), 3)
    tstates.append(_snapshot(tkv))
    return jstates, tstates


def _snapshot(kv):
    return dataclasses.replace(
        kv, pool_k=kv.pool_k.clone(), pool_v=kv.pool_v.clone())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or \
        x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16", "int8"])
def test_paginate_write_commit_match_jax(pool_dtype):
    jstates, tstates = _both_states(pool_dtype)
    for step, (j, t) in enumerate(zip(jstates, tstates)):
        for name in ("block_table", "key_pos", "pos"):
            np.testing.assert_array_equal(_np(getattr(t, name)),
                                          _np(getattr(j, name)),
                                          err_msg=f"step {step} {name}")
        real = slice(0, N_PAGES)              # the trash page is left out
        for name in ("pool_k", "pool_v"):
            got = _np(getattr(t, name))[:, real].astype(np.float32)
            want = _np(getattr(j, name))[:, real].astype(np.float32)
            if pool_dtype == "int8":
                assert np.abs(got - want).max() <= 1, (step, name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
        if pool_dtype == "int8":
            for name in ("scale_k", "scale_v"):
                got = _np(getattr(t, name))[:, real]
                want = _np(getattr(j, name))[:, real]
                np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            assert t.scale_k is None and j.scale_k is None
    assert tstates[-1].quantized == (pool_dtype == "int8")
    if pool_dtype == "int8":           # every reserved page armed by now
        assert (tstates[-1].scale_k[:, [7, 2, 0, 5, 9, 3]] > 0).all()


def test_frozen_scales_and_dequant_bound():
    """Armed scales stay frozen under later writes, and the dequantized
    view sits within scale / 2 of the float values it stores."""
    jstates, tstates = _both_states("int8")
    armed = tstates[0].scale_k[:, :N_PAGES]
    later = tstates[-1].scale_k[:, :N_PAGES]
    assert torch.equal(later[armed > 0], armed[armed > 0])
    kv = tstates[0]
    for layer in range(L):
        view = TC.gather_pages_dequant(kv.pool_k[layer], kv.scale_k[layer],
                                       kv.block_table)
        jview = JC.gather_pages_dequant(jstates[0].pool_k[layer],
                                        jstates[0].scale_k[layer],
                                        jstates[0].block_table)
        filled = kv.key_pos >= 0
        np.testing.assert_allclose(view[filled].numpy(),
                                   np.asarray(jview)[filled.numpy()],
                                   atol=float(kv.scale_k.max()) * 1.01)


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(2)
    pool = rng.normal(size=(N_PAGES + 1, PS, HKV, HD)).astype(np.float32)
    got = TC.gather_pages(torch.from_numpy(pool), torch.from_numpy(TABLES))
    want = JC.gather_pages(jnp.asarray(pool), jnp.asarray(TABLES))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unreserved_write_hits_trash_not_neighbor():
    """A row writing past its partial reservation must not touch ANY
    reservable page: the write lands in the trash page, and its key_pos
    never claims the unreserved slots (tests/test_paged.py)."""
    kv = TC.init_paged_kv_cache(1, 2, 16, 1, 2, page_size=4, n_pages=4,
                                dtype=torch.float32, device="cpu")
    kv = dataclasses.replace(
        kv, block_table=torch.tensor([[0, 1, -1, -1], [2, 3, -1, -1]],
                                     dtype=torch.int32),
        pos=torch.tensor([8, 0], dtype=torch.int32))
    ks = torch.full((1, 1, 2, 1, 2), 7.0)
    ks = torch.cat([ks, torch.zeros_like(ks)], dim=1)     # row 1 writes 0s
    out = TC.paged_kv_write(kv, ks, ks, torch.tensor([8, 0],
                                                     dtype=torch.int32))
    assert not (out.pool_k[:, :4] == 7.0).any()
    assert (out.pool_k[:, 4] == 7.0).any()
    assert (out.key_pos[0, 8:10] == -1).all()
    assert out.key_pos[1, :2].tolist() == [0, 1]
    assert TC.capacity_left(TC.Cache(kv=out)).tolist() == [-2, 6]


def test_page_bytes_match_jax():
    for name in ("float32", "bfloat16", "int8"):
        args = (32, 16, 32, 128)
        assert TC.page_bytes(*args, getattr(torch, name)) == \
            JC.page_bytes(*args, getattr(jnp, name))
        assert TC.pages_at_fixed_bytes(10 ** 9, *args,
                                       getattr(torch, name)) == \
            JC.pages_at_fixed_bytes(10 ** 9, *args, getattr(jnp, name))
        assert TC.kv_bytes_per_token(32, 32, 128, getattr(torch, name), 16) \
            == JC.kv_bytes_per_token(32, 32, 128, getattr(jnp, name), 16)


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------
_RUNS = {}


def _prompts(cfg):
    return MarkovDataset(cfg.vocab_size, seed=1).sample(
        3, 9, seed=7)[:, :-1].astype(np.int32)


def _run(arch, pkg, engine, budgets=BUDGETS, **kw):
    """Tokens and n_emitted of one engine run, cached per configuration."""
    key = (arch, pkg, engine, tuple(budgets), tuple(sorted(kw.items())))
    if key not in _RUNS:
        cfg, jm, jp, jh, tm, tp, th, spec, tspec, _ = _setup(arch)
        toks = _prompts(cfg)
        common = dict(max_len=MAX_LEN, chunk=CHUNK, **kw)
        if pkg == "jax":
            eng = (JSpec(jm, jh, jp, spec, **common) if engine == "spec"
                   else JBatch(jm, jp, **common))
        else:
            eng = (TSpec(tm, th, tp, tspec, **common) if engine == "spec"
                   else TBatch(tm, tp, **common))
        out, st = eng.generate({"tokens": toks}, budgets)
        _RUNS[key] = (np.asarray(out), np.asarray(st["n_emitted"]),
                      st["acceptance_length"])
    return _RUNS[key]


PAGED = dict(paged=True, page_size=PAGE)


@pytest.mark.parametrize("engine", ["spec", "batch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engines_equal_dense_and_jax(arch, engine):
    dense = _run(arch, "torch", engine)
    paged = _run(arch, "torch", engine, **PAGED)
    jpaged = _run(arch, "jax", engine, **PAGED)
    for got in (paged, jpaged):
        np.testing.assert_array_equal(got[0], dense[0])
        np.testing.assert_array_equal(got[1], dense[1])
    np.testing.assert_array_equal(paged[1], BUDGETS)
    if engine == "spec":
        assert paged[2] == pytest.approx(jpaged[2]) and paged[2] > 1.3


@pytest.mark.parametrize("tree_kernel", ["dense", "sparse"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_engines_equal_jax(arch, tree_kernel):
    """int8 pools, fused and split verify, against the JAX int8 engine (the
    split through the Pallas kernels in interpret mode, as the reference's
    serve pins for it)."""
    kw = dict(PAGED, kv_dtype="int8", tree_kernel=tree_kernel)
    got = _run(arch, "torch", "spec", **kw)
    want = _run(arch, "jax", "spec",
                backend="pallas" if tree_kernel == "sparse" else "ref", **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("engine", ["spec", "batch"])
def test_pool_shortfall_freezes_like_jax(engine):
    """``pool_pages`` below the need: the last row gets a partial
    reservation and freezes at its capacity, with the reference's tokens
    and ``n_emitted``; the fully reserved rows are untouched."""
    budgets = np.asarray([24, 24, 20], np.int32)
    kw = dict(PAGED, pool_pages=12)
    got = _run(ARCHS[1], "torch", engine, budgets=budgets, **kw)
    want = _run(ARCHS[1], "jax", engine, budgets=budgets, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][2] < budgets[2] and (got[1][:2] == budgets[:2]).all()
    full = _run(ARCHS[1], "torch", engine, budgets=budgets, **PAGED)
    np.testing.assert_array_equal(got[0][:2], full[0][:2])


def test_engine_validation_and_live_tree_kernel_switch():
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, _ = _setup(ARCHS[0])
    kw = dict(max_len=MAX_LEN, chunk=CHUNK)
    with pytest.raises(ValueError, match="paged"):
        TSpec(tm, th, tp, tspec, kv_dtype="int8", **kw)
    with pytest.raises(ValueError, match="paged"):
        TSpec(tm, th, tp, tspec, tree_kernel="sparse", **kw)
    with pytest.raises(ValueError):
        TSpec(tm, th, tp, tspec, tree_kernel="bogus", **PAGED, **kw)
    with pytest.raises(ValueError):
        TSpec(tm, th, tp, tspec, kv_dtype="int4", **PAGED, **kw)
    with pytest.raises(ValueError, match="full attention"):
        TBatch(tm, tp, window=8, **PAGED, **kw)
    with pytest.raises(ValueError):
        TSpec(tm, th, tp, tspec, hcmp="fused", **PAGED, **kw)
    dense_eng = TSpec(tm, th, tp, tspec, **kw)
    with pytest.raises(ValueError):
        dense_eng.set_tree_kernel("sparse")
    eng = TSpec(tm, th, tp, tspec, **PAGED, **kw)
    toks = _prompts(cfg)[:2]
    od, _ = eng.generate({"tokens": toks}, 10)
    eng.set_tree_kernel("sparse")
    osp, _ = eng.generate({"tokens": toks}, 10)
    eng.set_tree_kernel("dense")
    od2, _ = eng.generate({"tokens": toks}, 10)
    np.testing.assert_array_equal(od, osp)
    np.testing.assert_array_equal(od, od2)
    # the overlap partition serves the same tokens under each kernel; a
    # kernel switch drops its runner, a partition switch comes back
    over = TSpec(tm, th, tp, tspec, hcmp="overlap", **PAGED, **kw)
    assert over.hcmp == "overlap" and over.hcmp_stats is None
    oo, _ = over.generate({"tokens": toks}, 10)
    over.set_tree_kernel("sparse")
    assert over.hcmp_stats is None
    oos, _ = over.generate({"tokens": toks}, 10)
    assert over.hcmp_stats["chunks"] >= 1
    over.set_hcmp("inline")
    oi, _ = over.generate({"tokens": toks}, 10)
    assert over.hcmp == "inline"
    for o in (oo, oos, oi):
        np.testing.assert_array_equal(od, o)
    with pytest.raises(ValueError):
        eng.set_tree_kernel("coo")
    # the "fp32" name is a float32 pool; None keeps the model dtype
    assert TSpec(tm, th, tp, tspec, kv_dtype="fp32", **PAGED,
                 **kw).kv_dtype == torch.float32
    assert TSpec(tm, th, tp, tspec, **PAGED, **kw).kv_dtype is None
