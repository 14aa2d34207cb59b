"""The port's row surgery (``repro_torch/runtime/cache.py``: ``tile_rows``,
``blank_paged_rows``, ``insert_rows``, ``reset_rows``, ``slice_row``,
``write_row_at`` and ``_zero_page_scales``) against the JAX functions, on
the same numpy inputs, for a dense bank, an fp32 paged pool and an int8
paged pool.

Both packages run the same sequence of surgeries on a bank of three rows;
after every step the caches must agree.  Float leaves are bit-equal.  int8
codes may differ by at most 1 and scales by at most 1 ulp (the scale is
``amax / 127`` and the code ``round(x / scale)``; XLA may evaluate either
division as a multiply by the reciprocal, as ``tests/test_torch_paged.py``
explains).  The trash page stays out of every comparison: masked writes
land on its last slot, and with duplicate indices an indexed store keeps
an arbitrary one.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import cache as JC
from repro_torch.runtime import cache as TC

L, B, HKV, HD = 2, 3, 2, 16
MAX_LEN, PS, N_PAGES = 24, 4, 12
PROMPTS = (7, 5, 9)                    # the three admissions' prompt lengths
PAGES = ([0, 1, -1, -1, -1, -1],       # admission 0 (row 1)
         [2, 3, 4, -1, -1, -1],        # admission 1 (row 0)
         [0, 1, 5, -1, -1, -1])        # admission 2 (row 2): reuses 0, 1
LAYOUTS = ["dense", "paged float32", "paged int8"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    test workers share the machine's cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _prefill(i, size):
    """Admission i's B=1 dense prefill cache (numpy), ``size`` slots."""
    rng = np.random.default_rng(10 + i)
    n = PROMPTS[i]
    k = np.zeros((L, 1, size, HKV, HD), np.float32)
    v = np.zeros_like(k)
    # magnitudes differ per admission, so a stale page scale would show
    k[:, :, :n] = rng.normal(size=(L, 1, n, HKV, HD)) * (3.0 / (i + 1))
    v[:, :, :n] = rng.normal(size=(L, 1, n, HKV, HD)) * (i + 1)
    key_pos = np.full((1, size), -1, np.int32)
    key_pos[0, :n] = np.arange(n)
    pos = np.asarray([n], np.int32)
    return k, v, key_pos, pos


def _both(arrays):
    k, v, key_pos, pos = arrays
    j = JC.Cache(kv=JC.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                               key_pos=jnp.asarray(key_pos),
                               pos=jnp.asarray(pos)))
    t = TC.Cache(kv=TC.KVCache(k=torch.from_numpy(k.copy()),
                               v=torch.from_numpy(v.copy()),
                               key_pos=torch.from_numpy(key_pos.copy()),
                               pos=torch.from_numpy(pos.copy())))
    return j, t


def _same(t_cache, j_cache, what):
    """The port's cache equals the reference's (trash page left out)."""
    t, j = t_cache.kv, j_cache.kv
    for name in ("key_pos", "pos") + (("block_table",)
                                      if isinstance(t, TC.PagedKVCache)
                                      else ()):
        np.testing.assert_array_equal(_np(getattr(t, name)),
                                      _np(getattr(j, name)),
                                      err_msg=f"{what}: {name}")
    if not isinstance(t, TC.PagedKVCache):
        for name in ("k", "v"):
            np.testing.assert_array_equal(_np(getattr(t, name)),
                                          _np(getattr(j, name)),
                                          err_msg=f"{what}: {name}")
        return
    real = slice(0, t.n_pages)
    for name in ("pool_k", "pool_v"):
        got = _np(getattr(t, name))[:, real].astype(np.float32)
        want = _np(getattr(j, name))[:, real].astype(np.float32)
        if t.quantized:
            assert np.abs(got - want).max() <= 1, f"{what}: {name}"
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{what}: "
                                                             f"{name}")
    if t.quantized:
        for name in ("scale_k", "scale_v"):
            np.testing.assert_array_max_ulp(
                _np(getattr(t, name))[:, real],
                _np(getattr(j, name))[:, real], maxulp=1)
    else:
        assert t.scale_k is None and j.scale_k is None


def _bank(layout):
    """Both packages' empty bank of B rows, bootstrapped from admission 0's
    prefill as the scheduler does (``tile_rows`` dense,
    ``blank_paged_rows`` paged)."""
    if layout == "dense":
        j, t = _both(_prefill(0, MAX_LEN))
        return JC.tile_rows(j, B), TC.tile_rows(t, B)
    dtype = layout.split()[1]
    j, t = _both(_prefill(0, PROMPTS[0]))
    jb = JC.blank_paged_rows(j, B, page_size=PS, n_pages=N_PAGES,
                             max_len=MAX_LEN,
                             kv_dtype=getattr(jnp, dtype))
    tb = TC.blank_paged_rows(t, B, page_size=PS, n_pages=N_PAGES,
                             max_len=MAX_LEN,
                             kv_dtype=getattr(torch, dtype))
    return jb, tb


def _insert(layout, jb, tb, row, i):
    size = MAX_LEN if layout == "dense" else PROMPTS[i]
    j, t = _both(_prefill(i, size))
    if layout == "dense":
        return JC.insert_rows(jb, row, j), TC.insert_rows(tb, row, t)
    pages = np.asarray(PAGES[i], np.int32)
    return (JC.insert_rows(jb, row, j, pages=jnp.asarray(pages)),
            TC.insert_rows(tb, row, t, pages=torch.from_numpy(pages)))


def _reset(jb, tb, rows):
    mask = np.zeros((B,), bool)
    mask[list(rows)] = True
    return JC.reset_rows(jb, mask), TC.reset_rows(tb, torch.from_numpy(mask))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_row_surgery_matches_jax(layout):
    """Bootstrap, two admissions, a chunked-prefill piece on a resident
    row (three real entries and one padding entry), its B=1 view, a reset,
    and a third admission into the reset row."""
    jb, tb = _bank(layout)
    _same(tb, jb, "bootstrap")
    jb, tb = _insert(layout, jb, tb, 1, 0)
    _same(tb, jb, "insert row 1")
    jb, tb = _insert(layout, jb, tb, 0, 1)
    _same(tb, jb, "insert row 0")

    rng = np.random.default_rng(3)
    ks = rng.normal(size=(L, 4, HKV, HD)).astype(np.float32) * 2
    vs = rng.normal(size=(L, 4, HKV, HD)).astype(np.float32)
    start = PROMPTS[0]
    jb = JC.write_row_at(jb, 1, jnp.asarray(ks), jnp.asarray(vs), start, 3)
    tb = TC.write_row_at(tb, 1, torch.from_numpy(ks), torch.from_numpy(vs),
                         torch.tensor(start, dtype=torch.int32), 3)
    _same(tb, jb, "write_row_at row 1")
    assert int(tb.kv.pos[1]) == start + 3

    jv, tv = JC.slice_row(jb, 1), TC.slice_row(tb, 1)
    _same(tv, jv, "slice_row 1")
    if layout != "dense":          # the view shares the pool by reference
        assert tv.kv.pool_k is tb.kv.pool_k

    jb, tb = _reset(jb, tb, [1])
    _same(tb, jb, "reset row 1")
    assert (tb.kv.key_pos[1] == -1).all() and int(tb.kv.pos[1]) == 0
    jb, tb = _insert(layout, jb, tb, 1, 2)
    _same(tb, jb, "insert row 1 again")


@pytest.mark.parametrize("layout", LAYOUTS[1:])
def test_reset_after_same_boundary_reservation_keeps_scales(layout):
    """The int8 scale lifecycle regression: row 1 finishes and its pages
    are released; at the same boundary a new request reserves those pages
    into row 2 (its insert zeroes, then arms their scales); only then is
    row 1 reset.  The reset must leave the new resident's pool and scales
    as they were, in both packages."""
    jb, tb = _bank(layout)
    jb, tb = _insert(layout, jb, tb, 1, 0)     # pages 0, 1
    jb, tb = _insert(layout, jb, tb, 0, 1)
    jb, tb = _insert(layout, jb, tb, 2, 2)     # pages 0, 1 again
    before = tb.kv.scale_k, tb.kv.pool_k.clone()
    jb, tb = _reset(jb, tb, [1])               # row 1's table is stale
    _same(tb, jb, "reset after re-reservation")
    if tb.kv.quantized:
        assert torch.equal(tb.kv.scale_k, before[0])
        assert (tb.kv.scale_k[:, [0, 1, 5]] > 0).all()
    assert torch.equal(tb.kv.pool_k, before[1])
    assert (tb.kv.block_table[1] == -1).all()
    assert tb.kv.block_table[2].tolist() == PAGES[2]


def test_zero_page_scales_matches_jax():
    rng = np.random.default_rng(4)
    scale = rng.uniform(0.1, 1.0, size=(L, N_PAGES + 1, HKV)).astype(
        np.float32)
    pages = np.asarray([3, -1, 7, 0], np.int32)
    mask = np.asarray([True, True, False, True])
    got = TC._zero_page_scales(torch.from_numpy(scale),
                               torch.from_numpy(pages),
                               torch.from_numpy(mask))
    want = JC._zero_page_scales(jnp.asarray(scale), jnp.asarray(pages),
                                jnp.asarray(mask))
    real = slice(0, N_PAGES)
    np.testing.assert_array_equal(got.numpy()[:, real],
                                  np.asarray(want)[:, real])
    assert (got[:, [0, 3]] == 0).all() and (got[:, 7] > 0).all()


def test_paged_insert_needs_pages():
    jb, tb = _bank("paged float32")
    _, t = _both(_prefill(1, PROMPTS[1]))
    with pytest.raises(ValueError):
        TC.insert_rows(tb, 0, t)
    assert dataclasses.is_dataclass(tb.kv)
