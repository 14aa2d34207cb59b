"""The redesigned B3 (cache-only page walk) and B5 (normalized tree
attention) kernels, modelled on the CPU.

B3 (``csrc/paged_attention.cu``, ``flash_common.cuh::cache_block``) walks
each row's pages in the split ranges of ``kernels/launch.py::split_plan``
with no tree part, one fp32 ``(o, m, l)`` partial per range, then folds the
ranges into ONE unnormalized partial by the carry rule
(``flash_common.cuh::carry_fold_kernel``, the rule of
``cm.merge_partials_carry``).  ``cache_split_model`` writes that in plain
PyTorch (skipped slots zero-filled, ``cm.gqa_attend_partial`` per range,
the carry fold) and holds it against ``paged_cache_attention_plain`` and
the JAX oracle ``repro.kernels.ref.paged_cache_attention_ref`` on the same
numpy inputs: the reference's sweeps as page tables (``CASES``,
``PAGED_INT8_CASES``) at 1, 2, 3 and one split per key tile, the main
path's shapes and ``chip_smoke.py``'s split-edge cases at the wrappers'
own plan, with the all-masked row (m = NEG_INF / 2, l = 0 survives the
fold and drops out of ``cm.merge_partials``).

B5 (``csrc/tree_partial.cu``) cuts each kv head's G*W query rows into row
tiles (``kernels/tree_partial.py::norm_rows``).  ``f32_model`` is its fp32
route (one pass over the W <= 64 keys: max, exp, sum, P V);
``flash_model`` its bf16 route (key tiles of 64 split among the block's
warps when a block holds <= 32 rows, P rounded to bf16, the groups folded
by Eq. 1).  Both are held against ``sparse_tree_ref`` and the plain version
over the reference's sparse sweep, Fig. 10b and the main path's W=8 at
every row tile.  The host-side pickers are checked too.

Tolerances are the reference's: fp32 2e-5, bf16 2e-2 against the plain
version (3e-2 against the JAX oracle, as ``tests/test_torch_sparse.py``),
int8 2e-5 against the int8 oracle.  The kernels themselves run on the card
(``tests/test_torch_card.py``, ``chip_smoke.py``).
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import (paged_cache_attention_ref,  # noqa: E402
                               sparse_tree_ref)
from repro_torch.kernels import launch  # noqa: E402
from repro_torch.kernels import plain  # noqa: E402
from repro_torch.kernels import tree_partial as tp  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.runtime.cache import gather_pages_dequant  # noqa: E402
from test_torch_split import (_FAKE_SMEM, _FLASH_SMEM, _PER_SM,  # noqa: E402
                              MODEL_TILE, SMS, SPLITS, _close, _jax,
                              _paged_sweep, kernel_ranges, split_ranges)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ORACLE_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    """chip_smoke's inputs, made on the CPU."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")


# ---------------------------------------------------------------- B3
def carry_fold(parts):
    """The splits' partials folded into one by the carry rule, m clamped to
    NEG_INF / 2 (``carry_fold_kernel``)."""
    acc = parts[0]
    for part in parts[1:]:
        acc = cm.merge_partials_carry(acc, part)
    o, m, l = acc
    return o, torch.clamp(m, min=cm.NEG_INF / 2), l


def cache_split_model(a, ranges):
    """B3's walk in plain PyTorch over a paged layout: a slot on an
    unreserved page or with key_pos < 0 is zero-filled, each range gives
    one partial, the carry fold one partial of them all."""
    q, key_pos = a["q"], a["key_pos"]
    ck = gather_pages_dequant(a["pool_k"], a["scale_k"], a["block_table"])
    cv = gather_pages_dequant(a["pool_v"], a["scale_v"], a["block_table"])
    ps = a["pool_k"].shape[1]
    reserved = (a["block_table"] >= 0).repeat_interleave(ps, dim=1)
    filled = (reserved & (key_pos >= 0))[:, :, None, None]
    ck, cv = torch.where(filled, ck, 0), torch.where(filled, cv, 0)
    B, W = q.shape[:2]
    ok = plain._cache_ok(key_pos, a["q_pos"], a["lo"], B, W, ck.shape[1])
    scale = q.shape[-1] ** -0.5
    parts = [cm.gqa_attend_partial(q, ck[:, r.start:r.stop],
                                   cv[:, r.start:r.stop],
                                   ok[:, None, :, r.start:r.stop], scale)
             for r in ranges]
    return carry_fold(parts), parts


def _hold_cache(got, a):
    """The model's partial against the plain version and the JAX oracle."""
    args = chip_smoke.paged_args(a, tree=False)
    tol = TOL[a["q"].dtype]
    for g, w in zip(got, plain.paged_cache_attention_plain(*args)):
        _close(g, w, tol)
    for g, w in zip(got, paged_cache_attention_ref(*map(_jax, args))):
        _close(g, w, ORACLE_TOL[a["q"].dtype])


def _plan(a):
    """The wrappers' own plan of the cache-only walk for these operands
    (an H100's 132 SMs, two tensor-core blocks each)."""
    q, pool = a["q"], a["pool_k"]
    B, W, Hq, hd = q.shape
    flash = launch.flash_route(q.dtype, pool.dtype, hd,
                               a["scale_k"] is not None)
    return launch.split_plan(_FAKE_SMEM, _FLASH_SMEM, _PER_SM, SMS, flash, B,
                             W, Hq, pool.shape[2], hd, a["key_pos"].shape[1],
                             page=pool.shape[1], tree=False)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("case", _paged_sweep())
def test_cache_split_matches_plain_and_oracle(case, n_split):
    """Window-0 CASES as page tables and PAGED_INT8_CASES at 1, 2, 3 and
    one split per key tile: the carry-folded splits are the whole walk."""
    _, kw = chip_smoke.paged_case_list(np)[case]
    a = chip_smoke.paged_inputs(torch, np, **kw)
    ps = a["pool_k"].shape[1]
    gran = MODEL_TILE * ps // math.gcd(MODEL_TILE, ps)
    ranges = split_ranges(a["key_pos"].shape[1], n_split, gran)
    got, _ = cache_split_model(a, ranges)
    _hold_cache(got, a)


def _main():
    return {label: kw for label, kw in chip_smoke.paged_main_shapes(np, 0)}


@pytest.mark.parametrize("label", list(_main()))
def test_cache_split_at_the_main_shapes(label):
    """The main path's B=4, 37 pages of 16, bf16 and int8 pools, verify W=8
    and decode W=1, at the wrappers' plan: two splits (128 blocks a split
    against 264 resident slots), so the carry fold runs."""
    a = chip_smoke.paged_inputs(torch, np, **_main()[label])
    tile, rows, n, split_len, parts = _plan(a)
    assert (tile, rows, n, parts) == (launch.FLASH_TILE, launch.FLASH_ROWS,
                                      2, 2)
    got, _ = cache_split_model(a, kernel_ranges(a["key_pos"].shape[1], n,
                                                split_len))
    _hold_cache(got, a)


@pytest.mark.parametrize("label", list(chip_smoke.SPLIT_EDGE))
def test_cache_split_edges(label):
    """The card's split-edge cases at the cache-only walk's own plan:
    a split past a row's fill, on unreserved pages or cut away by its
    window gives exactly (0, NEG_INF / 2, 0); row 2 (lo = q_pos) keeps
    l = 0 and m = NEG_INF / 2 through the fold, and the Eq.-1 merge with
    the tree partial then gives the tree part alone."""
    case = chip_smoke.SPLIT_EDGE[label]
    _, a = chip_smoke.split_edge_inputs(torch, np, *case, seed=1)
    plan = _plan(a)
    assert plan[4] == plan[2]                      # no tree part
    S = a["key_pos"].shape[1]
    ranges = kernel_ranges(S, *plan[2:4])
    assert all(r.start % chip_smoke.EDGE_PS == 0 for r in ranges)
    (o, m, l), parts = cache_split_model(a, ranges)
    _hold_cache((o, m, l), a)
    ps = a["pool_k"].shape[1]
    reserved = (a["block_table"] >= 0).repeat_interleave(ps, dim=1)
    kp = torch.where(reserved, a["key_pos"], -1)
    for r, (po, pm, pl) in zip(ranges, parts):
        k = kp[:, r.start:r.stop]
        seen = ((k[:, None, :] >= 0)
                & (k[:, None, :] <= a["q_pos"][..., None])
                & (k[:, None, :] > a["lo"][..., None])).any(-1)   # (B, W)
        empty = (~seen)[:, None, :].expand_as(pm)
        assert torch.all(pl[empty] == 0)
        assert torch.all(pm[empty] == cm.NEG_INF / 2)
        assert torch.all(po.transpose(1, 2)[empty] == 0)
    assert torch.all(l[2] == 0) and torch.all(o[2] == 0)
    assert torch.all(m[2] == cm.NEG_INF / 2)
    tree = plain.sparse_tree_attention_partial_plain(
        a["q"], a["k_new"], a["v_new"], a["tree_mask"])
    merged = cm.merge_partials([(o, m, l), tree])
    _close(merged[2], cm.merge_partials([tree])[2], TOL[a["q"].dtype])


def test_cache_split_edges_cover_every_split_count():
    """Without a tree part the split-edge cases still reach one split per
    key tile (5 at S = 320, 10 at S = 592), three, two and one."""
    counts = set()
    for case in chip_smoke.SPLIT_EDGE.values():
        _, a = chip_smoke.split_edge_inputs(torch, np, *case, seed=1)
        counts.add(_plan(a)[2])
    assert {10, 5, 3, 2, 1} <= counts


# (B, W, S, ps, n_split) of the cache-only walk at vicuna-7b's Hq = Hkv =
# 32, hd 128: the main path's verify and decode (37 pages of 16), the
# W=256 chain of a prefill piece alone (four row tiles: 128 blocks) and in
# a bank of four rows (512 blocks: one split, no fold)
NO_TREE_SHAPES = {"verify W=8": (4, 8, 592, 16, 2),
                  "decode W=1": (4, 1, 592, 16, 2),
                  "chain W=256 B=1": (1, 256, 592, 16, 2),
                  "chain W=256 B=4": (4, 256, 592, 16, 1)}


@pytest.mark.parametrize("shape", list(NO_TREE_SHAPES))
def test_split_plan_without_a_tree(shape):
    """``split_plan(tree=False)``: parts == n_split at every W (a W=256
    piece too), the tensor-core tile and rows, whole pages a split, and
    within the card's resident block slots."""
    B, W, S, ps, want = NO_TREE_SHAPES[shape]
    tile, rows, n, split_len, parts = launch.split_plan(
        None, _FLASH_SMEM, _PER_SM, SMS, True, B, W, 32, 32, 128, S,
        page=ps, tree=False)
    assert (tile, rows) == (launch.FLASH_TILE, launch.FLASH_ROWS)
    assert n == want and parts == n
    assert split_len % (tile * ps // math.gcd(tile, ps)) == 0
    blocks = B * 32 * -(-W // rows)
    assert n == 1 or blocks * n <= 2 * SMS
    assert [j for r in kernel_ranges(S, n, split_len) for j in r] == \
        list(range(S))
    # with a tree the W=256 piece adds a part of its own
    with_tree = launch.split_plan(None, _FLASH_SMEM, _PER_SM, SMS, True, B,
                                  W, 32, 32, 128, S, page=ps)
    assert with_tree[4] == with_tree[2] + (W > launch.FLASH_TILE)


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_partial_outputs_share_one_allocation(parts):
    """``launch.partial_outputs``: o, m, l are contiguous views in the
    merge layout; the splits' workspace follows them as parts 1 .. parts
    of ``workspace``'s layout in the same buffer (none for one split)."""
    q = torch.zeros(2, 8, 4, 16)
    B, W, Hq, hd = q.shape
    o, m, l, ws = launch.partial_outputs(q, parts)
    assert o.shape == q.shape and m.shape == l.shape == (B, Hq, W)
    assert all(t.is_contiguous() and t.dtype == torch.float32
               for t in (o, m, l))
    n = 1 if parts == 1 else parts + 1
    n_o, n_m = B * W * Hq * hd, B * Hq * W
    assert o.untyped_storage().nbytes() == 4 * n * (n_o + 2 * n_m)
    base = o.data_ptr()
    assert m.data_ptr() == base + 4 * n * n_o
    assert l.data_ptr() == base + 4 * n * (n_o + n_m)
    if parts == 1:
        assert ws == (None, None, None)
    else:
        assert ws == (base + 4 * n_o, m.data_ptr() + 4 * n_m,
                      l.data_ptr() + 4 * n_m)


# ---------------------------------------------------------------- B5
def _row_tiles(q, k, v, rows):
    """(b, h, rows of the tile as (g, w) index arrays, q rows, K, V) of
    every row tile of every (batch row, kv head)."""
    B, W, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    for b in range(B):
        for h in range(Hkv):
            for r0 in range(0, G * W, rows):
                r = torch.arange(r0, min(r0 + rows, G * W))
                g, w = r // W, r % W
                yield (b, h, g, w, q[b, w, h * G + g].float(),
                       k[b, :, h].float(), v[b, :, h].float())


def f32_model(q, k, v, mask, rows):
    """B5's fp32 route: per row tile, all W keys in one pass (masked max,
    exp, sum, P V), normalized; a row with no key stores 0."""
    out = torch.zeros(q.shape, dtype=torch.float32)
    scale = q.shape[-1] ** -0.5
    for b, h, g, w, qt, K, V in _row_tiles(q, k, v, rows):
        ok = mask[w]                                       # (rows, W)
        s = torch.where(ok, qt @ K.T * scale, cm.NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.where(ok, torch.exp(s - m), 0.0)
        l = p.sum(-1, keepdim=True)
        out[b, w, h * (q.shape[2] // k.shape[2]) + g] = \
            (p @ V) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def flash_model(q, k, v, mask, rows):
    """B5's bf16 route: per row tile, key tiles of 64 through an online
    softmax; a tile of <= 16 rows is split four ways among the warps (<=
    32 rows: two), each key group its own partial with P rounded to bf16
    before P V, the groups folded by Eq. 1 and normalized."""
    out = torch.zeros(q.shape, dtype=torch.float32)
    scale = q.shape[-1] ** -0.5
    tile = launch.FLASH_TILE
    G = q.shape[2] // k.shape[2]
    for b, h, g, w, qt, K, V in _row_tiles(q, k, v, rows):
        n = len(w)
        groups = 4 if n <= 16 else 2 if n <= 32 else 1
        per = tile // groups
        parts = []
        for grp in range(groups):
            m_run = torch.full((n,), cm.NEG_INF)
            l_run = torch.zeros(n)
            o_run = torch.zeros(n, V.shape[1])
            for j0 in range(grp * per, K.shape[0], tile):
                j = torch.arange(j0, min(j0 + per, K.shape[0]))
                if not len(j):
                    continue
                ok = mask[w][:, j]
                s = torch.where(ok, qt @ K[j].T * scale, cm.NEG_INF)
                m_new = torch.maximum(m_run, s.amax(-1))
                p = torch.where(ok, torch.exp(s - m_new[:, None]), 0.0)
                corr = torch.exp(m_run - m_new)
                l_run = l_run * corr + p.sum(-1)
                o_run = o_run * corr[:, None] + \
                    p.to(torch.bfloat16).float() @ V[j]
                m_run = m_new
            parts.append((o_run, m_run, l_run))
        m_star = torch.stack([p[1] for p in parts]).amax(0)
        c = [torch.exp(p[1] - m_star) for p in parts]
        o = sum(p[0] * ci[:, None] for p, ci in zip(parts, c))
        l = sum(p[2] * ci for p, ci in zip(parts, c))
        out[b, w, h * G + g] = o / torch.clamp(l, min=1e-30)[:, None]
    return out.to(q.dtype)


def _sparse_cases():
    """(kwargs of ``chip_smoke.sparse_inputs``, row tile): the reference's
    sparse sweep, Fig. 10b in fp32 and bf16 and the main path's W=8, each
    at every row tile its route offers."""
    out = []
    for label, kw in chip_smoke.sparse_case_list(np):
        route = tp.norm_route(getattr(torch, kw["dtype"]), kw["W"], kw["hd"])
        out += [pytest.param(kw, rows, id=f"{label}-{rows} rows")
                for rows in tp.NORM_ROWS[route]]
    return out


def _sparse(kw):
    args = chip_smoke.sparse_inputs(torch, np, seed=0, **kw)
    want = plain.sparse_tree_attention_plain(*args)
    oracle = np.asarray(sparse_tree_ref(*map(_jax, args)), np.float32)
    return args, want, oracle


@pytest.mark.parametrize("kw,rows", _sparse_cases())
def test_norm_row_tiles_match_oracle(kw, rows):
    """B5 at every row tile of its route (the fp32 route's 16 and 32, the
    tensor-core route's 16, 32 and 64) equals the plain version and
    ``sparse_tree_ref``."""
    args, want, oracle = _sparse(kw)
    q = args[0]
    route = tp.norm_route(q.dtype, q.shape[1], q.shape[3])
    model = f32_model if route == tp.ROUTE_F32 else flash_model
    got = model(*args, rows)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got.float(), want.float(), TOL[q.dtype])
    _close(got.float(), oracle, ORACLE_TOL[q.dtype])


@pytest.mark.parametrize("model,tol", [(f32_model, 2e-5),
                                       (flash_model, 2e-2)])
def test_norm_empty_mask_row_stores_zero(model, tol):
    """A row whose mask is empty stores 0, as the TPU kernel does (the
    plain version's softmax over an all-masked row would average V; a tree
    row always sees itself, so no sweep has one); every other row is the
    plain version's (the tensor-core route at bf16's tolerance: it rounds
    P to bf16)."""
    rng = np.random.default_rng(5)
    B, W, Hq, Hkv, hd = 1, 8, 2, 1, 32
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, W, Hq, hd), (B, W, Hkv, hd), (B, W, Hkv, hd)))
    mask = torch.from_numpy(chip_smoke.rand_tree(np, W, seed=3)[0])
    mask[5] = False
    got = model(q, k, v, mask, 16)
    pallas = np.asarray(jops.sparse_tree_attention(
        *map(_jax, (q, k, v, mask)), backend="pallas", interpret=True))
    assert torch.all(got[:, 5] == 0)
    _close(got.numpy(), pallas, tol)
    keep = [i for i in range(W) if i != 5]
    want = plain.sparse_tree_attention_plain(q, k, v, mask)
    _close(got[:, keep], want[:, keep], tol)


@pytest.mark.parametrize("dtype,W,hd,want", [
    (torch.bfloat16, 64, 128, tp.ROUTE_FLASH),     # Fig. 10b bf16
    (torch.bfloat16, 256, 16, tp.ROUTE_FLASH),     # any W on the tensor cores
    (torch.bfloat16, 8, 256, tp.ROUTE_TILES),      # past the register tiles
    (torch.float32, 64, 128, tp.ROUTE_F32),        # Fig. 10b fp32
    (torch.float32, 4, 32, tp.ROUTE_F32),          # the W=4 sweep case
    (torch.float32, 65, 128, tp.ROUTE_TILES),      # past one key tile
    (torch.float32, 16, 256, tp.ROUTE_TILES),
])
def test_norm_route(dtype, W, hd, want):
    assert tp.norm_route(dtype, W, hd) == want


@pytest.mark.parametrize("route,B,Hkv,GW,want", [
    (tp.ROUTE_FLASH, 1, 8, 256, 16),     # Fig. 10b: 128 blocks
    (tp.ROUTE_F32, 1, 8, 256, 16),
    (tp.ROUTE_FLASH, 4, 32, 8, 64),      # main W=8: one tile holds all rows
    (tp.ROUTE_FLASH, 2, 1, 256, 16),     # the W=64 sweep case: too few heads
    (tp.ROUTE_FLASH, 16, 8, 256, 64),    # enough blocks at the widest tile
    (tp.ROUTE_F32, 16, 8, 256, 32),
    (tp.ROUTE_F32, 4, 8, 256, 32),       # 4 * 8 * 8 = 256 blocks
])
def test_norm_rows(route, B, Hkv, GW, want):
    """The largest row tile whose grid reaches ``NORM_MIN_BLOCKS``, else
    the smallest."""
    rows = tp.norm_rows(route, B, Hkv, GW)
    assert rows == want and rows in tp.NORM_ROWS[route]
    blocks = B * Hkv * -(-GW // rows)
    wider = [r for r in tp.NORM_ROWS[route] if r > rows]
    if blocks >= tp.NORM_MIN_BLOCKS:
        assert all(B * Hkv * -(-GW // r) < tp.NORM_MIN_BLOCKS for r in wider)
    else:
        assert rows == tp.NORM_ROWS[route][-1]
