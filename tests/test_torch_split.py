"""The split walk of the redesigned B1 and B2 kernels, modelled on the CPU.

``csrc/flash_common.cuh`` walks each row's cache in contiguous slot ranges
(whole key tiles, whole pages of a paged pool) chosen on the host by
``kernels/launch.py::pick_split``, writes one fp32 (o, m, l) partial per
range plus one for the W tree nodes, and merges them by Eq. 1.  Here that
design is written in plain PyTorch (``split_model``: skipped slots
zero-filled, ``cm.gqa_attend_partial`` per range, ``cm.merge_partials``)
and held against the port's plain versions and the JAX oracles
(``repro.kernels.ref``) on the same numpy inputs: the reference's sweeps
(``CASES``, ``PAGED_INT8_CASES``) at 1, 2, 3 and one split per key tile,
and ``chip_smoke.py``'s split-edge cases (splits wholly unreserved, past
the fill, cut away by a window; a row whose cache is all masked).
Tolerances are the reference's: fp32 2e-5, bf16 2e-2, int8 2e-5 against
the int8 oracle.  The picker's contract (coverage, tiles, pages, resident
block slots, shared memory) is checked too.  The kernels themselves run on the card
(``tests/test_torch_card.py``, ``chip_smoke.py``).
"""
import ctypes
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

from repro.kernels.ref import (paged_tree_attention_ref,  # noqa: E402
                               tree_attention_ref)
from repro_torch.kernels import launch  # noqa: E402
from repro_torch.kernels import plain  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.runtime.cache import gather_pages_dequant  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
MODEL_TILE = 8          # key tile of the model: small S still splits
SPLITS = (1, 2, 3, 0)   # 0: one split per key tile


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    """chip_smoke's input builders, on the CPU."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")


def kernel_ranges(S, n_split, split_len):
    """The slot range of each split as the kernels walk it: split z takes
    ``[z * split_len, min((z + 1) * split_len, S))``."""
    return [range(z * split_len, min((z + 1) * split_len, S))
            for z in range(n_split)]


def split_ranges(S, n_split, gran):
    """``n_split`` contiguous ranges of whole ``gran``-slot chunks over
    [0, S) (0: one per chunk), as the kernels walk them."""
    chunks = -(-S // gran)
    per = -(-chunks // (n_split or chunks))
    return kernel_ranges(S, -(-chunks // per), per * gran)


def split_model(q, ck, cv, kn, vn, key_pos, q_pos, lo, mask, ranges,
                filled=None):
    """The split walk in plain PyTorch: a skipped slot (``filled`` False;
    by default key_pos < 0) is zero-filled, each range gives one partial,
    the tree one more, and Eq. 1 merges them."""
    B, W = q.shape[:2]
    scale = q.shape[-1] ** -0.5
    if filled is None:
        filled = key_pos >= 0
    ck = torch.where(filled[:, :, None, None], ck, 0)
    cv = torch.where(filled[:, :, None, None], cv, 0)
    ok = plain._cache_ok(key_pos, q_pos, lo, B, W, ck.shape[1])
    parts = [cm.gqa_attend_partial(q, kn, vn, mask[None, None], scale)]
    for r in ranges:
        sl = slice(r.start, r.stop)
        parts.append(cm.gqa_attend_partial(q, ck[:, sl], cv[:, sl],
                                           ok[:, None, :, sl], scale))
    return cm.merge_partials(parts).to(q.dtype), parts


def folded_model(q, ck, cv, kn, vn, key_pos, q_pos, lo, mask, ranges):
    """split_model with the tree walked by the last split's block after
    its slots, into that split's partial (the tensor-core walk's layout
    for a tree of at most one key tile)."""
    B, W = q.shape[:2]
    scale = q.shape[-1] ** -0.5
    filled = (key_pos >= 0)[:, :, None, None]
    ck, cv = torch.where(filled, ck, 0), torch.where(filled, cv, 0)
    ok = plain._cache_ok(key_pos, q_pos, lo, B, W, ck.shape[1])[:, None]
    parts = []
    for i, r in enumerate(ranges):
        sl = slice(r.start, r.stop)
        k, v, m = ck[:, sl], cv[:, sl], ok[..., sl]
        if i == len(ranges) - 1:
            k, v = torch.cat([k, kn], 1), torch.cat([v, vn], 1)
            m = torch.cat([m, mask[None, None].expand(B, 1, W, W)], -1)
        parts.append(cm.gqa_attend_partial(q, k, v, m, scale))
    return cm.merge_partials(parts).to(q.dtype)


def _jax(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _paged_model(a, ranges):
    """split_model over a paged layout's logical view (dequantized)."""
    ck = gather_pages_dequant(a["pool_k"], a["scale_k"], a["block_table"])
    cv = gather_pages_dequant(a["pool_v"], a["scale_v"], a["block_table"])
    ps = a["pool_k"].shape[1]
    reserved = (a["block_table"] >= 0).repeat_interleave(ps, dim=1)
    if a["scale_k"] is None:            # a float pool: verbatim, q's dtype
        ck, cv = ck.to(a["q"].dtype), cv.to(a["q"].dtype)
    return split_model(a["q"], ck, cv, a["k_new"], a["v_new"], a["key_pos"],
                       a["q_pos"], a["lo"], a["tree_mask"], ranges,
                       filled=reserved & (a["key_pos"] >= 0))


# ---------------------------------------------------------------- sweeps
@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("case", range(len(chip_smoke.CASES)))
def test_dense_split_matches_plain_and_oracle(case, n_split):
    B, W, Hq, Hkv, hd, S, pos, window, dt = chip_smoke.CASES[case]
    args = chip_smoke.attention_inputs(torch, np, B, W, Hq, Hkv, hd, S, pos,
                                       window, dt, seed=B * W + S)
    ranges = split_ranges(S, n_split, MODEL_TILE)
    assert n_split == 0 or len(ranges) <= n_split
    got, _ = split_model(*args, ranges)
    tol = TOL[args[0].dtype]
    _close(got.float(), plain.tree_attention_plain(*args).float(), tol)
    _close(got.float(), tree_attention_ref(*map(_jax, args)), tol)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("case", range(len(chip_smoke.CASES)))
def test_tree_in_the_last_split_matches(case, n_split):
    """A tree walked after the last split's slots, into its partial, gives
    what a tree part of its own gives."""
    B, W, Hq, Hkv, hd, S, pos, window, dt = chip_smoke.CASES[case]
    args = chip_smoke.attention_inputs(torch, np, B, W, Hq, Hkv, hd, S, pos,
                                       window, dt, seed=B * W + S)
    ranges = split_ranges(S, n_split, MODEL_TILE)
    got = folded_model(*args, ranges)
    tol = TOL[args[0].dtype]
    _close(got.float(), split_model(*args, ranges)[0].float(), tol)
    _close(got.float(), tree_attention_ref(*map(_jax, args)), tol)


def _paged_sweep():
    return [pytest.param(i, id=label) for i, (label, _) in
            enumerate(chip_smoke.paged_case_list(np)[:10])]


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("case", _paged_sweep())
def test_paged_split_matches_plain_and_oracle(case, n_split):
    """Window-0 CASES as page tables and PAGED_INT8_CASES (fragmented
    tables, -1 entries, partial last pages): the splits hold whole pages
    and whole key tiles."""
    _, kw = chip_smoke.paged_case_list(np)[case]
    a = chip_smoke.paged_inputs(torch, np, **kw)
    ps = a["pool_k"].shape[1]
    S = a["key_pos"].shape[1]
    gran = MODEL_TILE * ps // math.gcd(MODEL_TILE, ps)
    got, _ = _paged_model(a, split_ranges(S, n_split, gran))
    tol = TOL[a["q"].dtype]
    args = chip_smoke.paged_args(a)
    _close(got.float(), plain.paged_tree_attention_plain(*args).float(), tol)
    _close(got.float(), paged_tree_attention_ref(*map(_jax, args)), tol)


# ---------------------------------------------------------------- edges
_FAKE_SMEM = ctypes.CFUNCTYPE(ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int)(
    lambda rows, W, hd, tile: 1024 * rows)
# the tensor-core block's shared memory at hd 128 (flash_common.cuh's
# layout), and the two blocks an H100 SXM's 132 SMs each hold at once (the
# library's occupancy query)
_FLASH_SMEM = ctypes.CFUNCTYPE(ctypes.c_size_t, ctypes.c_int)(
    lambda hd: 115_200)
_PER_SM = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int)(lambda hd: 2)
SMS = 132
RESIDENT = 2 * SMS


def _edge(label):
    """A SPLIT_EDGE case and the slot ranges the wrappers' plan gives it."""
    case = chip_smoke.SPLIT_EDGE[label]
    dense, paged = chip_smoke.split_edge_inputs(torch, np, *case, seed=1)
    Hkv, G, W, hd, q_dt, pool_dt, S = case
    flash = launch.flash_route(getattr(torch, q_dt), getattr(torch, pool_dt),
                               hd)
    plan = launch.split_plan(_FAKE_SMEM, _FLASH_SMEM, _PER_SM, SMS, flash,
                             len(chip_smoke.edge_fills(S)), W, Hkv * G, Hkv,
                             hd, S, page=chip_smoke.EDGE_PS)
    return dense, paged, kernel_ranges(S, *plan[2:4])


@pytest.mark.parametrize("label", list(chip_smoke.SPLIT_EDGE))
def test_split_edges_dense(label):
    """The card's split-edge cases at the kernels' own split: whole splits
    past a row's fill or cut away by its window give exactly nothing, and
    a row whose cache is all masked is its tree part alone."""
    dense, _, ranges = _edge(label)
    got, parts = split_model(*dense, ranges)
    tol = TOL[dense[0].dtype]
    _close(got.float(), plain.tree_attention_plain(*dense).float(), tol)
    _close(got.float(), tree_attention_ref(*map(_jax, dense)), tol)
    key_pos, q_pos, lo = dense[5:8]
    for r, (o, m, l) in zip(ranges, parts[1:]):
        kp = key_pos[:, r.start:r.stop]
        seen = ((kp[:, None, :] >= 0) & (kp[:, None, :] <= q_pos[..., None])
                & (kp[:, None, :] > lo[..., None])).any(-1)      # (B, W)
        empty = (~seen)[:, None, :].expand_as(m)
        assert torch.all(l[empty] == 0) and torch.all(
            m[empty] == cm.NEG_INF / 2)
        assert torch.all(o.transpose(1, 2)[empty] == 0)
    # row 2 (lo = q_pos) is its tree part alone, normalized
    tree = cm.merge_partials([parts[0]]).to(dense[0].dtype)
    _close(got[2].float(), tree[2].float(), tol)


@pytest.mark.parametrize("label", list(chip_smoke.SPLIT_EDGE))
def test_split_edges_paged(label):
    """The same cases through the page table: page-aligned splits, one of
    them wholly on unreserved pages (row 1, pages 4-7)."""
    _, paged, ranges = _edge(label)
    assert all(r.start % chip_smoke.EDGE_PS == 0 for r in ranges)
    got, _ = _paged_model(paged, ranges)
    tol = TOL[paged["q"].dtype]
    args = chip_smoke.paged_args(paged)
    _close(got.float(), plain.paged_tree_attention_plain(*args).float(), tol)
    _close(got.float(), paged_tree_attention_ref(*map(_jax, args)), tol)


def test_split_edges_cover_every_split_count():
    """SPLIT_EDGE reaches one split per tile (5 at S = 320, 10 at S =
    592), three, two and one."""
    counts = {len(_edge(label)[2]) for label in chip_smoke.SPLIT_EDGE}
    assert counts == {10, 5, 3, 2, 1}


# ---------------------------------------------------------------- picker
@pytest.mark.parametrize("page", [1, 4, 8, 12, 16, 128])
@pytest.mark.parametrize("blocks", [1, 4, 128, 264, 5000])
def test_pick_split_covers_whole_tiles_and_pages(blocks, page):
    tile = launch.FLASH_TILE
    gran = tile * page // math.gcd(tile, page)
    for S in (1, 8, 63, 64, 65, 200, 582, 592, 4096):
        for extra in (0, blocks):
            n, split_len = launch.pick_split(S, blocks, tile, RESIDENT,
                                             page, extra)
            ranges = kernel_ranges(S, n, split_len)
            assert [j for r in ranges for j in r] == list(range(S))
            assert split_len % gran == 0 and split_len >= tile
            assert all(len(r) > 0 for r in ranges)
            assert all(r.start % page == 0 and r.start % tile == 0
                       for r in ranges)
            assert n <= -(-S // gran)


@pytest.mark.parametrize("page", [1, 16])
def test_pick_split_one_split_when_one_tile(page):
    for S in range(1, launch.FLASH_TILE + 1):
        for blocks in (1, 7, 128):
            assert launch.pick_split(S, blocks, launch.FLASH_TILE,
                                     RESIDENT, page)[0] == 1


def _main_shapes():
    """The main path's walks (vicuna-7b: Hq = Hkv = 32, hd 128; batch 4;
    prompt 512 + 64 tokens + tree depth 6): dense verify and decode, paged
    (37 pages of 16), and the W=256 chain of a prefill piece (B=1)."""
    return {"dense verify W=8": (4, 8, 582, 1), "dense decode W=1":
            (4, 1, 576, 1), "paged verify W=8": (4, 8, 592, 16),
            "paged decode W=1": (4, 1, 592, 16), "dense chain W=256":
            (1, 256, 512, 1), "paged chain W=256": (1, 256, 592, 16)}


@pytest.mark.parametrize("shape", list(_main_shapes()))
def test_pick_split_fills_the_resident_slots_at_the_main_shapes(shape):
    """At the main path's shapes the grid fills the card: at least 1.9
    waves of 132 blocks, within the 2 x 132 blocks resident at once, and
    one more split would not fit; the tree is a part of its own only for
    the W=256 chain."""
    B, W, S, ps = _main_shapes()[shape]
    tile, rows, n, split_len, parts = launch.split_plan(
        None, _FLASH_SMEM, _PER_SM, SMS, True, B, W, 32, 32, 128, S,
        page=ps)
    assert (tile, rows) == (launch.FLASH_TILE, launch.FLASH_ROWS)
    per_split = B * 32 * -(-W // rows)
    total = per_split * parts
    assert 1.9 * SMS <= total <= RESIDENT
    assert total + per_split > RESIDENT or n == -(-S // split_len)
    assert split_len % (tile * ps // math.gcd(tile, ps)) == 0
    assert parts == n + (W > launch.FLASH_TILE)
    # the plan is kept: the same objects come back without a search
    assert launch.split_plan(None, _FLASH_SMEM, _PER_SM, SMS, True, B, W,
                             32, 32, 128, S, page=ps) == (tile, rows, n,
                                                          split_len, parts)


@pytest.mark.parametrize("hd", [16, 32, 40, 64, 80, 96, 112, 128])
def test_flash_block_fits_shared_memory(hd):
    """``split_plan`` plans a tensor-core walk only when the library's
    block fits ``SMEM_LIMIT``, and counts the resident slots by the
    library's occupancy query at that head_dim (the CUDA-core walk above
    head_dim 128 asks at 128); a failed query raises."""
    asked = []

    def per_sm(h):
        asked.append(h)
        return 1

    def plan(smem, occupancy, flash, head_dim):
        return launch.split_plan(_FAKE_SMEM, smem, occupancy, SMS, flash, 4,
                                 8, 32, 32, head_dim, 4096)

    fits = ctypes.CFUNCTYPE(ctypes.c_size_t, ctypes.c_int)(
        lambda h: launch.SMEM_LIMIT)
    over = ctypes.CFUNCTYPE(ctypes.c_size_t, ctypes.c_int)(
        lambda h: launch.SMEM_LIMIT + 1)
    # one block per SM: 132 slots hold one split of 128 blocks
    assert plan(fits, per_sm, True, hd)[2] == 1 and asked == [hd]
    assert plan(_FLASH_SMEM, _PER_SM, True, hd)[2] == 2
    with pytest.raises(ValueError, match="does not fit"):
        plan(over, _PER_SM, True, hd)
    assert plan(over, per_sm, False, hd + 128)[2] == 1
    assert asked == [hd, 128]
    with pytest.raises(RuntimeError, match="occupancy"):
        plan(fits, lambda h: -1, True, hd)


def test_flash_route():
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    assert launch.flash_route(bf, bf, 128) and launch.flash_route(bf, i8, 64)
    assert not launch.flash_route(bf, bf, 128, scaled=True)
    assert launch.flash_route(bf, i8, 128, scaled=True)
    assert not launch.flash_route(f32, f32, 64)
    assert not launch.flash_route(f32, i8, 64)
    assert not launch.flash_route(bf, f32, 64)
    assert not launch.flash_route(bf, bf, 192)
