"""B4's warp route (``csrc/tree_partial.cu::tree_warp_kernel``) and its call
path, modelled and checked on the CPU.

``warp_model`` writes the kernel's arithmetic in plain PyTorch: each tree
row's mask turned into one 64-bit word, the G*W query rows of a
(b, kv head) cut into blocks of 8 rows on four warps of two rows each
(rows past G*W zero-filled), keys padded with zero rows to the key slots
of the kernel's template (8, 16, 32 or 64), each dot product summed from
its head_dim parts on DP lanes (2 when a row has 8 key slots), then ONE
pass: the masked row max clamped to NEG_INF / 2, p = exp(s - m) on the
seen keys, l = sum p, o = p @ V, unnormalized, stored in the
``cm.merge_partials`` layout.  It is held against the JAX kernel
``repro.kernels.sparse_tree.sparse_tree_attention_partial`` (Pallas in
interpret mode, as ``tests/test_kernels.py`` runs it) and the port's plain
version on the same seeded numpy inputs, at the reference's tolerances:
fp32 2e-5, bf16 2e-2 against the plain version and 3e-2 against the JAX
kernel.

The call path: the route rule at its edges (``partial_route``: W = 64 / 65,
head_dim = 128 / 136), the C plan's layout against the C source, and the
per-signature plan (``launch.Plans``) with CPU tensors passed straight to
the checker: a new signature gets its own plan, and every check the
contract needs still raises after a cache hit.  The kernel itself runs on
the card (``tests/test_torch_card.py``, ``chip_smoke.py``):

    PYTHONPATH=src python -m pytest -q tests/test_torch_tree_partial.py
"""
import ctypes
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.speculative import tree as T  # noqa: E402
from repro_torch.kernels import launch, plain  # noqa: E402
from repro_torch.kernels import tree_partial as tp  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

CSRC = Path(tp.__file__).resolve().parent / "csrc" / "tree_partial.cu"
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ORACLE_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
WARPS, ROWS_PER_WARP = 4, 2          # a block: 8 rows on four warps


# ---------------------------------------------------------------- model
def mask_words(mask):
    """Each tree row's mask as one word, bit t = key t (W <= 64)."""
    return [sum(1 << t for t in range(mask.shape[1]) if mask[w, t])
            for w in range(mask.shape[0])]


def key_slots(W):
    """The template's key slots a row: W rounded up to 8, 16, 32, 64."""
    return next(n for n in (8, 16, 32, 64) if W <= n)


def lanes_per_dot(W):
    """DP: lanes that split one dot product (32 lanes over 2 rows x key
    slots; a row of 32 or 64 slots keeps one lane a dot product)."""
    KL = min(key_slots(W), 32)
    RS = ROWS_PER_WARP if KL * ROWS_PER_WARP <= 32 else 1
    return 32 // (KL * RS)


def warp_model(q, k, v, mask):
    """``tree_warp_kernel`` in plain PyTorch (fp32 from the operands), the
    partials in the merge layout."""
    B, W, Hq, hd = q.shape
    Hkv = k.shape[2]
    G, WMAX, DP = Hq // Hkv, key_slots(W), lanes_per_dot(W)
    VN = 16 // q.element_size()              # elements a 16-byte copy
    GW = G * W
    n_blk = -(-GW // tp.WARP_ROWS)
    # rows r = g*W + w of (b, h), zero past GW: (B, Hkv, blocks, warps, 2)
    qg = q.float().reshape(B, W, Hkv, G, hd).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B, Hkv, GW, hd)
    qg = torch.cat([qg, qg.new_zeros(B, Hkv, n_blk * tp.WARP_ROWS - GW,
                                     hd)], 2)
    qg = qg.reshape(B, Hkv, n_blk, WARPS, ROWS_PER_WARP, hd)
    # the W keys and values, zero rows up to the key slots
    kp = torch.cat([k.float(), k.new_zeros(B, WMAX - W, Hkv, hd).float()], 1)
    vp = torch.cat([v.float(), v.new_zeros(B, WMAX - W, Hkv, hd).float()], 1)
    kp, vp = kp.permute(0, 2, 1, 3), vp.permute(0, 2, 1, 3)  # (B, Hkv, T, hd)
    # each dot product from its DP parts: part p sums chunks p, p + DP, ...
    chunk = torch.arange(hd) // VN % DP
    s = sum(torch.einsum("bhnwrd,bhtd->bhnwrt", qg * (chunk == p), kp)
            for p in range(DP))
    scale = hd ** -0.5
    s = s * scale
    # the mask words of each row's tree row; rows past GW see nothing
    words = mask_words(mask.numpy())
    r = torch.arange(n_blk * tp.WARP_ROWS)
    bits = torch.tensor([[(words[i % W] >> t) & 1 if i < GW else 0
                          for t in range(WMAX)] for i in r.tolist()],
                        dtype=torch.bool)
    ok = bits.reshape(n_blk, WARPS, ROWS_PER_WARP, WMAX)[None, None]
    mx = torch.where(ok, s, cm.NEG_INF).amax(-1)
    m = torch.clamp(mx, min=cm.NEG_INF / 2)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhnwrt,bhtd->bhnwrd", p, vp)
    # back to the merge layout: o (B, W, Hq, hd), m and l (B, Hq, W)
    o = o.reshape(B, Hkv, -1, hd)[:, :, :GW].reshape(B, Hkv, G, W, hd)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, W, Hq, hd)

    def rows(x):
        return x.reshape(B, Hkv, -1)[:, :, :GW].reshape(B, Hq, W)
    return o, rows(m), rows(l)


def _inputs(B, W, Hq, Hkv, hd, dtype, mask, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, W, Hq, hd), (B, W, Hkv, hd), (B, W, Hkv, hd))]
    dt = getattr(torch, dtype)
    targs = [torch.from_numpy(a).to(dt) for a in arrays]
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    return targs + [torch.from_numpy(mask)], jargs + [jnp.asarray(mask)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _hold(targs, jargs):
    """The model against the plain version and the JAX kernel."""
    q = targs[0]
    got = warp_model(*targs)
    want = plain.sparse_tree_attention_partial_plain(*targs)
    jax_parts = jops.sparse_tree_attention_partial(*jargs)
    for g, w, j in zip(got, want, jax_parts):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w, TOL[q.dtype])
        _close(g, np.asarray(j, np.float32), ORACLE_TOL[q.dtype])
    return got


# ---------------------------------------------------------------- sweep
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("W", [1, 8, 16, 32, 64])
def test_warp_model_matches_jax_and_plain(W, G, hd, dtype):
    mask = chip_smoke.rand_tree(np, W, seed=W)[0]
    targs, jargs = _inputs(2, W, 2 * G, 2, hd, dtype, mask,
                           seed=W * 100 + G * 10 + hd)
    assert tp.partial_route(W, hd) == tp.PARTIAL_WARP
    _hold(targs, jargs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W", [8, 64])
def test_warp_model_on_the_engines_tree(W, dtype):
    """The engine's own tree builder: the main path's W=8 tree (serve
    --width 8) and the Fig. 10b study's 64-node tree, at the main path's
    head_dim."""
    mask = T.build_tree(T.default_accs(5, 10), W).mask
    targs, jargs = _inputs(2, W, 4, 4, 128, dtype, mask, seed=W)
    _hold(targs, jargs)


def test_all_masked_row_is_dropped():
    """A row whose mask is empty: l = 0, m = NEG_INF / 2, o = 0 in the
    model, the plain version and the JAX kernel alike, so the row drops
    out of ``cm.merge_partials`` beside any part that sees a key."""
    mask = chip_smoke.rand_tree(np, 8, seed=3)[0]
    mask[5] = False
    targs, jargs = _inputs(1, 8, 2, 1, 64, "float32", mask, seed=5)
    o, m, l = _hold(targs, jargs)
    assert torch.all(l[:, :, 5] == 0) and torch.all(o[:, 5] == 0)
    assert torch.all(m[:, :, 5] == cm.NEG_INF / 2)
    assert torch.all(l[:, :, [i for i in range(8) if i != 5]] > 0)


def test_mask_words_hold_every_bit():
    """A 64-node tree's words keep key 63 (the top bit of the word)."""
    mask = np.tril(np.ones((64, 64), bool))
    words = mask_words(mask)
    assert words[63] == 2 ** 64 - 1 and words[0] == 1
    assert all((words[w] >> t) & 1 == mask[w, t]
               for w in range(64) for t in range(64))


@pytest.mark.parametrize("W,want", [(1, 2), (8, 2), (9, 1), (16, 1),
                                    (32, 1), (33, 1), (64, 1)])
def test_lanes_split_dot_products_only_for_small_trees(W, want):
    """32 lanes over 2 rows x the key slots: two lanes a dot product at 8
    slots, one from 16 up (2 x 32 at W > 32 run two keys a lane)."""
    assert lanes_per_dot(W) == want


# ---------------------------------------------------------------- route
@pytest.mark.parametrize("W,hd,want", [
    (64, 128, tp.PARTIAL_WARP),       # the warp route's widest tree
    (65, 128, tp.PARTIAL_TILES),      # one key past one pass
    (64, 136, tp.PARTIAL_TILES),      # past four columns a lane
    (8, 136, tp.PARTIAL_TILES),
    (8, 128, tp.PARTIAL_WARP),        # the main path's verify
    (1, 8, tp.PARTIAL_WARP),
    (256, 128, tp.PARTIAL_TILES),     # a W=256 prefill piece
])
def test_partial_route_edges(W, hd, want):
    assert tp.partial_route(W, hd) == want


def test_route_rule_and_plan_match_the_c_source():
    """The C source states the same rule (64 keys, head_dim 128) and the
    same plan layout, field by field."""
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (kWarp\w+) = (\d+);", src))
    assert int(consts["kWarpKeys"]) == tp.WARP_KEYS
    assert int(consts["kWarpHdMax"]) == launch.FLASH_HD_MAX
    assert int(consts["kWarpRows"]) == tp.WARP_ROWS
    assert int(consts["kWarpWarps"]) == WARPS
    assert "return W <= kWarpKeys && hd <= kWarpHdMax ? 1 : 0;" in src
    body = re.search(r"struct TreePlan \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.findall(r"(int|float) ([^;]+);", body):
        fields += [(decl[0], n.strip()) for n in decl[1].split(",")]
    assert [n for _, n in fields] == [n for n, _ in tp._TreePlan._fields_]
    assert [t for t, _ in fields] == [
        "float" if c is ctypes.c_float else "int"
        for _, c in tp._TreePlan._fields_]


# ---------------------------------------------------------------- plans
def _cpu(B=2, W=8, Hq=4, Hkv=2, hd=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, W, Hq, hd, generator=g).to(dtype)
    k = torch.randn(B, W, Hkv, hd, generator=g).to(dtype)
    v = torch.randn(B, W, Hkv, hd, generator=g).to(dtype)
    mask = torch.from_numpy(chip_smoke.rand_tree(np, W, seed=W)[0])
    return [q, k, v, mask]


def test_a_signature_gets_one_plan_and_a_new_one_its_own():
    plans = launch.Plans(tp._partial_plan)
    args = _cpu()
    plan = plans.get(*args)
    assert plans.get(*_cpu()) is plan and len(plans) == 1
    c = plan.c_plan
    assert (c.route, c.q_dtype, c.B, c.W, c.Hq, c.Hkv, c.hd) == \
        (tp.PARTIAL_WARP, 0, 2, 8, 4, 2, 64)
    assert c.scale == pytest.approx(64 ** -0.5)
    for other in (_cpu(W=16), _cpu(dtype=torch.bfloat16), _cpu(hd=128),
                  _cpu(Hq=8)):
        p = plans.get(*other)
        assert p is not plan and p is plans.get(*other)
        assert (p.c_plan.W, p.c_plan.q_dtype, p.c_plan.hd, p.c_plan.Hq) == \
            (other[1].shape[1], 1 if other[0].dtype == torch.bfloat16
             else 0, other[0].shape[3], other[0].shape[2])
    assert len(plans) == 5


@pytest.mark.parametrize("breaks,error", [
    (lambda a: a.__setitem__(2, a[2][:, :4]), ValueError),       # v shape
    (lambda a: a.__setitem__(1, a[1].double()), TypeError),      # k dtype
    (lambda a: a.__setitem__(0, a[0].to(torch.bfloat16)), TypeError),
    (lambda a: a.__setitem__(3, a[3].int()), TypeError),         # mask
    (lambda a: a.__setitem__(3, a[3][:4, :4]), ValueError),
])
def test_a_bad_signature_raises_after_a_cache_hit(breaks, error):
    """A wrong shape or dtype is a signature of its own: its plan is made,
    the check raises, and nothing is kept."""
    plans = launch.Plans(tp._partial_plan)
    plans.get(*_cpu())
    plans.get(*_cpu())                        # a cache hit
    args = _cpu()
    breaks(args)
    with pytest.raises(error):
        plans.get(*args)
    assert len(plans) == 1


def _misaligned(t):
    """``t``'s values in a tensor of the same shape, dtype and layout whose
    data start one element past a 16-byte boundary (a storage offset)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    out = flat.view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_layout_checks_run_on_every_call(which, dtype):
    """A non-contiguous or 16-byte-misaligned operand has the signature of
    a good one, so it hits the cached plan; ``launch.pointers`` still
    raises on it, every call."""
    plans = launch.Plans(tp._partial_plan)
    good = _cpu(dtype=dtype)
    plan = plans.get(*good)
    assert launch.pointers(good, 3) == [t.data_ptr() for t in good]
    t = good[which]
    strided = t.transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous()
    for bad, why in ((strided, "contiguous"), (_misaligned(t), "aligned")):
        args = list(good)
        args[which] = bad
        assert launch.signature(args) == launch.signature(good)
        assert plans.get(*args) is plan              # a cache hit
        with pytest.raises(ValueError, match=why):
            launch.pointers(args, 3)
    # the mask is read byte by byte: any offset will do, contiguity not
    mask = torch.zeros(good[3].numel() + 1, dtype=torch.bool)[1:].view(
        good[3].shape)
    launch.pointers(good[:3] + [mask], 3)
    with pytest.raises(ValueError, match="contiguous"):
        launch.pointers(good[:3] + [good[3].t()], 3)


def test_a_plan_of_the_tiles_route_takes_the_library_tiles(monkeypatch):
    """W = 65: the plan asks the library's shared-memory count for the key
    tile and rows, as ``launch.pick_tiles`` does for the tiles route."""
    from test_torch_sparse import _smem_bytes

    class Lib:
        tree_partial_smem_bytes = staticmethod(_smem_bytes)
    monkeypatch.setattr(tp, "_bind", lambda: Lib)
    args = _cpu(W=65, Hq=4, Hkv=1, hd=128)
    plan = launch.Plans(tp._partial_plan).get(*args)
    c = plan.c_plan
    assert c.route == tp.PARTIAL_TILES
    assert (c.tile, c.rows) == launch.pick_tiles(_smem_bytes, 4 * 65, 65,
                                                 128)


@pytest.mark.parametrize("B,W,Hq,hd", [(4, 8, 32, 128), (1, 1, 7, 64)])
def test_plan_outputs_share_one_allocation(B, W, Hq, hd):
    """o, m, l are views of one fp32 buffer in the merge layout, m and l
    where the C entry point puts them (after o, then after m)."""
    plan = launch.Plans(tp._partial_plan).get(*_cpu(B=B, W=W, Hq=Hq, Hkv=1,
                                                    hd=hd))
    (o, m, l), base = plan.outputs()
    assert [t.shape for t in (o, m, l)] == [(B, W, Hq, hd), (B, Hq, W),
                                            (B, Hq, W)]
    assert all(t.is_contiguous() and t.dtype == torch.float32
               for t in (o, m, l))
    assert o.untyped_storage().data_ptr() == m.untyped_storage().data_ptr() \
        == l.untyped_storage().data_ptr()
    assert base == o.data_ptr()
    assert m.data_ptr() == o.data_ptr() + 4 * o.numel()
    assert l.data_ptr() == m.data_ptr() + 4 * m.numel()


def test_cpu_calls_run_the_plain_version_and_launch_nothing():
    args = _cpu()
    n = tp.sparse_tree_attention_partial.launches
    got = tp.sparse_tree_attention_partial(*args)
    want = plain.sparse_tree_attention_partial_plain(*args)
    assert tp.sparse_tree_attention_partial.launches == n
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_count_reads_and_sets():
    """Reads draw from the count without changing it; a set starts it
    anew."""
    counted = launch.Counted(lambda: None)
    assert counted.launches == 0 and counted.launches == 0
    for _ in range(3):
        counted.count_launch()
    assert counted.launches == 3 and counted.launches == 3
    counted.launches = 10
    counted.count_launch()
    assert counted.launches == 11
