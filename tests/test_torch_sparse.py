"""The normalized sparse tree attention (B5) and the kernel-launch helpers
shared by every wrapper, on the CPU.

* ``sparse_tree_attention_plain``, the CPU route of the wrapper and of
  ``kernels.dispatch.sparse_tree_attention``, against the reference's
  oracle ``repro.kernels.ref.sparse_tree_ref`` and its Pallas kernel in
  interpret mode, over ``tests/test_kernels.py:134-138`` and the Fig. 10b
  shape, at the reference's tolerances (fp32 2e-5, bf16 3e-2).
* ``launch.pick_tiles``: the key tile and the query-row tile; all rows in
  one block whenever they fit, else the largest key tile and as many rows
  as a block of it holds.
* ``launch.Counted``: the launch count under concurrent worker threads.
The CUDA kernel is held against the plain version on the card by
``test_torch_card.py`` and ``chip_smoke.py``.
"""
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.speculative import tree as JT
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import dispatch, launch, plain
from repro_torch.kernels import tree_partial as tp
from test_torch_paged_kernels import _rand_tree_mask

# tests/test_kernels.py:134-138 (B=2), then benchmarks/sparse.py's Fig. 10b
# shape (B=1, the study's tree): B, W, Hq, Hkv, hd, dtype
CASES = [(2, 4, 4, 2, 32, "float32"), (2, 16, 8, 8, 64, "float32"),
         (2, 64, 4, 1, 128, "bfloat16"), (1, 64, 32, 8, 128, "float32")]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(B, W, Hq, Hkv, hd, dtype):
    rng = np.random.default_rng(W + Hq)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, W, Hq, hd), (B, W, Hkv, hd), (B, W, Hkv, hd))]
    if B == 1:                         # the Fig. 10b study's tree
        mask = JT.build_tree(JT.default_accs(5, 10), W).mask
    else:
        mask = _rand_tree_mask(W, seed=W)[0]
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return (jargs + [jnp.asarray(mask)], targs + [torch.from_numpy(mask)])


@pytest.mark.parametrize("B,W,Hq,Hkv,hd,dtype", CASES)
def test_sparse_tree_attention_matches_oracle_and_pallas(B, W, Hq, Hkv, hd,
                                                         dtype):
    jargs, targs = _inputs(B, W, Hq, Hkv, hd, dtype)
    n = tp.sparse_tree_attention.launches
    got = tp.sparse_tree_attention(*targs)
    assert tp.sparse_tree_attention.launches == n          # CPU: no launch
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    tol = TOL[dtype]
    want = np.asarray(jref.sparse_tree_ref(*jargs), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    if B > 1:                          # the reference's kernel sweep
        pallas = jops.sparse_tree_attention(*jargs, backend="pallas",
                                            interpret=True)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(pallas, np.float32),
                                   atol=tol, rtol=tol)


def test_dispatch_cpu_route_is_the_plain_version():
    _, targs = _inputs(2, 16, 8, 8, 64, "float32")
    n = tp.sparse_tree_attention.launches
    out = dispatch.sparse_tree_attention(*targs)
    assert torch.equal(out, plain.sparse_tree_attention_plain(*targs))
    assert tp.sparse_tree_attention.launches == n


def test_sparse_tree_wrapper_checks_and_device():
    _, targs = _inputs(2, 4, 4, 2, 32, "float32")
    assert tp._check(*targs) == (2, 4, 4, 2, 32)
    with pytest.raises(TypeError):            # checked before any launch
        tp._check(targs[0], targs[1].double(), *targs[2:])
    meta = [t.to("meta") for t in targs]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tp.sparse_tree_attention(*meta)


def _smem_bytes(rows, W, hd, tile):
    """``attn::smem_bytes`` of ``csrc/attention_common.cuh``."""
    floats = (2 * rows * hd + tile * (hd + 1) + tile * hd + rows * tile
              + 3 * rows + 2 * tile)
    return (floats + 2 * tile + 2 * W) * 4 + W * W + rows * tile


@pytest.mark.parametrize("GW,W,hd,want", [
    (8, 8, 128, (64, 8)),          # main path verify: one tile, as before
    (1, 1, 128, (64, 1)),          # decode
    (256, 64, 128, (64, 86)),      # Fig. 10b / the W=64 sweep case
    (256, 256, 128, (64, 64)),     # a W=256 chunked-prefill piece
    (128, 16, 128, (32, 128)),     # the W=16 GQA sweep case fits whole
])
def test_pick_tiles(GW, W, hd, want):
    tile, rows = launch.pick_tiles(_smem_bytes, GW, W, hd)
    assert (tile, rows) == want
    assert _smem_bytes(rows, W, hd, tile) <= launch.SMEM_LIMIT
    if rows == GW:                 # all rows fit: the largest such tile
        assert all(_smem_bytes(GW, W, hd, t) > launch.SMEM_LIMIT
                   for t in launch.TILES if t > tile)
    else:                          # the largest tile, as many rows as fit
        assert tile == launch.TILES[0]
        n = -(-GW // rows)
        assert _smem_bytes(-(-GW // (n - 1)), W, hd, tile) > \
            launch.SMEM_LIMIT


def test_pick_tiles_refuses_what_no_block_holds():
    with pytest.raises(ValueError):
        launch.pick_tiles(lambda *a: launch.SMEM_LIMIT + 1, 8, 8, 128)


def test_launch_count_survives_concurrent_workers():
    """More threads than cores, a short switch interval: every launch
    counted once (a plain ``+=`` on an attribute loses updates here)."""
    counted = launch.Counted(lambda: None)
    counted.launches = 0
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counted.count_launch() for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counted.launches == n_threads * per
    counted.launches = 0
    assert counted.launches == 0
