"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

They take the kernels' exact argument layout.  A wrapper runs its plain
version for CPU tensors; on the card they are reached only by calling them
by name (``chip_smoke.py`` holds each kernel against its plain version).
"""
from __future__ import annotations

import torch

from repro_torch.models import common as cm
from repro_torch.runtime.cache import gather_pages_dequant


def tree_attention_plain(q, ck, cv, k_new, v_new, key_pos, q_pos, lo,
                         tree_mask):
    """Fused dense(cache)+sparse(tree) verification attention.

    q:        (B, W, Hq, hd)
    ck, cv:   (B, S, Hkv, hd)   KV cache
    k_new:    (B, W, Hkv, hd)   fresh tree KVs
    key_pos:  (B, S) int32      absolute position per cache slot (-1 empty)
    q_pos:    (B, W) int32      absolute position per query node
    lo:       (B, W) int32      window lower bound per query (-1 = no window)
    tree_mask:(W, W) bool       ancestor-or-self
    returns   (B, W, Hq, hd) in q.dtype
    """
    B, W = q.shape[:2]
    scale = q.shape[-1] ** -0.5
    cache_ok = _cache_ok(key_pos, q_pos, lo, B, W, ck.shape[1])
    dense = cm.gqa_attend_partial(q, ck, cv, cache_ok[:, None], scale)
    sparse = cm.gqa_attend_partial(q, k_new, v_new,
                                   tree_mask[None, None], scale)
    return cm.merge_partials([dense, sparse]).to(q.dtype)


def _cache_ok(key_pos, q_pos, lo, B, W, S):
    """(B, W, S) cache validity: filled, causal, inside the window."""
    key_pos = torch.broadcast_to(key_pos, (B, S))
    q_pos = torch.broadcast_to(q_pos, (B, W))
    lo = torch.broadcast_to(lo, (B, W))
    return ((key_pos[:, None, :] >= 0)
            & (key_pos[:, None, :] <= q_pos[:, :, None])
            & (key_pos[:, None, :] > lo[:, :, None]))


def paged_tree_attention_plain(q, pool_k, pool_v, scale_k, scale_v, k_new,
                               v_new, block_table, key_pos, q_pos, lo,
                               tree_mask):
    """Paged verify attention: gather each row's pages into the logical
    (B, S_logical, Hkv, hd) view, dequantized through the per-page scales
    (``None`` = float pool, gathered verbatim), then the dense version.

    pool_k/pool_v: (n_pages + 1, ps, Hkv, hd) ONE layer's pool, trash page
    last; scale_k/scale_v: (n_pages + 1, Hkv) or None; block_table:
    (B, max_pages), -1 = unreserved; key_pos: (B, max_pages * ps).
    """
    ck = gather_pages_dequant(pool_k, scale_k, block_table)
    cv = gather_pages_dequant(pool_v, scale_v, block_table)
    return tree_attention_plain(q, ck, cv, k_new, v_new, key_pos, q_pos, lo,
                                tree_mask)


def paged_cache_attention_plain(q, pool_k, pool_v, scale_k, scale_v,
                                block_table, key_pos, q_pos, lo):
    """Cache-only half of the split verify: the paged gather and the dense
    partial.  Returns UNNORMALIZED ``(o (B, W, Hq, hd) f32, m (B, Hq, W),
    l (B, Hq, W))`` in the ``cm.merge_partials`` layout; an all-masked row
    has l = 0 and m = NEG_INF / 2."""
    ck = gather_pages_dequant(pool_k, scale_k, block_table)
    cv = gather_pages_dequant(pool_v, scale_v, block_table)
    B, W = q.shape[:2]
    ok = _cache_ok(key_pos, q_pos, lo, B, W, ck.shape[1])
    return cm.gqa_attend_partial(q, ck, cv, ok[:, None], q.shape[-1] ** -0.5)


def sparse_tree_attention_partial_plain(q, k_new, v_new, tree_mask):
    """Tree half of the split verify: UNNORMALIZED ``(o, m, l)`` partials
    of the W x W ancestor-masked attention of the tree queries over the
    fresh tree KVs."""
    return cm.gqa_attend_partial(q, k_new, v_new, tree_mask[None, None],
                                 q.shape[-1] ** -0.5)


def sparse_tree_attention_plain(q, k_new, v_new, tree_mask):
    """The tree part alone, normalized (counterpart of
    ``repro/kernels/ref.py::sparse_tree_ref``): the W x W ancestor-masked
    attention of the tree queries over the fresh tree KVs, (B, W, Hq, hd) in
    q's dtype."""
    return cm.gqa_attend(q, k_new, v_new, tree_mask[None, None],
                         q.shape[-1] ** -0.5)
