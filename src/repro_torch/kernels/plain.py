"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

They take the kernels' exact argument layout.  A wrapper runs its plain
version for CPU tensors; on the card they are reached only by calling them
by name (``chip_smoke.py`` holds each kernel against its plain version).
"""
from __future__ import annotations

import torch

from repro_torch.models import common as cm


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
    key_pos = torch.broadcast_to(key_pos, (B, ck.shape[1]))
    q_pos = torch.broadcast_to(q_pos, (B, W))
    lo = torch.broadcast_to(lo, (B, W))
    scale = q.shape[-1] ** -0.5
    cache_ok = ((key_pos[:, None, :] >= 0)
                & (key_pos[:, None, :] <= q_pos[:, :, None])
                & (key_pos[:, None, :] > lo[:, :, None]))      # (B, W, S)
    dense = cm.gqa_attend_partial(q, ck, cv, cache_ok[:, None], scale)
    sparse = cm.gqa_attend_partial(q, k_new, v_new,
                                   tree_mask[None, None], scale)
    return cm.merge_partials([dense, sparse]).to(q.dtype)
