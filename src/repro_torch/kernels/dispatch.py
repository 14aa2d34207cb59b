"""Public kernel entry points with the model-side signatures (counterpart
of ``repro/kernels/ops.py``): they turn ``pos``/``tree_depth``/``window``
into the kernel's per-query ``q_pos``/``lo`` rows and call the wrapper,
which runs the plain version for CPU tensors and the CUDA kernel for CUDA
tensors.

The paged entry points pass a float pool's missing scales on as ``None``
(the reference's ``_pool_scales`` makes all-ones tensors instead): the
kernel then skips the scale reads and multiplies by 1.0, so the result is
exact either way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import tree_partial as _tree
from repro_torch.kernels.verify_attention import verify_attention


def wrappers() -> dict:
    """The port's kernel wrappers by name: each counts its launches in
    ``.launches`` (on a CPU tensor a wrapper runs its plain version and
    counts nothing)."""
    return {"verify_attention": verify_attention,
            "paged_tree_attention": _paged.paged_tree_attention,
            "paged_cache_attention": _paged.paged_cache_attention,
            "sparse_tree_attention_partial":
                _tree.sparse_tree_attention_partial,
            "sparse_tree_attention": _tree.sparse_tree_attention}


def _query_pos(q, pos, tree_depth):
    """(B, W) int32 absolute position of every tree query: ``pos`` (an int
    or (B,)) plus the node's depth."""
    pos_b = torch.broadcast_to(
        torch.as_tensor(pos, dtype=torch.int32, device=q.device),
        (q.shape[0],))
    return (pos_b[:, None] + tree_depth[None, :]).to(torch.int32)


def tree_attention(q, ck, cv, k_new, v_new, key_pos, pos, tree_depth,
                   tree_mask, *, window=0):
    """``pos`` is an int or (B,) and ``key_pos`` (S,) or (B, S): sequences
    sit at different absolute positions once batched speculative commits
    diverge, so the kernel takes per-batch ``q_pos``/``lo`` rows."""
    B, S = q.shape[0], ck.shape[1]
    key_pos_b = torch.broadcast_to(key_pos, (B, S)).contiguous()
    q_pos = _query_pos(q, pos, tree_depth)                     # (B, W)
    if window:
        lo = q_pos - window
    else:
        lo = torch.full_like(q_pos, -1)
    return verify_attention(q, ck, cv, k_new, v_new, key_pos_b, q_pos, lo,
                            tree_mask)


def decode_attention(q, ck, cv, k_new, v_new, key_pos, pos, *, window=0):
    """Plain decode = W=1 tree."""
    dev = q.device
    return tree_attention(q, ck, cv, k_new, v_new, key_pos, pos,
                          torch.zeros((1,), dtype=torch.int32, device=dev),
                          torch.ones((1, 1), dtype=torch.bool, device=dev),
                          window=window)


def paged_tree_attention(q, pool_k, pool_v, k_new, v_new, block_table,
                         key_pos, pos, tree_depth, tree_mask, *,
                         scale_k=None, scale_v=None):
    """Paged verify: ``pool_k/pool_v`` are ONE layer's shared pool
    ``(n_pages + 1, ps, Hkv, hd)`` (trash page last), ``scale_k/scale_v
    (n_pages + 1, Hkv)`` an int8 pool's scales (None = float pool).  Paged
    caches take no window (the ring IS the window, so they stay dense)."""
    q_pos = _query_pos(q, pos, tree_depth)
    return _paged.paged_tree_attention(
        q, pool_k, pool_v, scale_k, scale_v, k_new, v_new, block_table,
        key_pos, q_pos, torch.full_like(q_pos, -1), tree_mask)


def paged_cache_attention(q, pool_k, pool_v, block_table, key_pos, pos,
                          tree_depth, *, scale_k=None, scale_v=None):
    """Cache-only half of the split verify (``tree_kernel="sparse"``): the
    page walk without the tree tile, as ``(o, m, l)`` merge partials."""
    q_pos = _query_pos(q, pos, tree_depth)
    return _paged.paged_cache_attention(
        q, pool_k, pool_v, scale_k, scale_v, block_table, key_pos, q_pos,
        torch.full_like(q_pos, -1))


def sparse_tree_attention_partial(q, k_new, v_new, tree_mask):
    """Tree half of the split verify: ``(o, m, l)`` partials of the W x W
    masked tree attention, merged with ``paged_cache_attention``'s."""
    return _tree.sparse_tree_attention_partial(q, k_new, v_new, tree_mask)


def sparse_tree_attention(q, k_new, v_new, tree_mask):
    """The W x W tree-correlation attention alone, normalized (the Fig. 10b
    study's block-masked kernel; counterpart of ``repro/kernels/ops.py::
    sparse_tree_attention``): a CUDA tensor launches the kernel, a CPU
    tensor runs its plain version."""
    return _tree.sparse_tree_attention(q, k_new, v_new, tree_mask)
