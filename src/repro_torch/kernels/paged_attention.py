"""Paged verify attention: the wrappers of the hand-written CUDA kernels in
``csrc/paged_attention.cu`` (counterparts of the Pallas
``repro/kernels/tree_attention.py::paged_tree_attention`` and
``::paged_cache_attention``).

Both take the exact argument layout of their plain versions in
``plain.py``.  A CPU tensor runs the plain version; a CUDA tensor launches
the kernel or raises, with no fallback between the two.  Both are split
walks over the cache (``launch.split_plan``).  The fused walk writes an
fp32 partials workspace, then the Eq.-1 merge normalizes it (two kernels
from one C call, counted as one launch).  The cache-only walk has no tree
part: with one split it writes its ``(o, m, l)`` outputs directly, with
more it writes the workspace and a carry fold folds the splits into one
unnormalized partial (two kernels, one launch).  Each wrapper counts its
own kernel launches in ``.launches`` (and nothing else).

The pool may be float32, bfloat16 or int8 (then with its per-page scales);
q, the tree KVs and the output share q's dtype, float32 or bfloat16.  Every
``q x pool`` combination is built.  A float pool takes ``scale_k = scale_v
= None``: the kernel then multiplies by 1.0, which is exact.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import (Counted, check_common, flash_route,
                                        launch, partial_outputs, sm_count,
                                        split_plan, workspace)
from repro_torch.kernels.plain import (paged_cache_attention_plain,
                                       paged_tree_attention_plain)

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _bind():
    """Build (first use) and load the library, and declare every C
    signature: pointers and the stream as ``c_void_p``."""
    lib = build.load("paged_attention")
    lib.paged_tree_attention.argtypes = ([_I, _I] + [_P] * 16 + [_I] * 12
                                         + [ctypes.c_float, _P])
    lib.paged_cache_attention.argtypes = ([_I, _I] + [_P] * 15 + [_I] * 12
                                          + [ctypes.c_float, _P])
    lib.paged_tree_attention.restype = _I
    lib.paged_cache_attention.restype = _I
    lib.paged_attention_smem_bytes.argtypes = [_I] * 4
    lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
    lib.paged_attention_flash_smem_bytes.argtypes = [_I]
    lib.paged_attention_flash_smem_bytes.restype = ctypes.c_size_t
    for f in (lib.paged_attention_flash_blocks_per_sm,
              lib.paged_cache_flash_blocks_per_sm):
        f.argtypes = [_I]
        f.restype = _I
    lib.paged_attention_error_string.argtypes = [_I]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _check(q, pool_k, pool_v, scale_k, scale_v, block_table, key_pos, q_pos,
           lo, k_new=None, v_new=None, tree_mask=None):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, W, Hq, hd), got {tuple(q.shape)}")
    B, W, Hq, hd = q.shape
    if pool_k.dim() != 4 or pool_k.shape[3] != hd:
        raise ValueError(f"pool_k {tuple(pool_k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    P, ps, Hkv = pool_k.shape[:3]
    maxp = block_table.shape[-1]
    _shape("pool_v", pool_v, pool_k.shape)
    _shape("block_table", block_table, (B, maxp))
    _shape("key_pos", key_pos, (B, maxp * ps))
    _shape("q_pos", q_pos, (B, W))
    _shape("lo", lo, (B, W))
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if pool_k.dtype not in _POOL_CODES or pool_v.dtype != pool_k.dtype:
        raise TypeError(f"the pool must be float32, bfloat16 or int8 (K and "
                        f"V alike), got {pool_k.dtype} / {pool_v.dtype}")
    if (scale_k is None) != (scale_v is None):
        raise ValueError("pass both scales or neither")
    if pool_k.dtype == torch.int8 and scale_k is None:
        raise ValueError("an int8 pool needs its per-page scales")
    scales = () if scale_k is None else (scale_k, scale_v)
    for name, t in zip(("scale_k", "scale_v"), scales):
        _shape(name, t, (P, Hkv))
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("block_table", block_table), ("key_pos", key_pos),
                    ("q_pos", q_pos), ("lo", lo)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    step = 16 // pool_k.element_size()
    if hd % step or hd % 8:
        raise ValueError(f"head_dim {hd} must be a multiple of {max(step, 8)}"
                         f" (16-byte vector loads of a {pool_k.dtype} pool)")
    tree = ()
    if k_new is not None:
        _shape("k_new", k_new, (B, W, Hkv, hd))
        _shape("v_new", v_new, (B, W, Hkv, hd))
        _shape("tree_mask", tree_mask, (W, W))
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if t.dtype != q.dtype:
                raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if tree_mask.dtype != torch.bool:
            raise TypeError(f"tree_mask must be bool, got {tree_mask.dtype}")
        tree = (k_new, v_new, tree_mask)
    check_common(q, (q, pool_k, pool_v, block_table, key_pos, q_pos, lo)
                 + scales + tree, (q, pool_k, pool_v) + tree[:2])
    return B, W, Hq, Hkv, hd, ps, maxp


def _plan(q, pool_k, scale_k, dims, tree):
    """``split_plan``'s ``(tile, rows, n_split, split_len, parts)`` of the
    fused (``tree``) or the cache-only walk, from the library's own shared
    memory and occupancy queries."""
    B, W, Hq, Hkv, hd, ps, maxp = dims
    lib = _bind()
    blocks_per_sm = (lib.paged_attention_flash_blocks_per_sm if tree
                     else lib.paged_cache_flash_blocks_per_sm)
    return split_plan(lib.paged_attention_smem_bytes,
                      lib.paged_attention_flash_smem_bytes, blocks_per_sm,
                      sm_count(q.device),
                      flash_route(q.dtype, pool_k.dtype, hd,
                                  scale_k is not None),
                      B, W, Hq, Hkv, hd, maxp * ps, page=ps, tree=tree)


def _launch(wrapper, q, pool_k, dims, operands, split, ws):
    """Launch ``wrapper``'s C entry point with ``split = (tile, rows,
    n_split, split_len, parts)`` and the workspace pointers ``ws``."""
    B, W, Hq, Hkv, hd, ps, maxp = dims
    lib = _bind()
    launch(wrapper, getattr(lib, wrapper.__name__),
           lib.paged_attention_error_string, q.device, _Q_CODES[q.dtype],
           _POOL_CODES[pool_k.dtype],
           *(None if t is None else t.data_ptr() for t in operands), *ws,
           B, W, Hq, Hkv, hd, ps, maxp, *split, hd ** -0.5)


@Counted
def paged_tree_attention(q, pool_k, pool_v, scale_k, scale_v, k_new, v_new,
                         block_table, key_pos, q_pos, lo, tree_mask):
    """See ``paged_tree_attention_plain`` for the semantics and layout."""
    if q.device.type == "cpu":
        return paged_tree_attention_plain(q, pool_k, pool_v, scale_k,
                                          scale_v, k_new, v_new, block_table,
                                          key_pos, q_pos, lo, tree_mask)
    if q.device.type != "cuda":
        raise ValueError(f"paged_tree_attention runs on cuda or cpu, got "
                         f"{q.device}")
    dims = _check(q, pool_k, pool_v, scale_k, scale_v, block_table, key_pos,
                  q_pos, lo, k_new, v_new, tree_mask)
    split = _plan(q, pool_k, scale_k, dims, tree=True)
    out = torch.empty_like(q)
    ws, ws_o, ws_m, ws_l = workspace(q, split[4])
    _launch(paged_tree_attention, q, pool_k, dims,
            (q, pool_k, pool_v, scale_k, scale_v, k_new, v_new, block_table,
             key_pos, q_pos, lo, tree_mask, out), split, (ws_o, ws_m, ws_l))
    return out


@Counted
def paged_cache_attention(q, pool_k, pool_v, scale_k, scale_v, block_table,
                          key_pos, q_pos, lo):
    """See ``paged_cache_attention_plain``: returns the unnormalized
    ``(o, m, l)`` partials of the page walk in the merge layout (one
    partial whatever the split: the splits are folded on the card)."""
    if q.device.type == "cpu":
        return paged_cache_attention_plain(q, pool_k, pool_v, scale_k,
                                           scale_v, block_table, key_pos,
                                           q_pos, lo)
    if q.device.type != "cuda":
        raise ValueError(f"paged_cache_attention runs on cuda or cpu, got "
                         f"{q.device}")
    dims = _check(q, pool_k, pool_v, scale_k, scale_v, block_table, key_pos,
                  q_pos, lo)
    split = _plan(q, pool_k, scale_k, dims, tree=False)
    # one split writes o, m, l itself: no workspace pointers, no fold
    o, m, l, ws = partial_outputs(q, split[4])
    _launch(paged_cache_attention, q, pool_k, dims,
            (q, pool_k, pool_v, scale_k, scale_v, block_table, key_pos,
             q_pos, lo, o, m, l), split, ws)
    return o, m, l
