"""The W x W masked tree attention: the wrappers of the hand-written CUDA
kernel ``csrc/tree_partial.cu`` (counterparts of the Pallas
``repro/kernels/sparse_tree.py::sparse_tree_attention_partial`` and
``::sparse_tree_attention``).

``sparse_tree_attention_partial`` (the split verify's tree half, the
unnormalized ``(o, m, l)`` partials, B4) and ``sparse_tree_attention`` (the
tree part alone, normalized, in q's dtype, B5) take their plain versions'
exact arguments.  A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises.  Each wrapper's ``.launches`` counts its
kernel's launches and nothing else.

B5 has three routes (``norm_route``; ``csrc/tree_partial.cu`` states the
same rule): bf16 at head_dim <= 128 on the tensor cores, fp32 with W <= 64
and head_dim <= 128 in one exact fp32 pass on the CUDA cores, and B4's
kernel with the normalized epilogue otherwise.  The first two cut each kv
head's G*W query rows into small row tiles (``norm_rows``) so that a
shape with few kv heads (Fig. 10b: 8) still fills the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import (FLASH_HD_MAX, Counted,
                                        check_common, launch, pick_tiles)
from repro_torch.kernels.plain import (sparse_tree_attention_partial_plain,
                                       sparse_tree_attention_plain)

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _bind():
    """Build (first use) and load the library, and declare every C
    signature: pointers and the stream as ``c_void_p``."""
    lib = build.load("tree_partial")
    f = lib.sparse_tree_attention_partial
    f.argtypes = [_I] + [_P] * 7 + [_I] * 7 + [ctypes.c_float, _P]
    f.restype = _I
    f = lib.sparse_tree_attention
    f.argtypes = [_I] + [_P] * 5 + [_I] * 8 + [ctypes.c_float, _P]
    f.restype = _I
    lib.tree_partial_smem_bytes.argtypes = [_I] * 4
    lib.tree_partial_smem_bytes.restype = ctypes.c_size_t
    lib.tree_partial_error_string.argtypes = [_I]
    lib.tree_partial_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_new, v_new, tree_mask):
    if q.dim() != 4 or k_new.dim() != 4:
        raise ValueError(f"q and k_new must be 4-D, got {tuple(q.shape)} and "
                         f"{tuple(k_new.shape)}")
    B, W, Hq, hd = q.shape
    Hkv = k_new.shape[2]
    for name, t, shape in (("k_new", k_new, (B, W, Hkv, hd)),
                           ("v_new", v_new, (B, W, Hkv, hd)),
                           ("tree_mask", tree_mask, (W, W))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if tree_mask.dtype != torch.bool:
        raise TypeError(f"tree_mask must be bool, got {tree_mask.dtype}")
    if hd % 8:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 (16-byte "
                         f"vector loads)")
    check_common(q, (q, k_new, v_new, tree_mask), (q, k_new, v_new))
    return B, W, Hq, Hkv, hd


# B5's routes (the codes of csrc/tree_partial.cu::norm_route)
ROUTE_TILES, ROUTE_FLASH, ROUTE_F32 = 0, 1, 2
F32_KEYS = 64               # the fp32 route's one key tile
# query rows a block, largest first, per route
NORM_ROWS = {ROUTE_FLASH: (64, 32, 16), ROUTE_F32: (32, 16)}
# blocks a grid should reach: about one per SM of an H100 SXM (132)
NORM_MIN_BLOCKS = 128


def norm_route(dtype, W, hd) -> int:
    """B5's route: the tensor cores for bf16 at head_dim <= 128, the
    one-pass fp32 kernel for fp32 with all W keys in one tile and head_dim
    <= 128, else B4's kernel with the normalized epilogue."""
    if dtype == torch.bfloat16 and hd <= FLASH_HD_MAX:
        return ROUTE_FLASH
    if dtype == torch.float32 and W <= F32_KEYS and hd <= FLASH_HD_MAX:
        return ROUTE_F32
    return ROUTE_TILES


def norm_rows(route, B, Hkv, GW) -> int:
    """Query rows a block of B5's route: the largest of ``NORM_ROWS`` whose
    grid of ``B * Hkv * ceil(GW / rows)`` blocks still reaches
    ``NORM_MIN_BLOCKS``, else the smallest (Fig. 10b, B*Hkv = 8 and
    G*W = 256: 16 rows, 128 blocks).  A smaller tile costs more blocks
    each reading the kv head's W keys again (from L2); a larger one leaves
    SMs idle."""
    choices = NORM_ROWS[route]
    for rows in choices:
        if B * Hkv * -(-GW // rows) >= NORM_MIN_BLOCKS:
            return rows
    return choices[-1]


def _launch(wrapper, q, k_new, v_new, tree_mask, outs, route=None):
    """Check the operands and launch ``wrapper``'s entry point writing
    ``outs``; B5 passes its route, the key tile and its rows."""
    B, W, Hq, Hkv, hd = _check(q, k_new, v_new, tree_mask)
    lib = _bind()
    GW = Hq // Hkv * W
    if route in NORM_ROWS:
        tile, rows = 0, norm_rows(route, B, Hkv, GW)
    else:
        tile, rows = pick_tiles(lib.tree_partial_smem_bytes, GW, W, hd)
    plan = (tile, rows) if route is None else (route, tile, rows)
    launch(wrapper, getattr(lib, wrapper.__name__),
           lib.tree_partial_error_string, q.device, _Q_CODES[q.dtype],
           *(t.data_ptr() for t in (q, k_new, v_new, tree_mask) + outs),
           B, W, Hq, Hkv, hd, *plan, hd ** -0.5)


def _on_cuda(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")


@Counted
def sparse_tree_attention_partial(q, k_new, v_new, tree_mask):
    """See ``sparse_tree_attention_partial_plain``: returns the unnormalized
    ``(o, m, l)`` partials of the W x W tree attention."""
    if q.device.type == "cpu":
        return sparse_tree_attention_partial_plain(q, k_new, v_new,
                                                   tree_mask)
    _on_cuda("sparse_tree_attention_partial", q)
    B, W, Hq = q.shape[:3]
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hq, W), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hq, W), dtype=torch.float32, device=q.device)
    _launch(sparse_tree_attention_partial, q, k_new, v_new, tree_mask,
            (o, m, l))
    return o, m, l


@Counted
def sparse_tree_attention(q, k_new, v_new, tree_mask):
    """See ``sparse_tree_attention_plain``: the normalized W x W tree
    attention, (B, W, Hq, hd) in q's dtype."""
    if q.device.type == "cpu":
        return sparse_tree_attention_plain(q, k_new, v_new, tree_mask)
    _on_cuda("sparse_tree_attention", q)
    out = torch.empty_like(q)
    _launch(sparse_tree_attention, q, k_new, v_new, tree_mask, (out,),
            route=norm_route(q.dtype, q.shape[1], q.shape[3]))
    return out
