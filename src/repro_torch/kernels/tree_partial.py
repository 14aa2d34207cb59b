"""Tree half of the split verify: the wrapper of the hand-written CUDA
kernel ``csrc/tree_partial.cu`` (counterpart of the Pallas
``repro/kernels/sparse_tree.py::sparse_tree_attention_partial``).

``sparse_tree_attention_partial`` takes the plain version's exact
arguments.  A CPU tensor runs ``sparse_tree_attention_partial_plain``; a
CUDA tensor launches the kernel or raises.  ``.launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import check_common, launch, pick_tile
from repro_torch.kernels.plain import sparse_tree_attention_partial_plain

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _bind():
    """Build (first use) and load the library, and declare every C
    signature: pointers and the stream as ``c_void_p``."""
    lib = build.load("tree_partial")
    f = lib.sparse_tree_attention_partial
    f.argtypes = [_I] + [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P]
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


def sparse_tree_attention_partial(q, k_new, v_new, tree_mask):
    """See ``sparse_tree_attention_partial_plain``: returns the unnormalized
    ``(o, m, l)`` partials of the W x W tree attention."""
    if q.device.type == "cpu":
        return sparse_tree_attention_partial_plain(q, k_new, v_new,
                                                   tree_mask)
    if q.device.type != "cuda":
        raise ValueError(f"sparse_tree_attention_partial runs on cuda or "
                         f"cpu, got {q.device}")
    B, W, Hq, Hkv, hd = _check(q, k_new, v_new, tree_mask)
    lib = _bind()
    tile = pick_tile(lib.tree_partial_smem_bytes, Hq // Hkv * W, W, hd)
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hq, W), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hq, W), dtype=torch.float32, device=q.device)
    launch("sparse_tree_attention_partial",
           lib.sparse_tree_attention_partial, lib.tree_partial_error_string,
           q.device, _Q_CODES[q.dtype],
           *(t.data_ptr() for t in (q, k_new, v_new, tree_mask, o, m, l)),
           B, W, Hq, Hkv, hd, tile, hd ** -0.5)
    sparse_tree_attention_partial.launches += 1
    return o, m, l


sparse_tree_attention_partial.launches = 0
