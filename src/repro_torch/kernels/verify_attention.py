"""Fused tree-verification attention: the wrapper of the hand-written CUDA
kernel ``csrc/verify_attention.cu`` (counterpart of the Pallas
``repro/kernels/tree_attention.py::tree_attention``).

``verify_attention`` takes ``tree_attention_plain``'s exact arguments.  A
CPU tensor runs the plain version; a CUDA tensor launches the kernel (the
split walk into an fp32 partials workspace, then the Eq.-1 merge: two
kernels from one C call, counted as one launch) or raises.  There is no
fallback between the two.  ``verify_attention.launches`` counts kernel
launches (and nothing else), so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import (Counted, check_common, flash_route,
                                        launch, sm_count, split_plan,
                                        workspace)
from repro_torch.kernels.plain import tree_attention_plain

_DTYPES = {torch.float32: "verify_attention_f32",
           torch.bfloat16: "verify_attention_bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _bind():
    """Build (first use) and load the library, and declare every C
    signature: pointers and the stream as ``c_void_p``, or ctypes would cut
    them to 32-bit ints."""
    lib = build.load("verify_attention")
    for fn in _DTYPES.values():
        f = getattr(lib, fn)
        f.argtypes = [_P] * 13 + [_I] * 11 + [ctypes.c_float, _P]
        f.restype = _I
    lib.verify_attention_smem_bytes.argtypes = [_I] * 4
    lib.verify_attention_smem_bytes.restype = ctypes.c_size_t
    lib.verify_attention_flash_smem_bytes.argtypes = [_I]
    lib.verify_attention_flash_smem_bytes.restype = ctypes.c_size_t
    lib.verify_attention_flash_blocks_per_sm.argtypes = [_I]
    lib.verify_attention_flash_blocks_per_sm.restype = _I
    lib.verify_attention_error_string.argtypes = [_I]
    lib.verify_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, ck, cv, k_new, v_new, key_pos, q_pos, lo, tree_mask):
    B, W, Hq, hd = q.shape
    if ck.dim() != 4 or ck.shape[0] != B or ck.shape[3] != hd:
        raise ValueError(f"ck {tuple(ck.shape)} does not match q "
                         f"{tuple(q.shape)}")
    S, Hkv = ck.shape[1], ck.shape[2]
    want = {"cv": (cv, (B, S, Hkv, hd)), "k_new": (k_new, (B, W, Hkv, hd)),
            "v_new": (v_new, (B, W, Hkv, hd)), "key_pos": (key_pos, (B, S)),
            "q_pos": (q_pos, (B, W)), "lo": (lo, (B, W)),
            "tree_mask": (tree_mask, (W, W))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"verify_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("ck", ck), ("cv", cv), ("k_new", k_new),
                    ("v_new", v_new)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("key_pos", key_pos), ("q_pos", q_pos), ("lo", lo)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tree_mask.dtype != torch.bool:
        raise TypeError(f"tree_mask must be bool, got {tree_mask.dtype}")
    if hd % 8:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 "
                         f"(16-byte vector loads)")
    tensors = (q, ck, cv, k_new, v_new, key_pos, q_pos, lo, tree_mask)
    check_common(q, tensors, tensors[:5])
    return B, W, Hq, Hkv, hd, S


@Counted
def verify_attention(q, ck, cv, k_new, v_new, key_pos, q_pos, lo,
                     tree_mask):
    """See ``tree_attention_plain`` for the semantics and layout."""
    if q.device.type == "cpu":
        return tree_attention_plain(q, ck, cv, k_new, v_new, key_pos, q_pos,
                                    lo, tree_mask)
    if q.device.type != "cuda":
        raise ValueError(f"verify_attention runs on cuda or cpu, got "
                         f"{q.device}")
    B, W, Hq, Hkv, hd, S = _check(q, ck, cv, k_new, v_new, key_pos, q_pos,
                                  lo, tree_mask)
    lib = _bind()
    tile, rows, n_split, split_len, parts = split_plan(
        lib.verify_attention_smem_bytes,
        lib.verify_attention_flash_smem_bytes,
        lib.verify_attention_flash_blocks_per_sm, sm_count(q.device),
        flash_route(q.dtype, ck.dtype, hd), B, W, Hq, Hkv, hd, S)
    out = torch.empty_like(q)
    ws, ws_o, ws_m, ws_l = workspace(q, parts)
    launch(verify_attention, getattr(lib, _DTYPES[q.dtype]),
           lib.verify_attention_error_string, q.device,
           *(t.data_ptr() for t in (q, ck, cv, k_new, v_new, key_pos, q_pos,
                                    lo, tree_mask, out)), ws_o, ws_m, ws_l,
           B, W, Hq, Hkv, hd, S, tile, rows, n_split, split_len, parts,
           hd ** -0.5)
    return out
