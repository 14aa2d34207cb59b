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

B4 has two routes (``plan.partial_route``; ``csrc/tree_partial.cu`` states
the same rule): ``tree_warp_kernel`` (one warp per 8 query rows, all W keys in
one pass) for W <= 64 and head_dim <= 128, in fp32 and bf16, and
``tree_partial_kernel`` otherwise (a W=256 prefill piece, head_dim > 128).
Its call is built for the host's time: a plan per call signature
(``launch.Plans``: the shape, dtype and device checks and the route run
once per signature, the C plan is packed once), the contiguity and
alignment checks on every call (``launch.pointers``), one allocation for
the three partials, and a C call of 7 pointers.

B5 has three routes (``plan.norm_route``; ``csrc/tree_partial.cu`` states
the same rule): bf16 at head_dim <= 128 on the tensor cores, fp32 with W <= 64
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
from repro_torch.kernels.launch import (Counted, Plans, check_common,
                                        launch, pointers)
# the routes and row tiles (``plan.py``), re-exported with the wrappers
from repro_torch.kernels.plan import (  # noqa: F401
    F32_KEYS, NORM_MIN_BLOCKS, NORM_ROWS, PARTIAL_TILES, PARTIAL_WARP,
    ROUTE_F32, ROUTE_FLASH, ROUTE_TILES, WARP_KEYS, WARP_ROWS, norm_route,
    norm_rows, partial_route, pick_tiles)
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
    f = lib.tree_partial_launch
    f.argtypes = [_P] * 7
    f.restype = _I
    f = lib.tree_partial_floor
    f.argtypes = [_P] * 2
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


class _TreePlan(ctypes.Structure):
    """``csrc/tree_partial.cu::TreePlan``, field by field."""
    _fields_ = [("route", _I), ("q_dtype", _I), ("B", _I), ("W", _I),
                ("Hq", _I), ("Hkv", _I), ("hd", _I), ("tile", _I),
                ("rows", _I), ("scale", ctypes.c_float)]


class PartialPlan:
    """One call signature's B4 launch: the packed C plan (kept alive here,
    passed by its address ``ref``), the device, and the partials' layout
    in one fp32 allocation: o (B, W, Hq, hd), then m and l (B, Hq, W), the
    ``cm.merge_partials`` layout, which the C entry point derives from the
    buffer's address and the plan."""

    def __init__(self, c_plan, device):
        B, W, Hq, hd = c_plan.B, c_plan.W, c_plan.Hq, c_plan.hd
        self.c_plan = c_plan
        self.ref = ctypes.addressof(c_plan)
        self.device = device
        self.n_o, self.n_m = B * W * Hq * hd, B * Hq * W
        self.n = self.n_o + 2 * self.n_m
        self.o_layout = (B, W, Hq, hd), (W * Hq * hd, Hq * hd, hd, 1)
        self.ml_layout = (B, Hq, W), (Hq * W, W, 1)
        # an empty fp32 tensor on the device: ``new_empty`` takes the dtype
        # and device from it, with no keyword to parse on each call
        self._like = torch.empty(0, dtype=torch.float32, device=device)

    @property
    def route(self) -> int:
        return self.c_plan.route

    def outputs(self):
        """``((o, m, l), the buffer's address)``: three views of one
        allocation (from the current stream's pool)."""
        buf = self._like.new_empty(self.n)
        return ((buf.as_strided(*self.o_layout, 0),
                 buf.as_strided(*self.ml_layout, self.n_o),
                 buf.as_strided(*self.ml_layout, self.n_o + self.n_m)),
                buf.data_ptr())


def _partial_plan(q, k_new, v_new, tree_mask):
    """A signature's plan: every check of ``_check``, the route, and
    route 0's key tile and rows from the library's shared-memory count."""
    B, W, Hq, Hkv, hd = _check(q, k_new, v_new, tree_mask)
    route = partial_route(W, hd)
    tile = rows = 0
    if route == PARTIAL_TILES:
        tile, rows = pick_tiles(_bind().tree_partial_smem_bytes,
                                Hq // Hkv * W, W, hd)
    return PartialPlan(_TreePlan(route, _Q_CODES[q.dtype], B, W, Hq, Hkv,
                                 hd, tile, rows, hd ** -0.5), q.device)


PARTIAL_PLANS = Plans(_partial_plan)


def _on_cuda(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")


@Counted
def sparse_tree_attention_partial(q, k_new, v_new, tree_mask):
    """See ``sparse_tree_attention_partial_plain``: returns the unnormalized
    ``(o, m, l)`` partials of the W x W tree attention."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            return sparse_tree_attention_partial_plain(q, k_new, v_new,
                                                       tree_mask)
        _on_cuda("sparse_tree_attention_partial", q)
    plan = PARTIAL_PLANS.get(q, k_new, v_new, tree_mask)
    ptrs = pointers((q, k_new, v_new, tree_mask), 3)
    outs, out = plan.outputs()
    lib = _bind()
    launch(sparse_tree_attention_partial, lib.tree_partial_launch,
           lib.tree_partial_error_string, plan.device, plan.ref, *ptrs, out)
    return outs


@Counted
def sparse_tree_attention(q, k_new, v_new, tree_mask):
    """See ``sparse_tree_attention_plain``: the normalized W x W tree
    attention, (B, W, Hq, hd) in q's dtype."""
    if q.device.type == "cpu":
        return sparse_tree_attention_plain(q, k_new, v_new, tree_mask)
    _on_cuda("sparse_tree_attention", q)
    B, W, Hq, Hkv, hd = _check(q, k_new, v_new, tree_mask)
    lib = _bind()
    route = norm_route(q.dtype, W, hd)
    GW = Hq // Hkv * W
    if route in NORM_ROWS:
        tile, rows = 0, norm_rows(route, B, Hkv, GW)
    else:
        tile, rows = pick_tiles(lib.tree_partial_smem_bytes, GW, W, hd)
    out = torch.empty_like(q)
    launch(sparse_tree_attention, lib.sparse_tree_attention,
           lib.tree_partial_error_string, q.device, _Q_CODES[q.dtype],
           *(t.data_ptr() for t in (q, k_new, v_new, tree_mask, out)),
           B, W, Hq, Hkv, hd, route, tile, rows, hd ** -0.5)
    return out
