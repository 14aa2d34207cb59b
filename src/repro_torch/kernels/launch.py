"""What every kernel wrapper does around its launch: pick the key tile
that fits a block's shared memory, check the operands' device, layout and
alignment, and launch on PyTorch's current stream, raising on a CUDA error
(a refused launch never runs, so ``torch.cuda.synchronize`` would not
report it).
"""
from __future__ import annotations

import torch

SMEM_LIMIT = 232_448          # dynamic shared memory a block may use (H100)
TILES = (64, 32, 16)          # keys per tile, largest that fits first


def pick_tile(smem_bytes, GW, W, hd):
    """Largest key tile whose block fits the card's shared memory;
    ``smem_bytes(GW, W, hd, tile)`` is the kernel library's own count."""
    for tile in TILES:
        if smem_bytes(GW, W, hd, tile) <= SMEM_LIMIT:
            return tile
    raise ValueError(f"G*W={GW} query rows at head_dim {hd} do not fit one "
                     f"block's shared memory")


def check_common(q, tensors, vectors):
    """Every operand on q's device and contiguous; the vector-loaded ones
    16-byte aligned."""
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, found "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel needs contiguous operands")
    for t in vectors:
        if t.data_ptr() % 16:
            raise ValueError("vector-loaded operands must be 16-byte "
                             "aligned")


def launch(name, fn, error_string, device, *args):
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream; raise with the CUDA error's text if it returns one."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({error_string(err).decode()})")
