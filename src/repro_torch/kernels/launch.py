"""What every kernel wrapper does around its launch: count its launches,
pick the key tile and the query-row tile that fit a block's shared memory,
check the operands' device, layout and alignment, and launch on PyTorch's
current stream, raising on a CUDA error (a refused launch never runs, so
``torch.cuda.synchronize`` would not report it).
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, Tuple

import torch

SMEM_LIMIT = 232_448          # dynamic shared memory a block may use (H100)
TILES = (64, 32, 16)          # keys per tile, largest first


class Counted:
    """A kernel wrapper with a count of its kernel's launches.

    ``launches`` reads and sets the count (a run sets it to 0, then reads
    how often its path launched the kernel); ``launch`` below adds one
    after each launch that succeeded, and nothing else does.  The count
    takes a lock: the serving plane launches kernels from one worker
    thread per replica, and ``+=`` on a plain attribute can lose counts
    between threads."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self._lock = threading.Lock()
        self._launches = 0

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        with self._lock:
            return self._launches

    @launches.setter
    def launches(self, n: int) -> None:
        with self._lock:
            self._launches = int(n)

    def count_launch(self) -> None:
        with self._lock:
            self._launches += 1


def _max_rows(smem_bytes, W, hd, tile, GW):
    """Most query rows (at most GW) whose block fits at ``tile`` keys; 0 if
    not even one does.  ``smem_bytes`` grows with the row count."""
    lo, hi = 0, GW
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if smem_bytes(mid, W, hd, tile) <= SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    return lo


# (id of the library's smem_bytes, GW, W, hd) -> (smem_bytes, tile, rows):
# the choice depends on shapes alone, and a call should not redo the
# search; the entry keeps smem_bytes alive, so its id is never reused
_PICKED: Dict[tuple, Tuple[object, int, int]] = {}


def pick_tiles(smem_bytes, GW, W, hd):
    """``(key tile, rows per block)`` for G*W = ``GW`` query rows:
    ``smem_bytes(rows, W, hd, tile)`` is the kernel library's own count.

    The largest key tile at which all GW rows fit one block (the main
    path's verify and decode: one row tile, as before row tiles existed);
    else the largest key tile and the most rows a block of it holds, spread
    evenly over the row tiles (a W=256 prefill piece: 4 tiles of 64)."""
    key = (id(smem_bytes), GW, W, hd)
    if key not in _PICKED:
        _PICKED[key] = (smem_bytes,) + _pick(smem_bytes, GW, W, hd)
    return _PICKED[key][1:]


def _pick(smem_bytes, GW, W, hd):
    for tile in TILES:
        if smem_bytes(GW, W, hd, tile) <= SMEM_LIMIT:
            return tile, GW
    for tile in TILES:
        rows = _max_rows(smem_bytes, W, hd, tile, GW)
        if rows:
            n = -(-GW // rows)
            return tile, -(-GW // n)
    raise ValueError(f"a W={W} tree at head_dim {hd} does not fit one "
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


def launch(wrapper: Counted, fn, error_string, device, *args):
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream; raise with the CUDA error's text if it returns one, else count
    one launch of ``wrapper``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{err} ({error_string(err).decode()})")
    wrapper.count_launch()
