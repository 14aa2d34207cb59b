"""What every kernel wrapper does around its launch: count its launches,
plan it (``plan.py``: the key and query-row tiles, the split over the
cache of the split walks B1, B2 and B3), lay out the split walks'
partials' workspace, check the operands'
device, layout and alignment, keep a launch plan per call signature
(``Plans``, with the per-call checks in ``pointers``), and launch on
PyTorch's current stream, raising on a CUDA error (a refused launch never
runs, so ``torch.cuda.synchronize`` would not report it).

Under CUDA-graph capture (``runtime/graphs.py``) a launch lands on the
capturing stream and executes nothing; ``CaptureTally`` keeps its count
for the graph, which adds it at every replay (``Counted.add_launches``).
"""
from __future__ import annotations

import functools
import itertools
import threading
from typing import Dict

import torch

# the plans (``plan.py``, standard library only), re-exported: the
# wrappers and their tests plan through this module
from repro_torch.kernels.plan import (  # noqa: F401
    FLASH_HD_MAX, FLASH_ROWS, FLASH_TILE, SMEM_LIMIT, TILES, flash_route,
    pick_split, pick_tiles, split_plan)


class Counted:
    """A kernel wrapper with a count of its kernel's launches.

    ``launches`` reads and sets the count (a run sets it to 0, then reads
    how often its path launched the kernel); ``launch`` below adds one
    after each launch that succeeded (or, under a capture, gives it to the
    graph's ``CaptureTally``), and a replay of a captured graph adds the
    launches it holds (``add_launches``); nothing else counts.  The serving
    plane launches kernels from one worker thread per replica, and ``+=``
    on a plain attribute can lose counts between threads; so a launch
    (``count_launch``) draws the next number of one ``itertools.count`` (a
    single call into C, which no other thread interrupts) instead of
    taking a lock.  Reads and sets draw too, under a lock among
    themselves: a set records the number it drew, a read takes away that
    number and the reads since; an add lowers the recorded draw under the
    same lock, so a read sees all of it or none."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self._lock = threading.Lock()
        self._ticks = itertools.count()
        self._base = 0        # the draw a set made, + 1, - the count it set
        self._reads = 0       # reads since that set
        # adds one launch: the count's own ``__next__``, a call into C with
        # no Python frame
        self.count_launch = self._ticks.__next__

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        with self._lock:
            n = next(self._ticks) - self._base - self._reads
            self._reads += 1
            return n

    @launches.setter
    def launches(self, n: int) -> None:
        with self._lock:
            self._base = next(self._ticks) + 1 - int(n)
            self._reads = 0

    def add_launches(self, n: int) -> None:
        """Add ``n`` launches at once: a graph replay's captured ones."""
        with self._lock:
            self._base -= int(n)


# the calling thread's open capture tally, if any (``CaptureTally``)
_capturing = threading.local()


class CaptureTally:
    """The kernel launches made on this thread while a CUDA graph is
    captured.  Capture executes nothing, so they go here and not into the
    wrappers' counts; ``replayed()`` adds them to each wrapper every time
    the graph replays.  ``with CaptureTally() as tally:`` around the
    capture; another thread's launches meanwhile count as usual."""

    def __init__(self):
        self.counts: Dict[Counted, int] = {}

    def __enter__(self) -> "CaptureTally":
        if getattr(_capturing, "tally", None) is not None:
            raise RuntimeError("a capture tally is already open on this "
                               "thread")
        _capturing.tally = self.counts
        return self

    def __exit__(self, *exc) -> None:
        _capturing.tally = None

    def replayed(self) -> None:
        """One replay of the graph: add its launches to every wrapper."""
        for wrapper, n in self.counts.items():
            wrapper.add_launches(n)


def count(wrapper: Counted) -> None:
    """One launch of ``wrapper`` that succeeded: into its count, or into
    the calling thread's open capture tally."""
    tally = getattr(_capturing, "tally", None)
    if tally is None:
        wrapper.count_launch()
    else:
        tally[wrapper] = tally.get(wrapper, 0) + 1


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def workspace(q, parts):
    """The split walk's fp32 partials for ``parts`` parts (the splits and
    any tree part), in one allocation on q's device (from the current
    stream's pool): ``(buffer, o, m, l)`` with the pointers of o
    ``(parts, B, W, Hq, hd)`` and m, l ``(parts, B, Hq, W)``, the
    ``cm.merge_partials`` layout part by part.  Every element is written
    by the walk before the merge reads it; the caller keeps ``buffer``
    until the launch is enqueued."""
    B, W, Hq, hd = q.shape
    n_o, n_m = parts * B * W * Hq * hd, parts * B * Hq * W
    buf = torch.empty(n_o + 2 * n_m, dtype=torch.float32, device=q.device)
    o = buf.data_ptr()
    return buf, o, o + 4 * n_o, o + 4 * (n_o + n_m)


def partial_outputs(q, parts):
    """The cache-only walk's (B3) unnormalized partial: ``o (B, W, Hq,
    hd)``, ``m, l (B, Hq, W)`` fp32 in the merge layout, and, for a walk
    of ``parts > 1`` splits, the pointers of their workspace (else None),
    all in ONE allocation: ``workspace``'s layout with the output as part 0
    and the splits as parts 1 .. parts (one allocation and three views cost
    the host less than four allocations).  The outputs keep the workspace
    alive; the caller merges and drops them within the step."""
    B, W, Hq, hd = q.shape
    n = 1 if parts == 1 else parts + 1
    buf, o_ptr, m_ptr, l_ptr = workspace(q, n)
    n_o, n_m = B * W * Hq * hd, B * Hq * W
    o = buf.as_strided((B, W, Hq, hd), (W * Hq * hd, Hq * hd, hd, 1), 0)
    m = buf.as_strided((B, Hq, W), (Hq * W, W, 1), n * n_o)
    l = buf.as_strided((B, Hq, W), (Hq * W, W, 1), n * (n_o + n_m))
    if parts == 1:
        return o, m, l, (None, None, None)
    return o, m, l, (o_ptr + 4 * n_o, m_ptr + 4 * n_m, l_ptr + 4 * n_m)


def check_common(q, tensors, vectors):
    """Every operand on q's device and contiguous; the vector-loaded ones
    16-byte aligned."""
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, found "
                             f"{t.device}")
    pointers(tensors, 0)
    pointers(vectors, len(vectors))


def signature(tensors):
    """What a launch plan depends on: every operand's shape, dtype and
    device index (-1 on the CPU)."""
    return tuple([(t.shape, t.dtype, t.get_device()) for t in tensors])


class Plans:
    """One wrapper's launch plans, one per call signature (``signature``:
    every operand's shape, dtype and device).  ``get(*operands)`` makes a
    signature's plan on its first call with ``make(*operands)``, which
    checks everything the signature fixes and raises on a bad one (nothing
    is kept then), and looks it up on later calls, so a call does not
    rebuild and compare shape tuples.  The key is the whole signature, so
    a plan is never handed to another one.  What the signature does not
    fix, whether each operand is contiguous and aligned (a view of the same
    shape and dtype may be neither), is for ``pointers`` on every call.
    Two threads may make one signature's plan at once; the first stored is
    kept."""

    def __init__(self, make):
        self._make = make
        self._plans = {}

    def get(self, *operands):
        key = signature(operands)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans.setdefault(key, self._make(*operands))
        return plan

    def __len__(self) -> int:
        return len(self._plans)


def pointers(tensors, vectors):
    """Each operand's ``data_ptr``; raises unless every operand is
    contiguous and the first ``vectors`` (the vector-loaded ones) are
    16-byte aligned."""
    out = []
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the kernel needs contiguous operands")
        out.append(t.data_ptr())
    for p in out[:vectors]:
        if p % 16:
            raise ValueError("vector-loaded operands must be 16-byte "
                             "aligned")
    return out


def launch(wrapper: Counted, fn, error_string, device, *args):
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream (the capturing one while a graph is captured); raise with the
    CUDA error's text if it returns one, else count one launch of
    ``wrapper`` (``count``).  The stream is read as its raw handle (no
    ``torch.cuda.Stream`` object is built per call), and the device is
    switched only when it is not the calling thread's current one (read
    from the binding, not through ``torch.cuda.current_device``): both are
    host time on every kernel call of a host-bound serve."""
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if torch._C._cuda_getDevice() == index:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{err} ({error_string(err).decode()})")
    count(wrapper)
