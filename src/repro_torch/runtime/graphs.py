"""The compiled chunk on the card: one decode step captured in a CUDA graph
on static buffers and replayed K times a chunk (counterpart of the
reference's ``jax.jit(jax.lax.scan(body))`` with the carry donated,
``repro/runtime/engine.py::_chunk_fn``).

One step, not the whole chunk, is captured: the host loop's power-of-two
schedule (``engine._pow2_chunk``) runs chunks of 1, 2, 4, ... K steps, and
one step's graph serves every length.  The chunk keeps its one host sync:
a replay reads nothing back.

The carry lives in the graph's static inputs.  K/V (the dense rows or the
page pool) are written in place by the step, and the enc-dec cross memory
(``cross_k``/``cross_v``) is only read, so the graph adopts the caller's
tensors as its own (the big tensors); every other carried tensor
(``key_pos``, ``pos``, the block table, the int8 scales, the hybrid
family's recurrent state ``ssm``/``conv``/``pos``, the xLSTM layers'
states and ``pos``, ``cur_token``, ``hidden``, ``done``, ``rem``) the step
rebuilds, so the captured step ends by copying each new value back into
its static input and the replays chain; a big tensor the step rebuilt
raises.  The recurrent verifies' per-depth states (``(D, B*P, ...)`` a
layer) are transients of the step: they live in the graph's pool, not in
the carry.  Between chunks the host may replace any of the small tensors
(row surgery, admissions, new block tables, ``done``/``rem`` from the
scheduler): before the replays each one that is not the static tensor
itself is copied in.  Big tensors that are not the adopted ones (a new
prefill, a new bank, a new cross memory) take a new capture of the same
key; the previous graph of the key is dropped, so a caller still holding
its state keeps it intact.  A cache with no KV and no cross memory
(xLSTM) has no big tensor: every new state is copied in.  The chunk's
state comes back as the static tensors themselves: as in the reference,
the carry passed in is consumed.

The key is the reference's compile key plus the shapes a jit keys on
implicitly: draft kind, tree kernel, the tree's shape (W, max_depth,
paths) and the cache's layout and the name, shape and dtype of each of
its tensors (B included).  Two trees of one shape share a graph: the tree's tensors are copied into the
graph's static tree before the replays (``measure_acceptance`` and
``set_tree`` rely on it).  EOS is a static scalar, as the reference traces
it.

The first chunk of a key runs eagerly, on the capture stream, and its
result is used: it is the warm-up (launch plans, occupancy queries, the
shared-memory attributes, cuBLAS handles and workspaces).  The capture
follows at the key's next chunk and every later chunk replays.  One
engine's graphs share one memory pool.  Captures are serialised in the
process and run with ``capture_error_mode="thread_local"``, so a replica
thread's eager work cannot void another's capture.  A kernel launch made
while capturing counts into the graph's ``CaptureTally``, which every
replay adds to the wrappers' counts.  A failed capture or replay raises;
nothing falls back to the eager loop.

The HCMP overlap step (``core/hcmp/executors.py``) is captured the same
way under its own key (the key's partition is "overlap"): its draft tree
tokens are one more static buffer of the carry, read by the step's verify
and written by its draft.  The capture forks the draft stream off the
capture stream after the verify and joins it after the commit, so the
graph holds two concurrent branches (a capture whose forked stream is not
joined fails as unjoined).  The runner hands the chunk its first draft:
the pre-draft left in the static buffer by the previous chunk, or one
drafted anew when the bank moved (a stale pre-draft is never reused).

``release(state)`` drops the graphs that adopted ``state``'s K/V:
``time_step`` releases its measurement's graphs once timed.

``ChunkGraphs(..., capture=False)`` runs the same static-buffer step
without capture, one call a replay: the CPU tests drive the bookkeeping
through it, the overlap step's included.

Every capture of the inline drafted step holds five timing events at its
phase boundaries (``trace.PhaseMarks``, handed to the step as ``marks``),
whether the tracer is on or not; ``ChunkGraphs.marks`` is the latest
chunk's graph's, for the tracer to read after the chunk's host transfer.
For a model with experts (``ChunkGraphs(..., experts=(L, E))``) that
step also holds a ``trace.ExpertTap``: two timing events a layer around
its expert block and the buffer its dispatch counts each expert's rows
into (``ChunkGraphs.tap``, read alike); a model without experts holds
none, so its step gains no node.

Prompt prefill (``PieceGraphs``): the continuous scheduler's admission
prefill and its chunked-prefill pieces, captured at fixed widths (the
admission at C/4, C/2 and C, the piece at C, for the scheduler's piece
width C) on a static B=1 row, so a prompt is landed by one replay instead
of a few thousand launches.  A piece graph adopts the bank's page pool,
which it writes in place, as a step graph does.  The row's small tensors,
its carry and the piece's int32 input (its tokens, its real length and,
for an admission, the row's fresh pages) are static buffers: around each
replay the bank's row is copied into them, the input crosses in one
host-to-device copy, and the row's new values are copied back out into
new bank tensors (and the first token into a tensor of its own), so no
value the caller keeps lives in a buffer that the next replay overwrites.
One graph serves every row.  All of an engine's pieces are built at its
first call that engages, each after one eager warm-up with a real length
of 0 (every write lands in the trash page, nothing of the row moves),
whose launches stay out of the wrappers' counts; they share the step
graphs' memory pool and count in ``stats``: ``captures``,
``piece_replays``, and ``piece_eager``, which the engine counts for the
prefill calls that stayed eager.  A new pool (a new bank) or a new piece
width builds them again.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core.speculative.tree import Tree
from repro_torch.core.speculative.verify import SpecState
from repro_torch.kernels.launch import CaptureTally
from repro_torch.runtime import trace
from repro_torch.runtime.cache import (Cache, KVCache, MambaState,
                                      PagedKVCache, XLSTMState, _set_row,
                                      slice_row)

_TREE = ("depth", "mask", "paths", "node_path", "node_depth", "parent",
         "rank")
# the cache fields the step rebuilds or the host replaces between chunks
# (copied into static inputs), and those written in place (adopted)
_SMALL = {KVCache: ("key_pos", "pos"),
          PagedKVCache: ("block_table", "key_pos", "pos", "scale_k",
                         "scale_v"), type(None): ()}
_BIG = {KVCache: ("k", "v"), PagedKVCache: ("pool_k", "pool_v"),
        type(None): ()}
_MAMBA = ("ssm", "conv", "pos")      # the recurrent carry, all copied
_CROSS = ("cross_k", "cross_v")      # read-only, adopted

_CAPTURE_LOCK = threading.Lock()     # one capture at a time in the process


def _clone(t):
    return None if t is None else t.clone()


def _copy_in(dst, src, what, cast=False):
    """Copy ``src`` into the static ``dst`` unless it is that tensor.  A
    shape (or, without ``cast``, a dtype) that does not fit raises."""
    if src is dst:
        return
    if dst is None or src is None:
        raise RuntimeError(f"{what}: the graph was captured with "
                           f"{'no' if dst is None else 'a'} tensor there")
    if src.shape != dst.shape or (not cast and src.dtype != dst.dtype):
        raise RuntimeError(f"{what}: {tuple(src.shape)} {src.dtype} does not "
                           f"fit the graph's {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def _signature(t):
    return None if t is None else (tuple(t.shape), t.dtype)


def _tensors(cache: Cache) -> Dict[str, Optional[torch.Tensor]]:
    """Every tensor field of ``cache`` by name ("kv.pos", "mamba.ssm",
    "xlstm.3.C", "cross_k", ...), in a fixed order."""
    out = {}
    kv = cache.kv
    for f in _SMALL[type(kv)] + _BIG[type(kv)]:
        out["kv." + f] = getattr(kv, f)
    if cache.mamba is not None:
        for f in _MAMBA:
            out["mamba." + f] = getattr(cache.mamba, f)
    if cache.xlstm is not None:
        for i, layer in enumerate(cache.xlstm.layers):
            for k, t in layer.items():
                out[f"xlstm.{i}.{k}"] = t
        out["xlstm.pos"] = cache.xlstm.pos
    for f in _CROSS:
        if getattr(cache, f) is not None:
            out[f] = getattr(cache, f)
    return out


def _big(cache: Cache) -> tuple:
    """The names of the tensors a graph adopts: K/V and the cross memory."""
    return tuple("kv." + f for f in _BIG[type(cache.kv)]) + tuple(
        f for f in _CROSS if getattr(cache, f) is not None)


def _with(cache: Cache, tensors: dict) -> Cache:
    """A new ``Cache`` of ``cache``'s structure holding ``tensors`` (names
    as ``_tensors``)."""
    kv = cache.kv
    if kv is not None:
        kv = dataclasses.replace(kv, **{
            f: tensors["kv." + f] for f in _SMALL[type(kv)] + _BIG[type(kv)]})
    mamba = None if cache.mamba is None else MambaState(
        **{f: tensors["mamba." + f] for f in _MAMBA})
    xl = None if cache.xlstm is None else XLSTMState(
        layers=tuple({k: tensors[f"xlstm.{i}.{k}"] for k in layer}
                     for i, layer in enumerate(cache.xlstm.layers)),
        pos=tensors["xlstm.pos"])
    return Cache(kv=kv, mamba=mamba, xlstm=xl,
                 **{f: tensors.get(f) for f in _CROSS})


@contextlib.contextmanager
def _gc_held():
    """The garbage collector held off: a collection that destroyed some
    other CUDA graph would void a capture."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


class StepGraph:
    """One decode step on static buffers, captured (or, without capture,
    called once a replay).  ``step_fn(strategy, state, done, rem, eos,
    tree_kernel)`` is the engine's step: it returns ``(state, done, rem,
    emitted (B, D), n (B,))``.  With ``tree_tokens`` it is the overlap
    step, ``step_fn(..., tree_kernel, tree_tokens, out)``, which also
    returns the next draft, written into ``out``.  ``marks`` (a
    ``trace.PhaseMarks``) goes to the inline step as its phase events,
    ``tap`` (a ``trace.ExpertTap``) as its expert tap."""

    def __init__(self, step_fn: Callable, strategy, state: SpecState, done,
                 rem, eos_val: int, tree_kernel: str, tree_tokens=None,
                 marks=None, tap=None):
        cache = state.cache
        self.step_fn, self.tree_kernel = step_fn, tree_kernel
        self.layout = type(cache.kv)
        src = strategy.tree
        self.tree = Tree(width=src.width, max_depth=src.max_depth,
                         **{f: getattr(src, f).clone() for f in _TREE})
        self.tree_src = src
        self.strategy = dataclasses.replace(strategy, tree=self.tree)
        # the static cache: the big tensors adopted, the small ones cloned
        self.big = _big(cache)
        self.tensors = {n: t if n in self.big else _clone(t)
                        for n, t in _tensors(cache).items()}
        self.cache = _with(cache, self.tensors)
        self.cur_token = state.cur_token.clone()
        self.hidden = _clone(state.hidden)
        dev = self.cur_token.device
        self.done = torch.empty(done.shape, dtype=torch.bool, device=dev)
        self.rem = torch.empty(rem.shape, dtype=torch.int64, device=dev)
        self.done.copy_(done)
        self.rem.copy_(rem)
        self.eos_val = int(eos_val)
        self.eos = torch.full((), self.eos_val, dtype=torch.int64, device=dev)
        self.tree_tokens = _clone(tree_tokens)
        self.marks, self.tap = marks, tap
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally = CaptureTally()
        self.emitted = self.n = None

    # ---- the captured function -----------------------------------------
    def step(self):
        """One step from the static inputs; every value it rebuilt is
        copied back into its static input, so the next replay continues
        from it.  Returns the step's ``(emitted, n)``."""
        state = SpecState(cache=_with(self.cache, self.tensors),
                          cur_token=self.cur_token, hidden=self.hidden)
        args = (self.strategy, state, self.done, self.rem, self.eos,
                self.tree_kernel)
        if self.tree_tokens is None:
            kw = {k: v for k, v in (("marks", self.marks), ("tap", self.tap))
                  if v is not None}
            state, done, rem, emitted, n = self.step_fn(*args, **kw)
        else:
            state, done, rem, emitted, n, _ = self.step_fn(
                *args, self.tree_tokens, out=self.tree_tokens)
        new = self._same_structure(state.cache)
        for name in self.big:
            if new[name] is not self.tensors[name]:
                raise RuntimeError(
                    f"the step rebuilt the cache's {name}: its K/V must be "
                    f"written in place and its cross memory only read")
        self._small_in(new)
        _copy_in(self.cur_token, state.cur_token, "cur_token")
        _copy_in(self.hidden, state.hidden, "hidden")
        _copy_in(self.done, done, "done")
        _copy_in(self.rem, rem, "rem")
        return emitted, n

    def _same_structure(self, cache: Cache) -> dict:
        """``cache``'s tensors by name; a cache whose fields differ from
        the captured one's raises."""
        new = _tensors(cache)
        if new.keys() != self.tensors.keys():
            missing = sorted(set(self.tensors) ^ set(new))
            raise RuntimeError(f"the graph was captured with another cache "
                               f"structure: {missing} differ")
        return new

    def _small_in(self, new: dict) -> None:
        """Copy the small tensors of ``new`` into the static ones."""
        for name, t in new.items():
            if name not in self.big:
                _copy_in(self.tensors[name], t, name)

    # ---- around it -------------------------------------------------------
    def holds(self, state: SpecState) -> bool:
        """Whether ``state``'s big tensors (K/V, the cross memory) are the
        tensors this graph adopted: always, for a cache that has none."""
        cache = state.cache
        if type(cache.kv) is not self.layout or _big(cache) != self.big:
            return False
        tensors = _tensors(cache)
        return all(tensors[n] is self.tensors[n] for n in self.big)

    def load(self, strategy, state: SpecState, done, rem, eos_val,
             tree_tokens=None) -> None:
        """Copy what the host changed since the last replay into the
        static inputs: the tree (a same-shape tree), the small cache
        tensors, the carry, ``done``/``rem``, EOS and the overlap step's
        first draft."""
        if strategy.tree is not self.tree_src:
            for f in _TREE:
                _copy_in(getattr(self.tree, f), getattr(strategy.tree, f),
                         f"tree.{f}")
            self.tree_src = strategy.tree
        self._small_in(self._same_structure(state.cache))
        _copy_in(self.cur_token, state.cur_token, "cur_token")
        _copy_in(self.hidden, state.hidden, "hidden")
        _copy_in(self.done, done, "done", cast=True)
        _copy_in(self.rem, rem, "rem", cast=True)
        if self.tree_tokens is not None:
            _copy_in(self.tree_tokens, tree_tokens, "tree_tokens")
        if int(eos_val) != self.eos_val:
            self.eos.fill_(int(eos_val))
            self.eos_val = int(eos_val)

    def capture(self, pool, stream) -> None:
        """Capture ``step`` on ``stream`` into ``pool``; its kernel
        launches go into ``self.tally``.  Executes nothing.  The garbage
        collector is held off meanwhile."""
        graph = torch.cuda.CUDAGraph()
        with _gc_held(), _CAPTURE_LOCK, torch.cuda.stream(stream), \
                self.tally:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.emitted, self.n = self.step()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass          # the capture is void; the step's error is
                raise             # the one to report
            graph.capture_end()
        self.graph = graph

    def replay(self) -> None:
        """One step: the graph's replay on the current stream (or, without
        a capture, the step itself), then its launches into the counts."""
        if self.graph is None:
            self.emitted, self.n = self.step()
        else:
            self.graph.replay()
        self.tally.replayed()

    def state(self) -> SpecState:
        return SpecState(cache=_with(self.cache, self.tensors),
                         cur_token=self.cur_token, hidden=self.hidden)


class ChunkGraphs:
    """One engine's captured steps, one per key, in one memory pool, with
    what they cost: ``stats`` counts the graphs built (``captures``), the
    steps replayed and run as warm-up, the seconds the captures took and
    the memory the device reserved while capturing (``pool_bytes``).
    ``last`` says how the latest chunk ran: "warm-up", "capture" (then
    replayed), "replay", or "eager" (set by the engine, ``mark_eager``);
    ``marks`` and ``tap`` are the phase events and the expert tap of the
    graph it replayed (None when it replayed none or the graph has none).
    ``experts``, (L, E) for a model with experts, gives each inline
    drafted step a tap."""

    def __init__(self, step_fn: Callable, device, *, capture: bool = True,
                 experts: Optional[tuple] = None):
        self.step_fn, self.device, self.capture = step_fn, device, capture
        self.experts = experts
        self._graphs: Dict[tuple, StepGraph] = {}
        self._warm = set()
        self._pool = self._stream = None
        self.stats = dict(captures=0, replays=0, warmup_steps=0,
                          capture_s=0.0, pool_bytes=0, piece_replays=0,
                          piece_eager=0)
        self.last: Optional[str] = None
        self.marks: Optional[trace.PhaseMarks] = None
        self.tap: Optional[trace.ExpertTap] = None

    def mark_eager(self) -> None:
        """The latest chunk ran op by op: no graph's events to read."""
        self.last, self.marks, self.tap = "eager", None, None

    def __len__(self) -> int:
        return len(self._graphs)

    @staticmethod
    def key(strategy, state: SpecState, done, tree_kernel: str,
            partition="inline") -> tuple:
        kv = state.cache.kv
        return (partition, strategy.draft, tree_kernel, type(kv).__name__,
                getattr(kv, "window", 0), getattr(kv, "page_size", 0),
                strategy.tree.width, strategy.tree.max_depth,
                tuple(_signature(getattr(strategy.tree, f)) for f in _TREE),
                tuple((n, _signature(t))
                      for n, t in _tensors(state.cache).items()),
                _signature(state.cur_token), _signature(state.hidden),
                tuple(done.shape))

    def _side(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _warm_up(self, eager_chunk, K, *args):
        """The key's first chunk, eager, on the capture stream."""
        if not self.capture:
            return eager_chunk(K, *args)
        side = self._side()
        cur = torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = eager_chunk(K, *args)
        cur.wait_stream(side)
        return out

    def _build(self, step_fn, strategy, state, done, rem, eos_val,
               tree_kernel, tree_tokens):
        inline = tree_tokens is None and strategy.draft == "medusa"
        marks = trace.PhaseMarks() if self.capture and inline else None
        tap = trace.ExpertTap(*self.experts, self.device, self.capture) \
            if self.experts and inline else None
        g = StepGraph(step_fn, strategy, state, done, rem, eos_val,
                      tree_kernel, tree_tokens, marks, tap)
        self._capture(g)
        return g

    def _capture(self, g) -> None:
        """Capture ``g`` (a step or a piece graph) into the shared pool on
        the capture stream, and count it."""
        if self.capture:
            side = self._side()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            try:
                with trace.span("graphs.capture"):
                    g.capture(self._pool, side)
            except BaseException:
                # a pool whose only capture failed dies with it
                if not self._graphs:
                    self._pool = torch.cuda.graph_pool_handle()
                raise
            self.stats["capture_s"] += time.perf_counter() - t0
            self.stats["pool_bytes"] += \
                torch.cuda.memory_reserved(self.device) - reserved
        self.stats["captures"] += 1

    def run(self, K, strategy, state, done, rem, eos_val, tree_kernel,
            eager_chunk, overlap=None):
        """One K-step chunk: ``eager_chunk(K, strategy, state, done, rem,
        eos_val)`` at a key's first chunk, else K replays of its graph.
        Returns what the eager chunk returns: ``(state, done, rem, toks (K,
        B, D), ns (K, B))``.  ``overlap=(step_fn, tree_tokens)`` runs the
        HCMP overlap step from the first draft ``tree_tokens``: then the
        eager chunk takes the draft last, and both return the dangling
        draft last (on the graph path, the graph's static buffer)."""
        step_fn, tree_tokens = overlap or (self.step_fn, None)
        partition = "inline" if overlap is None else "overlap"
        extra = () if overlap is None else (tree_tokens,)
        key = self.key(strategy, state, done, tree_kernel, partition)
        if key not in self._warm:
            with trace.span("graphs.warmup", k=K):
                out = self._warm_up(eager_chunk, K, strategy, state, done,
                                    rem, eos_val, *extra)
            self._warm.add(key)
            self.stats["warmup_steps"] += K
            self.last, self.marks, self.tap = "warm-up", None, None
            return out
        g = self._graphs.get(key)
        if g is not None and g.holds(state):
            with trace.span("engine.chunk.load"):
                g.load(strategy, state, done, rem, eos_val, *extra)
            self.last = "replay"
        else:
            # the key's old graph (and its adopted K/V) stays alive through
            # the new capture, which keeps the shared pool in use (a pool
            # whose graphs are all gone cannot take another capture), and
            # is destroyed outside any capture
            g = self._build(step_fn, strategy, state, done, rem, eos_val,
                            tree_kernel, tree_tokens)
            with _CAPTURE_LOCK:
                old = self._graphs.pop(key, None)
                self._graphs[key] = g
                del old
            self.last = "capture"
        toks = ns = None
        for i in range(K):
            with trace.span("engine.chunk.replay"):
                g.replay()
                if toks is None:
                    toks = g.emitted.new_empty((K,) + tuple(g.emitted.shape))
                    ns = g.n.new_empty((K,) + tuple(g.n.shape))
                toks[i].copy_(g.emitted)
                ns[i].copy_(g.n)
        self.marks, self.tap = g.marks, g.tap
        self.stats["replays"] += K
        out = (g.state(), g.done, g.rem, toks, ns)
        return out if overlap is None else out + (g.tree_tokens,)

    def release(self, state: SpecState) -> None:
        """Drop the graphs that adopted ``state``'s K/V (their memory goes
        back to the allocator).  When no graph is left the pool is
        replaced: a pool whose graphs are all gone takes no capture."""
        with _CAPTURE_LOCK:
            for key in [k for k, g in self._graphs.items() if g.holds(state)]:
                del self._graphs[key]
            if self.capture and not self._graphs and self._pool is not None:
                self._pool = torch.cuda.graph_pool_handle()


# ===========================================================================
def piece_widths(C: int) -> tuple:
    """The admission widths of a scheduler's piece width ``C``: C/4, C/2
    and C (each at least 1), smallest first."""
    return tuple(sorted({max(1, C // 4), max(1, C // 2), C}))


class Piece(NamedTuple):
    """A prefill call to capture: ``fn(row, inp)`` (see ``PieceGraph``)
    and its warm-up input, an int32 numpy array whose real length is 0."""
    fn: Callable
    warm: object


class PieceGraph:
    """One prompt-prefill call on a static B=1 paged row, captured (or,
    without capture, called once a replay).  ``fn(row, inp)`` is the
    engine's piece: the row's new state (a ``SpecState``) from the row and
    ``inp``, the piece's int32 input.  The row's pool is adopted; its small
    tensors, ``cur_token``, ``hidden`` and ``inp`` are static buffers, and
    the step copies each new value back into its buffer."""

    def __init__(self, fn: Callable, row: SpecState, n_inp: int):
        cache = row.cache
        self.fn = fn
        self.big = _big(cache)
        self.tensors = {n: t if n in self.big else _clone(t)
                        for n, t in _tensors(cache).items()}
        self.cache = _with(cache, self.tensors)
        self.cur_token = row.cur_token.clone()
        self.hidden = _clone(row.hidden)
        self.inp = torch.zeros((n_inp,), dtype=torch.int32,
                               device=self.cur_token.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally = CaptureTally()

    def step(self) -> None:
        """The piece from the static buffers, its results copied back into
        them."""
        state = self.fn(SpecState(cache=_with(self.cache, self.tensors),
                                  cur_token=self.cur_token,
                                  hidden=self.hidden), self.inp)
        for name, t in _tensors(state.cache).items():
            if name in self.big:
                if t is not self.tensors[name]:
                    raise RuntimeError(f"the piece rebuilt the cache's "
                                       f"{name}: its pool must be written "
                                       f"in place")
            elif t is not None:
                _copy_in(self.tensors[name], t, name)
        _copy_in(self.cur_token, state.cur_token, "cur_token")
        _copy_in(self.hidden, state.hidden, "hidden")

    def holds(self, state: SpecState) -> bool:
        """Whether ``state``'s pool is the one this graph adopted."""
        tensors = _tensors(state.cache)
        return _big(state.cache) == self.big and all(
            tensors[n] is self.tensors[n] for n in self.big)

    def capture(self, pool, stream) -> None:
        """Capture ``step`` on ``stream`` into ``pool``, as
        ``StepGraph.capture`` does (a method of its own: the method that
        begins a capture names the function captured, which the analysis
        suite holds to the capture rules)."""
        graph = torch.cuda.CUDAGraph()
        with _gc_held(), _CAPTURE_LOCK, torch.cuda.stream(stream), \
                self.tally:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.step()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass          # the capture is void; the step's error is
                raise             # the one to report
            graph.capture_end()
        self.graph = graph

    def replay(self) -> None:
        if self.graph is None:
            self.step()
        else:
            self.graph.replay()
        self.tally.replayed()


class PieceGraphs:
    """One engine's captured prefill calls, keyed by (kind, width), in the
    memory pool of its step graphs (``graphs``, whose ``stats`` count
    them); see the module docstring."""

    def __init__(self, graphs: ChunkGraphs):
        self.chunk = graphs
        self._graphs: Dict[tuple, PieceGraph] = {}
        self.width = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def ready(self, state: SpecState, width: int) -> bool:
        """Whether the pieces are built for piece width ``width`` on
        ``state``'s pool."""
        g = next(iter(self._graphs.values()), None)
        return self.width == width and g is not None and g.holds(state)

    def build(self, pieces: dict, state: SpecState, width: int) -> None:
        """Build every piece of ``pieces`` ({key: ``Piece``}) on
        ``state``'s pool, each after its warm-up; the old pieces are
        dropped after the new ones are captured."""
        row = SpecState(cache=slice_row(state.cache, 0),
                        cur_token=state.cur_token[:1],
                        hidden=None if state.hidden is None
                        else state.hidden[:1])
        new = {key: self._build(key, fn, row, warm)
               for key, (fn, warm) in pieces.items()}
        with _CAPTURE_LOCK:
            old, self._graphs = self._graphs, new
            self.width = width
            del old

    def _build(self, key, fn, row, warm) -> PieceGraph:
        g = PieceGraph(fn, row, len(warm))
        g.inp.copy_(torch.from_numpy(warm))
        # the warm-up writes only the trash page and the static row; its
        # launches are no prefill call's, so they go to a tally of its own
        with trace.span("graphs.piece_warmup"), CaptureTally():
            if self.chunk.capture:
                side = self.chunk._side()
                cur = torch.cuda.current_stream(self.chunk.device)
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    g.step()
                cur.wait_stream(side)
            else:
                g.step()
        self.chunk._capture(g)
        return g

    def replay(self, key, state: SpecState, b: int, inp) -> None:
        """Copy bank row ``b`` into the piece's static row and ``inp`` (an
        int32 numpy array) into its input, then replay it."""
        g = self._graphs[key]
        bank = _tensors(state.cache)
        for name, t in g.tensors.items():
            if name not in g.big and t is not None:
                t.copy_(bank[name][b:b + 1])
        g.cur_token.copy_(state.cur_token[b:b + 1])
        if g.hidden is not None:
            g.hidden.copy_(state.hidden[b:b + 1])
        src = torch.from_numpy(inp)
        if g.inp.is_cuda:
            src = src.pin_memory()
        g.inp.copy_(src, non_blocking=True)
        g.replay()
        self.chunk.stats["piece_replays"] += 1

    def store(self, key, state: SpecState, b: int):
        """The bank with row ``b``'s new values copied out of the piece's
        static row, and the row's token as a device scalar of its own:
        (state, token)."""
        g = self._graphs[key]
        bank = _tensors(state.cache)
        new = {name: t if name in g.big or t is None
               else _set_row(t, b, g.tensors[name][0])
               for name, t in bank.items()}
        hid = None if g.hidden is None else \
            _set_row(state.hidden, b, g.hidden[0])
        return (SpecState(cache=_with(state.cache, new),
                          cur_token=_set_row(state.cur_token, b,
                                             g.cur_token[0]),
                          hidden=hid),
                g.cur_token[0].clone())
