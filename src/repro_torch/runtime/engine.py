"""Serving engine: ONE chunked decode driver parameterized by a
``DecodeStrategy`` (counterpart of ``repro/runtime/engine.py``, dense
layout).

A strategy bundles the verification tree, its width and the draft source:

  * ``DecodeStrategy.medusa(tree_spec, device)``: Ghidorah speculative
    decoding.  Medusa heads draft, the tree is verified in one forward, each
    sequence accepts its own chain (paper §III).
  * ``DecodeStrategy.sequential(device)``: the degenerate width-1 strategy.
    The tree is just the root and there is no draft source, so the step is
    plain one-token decoding through ``model.decode``.

Chunked driver: K steps run back to back on the device with ONE host sync
per chunk (the chunk's tokens, counts, done mask and budgets come back in
one transfer).  A row goes (and stays) done on EOS, on its ``rem`` budget
reaching 0, or on a capacity freeze: a full (window=0) KV cache that cannot
take a worst-case accepted chain (``capacity_left < tree.max_depth``)
freezes instead of wrapping its ring.  Done speculative rows commit nothing
(``spec_step(active=...)``); done sequential rows keep stepping with their
emission masked and their ``key_pos``/``pos`` restored.  The host loop
clamps the chunk length to the largest remaining budget (power-of-two
schedule).

Paged KV (``paged=True``): the batch's KV lives in one shared page pool
(runtime/cache.py).  ``generate`` reserves each row's pages on the host
before prefill (``prompt + budget + overshoot`` slots, partial when the
pool is short: the row then freezes at ``capacity_left``), prefills a
dense cache sized to the prompt and paginates it, so the tables reach the
device once.  ``kv_dtype`` picks the pool's dtype (``int8`` = quantized
pages); ``tree_kernel`` picks the fused or the split paged verify.

Continuous batching: the ``sched_*`` methods are the slot protocol
``runtime/continuous.py`` drives (``SchedulableEngine``): B=1 admission
prefills spliced into a resident bank, batched row resets, chunked-prefill
pieces (``sched_extend``) and the K-step chunk, with page reservations
kept on the host.  ``sched_step`` brings the chunk's tokens, counts, done
mask and budgets to the host in ONE transfer and hands the scheduler numpy
arrays; an admission's first token stays an unsynced device scalar until
the scheduler reads it.

The KV cache is updated in place where the reference donates it.

Families: every engine takes the prefill batch dict.  A VLM batch's
``patch_embeds`` join the decoder sequence, so a prompt's length
(``_prompt_len``) counts them and a paged row reserves pages for the whole
prefix.  An enc-dec batch's ``frame_embeds`` feed the encoder and are not
decoder positions: ``_prompt_len`` leaves them out, and the cross memory
rides in ``Cache.cross_k/cross_v``.  A hybrid (Zamba2) engine carries the
Mamba2 layers' recurrent state in ``Cache.mamba`` beside the
shared-attention sites' KV, an xLSTM engine only ``Cache.xlstm`` (no KV:
no capacity limit, and its paged layout holds no pages on the card; the
host still books the reservation).  The recurrent families and enc-dec
admit whole prompts (``sched_chunked_ok`` is False).

The compiled chunk (``runtime/graphs.py``): where the reference jits the
K-step scan, the port on a CUDA device captures one decode step in a CUDA
graph on static buffers and replays it K times a chunk, for ``generate``
and ``sched_step`` alike; a key's first chunk runs eagerly as the warm-up
and the capture follows.  A failed capture or replay raises.  ``eager()``
(the counterpart of ``jax.disable_jit()``) runs every chunk op by op
instead, and the CPU always does: there the tests drive the graphs'
static-buffer step without capture (``ChunkGraphs(..., capture=False)``).
``time_step`` times the deployed chunk (the replay, on the card) and
``measure_acceptance`` reuses one engine across same-shape trees, as in
the reference.

The captured prefill calls (``runtime/graphs.py::PieceGraphs``): under a
continuous scheduler with chunked prefill (its piece width C handed over
by ``sched_piece_width``), an engine on the graph path over a paged float
pool replays ``sched_admit`` (padded at its end to C/4, C/2 or C) and
``sched_extend`` (at C) from graphs captured on a static B=1 row, with
the real length as a device scalar; every other prefill call, the bank's
bootstrap ``sched_prefill`` included, runs eagerly (``_piece_width``).

HCMP executor split (``hcmp="overlap"``, ``core/hcmp/executors.py``): the
chunks of a drafted strategy go through the overlap runner, which drafts
step t+1 on a second stream of the card while step t commits (on the CPU
the same phases run serially); on the card it replays the overlapped step
captured with both streams.  Its tokens are the inline engine's.  The
bank epoch versions the resident state: every mutation (admission, reset,
extend, a strategy, partition or kernel switch, a new ``generate`` or
``time_step`` stream) bumps it, so a pre-draft made before it is
discarded and redrafted.  ``time_step(hcmp=...)`` times either partition
and ``core/arca.py``'s ``profile_engine`` records the measured choice on
``Strategy.hcmp``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Dict, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.speculative.tree import Tree, TreeSpec, chain_spec
from repro_torch.core.speculative.verify import (SpecState, spec_prefill,
                                                 spec_step)
from repro_torch.runtime import trace
from repro_torch.runtime.cache import (Cache, PageAllocator, PagedKVCache,
                                      _paged_insert_row, _set_row,
                                      blank_paged_rows, capacity_left,
                                      insert_rows, pages_for, paginate_cache,
                                      reset_rows, slice_row, tile_rows,
                                      write_row_at)
from repro_torch.runtime.graphs import (ChunkGraphs, Piece, PieceGraphs,
                                       piece_widths)
from repro_torch.runtime.sampling import greedy

_NO_EOS = -1          # sentinel: no real token id is negative

_KV_DTYPES = {"fp32": torch.float32, "f32": torch.float32,
              "float32": torch.float32, "bf16": torch.bfloat16,
              "bfloat16": torch.bfloat16, "int8": torch.int8}


def _kv_dtype(kv_dtype):
    """Normalize the engine's ``kv_dtype`` knob: None keeps the model
    dtype; a name ("fp32" | "bf16" | "int8") or a torch dtype picks the
    paged pool's storage dtype (int8 = quantized pages).  The serve CLI
    maps its default ``--kv-dtype fp32`` to None, the model's dtype, as the
    reference's does."""
    if kv_dtype is None:
        return None
    if isinstance(kv_dtype, str):
        if kv_dtype not in _KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {sorted(_KV_DTYPES)}"
                             f" or a dtype, got {kv_dtype!r}")
        return _KV_DTYPES[kv_dtype]
    if not isinstance(kv_dtype, torch.dtype):
        raise ValueError(f"kv_dtype must be a name or a torch dtype, got "
                         f"{kv_dtype!r}")
    return kv_dtype


def _eos_scalar(eos) -> int:
    """The engine's EOS value: -1 (no real token id) when ``eos`` is None."""
    return _NO_EOS if eos is None else int(eos)


def _budget(n_tokens, batch) -> np.ndarray:
    """Per-sequence token budgets: scalar broadcast or (B,) array."""
    b = np.broadcast_to(np.asarray(n_tokens, np.int32), (batch,)).copy()
    if np.any(b < 1):
        raise ValueError("n_tokens must be >= 1 per sequence")
    return b


class _Eager:
    """How many ``eager()`` blocks are open in the process."""

    def __init__(self):
        self.depth = 0
        self.lock = threading.Lock()


_EAGER = _Eager()


@contextlib.contextmanager
def eager():
    """Run every engine's decode chunk eagerly, op by op, while the block
    is open (the counterpart of ``jax.disable_jit()``): no graph is
    captured or replayed.  It holds for every thread of the process, so a
    replay whose scheduler runs in a worker thread is eager too."""
    with _EAGER.lock:
        _EAGER.depth += 1
    try:
        yield
    finally:
        with _EAGER.lock:
            _EAGER.depth -= 1


def _prompt_len(batch) -> int:
    """Decoder-sequence length of a prefill batch: its tokens plus any VLM
    patch embeds, which join the decoder sequence (an enc-dec batch's
    frame embeds feed the encoder and do not)."""
    n = int(batch["tokens"].shape[1])
    if "patch_embeds" in batch:
        n += int(batch["patch_embeds"].shape[1])
    return n


def _pow2_chunk(k_max: int, need: int) -> int:
    """Smallest power-of-two chunk covering ``need`` steps, capped at
    ``k_max``: bounds the tail-chunk overshoot."""
    k = 1
    while k < need and k < k_max:
        k *= 2
    return min(k, k_max)


# ===========================================================================
@dataclasses.dataclass(frozen=True)
class DecodeStrategy:
    """What one decode step does: verification tree + width + draft source
    (``"medusa"``: heads draft, the tree is verified in one forward;
    ``"none"``: the tree is the ``chain_spec(1)`` root, plain decode)."""
    width: int
    draft: str                   # "medusa" | "none"
    tree: Tree

    def shape(self) -> tuple:
        """Shape bucket: same-shape strategies share a captured step."""
        return (self.draft,) + self.tree.shape()

    @staticmethod
    def sequential(device) -> "DecodeStrategy":
        return DecodeStrategy(width=1, draft="none",
                              tree=Tree.from_spec(chain_spec(1), device))

    @staticmethod
    def medusa(spec: TreeSpec, device) -> "DecodeStrategy":
        return DecodeStrategy(width=spec.width, draft="medusa",
                              tree=Tree.from_spec(spec, device))


# ===========================================================================
def _prefill_state(model, params, heads, batch, *, max_len, window):
    """Prefill -> engine state.  ``heads is None`` selects the draft-free
    path (no hidden carry)."""
    if heads is None:
        logits, _, cache = model.prefill(params, batch, max_len=max_len,
                                         window=window)
        return SpecState(cache=cache, cur_token=greedy(logits[:, -1]),
                         hidden=None)
    return spec_prefill(model, params, heads, batch, max_len=max_len,
                        window=window)


def _insert_row(state, b, row, pages=None):
    cache = insert_rows(state.cache, b, row.cache, pages=pages)
    hid = None if state.hidden is None else \
        _set_row(state.hidden, b, row.hidden[0])
    return SpecState(cache=cache,
                     cur_token=_set_row(state.cur_token, b, row.cur_token[0]),
                     hidden=hid)


def _reset_state_rows(state, mask):
    # a freed slot must be fully inert, carry included: ``cur_token`` seeds
    # the next chunk's decode input and ``hidden`` keeps driving (masked)
    # drafts, so a stale carry is one masking bug away from leaking into a
    # recycled page.  Clear the whole row.
    mask = torch.as_tensor(mask, dtype=torch.bool,
                           device=state.cur_token.device)
    hid = None if state.hidden is None else \
        torch.where(mask[:, None], 0, state.hidden).to(state.hidden.dtype)
    return SpecState(cache=reset_rows(state.cache, mask),
                     cur_token=torch.where(mask, 0, state.cur_token),
                     hidden=hid)


def _at_last(t, n_valid):
    """``t[0, n_valid - 1]`` of a ``(1, W, ...)`` tensor.  A device-scalar
    ``n_valid`` is read on the device (0 reads position 0)."""
    if isinstance(n_valid, int):
        return t[0, n_valid - 1]
    at = (n_valid - 1).clamp(min=0).reshape(1).long()
    return t[0].index_select(0, at)[0]


def _extend_row(model, params, state, b, tokens, n_valid, tree,
                sp=trace.NOOP):
    """Chunked-prefill piece: run ``tokens (1, C)`` through the causal
    verify path (``tree`` = chain spec: plain causal attention at the row's
    offset) against row ``b``'s cache view and splice the piece's KVs in.
    The reference pins its plain attention here; the port has no backend
    switch, so on the card the piece runs through the verify kernel at
    W = C.  The drafting carry (``cur_token``/``hidden`` when present)
    tracks the last REAL position, so the final piece leaves the row
    exactly as a whole-prompt admission would.  ``n_valid`` is an int or a
    device scalar (the captured piece's).  ``sp``, the caller's span,
    marks the device time between the forward and the splice."""
    with trace.span("engine.extend.forward"):
        row_view, out = _extend_forward(model, params, state, b, tokens,
                                        tree)
    sp.mark()
    with trace.span("engine.extend.splice"):
        return _extend_splice(state, b, row_view, out, n_valid)


def _extend_forward(model, params, state, b, tokens, tree):
    """``_extend_row``'s forward: (row ``b``'s view, (logits, extras))."""
    row_view = slice_row(state.cache, b)
    return row_view, model.verify(params, row_view, tokens, tree)


def _extend_splice(state, b, row_view, out, n_valid):
    """``_extend_row``'s splice of the forward's ``out`` into row ``b``."""
    logits, extras = out
    k1, v1 = extras["tree_kv"]                       # (L, 1, C, Hkv, hd)
    cache = write_row_at(state.cache, b, k1[:, 0], v1[:, 0],
                         row_view.kv.pos[0], n_valid)
    last = greedy(_at_last(logits, n_valid))
    hid = None if state.hidden is None else \
        _set_row(state.hidden, b, _at_last(extras["hidden"], n_valid))
    cur = _set_row(state.cur_token, b, last)
    return SpecState(cache=cache, cur_token=cur, hidden=hid), last


# ---- the captured prefill calls (runtime/graphs.py::PieceGraphs) ---------
# A piece takes a static B=1 paged row and its int32 input ``inp``: the W
# tokens, the real length n_valid, and, for an admission, the row's fresh
# pages.  With n_valid = 0 (the warm-up) every write lands in the trash page.
def _admit_piece(model, params, heads, W, row, inp):
    """``_prefill_state`` and the paged ``_insert_row`` of a prompt padded
    at its end to W tokens.  Causal attention leaves the real positions as
    the unpadded prompt's: the first token and the hidden carry are read at
    n_valid - 1, only the first n_valid K/V entries are scattered into the
    row's pages, and the row's ``pos`` is n_valid."""
    n_valid = inp[W]
    logits, extras, dense = model.prefill(params, {"tokens": inp[None, :W]},
                                          max_len=1, window=0)
    kv = _paged_insert_row(row.cache.kv, 0, dense.kv, inp[W + 1:],
                           n_valid=n_valid)
    hidden = None if heads is None else \
        _at_last(extras["hidden"], n_valid)[None]
    return SpecState(cache=Cache(kv=kv),
                     cur_token=greedy(_at_last(logits, n_valid))[None],
                     hidden=hidden)


def _extend_piece(model, params, tree, W, row, inp):
    """``_extend_row``'s piece of W tokens (n_valid of them real) at the
    row's offset."""
    row_view, out = _extend_forward(model, params, row, 0, inp[None, :W],
                                    tree)
    return _extend_splice(row, 0, row_view, out, inp[W])[0]


def _host_tokens(tokens):
    """A prompt's tokens as an int32 numpy array, or None where they lie on
    a device (reading them would sync)."""
    if isinstance(tokens, torch.Tensor):
        if tokens.device.type != "cpu":
            return None
        tokens = tokens.numpy()
    return np.asarray(tokens, np.int32)


def _seq_step(model, params, state, *, active):
    """One step of the degenerate width-1 strategy: plain one-token decode.
    Interface mirrors ``spec_step``: returns (state, emitted (B, 1), n (B,)
    in {0, 1}).

    Every row decodes, done ones included; their ``key_pos``/``pos`` are
    restored afterwards so a done row's KV bookkeeping is frozen (its
    garbage k/v write stays invisible and is overwritten by the slot's next
    real write).  ``decode`` builds new ``key_pos``/``pos`` tensors, so the
    old ones are still intact here."""
    kv0 = state.cache.kv
    lg, cache = model.decode(params, state.cache, state.cur_token[:, None])
    # as in the reference, only the KV bookkeeping is restored: a done
    # recurrent row's state steps on (the row is inert until reset), and a
    # cache with no KV (xLSTM) restores nothing
    if kv0 is not None:
        done = ~active
        kv = cache.kv
        cache = dataclasses.replace(cache, kv=dataclasses.replace(
            kv,
            key_pos=torch.where(done[:, None], kv0.key_pos, kv.key_pos),
            pos=torch.where(done, kv0.pos, kv.pos)))
    nxt = greedy(lg[:, 0])
    cur = torch.where(active, nxt, state.cur_token)
    return (SpecState(cache=cache, cur_token=cur, hidden=state.hidden),
            nxt[:, None], active.to(torch.int64))


def _decode_step(model, params, heads, strategy, state, done, rem, eos_val,
                 tree_kernel, marks=None, tap=None):
    """One decode step, the body of the reference's scan (and the step
    ``runtime/graphs.py`` captures).  ``eos_val`` is an int or a 0-d
    tensor; ``marks`` and ``tap`` go to ``spec_step`` (the captured
    drafted step's phase events and expert tap).  Returns (state, done,
    rem, emitted (B, Dmax) eos-padded, n (B,) emitted count)."""
    # capacity guard BEFORE the step: a commit may write up to max_depth
    # slots (1 for sequential), so freeze once the ring cannot take a
    # worst case without wrapping
    done = done | (rem <= 0) | \
        (capacity_left(state.cache) < strategy.tree.max_depth)
    active = ~done
    if strategy.draft == "none":
        state, emitted, n = _seq_step(model, params, state, active=active)
    else:
        state, emitted, n = spec_step(model, params, heads, strategy.tree,
                                      state, tree_kernel=tree_kernel,
                                      active=active, marks=marks, tap=tap)
    idx = torch.arange(emitted.shape[1], device=emitted.device)[None]
    valid = idx < n[:, None]
    is_eos = valid & (emitted == eos_val)
    has_eos = is_eos.any(dim=1)
    # truncate each sequence's emission at its first EOS
    n_cut = torch.where(
        has_eos, torch.argmax(is_eos.to(torch.int32), dim=1) + 1, n)
    n_eff = torch.where(active, n_cut, 0)
    emitted = torch.where(idx < n_eff[:, None], emitted, eos_val)
    return state, done | has_eos, rem - n_eff, emitted, n_eff


@runtime_checkable
class SchedulableEngine(Protocol):
    """The slot protocol ``runtime/continuous.py`` drives engines through
    (the reference's ``SchedulableEngine``, method for method).  Every
    method below is REQUIRED (called unconditionally at chunk boundaries)
    except the last three, which the scheduler/server probe with
    ``getattr``/``hasattr``.  Two optional properties, ``sched_chunked_ok``
    and ``sched_pages_held``, are part of the wider contract but kept out of
    this Protocol so it stays ``issubclass``-checkable.

    Slot-state conventions: ``state`` is the opaque resident-bank carry,
    ``row`` an opaque B=1 prefill result, ``b`` a bank slot index.
    ``sched_step`` returns host (numpy) ``done``/``rem`` and a host raw
    block; ``sched_admit``/``sched_extend`` return the first token as an
    unsynced device scalar."""

    # ---- admission sizing (host-side, no device work) --------------------
    def sched_footprint(self, prompt_len: int, n_tokens: int) -> int: ...
    def sched_can_admit(self, prompt_len: int, n_tokens: int) -> bool: ...

    # ---- row lifecycle ---------------------------------------------------
    def sched_prefill(self, batch): ...
    def sched_first(self, row) -> int: ...
    def sched_blank(self, row, batch): ...
    def sched_insert(self, state, b, row, *, prompt_len=None,
                     n_tokens=None): ...
    def sched_admit(self, state, b, batch, *, n_tokens=None,
                    reserve_len=None): ...
    def sched_extend(self, state, b, tokens, n_valid): ...
    def sched_reset(self, state, b): ...
    def sched_release(self, b: int) -> None: ...

    # ---- the chunk step --------------------------------------------------
    def sched_step(self, state, done, rem, K, eos_val): ...
    def sched_emitted(self, raw): ...

    # ---- optional extensions (probed with getattr/hasattr) ---------------
    def sched_abort(self, b: int) -> None: ...
    def sched_pool_conserved(self) -> bool: ...
    def sched_drained(self) -> bool: ...


class _PagedPoolMixin:
    """Page-reservation bookkeeping of paged engines, all on the host:
    pages move between the free list and rows only at admission/eviction
    boundaries (and once per ``generate``), so reservation never syncs the
    device.  ``_overshoot`` is the engine's worst-case slots written past
    the budget: one full accepted chain of the current strategy's
    ``max_depth`` (1 for sequential), ratcheted to the deepest registered
    candidate when runtime switching is armed."""

    def _paged_init(self, *, paged, page_size, pool_pages):
        if paged and self.window:
            raise ValueError("paged KV supports full attention only "
                             "(sliding windows stay dense: the ring IS the "
                             "window)")
        self.paged, self.page_size = paged, page_size
        self.pool_pages = pool_pages
        self.max_pages = pages_for(self.max_len, page_size) if paged else 0
        self._alloc: Optional[PageAllocator] = None      # sched-bank state
        self._row_pages = {}
        self._extend_trees = {}     # piece width -> chain Tree

    def _need_pages(self, prompt_len: int, budget: int, n_total: int) -> int:
        return min(pages_for(prompt_len + budget + self._overshoot,
                             self.page_size),
                   self.max_pages, n_total)

    def _reserve_tables(self, batch_size, prompt_len, budget):
        """Per-row page reservations for a ``generate`` call, lowest page
        ids first.  When the pool cannot cover a row's need the reservation
        is PARTIAL: the row freezes at ``capacity_left`` with its shortfall
        in ``n_emitted``; it never borrows a neighbour's pages."""
        n_total = self.pool_pages or batch_size * self.max_pages
        alloc = PageAllocator(n_total)
        tables = np.full((batch_size, self.max_pages), -1, np.int32)
        for b in range(batch_size):
            pages = alloc.alloc_upto(
                self._need_pages(prompt_len, int(budget[b]), n_total))
            tables[b, :len(pages)] = pages
        return torch.as_tensor(tables, device=self.device), n_total

    # ---- scheduler-facing reservation hooks ------------------------------
    def sched_footprint(self, prompt_len: int, n_tokens: int) -> int:
        """Slot cost of a request, what SJF/LPT rank by: reserved pages
        when paged, otherwise logical slots (prompt + budget +
        overshoot)."""
        need = int(prompt_len) + int(n_tokens) + self._overshoot
        if self.paged:
            return pages_for(need, self.page_size)
        return need

    @property
    def sched_chunked_ok(self) -> bool:
        """Whether this engine supports chunked prefill (piecewise
        ``sched_extend`` admission): attention-only families with full
        attention."""
        return self.window == 0 and \
            getattr(self.model, "family", "") in ("dense", "moe", "vlm")

    def sched_can_admit(self, prompt_len: int, n_tokens: int) -> bool:
        """False while the pool cannot fund the request's reservation: the
        scheduler then DEFERS admission until evictions free pages.  A
        request bigger than the whole pool caps at the pool."""
        if not self.paged or self._alloc is None:
            return True
        return self._alloc.available >= self._need_pages(
            prompt_len, n_tokens, self._alloc.n_pages)

    def sched_release(self, b: int) -> None:
        """Return an evicted row's pages to the pool (host-side; the row's
        device-side table is cleared by the boundary's reset/insert before
        the next chunk runs)."""
        if self.paged and self._alloc is not None:
            with trace.span("engine.release"):
                self._alloc.free(self._row_pages.pop(b, ()))

    def sched_abort(self, b: int) -> None:
        """Release a LIVE, unfinished row mid-flight (cancellation, expired
        deadline, injected fault).  The caller MUST reset the row before
        the next chunk runs; the scheduler's dirty-reset ordering does."""
        self.sched_release(b)

    @property
    def sched_pages_held(self) -> int:
        """Pages currently reserved by resident rows (0 when dense)."""
        if not self.paged:
            return 0
        return sum(len(p) for p in self._row_pages.values())

    def sched_pool_conserved(self) -> bool:
        """Page-leak audit: the allocator's free + held equal the pool and
        agree with the engine's per-row bookkeeping."""
        if not self.paged or self._alloc is None:
            return True
        return (self._alloc.conserved
                and self._alloc.outstanding == self.sched_pages_held)

    def sched_drained(self) -> bool:
        """True when every page is back on the free list and no row holds
        a reservation."""
        if not self.paged or self._alloc is None:
            return True
        return (not self._row_pages
                and self._alloc.available == self._alloc.n_pages)

    def _sched_pages(self, b: int, prompt_len: int, n_tokens: int):
        """Allocate row ``b``'s reservation (gated by ``sched_can_admit``),
        padded with -1 to the ``max_pages`` table width, on the host."""
        pages = self._alloc.alloc(self._need_pages(prompt_len, n_tokens,
                                                   self._alloc.n_pages))
        self._row_pages[b] = pages
        out = np.full((self.max_pages,), -1, np.int32)
        out[:len(pages)] = pages
        return out

    def _extend_tree(self, C: int) -> Tree:
        """The chain tree of a chunked-prefill piece of width ``C``."""
        if C not in self._extend_trees:
            self._extend_trees[C] = Tree.from_spec(chain_spec(C),
                                                   self.device)
        return self._extend_trees[C]


class DecodeEngine(_PagedPoolMixin):
    """ONE serving engine for every decode strategy.

    ``strategy`` picks what a step does; ``heads`` are required exactly
    when the strategy drafts.  ``chunk`` = K steps per host sync; K=1 is the
    per-step host-synced loop.  The engine runs on the device of its params.
    """

    def __init__(self, model, params, *, strategy: Optional[DecodeStrategy]
                 = None, heads=None, max_len=512, window=0, chunk=8,
                 paged=False, page_size=16, pool_pages=None, hcmp="inline",
                 kv_dtype=None, tree_kernel="dense"):
        self.device = params["embed"].device
        if strategy is None:
            if heads is not None:
                raise ValueError("an engine with draft heads needs an "
                                 "explicit DecodeStrategy.medusa(tree_spec)")
            strategy = DecodeStrategy.sequential(self.device)
        if (strategy.draft == "medusa") != (heads is not None):
            raise ValueError(
                f"strategy draft {strategy.draft!r} "
                f"{'requires' if strategy.draft == 'medusa' else 'forbids'} "
                "draft heads")
        kv_dtype = _kv_dtype(kv_dtype)
        if kv_dtype == torch.int8 and not paged:
            raise ValueError("kv_dtype=int8 quantizes the PAGED pool "
                             "(per-page scales live on the page axis); "
                             "dense ring caches stay float: pass paged=True")
        self.kv_dtype = kv_dtype
        self.model, self.params, self.heads = model, params, heads
        self.strategy = strategy
        # HCMP executor split: "overlap" routes drafted chunks through the
        # runner, built lazily on the engine's executor pair (its draft
        # stream outlives a runner rebuilt for another tree kernel)
        self._hcmp_runner = None
        self._executors = None
        self._bank_epoch = 0
        self.set_hcmp(hcmp)
        self._registered: Dict[int, DecodeStrategy] = {}
        self._registered_depth = 0
        self.max_len, self.window = max_len, window
        self.chunk = chunk
        self._paged_init(paged=paged, page_size=page_size,
                         pool_pages=pool_pages)
        self.set_tree_kernel(tree_kernel)
        # the compiled chunk: captured and replayed on a CUDA device.  The
        # step holds the weights, not the engine: no reference cycle keeps
        # a dropped engine's graphs for the garbage collector to destroy
        # at some later moment (inside another capture, say)
        on_card = self.device.type == "cuda"
        cfg = model.cfg
        self._graphs = ChunkGraphs(
            functools.partial(_decode_step, model, params, heads),
            self.device, capture=on_card,
            experts=(cfg.num_layers, cfg.num_experts) if cfg.num_experts
            else None)
        self._graphed = on_card
        # the captured prefill calls, at the piece width the scheduler
        # hands over (``sched_piece_width``; 0: none)
        self._pieces = PieceGraphs(self._graphs)
        self._piece_C = 0

    @property
    def graph_stats(self) -> dict:
        """The chunk graphs' counters (``runtime/graphs.py``): graphs
        built (``captures``: step and piece graphs alike), steps replayed,
        warm-up steps, capture seconds, the memory reserved while
        capturing, prefill calls replayed from a piece graph and prefill
        calls run eagerly, and the step graphs held (``graphs``)."""
        return dict(self._graphs.stats, graphs=len(self._graphs))

    # ---- paged pool --------------------------------------------------------
    @property
    def _overshoot(self) -> int:
        # worst case slots written past the budget: one full accepted chain
        # (1 for sequential); with runtime switching armed, the deepest
        # registered candidate (a switch must never outgrow a reservation)
        return max(self.strategy.tree.max_depth, self._registered_depth)

    def _prefill_paged(self, batch, tables, n_total):
        """Prefill into a transient dense cache sized to the prompt, then
        paginate it into a fresh pool of ``n_total`` pages."""
        st = _prefill_state(self.model, self.params, self.heads, batch,
                            max_len=1, window=0)
        cache = paginate_cache(st.cache, tables, page_size=self.page_size,
                               n_pages=n_total, kv_dtype=self.kv_dtype)
        return SpecState(cache=cache, cur_token=st.cur_token,
                         hidden=st.hidden)

    def set_tree_kernel(self, mode: str) -> None:
        """Switch the paged verify kernel between chunks: "dense" = fused
        page walk + tree tile, "sparse" = page walk and tree partial merged
        by the Eq.-1 rule."""
        if mode not in ("dense", "sparse"):
            raise ValueError(f"tree_kernel must be 'dense' or 'sparse', "
                             f"got {mode!r}")
        if mode == "sparse" and not self.paged:
            raise ValueError("tree_kernel='sparse' splits the PAGED verify "
                             "path (page walk + tree partial); dense caches "
                             "use the fused kernel: pass paged=True")
        if mode != getattr(self, "tree_kernel", None):
            self.tree_kernel = mode
            self._hcmp_runner = None     # the runner runs the old kernel
        self._touch_bank()

    # ---- HCMP executor split (core/hcmp/executors.py) --------------------
    @property
    def hcmp_capable(self) -> bool:
        """Whether this engine can run the overlap schedule (it needs a
        draft source to put on the second executor)."""
        return self.heads is not None

    def set_hcmp(self, mode: str) -> None:
        """Switch the executor partition between chunks ("inline" |
        "overlap"); bumps the bank epoch so a pre-draft made under the
        other schedule is discarded."""
        if mode not in ("inline", "overlap"):
            raise ValueError(f"hcmp must be 'inline' or 'overlap', "
                             f"got {mode!r}")
        if mode == "overlap" and not self.hcmp_capable:
            raise ValueError("hcmp='overlap' needs a drafted strategy: a "
                             "sequential engine has no draft source to "
                             "disaggregate")
        self.hcmp = mode
        self._touch_bank()

    def _touch_bank(self) -> None:
        """Version the resident bank: called by every mutation that makes
        a cross-chunk pre-draft stale (admission, insert, reset, extend, a
        strategy, partition or kernel switch, a new generate/time_step
        stream)."""
        self._bank_epoch += 1

    def _hcmp(self):
        if self._hcmp_runner is None:
            from repro_torch.core.hcmp.executors import (HcmpOverlapRunner,
                                                         executor_pair)
            if self._executors is None:
                self._executors = executor_pair(self.device)
            self._hcmp_runner = HcmpOverlapRunner(
                self.model, self.heads, tree_kernel=self.tree_kernel,
                executors=self._executors)
        return self._hcmp_runner

    @property
    def hcmp_executors(self) -> tuple:
        """Names of the overlap runner's (verify, draft) executors."""
        st = self._hcmp().stats
        return st["verify_executor"], st["draft_executor"]

    @property
    def hcmp_stats(self) -> Optional[dict]:
        """Overlap-runner counters (None until the runner exists)."""
        if self._hcmp_runner is None:
            return None
        return dict(self._hcmp_runner.stats, mode=self.hcmp)

    # ---- strategy axis ---------------------------------------------------
    def strategy_for(self, spec: TreeSpec) -> DecodeStrategy:
        """Build a DecodeStrategy of THIS engine's draft kind from a tree
        spec (the state carry differs across draft kinds)."""
        if self.heads is None:
            if spec.width != 1:
                raise ValueError("a draft-free engine can only run the "
                                 "degenerate width-1 strategy")
            return DecodeStrategy.sequential(self.device)
        return DecodeStrategy.medusa(spec, self.device)

    def set_tree(self, tree_spec: TreeSpec) -> None:
        """Alias of ``set_strategy`` (``measure_acceptance`` swaps
        candidate trees through it; same-shape trees share the captured
        step)."""
        self.set_strategy(tree_spec)

    def set_strategy(self, strategy) -> None:
        """Swap the decode strategy between chunks.  Accepts a
        ``DecodeStrategy`` or a ``TreeSpec``; the draft kind must match the
        engine's."""
        if isinstance(strategy, TreeSpec):
            strategy = self.strategy_for(strategy)
        if strategy.draft != self.strategy.draft:
            raise ValueError(f"cannot switch draft kind "
                             f"{self.strategy.draft!r} -> {strategy.draft!r}"
                             " (the state carry differs)")
        self.strategy = strategy
        self._touch_bank()

    def register_strategies(self, specs) -> Dict[int, DecodeStrategy]:
        """Arm a candidate set for runtime switching: builds the
        DecodeStrategy per width ONCE (switches then reuse them) and
        ratchets the paged reservation overshoot to the deepest candidate so
        a mid-request switch can never outgrow a row's page reservation.
        ``specs``: {width: TreeSpec}."""
        self._registered = {int(w): self.strategy_for(sp)
                            for w, sp in specs.items()}
        self._registered_depth = max(
            [s.tree.max_depth for s in self._registered.values()],
            default=0)
        return self._registered

    # ---- the ONE chunk driver --------------------------------------------
    def _eager_chunk(self, K, strategy, state, done, rem, eos_val):
        """K steps launched op by op, no host sync."""
        toks, ns = [], []
        for _ in range(K):
            state, done, rem, emitted, n = _decode_step(
                self.model, self.params, self.heads, strategy, state, done,
                rem, eos_val, self.tree_kernel)
            toks.append(emitted)
            ns.append(n)
        return state, done, rem, torch.stack(toks), torch.stack(ns)

    def _run_chunk(self, K, strategy, state, done, rem, eos_val):
        """K steps on the device, no host sync: replays of the captured
        step on a CUDA device (``runtime/graphs.py``), else (the CPU, or
        inside ``eager()``) the steps op by op; a drafted strategy in
        overlap mode goes through the HCMP runner, graphed or op by op
        alike.  The carry passed in is consumed.  Returns (state, done,
        rem, toks (K, B, Dmax) eos-padded, ns (K, B) emitted counts)."""
        graphed = self._graphed and not _EAGER.depth
        if self.hcmp == "overlap" and strategy.draft == "medusa":
            self._graphs.mark_eager()
            return self._hcmp().run_chunk(
                self.params, strategy, state, done, rem, K, eos_val,
                self._bank_epoch, graphs=self._graphs if graphed else None)
        if graphed:
            return self._graphs.run(K, strategy, state, done, rem, eos_val,
                                    self.tree_kernel, self._eager_chunk)
        self._graphs.mark_eager()
        return self._eager_chunk(K, strategy, state, done, rem, eos_val)

    # ---- batch generation ------------------------------------------------
    def generate(self, batch, n_tokens, *, eos: Optional[int] = None,
                 chunk: Optional[int] = None):
        """``n_tokens``: int or (B,) per-sequence budgets.  Returns
        ``(out, stats)``; rows past their budget / EOS / capacity freeze
        pad with ``eos`` (-1 if None) and ``stats["n_emitted"]`` has the
        real per-sequence counts.  Drafted engines return a 1-D token
        array at B=1; the sequential strategy always returns
        ``(B, max_budget)``.  ``stats["device_steps"]`` counts the decode
        steps run on the device (each one verify or decode forward)."""
        K = chunk or self.chunk
        eos_val = _NO_EOS if eos is None else int(eos)
        batch = self._batch(batch)
        B = int(batch["tokens"].shape[0])
        budget = _budget(n_tokens, B)
        self._touch_bank()            # new stream: stale pre-drafts die
        if self.paged:
            # a VLM row reserves pages for its whole prefix too
            tables, n_total = self._reserve_tables(B, _prompt_len(batch),
                                                   budget)
            state = self._prefill_paged(batch, tables, n_total)
        else:
            state = _prefill_state(self.model, self.params, self.heads,
                                   batch, max_len=self.max_len,
                                   window=self.window)
        n_max = int(budget.max())
        # prologue sync: the prefill's first token
        first = state.cur_token.tolist()  # torchlint: disable=T3 (prologue)
        outs = [[first[b]] for b in range(B)]
        done = state.cur_token == eos_val
        rem = torch.as_tensor(budget - 1, device=self.device)
        done_np = np.array([t == eos_val for t in first])
        rem_np = budget - 1
        accepts, times, device_steps = [], [], 0
        replay_s, replay_steps = 0.0, 0

        while np.any(~done_np & (rem_np > 0)):
            # every live step emits >= 1 token, so the largest remaining
            # budget bounds the steps still needed
            need = int(rem_np[~done_np & (rem_np > 0)].max())
            k = _pow2_chunk(K, need)
            t0 = time.perf_counter()
            with trace.span("engine.chunk", rows=B, k=k):
                state, done, rem, toks, ns = self._run_chunk(
                    k, self.strategy, state, done, rem, eos_val)
                # ONE host sync per chunk: tokens, counts, done and
                # budgets travel in one transfer
                D = toks.shape[2]
                host = torch.cat([toks.reshape(-1), ns.reshape(-1),
                                  done.to(torch.int64), rem.to(torch.int64)])
                with trace.span("engine.chunk.wait"):
                    # torchlint: disable=T3 (the sync)
                    host = host.cpu().numpy()
                trace.after_transfer(self._graphs.marks, self._graphs.tap)
            times.append(time.perf_counter() - t0)
            device_steps += k
            if self._graphs.last == "replay":
                replay_s += times[-1]
                replay_steps += k
            toks_np = host[:k * B * D].reshape(k, B, D)
            ns_np = host[k * B * D:k * B * (D + 1)].reshape(k, B)
            done_np = host[k * B * (D + 1):k * B * (D + 1) + B] != 0
            rem_np = host[-B:]
            for s in range(k):
                for b in range(B):
                    m = int(ns_np[s, b])
                    if m and len(outs[b]) < budget[b]:
                        # count only steps whose tokens are (at least
                        # partly) kept: overshoot steps past n_tokens would
                        # bias the acceptance stats
                        accepts.append(m)
                        outs[b].extend(int(x) for x in toks_np[s, b, :m])

        n_emitted = np.array([min(len(outs[b]), int(budget[b]))
                              for b in range(B)], np.int32)
        stats = _stats(accepts, times)
        stats["chunk"] = K
        stats["device_steps"] = device_steps
        # the chunks that only replayed a graph captured earlier (no
        # warm-up, no capture): their steps and seconds
        stats["replay_steps"] = replay_steps
        stats["replay_s"] = replay_s
        stats["n_emitted"] = n_emitted
        stats["emitted_total"] = int(n_emitted.sum())
        out = np.full((B, n_max), eos_val, np.int32)
        for b in range(B):
            seq = outs[b][:budget[b]]
            out[b, :len(seq)] = seq
        if B == 1 and self.strategy.draft == "medusa":
            return out[0], stats
        return out, stats

    # ---- measured step time (ARCA's time source) -------------------------
    def time_step(self, strategy: Optional[DecodeStrategy] = None, *,
                  batch: int = 1, prompt_len: int = 16, reps: int = 3,
                  chunk: Optional[int] = None, hcmp: Optional[str] = None,
                  tree_kernel: Optional[str] = None) -> float:
        """Best-of-``reps`` wall time of ONE decode step under ``strategy``
        (default: the current one), measured through the chunk the engine
        deploys on a dummy prompt: on a CUDA device the replay of the
        captured step (the strategy's tree is copied into the graph's
        static tree), so the timed function is exactly the deployed one.
        Timed at the serving cadence (``chunk`` steps per sync, divided
        out).  ``hcmp`` ("inline" | "overlap") and ``tree_kernel``
        ("dense" | "sparse") override the executor partition and the paged
        verify kernel for the measurement and are restored after it; the
        engine's strategy is never changed.  The measurement's graphs are
        released once it is timed: each holds the dummy prompt's cache."""
        strategy = strategy or self.strategy
        K = chunk or self.chunk
        prev_hcmp, prev_tk = self.hcmp, self.tree_kernel
        if hcmp is not None:
            self.set_hcmp(hcmp)
        if tree_kernel is not None:
            self.set_tree_kernel(tree_kernel)
        state = None
        try:
            self._touch_bank()        # measurement stream, not the bank
            dummy = {"tokens": torch.zeros((batch, prompt_len),
                                           dtype=torch.int32,
                                           device=self.device)}
            if self.paged:
                budget = np.full((batch,), self.max_len, np.int64)
                tables, n_total = self._reserve_tables(batch, prompt_len,
                                                       budget)
                state = self._prefill_paged(dummy, tables, n_total)
            else:
                state = _prefill_state(self.model, self.params, self.heads,
                                       dummy, max_len=self.max_len,
                                       window=self.window)
            done = torch.zeros((batch,), dtype=torch.bool,
                               device=self.device)
            rem = torch.full((batch,), 1 << 30, dtype=torch.int32,
                             device=self.device)

            def step(st, dn, rm):
                return self._run_chunk(K, strategy, st, dn, rm, _NO_EOS)

            # warm-up: a new key's eager first chunk, then its capture
            for _ in range(2):
                state, done, rem, _, _ = step(state, done, rem)
            # reprolint: disable=R3 (timing harness)
            self._sync()
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                state, done, rem, _, _ = step(state, done, rem)
                # this IS the measurement: ARCA times the deployed step
                # reprolint: disable=R3 (timing harness)
                self._sync()
                best = min(best, time.perf_counter() - t0)
            return best / K
        finally:
            if state is not None:
                self._graphs.release(state)
            if hcmp is not None:
                self.set_hcmp(prev_hcmp)
            if tree_kernel is not None:
                self.set_tree_kernel(prev_tk)

    def _sync(self) -> None:
        """Wait for the engine's device work (the CPU runs synchronously)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


    # ---- continuous-batching slot protocol (runtime/continuous.py) -------
    def _batch(self, batch):
        """The prefill batch dict on the engine's device: ``tokens`` and,
        for the VLM family, ``patch_embeds`` (the enc-dec family:
        ``frame_embeds``)."""
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def sched_prefill(self, batch):
        """B=1 prefill -> opaque row state.  Paged engines prefill at
        prompt size (the dense row is a splice source, not a resident)."""
        self._graphs.stats["piece_eager"] += 1
        with trace.span("engine.prefill", rows=1, tokens=_prompt_len(batch),
                        device=self.device, graphed=0):
            with trace.span("engine.prefill.forward"):
                return self._prefill_row(batch)

    def _prefill_row(self, batch):
        if self.paged:
            return _prefill_state(self.model, self.params, self.heads,
                                  self._batch(batch), max_len=1, window=0)
        return _prefill_state(self.model, self.params, self.heads,
                              self._batch(batch), max_len=self.max_len,
                              window=self.window)

    @staticmethod
    def sched_first(row) -> int:
        return int(row.cur_token[0])

    def sched_blank(self, row, batch):
        """The resident bank of ``batch`` rows, bootstrapped from the first
        admission's prefill: a fresh page pool (and allocator) when paged,
        the prefilled row repeated when dense."""
        self._touch_bank()
        if self.paged:
            n_total = self.pool_pages or batch * self.max_pages
            self._alloc = PageAllocator(n_total)
            self._row_pages = {}
            bank = blank_paged_rows(row.cache, batch,
                                    page_size=self.page_size,
                                    n_pages=n_total, max_len=self.max_len,
                                    kv_dtype=self.kv_dtype)
        else:
            bank = tile_rows(row.cache, batch)
        hid = None if row.hidden is None else \
            row.hidden.repeat_interleave(batch, dim=0)
        return SpecState(cache=bank,
                         cur_token=row.cur_token.repeat_interleave(batch,
                                                                   dim=0),
                         hidden=hid)

    def sched_insert(self, state, b, row, *, prompt_len=None, n_tokens=None):
        self._touch_bank()
        if self.paged:
            pages = self._sched_pages(b, prompt_len, n_tokens)
            return _insert_row(state, int(b), row, pages=pages)
        return _insert_row(state, int(b), row)

    def sched_admit(self, state, b, batch, *, n_tokens=None,
                    reserve_len=None):
        """Prefill + insert; returns (state, first token as an unsynced
        device scalar: the scheduler reads it when it needs it).
        ``reserve_len`` overrides the page reservation's prompt length:
        chunked prefill admits only the FIRST piece here but reserves for
        the whole prompt.  Where it engages (``_piece_width``) the
        admission replays the captured piece of the smallest admission
        width that holds the prompt, padded at its end."""
        self._touch_bank()
        S = _prompt_len(batch)
        toks = _host_tokens(batch["tokens"]) if set(batch) == {"tokens"} \
            else None
        W = None if toks is None else self._piece_width(state, "admit", S)
        pages = None
        if self.paged:
            plen = reserve_len if reserve_len is not None else S
            pages = self._sched_pages(b, plen, n_tokens)
        with trace.span("engine.prefill", rows=1, tokens=S,
                        device=self.device, graphed=int(W is not None)) as sp:
            if W is not None:
                self._build_pieces(state)
                inp = np.zeros((W + 1 + self.max_pages,), np.int32)
                inp[:S] = toks[0]
                inp[W] = S
                inp[W + 1:] = pages
                with trace.span("engine.prefill.forward"):
                    self._pieces.replay(("admit", W), state, int(b), inp)
                sp.mark()
                with trace.span("engine.prefill.insert"):
                    return self._pieces.store(("admit", W), state, int(b))
            self._graphs.stats["piece_eager"] += 1
            with trace.span("engine.prefill.forward"):
                row = self._prefill_row(batch)
            sp.mark()
            with trace.span("engine.prefill.insert"):
                state = _insert_row(state, int(b), row, pages=pages)
        return state, row.cur_token[0]

    def sched_extend(self, state, b, tokens, n_valid):
        """One chunked-prefill piece: run ``tokens (1, C)`` (tail pieces
        right-padded; ``n_valid`` real entries) through the causal verify
        path against row ``b``'s cache and splice the piece's KVs in at the
        row's offset.  Returns (state, the last real token as a device
        scalar: after the final piece it is the request's first
        emission).  Where it engages (``_piece_width``) the piece replays
        its captured graph."""
        self._touch_bank()
        C = int(tokens.shape[1])
        toks = _host_tokens(tokens)
        W = None if toks is None else self._piece_width(state, "extend", C)
        with trace.span("engine.extend", rows=1, tokens=int(n_valid),
                        device=self.device, graphed=int(W is not None)) as sp:
            if W is not None:
                self._build_pieces(state)
                inp = np.append(toks[0], np.int32(n_valid))
                with trace.span("engine.extend.forward"):
                    self._pieces.replay(("extend", W), state, int(b), inp)
                sp.mark()
                with trace.span("engine.extend.splice"):
                    return self._pieces.store(("extend", W), state, int(b))
            self._graphs.stats["piece_eager"] += 1
            return _extend_row(self.model, self.params, state, int(b),
                               torch.as_tensor(tokens, dtype=torch.int32,
                                               device=self.device),
                               int(n_valid), self._extend_tree(C), sp)

    # ---- the captured prefill calls (runtime/graphs.py::PieceGraphs) -----
    def sched_piece_width(self, C: int) -> None:
        """The scheduler's prefill piece width ``C`` (0: whole-prompt
        admission): the width of the captured chunked-prefill piece, and
        the largest captured admission."""
        self._piece_C = int(C)

    def _piece_width(self, state, kind: str, S: int) -> Optional[int]:
        """The width of the captured piece that lands a prefill call of
        ``S`` tokens (``kind`` "admit" or "extend"), or None where the call
        runs eagerly.  It engages on the graph path (not inside ``eager()``),
        for a chunked-prefill engine over a paged float pool (an int8
        pool's page scales arm at piece boundaries), under a scheduler
        piece width C: a piece of width C, an admission of at most C
        tokens.  An admission pads to the smallest admission width that
        holds it (a model with experts routes every choice of every token,
        the pad's too, so the pad changes no real token's output)."""
        C = self._piece_C
        kv = state.cache.kv
        if not (C and self._graphed and not _EAGER.depth
                and self.sched_chunked_ok and isinstance(kv, PagedKVCache)
                and not kv.quantized):
            return None
        if kind == "extend":
            return C if S == C else None
        return next((w for w in piece_widths(C) if S <= w), None)

    def _build_pieces(self, state) -> None:
        """Every piece of the piece width, on ``state``'s pool, unless they
        are built: at the first call that engages, and again after a new
        bank or width."""
        if not self._pieces.ready(state, self._piece_C):
            self._pieces.build(self._piece_fns(self._piece_C), state,
                               self._piece_C)

    def _piece_fns(self, C: int) -> dict:
        """Every piece of piece width ``C``: {(kind, width): ``Piece``}."""
        model, params = self.model, self.params
        out = {}
        for w in piece_widths(C):
            warm = np.zeros((w + 1 + self.max_pages,), np.int32)
            warm[w + 1:] = -1                  # no pages
            out[("admit", w)] = Piece(functools.partial(
                _admit_piece, model, params, self.heads, w), warm)
        out[("extend", C)] = Piece(functools.partial(
            _extend_piece, model, params, self._extend_tree(C), C),
            np.zeros((C + 1,), np.int32))
        return out

    def sched_reset(self, state, b):
        self._touch_bank()
        mask = np.zeros((int(state.cur_token.shape[0]),), bool)
        mask[b] = True
        with trace.span("engine.reset", rows=int(mask.sum())):
            return _reset_state_rows(state, mask)

    def sched_step(self, state, done, rem, K, eos_val):
        """One K-step chunk over the bank from the host's ``done``/``rem``.
        The chunk's tokens, counts, done mask and budgets come back in ONE
        device-to-host transfer; returns (state, done, rem, (toks (K, B,
        Dmax), ns (K, B))) with everything but the state as numpy."""
        with trace.span("engine.chunk", rows=len(done), k=int(K)):
            with trace.span("engine.chunk.h2d"):
                done = torch.as_tensor(done, dtype=torch.bool,
                                       device=self.device)
                rem = torch.as_tensor(rem, device=self.device)
            state, done, rem, toks, ns = self._run_chunk(
                K, self.strategy, state, done, rem, int(eos_val))
            B, D = toks.shape[1], toks.shape[2]
            # the boundary's ONE host sync: every value the scheduler reads
            host = torch.cat([toks.reshape(-1), ns.reshape(-1),
                              done.to(torch.int64), rem.to(torch.int64)])
            with trace.span("engine.chunk.wait"):
                host = host.cpu().numpy()  # torchlint: disable=T3 (the sync)
            trace.after_transfer(self._graphs.marks, self._graphs.tap)
        n = K * B
        return (state, host[n * (D + 1):n * (D + 1) + B] != 0, host[-B:],
                (host[:n * D].reshape(K, B, D),
                 host[n * D:n * (D + 1)].reshape(K, B)))

    @staticmethod
    def sched_emitted(raw):
        """Per-row token lists of one chunk's host raw block."""
        toks, ns = raw
        K, B = ns.shape
        out = [[] for _ in range(B)]
        for k in range(K):
            for b in range(B):
                m = int(ns[k, b])
                if m:
                    out[b].extend(int(x) for x in toks[k, b, :m])
        return out


# ===========================================================================
class BatchEngine(DecodeEngine):
    """Sequential baseline = ``DecodeEngine`` pinned to the width-1
    strategy (no draft)."""

    def __init__(self, model, params, *, max_len=512, window=0, chunk=8,
                 paged=False, page_size=16, pool_pages=None, kv_dtype=None):
        super().__init__(model, params,
                         strategy=DecodeStrategy.sequential(
                             params["embed"].device),
                         max_len=max_len, window=window, chunk=chunk,
                         paged=paged, page_size=page_size,
                         pool_pages=pool_pages, kv_dtype=kv_dtype)


class SpeculativeEngine(DecodeEngine):
    """Ghidorah speculative serving = ``DecodeEngine`` with a Medusa-draft
    strategy built from ``tree_spec``."""

    def __init__(self, model, heads, params, tree_spec: TreeSpec, *,
                 max_len=512, window=0, chunk=8, paged=False, page_size=16,
                 pool_pages=None, hcmp="inline", kv_dtype=None,
                 tree_kernel="dense"):
        super().__init__(model, params, heads=heads,
                         strategy=DecodeStrategy.medusa(
                             tree_spec, params["embed"].device),
                         max_len=max_len, window=window, chunk=chunk,
                         paged=paged, page_size=page_size,
                         pool_pages=pool_pages, hcmp=hcmp, kv_dtype=kv_dtype,
                         tree_kernel=tree_kernel)


def _stats(accepts, times):
    accepts = np.asarray(accepts)
    return {
        "acceptance_length": float(np.mean(accepts)) if accepts.size else 0.0,
        "steps": int(accepts.size),
        "step_times": times,
    }


def measure_acceptance(model, heads, params, tree_spec: TreeSpec, prompts,
                       n_tokens=64, *, max_len=512,
                       engine: Optional[DecodeEngine] = None) -> float:
    """Empirical acceptance length over a prompt set (ARCA's brute-force
    refinement evaluator and the Table-I measurement).

    Pass ``engine`` to reuse a constructed engine across candidate trees:
    the strategy is swapped with ``set_tree``, and same-shape trees share
    its captured step on the card (the tree is copied into the graph's
    static tree), so the evaluator does not capture per candidate."""
    if engine is None:
        engine = SpeculativeEngine(model, heads, params, tree_spec,
                                   max_len=max_len)
    else:
        engine.set_tree(tree_spec)
    als = []
    for batch in prompts:
        _, stats = engine.generate(batch, n_tokens)
        als.append(stats["acceptance_length"])
    return float(np.mean(als))
