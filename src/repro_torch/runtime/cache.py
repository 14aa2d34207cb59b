"""Dense per-row KV cache (counterpart of the dense half of
``repro/runtime/cache.py``).

- K/V are stacked over layers: ``(L, B, S, Hkv, hd)``.  Every sequence
  owns a full ``S = max_len`` row; with a sliding window the row is a ring
  buffer: slot(p) = p % S.
- ``key_pos (B, S)`` holds the absolute position stored in each slot (-1 =
  empty), per sequence; ``pos (B,)`` counts the tokens processed so far per
  sequence.  Batched speculative decoding accepts a different number of
  draft tokens per sequence, so positions diverge across the batch and every
  write and mask below is per sequence.
- RoPE is applied to keys at write time with their absolute position.

The reference's jits donate the cache; here the K/V tensors are updated in
place and ``key_pos``/``pos`` (a few bytes per row) are rebuilt, so a
caller holding the previous ``key_pos``/``pos`` can still restore them.
The paged pool (``PagedKVCache``) comes with a later slice (ROADMAP A7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # (L, B, S, Hkv, hd)
    v: torch.Tensor          # (L, B, S, Hkv, hd)
    key_pos: torch.Tensor    # (B, S) int32 absolute position per slot; -1 empty
    pos: torch.Tensor        # (B,) int32 tokens processed so far per sequence
    window: int = 0          # 0 = full attention; >0 = sliding window

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class Cache:
    """Decode-state cache.  This slice ports the self-attention KV only;
    the recurrent and cross-attention states come with ROADMAP A11."""
    kv: Optional[KVCache] = None

    @property
    def pos(self) -> torch.Tensor:
        if self.kv is None:
            raise ValueError("empty cache")
        return self.kv.pos


# --------------------------------------------------------------------------
def init_kv_cache(n_layers, batch, max_len, n_kv, head_dim, *, window=0,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    size = min(max_len, window) if window else max_len
    shape = (n_layers, batch, size, n_kv, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        key_pos=torch.full((batch, size), -1, dtype=torch.int32,
                           device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
        window=window,
    )


def _ring_match(abs_pos, valid, size):
    """Per-slot source index for a masked ring write, batched over rows.

    abs_pos: (B, D) absolute positions being written; valid: (B, D) write
    mask.  Returns (written (B, S), src (B, S)): slot s of row b takes entry
    src[b, s] iff written[b, s].  Duplicate slots (a write run longer than
    the ring) resolve to the LAST write, as in the reference.
    """
    D = abs_pos.shape[1]
    slots = abs_pos.remainder(size)
    ar = torch.arange(size, device=abs_pos.device)
    match = (ar[None, :, None] == slots[:, None, :]) & valid[:, None, :]
    written = match.any(dim=2)
    src = (D - 1) - torch.argmax(match.flip(2).to(torch.int32), dim=2)
    return written, src


def _ring_write(kv, sel_k, sel_v, abs_pos, valid):
    """Masked per-row ring write of D entries per row.

    sel_k/sel_v: (L, B, D, Hkv, hd) entries; abs_pos/valid: (B, D).
    Returns the new key_pos; K/V are written in place.  The explicit
    (written, src) map decides every touched slot, so the write below never
    depends on the order of a scatter: each of the D touched slots receives
    the value the map assigns to that SLOT (its last valid writer, or its
    current content), and entries that share a slot carry identical values.
    """
    size = kv.max_len
    written, src = _ring_match(abs_pos, valid, size)          # (B, S)
    slots = abs_pos.remainder(size).long()                    # (B, D)
    w_at = written.gather(1, slots)                           # (B, D)
    src_at = src.gather(1, slots)                             # (B, D)
    rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
    m = w_at[None, :, :, None, None]
    for cur, sel in ((kv.k, sel_k), (kv.v, sel_v)):
        picked = sel[:, rows, src_at].to(cur.dtype)           # (L, B, D, ...)
        cur[:, rows, slots] = torch.where(m, picked, cur[:, rows, slots])
    kp_src = abs_pos.gather(1, src.long()).to(torch.int32)
    return torch.where(written, kp_src, kv.key_pos)


def bulk_write(kv: KVCache, ks, vs, start) -> KVCache:
    """Write (L, B, S, Hkv, hd) KVs at [start_b, start_b + S) per sequence
    (counterpart of ``repro/models/transformer.py::_bulk_write``).

    ``start`` is an int (prefill: uniform positions) or a (B,) tensor of
    per-sequence positions (decode after speculative steps).  The ring keeps
    the tail when S exceeds the cache size.
    """
    B, S = ks.shape[1], ks.shape[2]
    size = kv.max_len
    off = 0
    if S >= size:                     # only the last `size` entries survive
        ks, vs = ks[:, :, -size:], vs[:, :, -size:]
        off, S = S - size, size
    dev = kv.key_pos.device

    if isinstance(start, int):
        # uniform positions: one contiguous ring write shared by the whole
        # batch; the S slots are distinct because S <= size here
        abs_pos = start + off + torch.arange(S, dtype=torch.int32, device=dev)
        slots = abs_pos.remainder(size).long()
        kv.k[:, :, slots] = ks.to(kv.k.dtype)
        kv.v[:, :, slots] = vs.to(kv.v.dtype)
        key_pos = kv.key_pos.clone()
        key_pos[:, slots] = abs_pos
        return KVCache(k=kv.k, v=kv.v, key_pos=key_pos,
                       pos=torch.full((B,), start + off + S,
                                      dtype=torch.int32, device=dev),
                       window=kv.window)

    abs_pos = (start[:, None] + off
               + torch.arange(S, dtype=torch.int32, device=dev)[None, :])
    valid = torch.ones(abs_pos.shape, dtype=torch.bool, device=dev)
    key_pos = _ring_write(kv, ks, vs, abs_pos, valid)
    return KVCache(k=kv.k, v=kv.v, key_pos=key_pos,
                   pos=(start + off + S).to(torch.int32), window=kv.window)


def kv_commit(kv: KVCache, k_new, v_new, accept_nodes, n_accept,
              max_depth) -> KVCache:
    """Write each sequence's accepted tree path into its ring buffer.

    k_new/v_new: (L, B, W, Hkv, hd) uncommitted tree KVs;
    accept_nodes: (B, Dmax) node ids of the accepted chain (padded);
    n_accept: (B,) accepted tokens per sequence (0..Dmax).
    Slots beyond n_accept[b] keep their previous contents, and ``pos``
    advances by n_accept[b].
    """
    dev = kv.key_pos.device
    idx = torch.arange(max_depth, dtype=torch.int32, device=dev)
    abs_pos = kv.pos[:, None] + idx[None, :]                  # (B, Dmax)
    valid = idx[None, :] < n_accept[:, None]
    rows = torch.arange(k_new.shape[1], device=dev)[:, None]
    nodes = accept_nodes.long()
    key_pos = _ring_write(kv, k_new[:, rows, nodes], v_new[:, rows, nodes],
                          abs_pos, valid)
    return KVCache(k=kv.k, v=kv.v, key_pos=key_pos,
                   pos=(kv.pos + n_accept).to(torch.int32), window=kv.window)


_UNBOUNDED = 1 << 30


def capacity_left(cache: Cache) -> torch.Tensor:
    """(B,) decode slots left before a full (window=0) KV ring would wrap
    past capacity and silently overwrite its oldest entries.  Sliding-window
    caches wrap by design and report an effectively unbounded budget; the
    chunk driver folds this into its done mask so a row freezes instead of
    corrupting its own attention."""
    kv = cache.kv
    if kv.window:
        return torch.full(kv.pos.shape, _UNBOUNDED, dtype=torch.int32,
                          device=kv.pos.device)
    return kv.max_len - kv.pos


def batched_decode_mask(key_pos, q_pos, window):
    """Per-batch validity mask (B, W, S).

    key_pos: (B, S) absolute positions per slot; q_pos: (B, W) absolute
    query positions (they differ per sequence once acceptance diverges).
    """
    kp = key_pos[:, None, :]
    qp = q_pos[:, :, None]
    ok = (kp >= 0) & (kp <= qp)
    if window:
        ok &= kp > qp - window
    return ok


def prefill_mask(seq_len, window, device=None):
    """Causal (optionally windowed) (S, S) mask for prefill."""
    q = torch.arange(seq_len, device=device)[:, None]
    k = torch.arange(seq_len, device=device)[None, :]
    m = k <= q
    if window:
        m &= k > q - window
    return m
