"""Dense per-row and paged KV caches (counterpart of
``repro/runtime/cache.py``).

Dense (``KVCache``)
- K/V are stacked over layers: ``(L, B, S, Hkv, hd)``.  Every sequence
  owns a full ``S = max_len`` row; with a sliding window the row is a ring
  buffer: slot(p) = p % S.
- ``key_pos (B, S)`` holds the absolute position stored in each slot (-1 =
  empty), per sequence; ``pos (B,)`` counts the tokens processed so far per
  sequence.  Batched speculative decoding accepts a different number of
  draft tokens per sequence, so positions diverge across the batch and every
  write and mask below is per sequence.
- RoPE is applied to keys at write time with their absolute position.

Paged (``PagedKVCache``)
- One shared pool of fixed-size pages ``(L, n_pages + 1, page_size, Hkv,
  hd)``; page ``n_pages`` is a trash page: every masked, unreserved or
  overflowing write lands there, so a row never writes a page another row
  owns.  ``block_table (B, max_pages)`` maps logical page ``s // page_size``
  to a pool page (-1 = unreserved), with the dense ring's slot arithmetic.
- An int8 pool carries ``scale_k``/``scale_v (L, n_pages + 1, Hkv)``
  float32 per-page dequant scales: 0.0 = unarmed; the first write into a
  page arms it to amax/127 and the scale is then frozen (later writes
  saturate at +-127).  Dequant is ``code * scale``.

Recurrent state (``MambaState``, the hybrid family's Mamba2 layers)
- ``ssm (L, B, nh, hd, N)`` float32 and the conv tail ``conv (L, B, K-1,
  C)`` in the model's dtype, batch on axis 1 as in the KV stacks, with
  ``pos (B,)``.

xLSTM state (``XLSTMState``, the ssm family: no KV at all)
- ``layers``: a tuple of per-layer dicts of float32 state tensors (mLSTM
  ``C (B, nh, hd, hd)``, ``n``, ``m``; sLSTM ``c``, ``n``, ``h``, ``m``
  ``(B, d)``), batch on axis 0, with ``pos (B,)``.

Cross memory (the enc-dec family): ``cross_k``/``cross_v (L, B, Senc,
Hkv, hd)``, computed once at prefill and only read after it, batch on
axis 1.

The reference's jits donate the cache; here the K/V tensors (and the paged
pool) are updated in place, while ``key_pos``/``pos``, the block tables,
the int8 scales and the recurrent state are rebuilt, so a caller holding
the previous ``key_pos``/``pos`` can still restore them.  The continuous
scheduler's row surgery (``tile_rows``, ``blank_paged_rows``,
``reset_rows``, ``insert_rows``, ``slice_row``, ``write_row_at``) follows
the same rule (the cross memory, like K/V, is written in place); chunked
prefill (``slice_row``, ``write_row_at``) takes KV-only caches.  A cache
with no KV (xLSTM) has no capacity limit and no pages: the paged layout
leaves it as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.hcmp import sharding as shd


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
class PagedKVCache:
    """Block-table KV cache: one shared page pool (trash page last) and
    per-sequence tables.  ``window`` is always 0: sliding-window caches stay
    dense (the ring IS the window)."""
    pool_k: torch.Tensor        # (L, n_pages + 1, page_size, Hkv, hd)
    pool_v: torch.Tensor        # (L, n_pages + 1, page_size, Hkv, hd)
    block_table: torch.Tensor   # (B, max_pages) int32 pool page; -1 free
    key_pos: torch.Tensor       # (B, max_pages * page_size) int32; -1 empty
    pos: torch.Tensor           # (B,) int32 tokens processed so far
    scale_k: Optional[torch.Tensor] = None   # (L, n_pages + 1, Hkv) f32
    scale_v: Optional[torch.Tensor] = None   # (L, n_pages + 1, Hkv) f32
    page_size: int = 16
    window: int = 0

    @property
    def quantized(self) -> bool:
        return self.pool_k.dtype == torch.int8

    @property
    def max_len(self) -> int:
        """Logical row length (ring size): max_pages * page_size."""
        return self.key_pos.shape[1]

    @property
    def n_pages(self) -> int:
        """Reservable pages, the trash page excluded."""
        return self.pool_k.shape[1] - 1

    @property
    def max_pages(self) -> int:
        return self.block_table.shape[1]


@dataclasses.dataclass
class MambaState:
    ssm: torch.Tensor        # (L, B, nh, hd, N) float32
    conv: torch.Tensor       # (L, B, K-1, C) conv tail (C = di + 2N)
    pos: torch.Tensor        # (B,) int32


@dataclasses.dataclass
class XLSTMState:
    layers: tuple            # per-layer dict of float32 state (batch axis 0)
    pos: torch.Tensor        # (B,) int32


@dataclasses.dataclass
class Cache:
    """Decode-state cache of every family (unused fields None): the
    self-attention KV, the Mamba2 layers' and the xLSTM layers' recurrent
    state and the enc-dec cross memory ``(L, B, Senc, Hkv, hd)``."""
    kv: Optional[KVCache | PagedKVCache] = None
    mamba: Optional[MambaState] = None
    xlstm: Optional[XLSTMState] = None
    cross_k: Optional[torch.Tensor] = None
    cross_v: Optional[torch.Tensor] = None

    @property
    def pos(self) -> torch.Tensor:
        for c in (self.kv, self.mamba, self.xlstm):
            if c is not None:
                return c.pos
        raise ValueError("empty cache")


# --------------------------------------------------------------------------
def init_kv_cache(n_layers, batch, max_len, n_kv, head_dim, *, window=0,
                  dtype=torch.bfloat16, device="cuda", mesh=None) -> KVCache:
    """An empty dense cache; on a ``mesh`` its fields are DTensors laid out
    by the cache rules (``core/hcmp/sharding.py``: batch on the data axes,
    the sequence on ``model``), each rank allocating its own slice."""
    size = min(max_len, window) if window else max_len
    shape = (n_layers, batch, size, n_kv, head_dim)

    def full(name, shape, fill, dt):
        if mesh is not None:
            return shd.full(mesh, ("kv", name), shape, fill, dt)
        return torch.full(shape, fill, dtype=dt, device=device)

    return KVCache(
        k=full("k", shape, 0, dtype),
        v=full("v", shape, 0, dtype),
        key_pos=full("key_pos", (batch, size), -1, torch.int32),
        pos=full("pos", (batch,), 0, torch.int32),
        window=window,
    )


def init_paged_kv_cache(n_layers, batch, max_len, n_kv, head_dim, *,
                        page_size, n_pages, dtype=torch.bfloat16,
                        device="cuda") -> PagedKVCache:
    """Empty paged bank: zeroed pool (+1 trash page), all tables
    unreserved.  ``max_len`` is the logical per-row capacity (rounded up to
    whole pages).  ``dtype=torch.int8`` builds a quantized pool with zeroed
    (unarmed) scales, one distinct tensor for K and one for V."""
    max_pages = pages_for(max_len, page_size)
    shape = (n_layers, n_pages + 1, page_size, n_kv, head_dim)

    def scale():
        return (torch.zeros((n_layers, n_pages + 1, n_kv),
                            dtype=torch.float32, device=device)
                if dtype == torch.int8 else None)

    return PagedKVCache(
        pool_k=torch.zeros(shape, dtype=dtype, device=device),
        pool_v=torch.zeros(shape, dtype=dtype, device=device),
        block_table=torch.full((batch, max_pages), -1, dtype=torch.int32,
                               device=device),
        key_pos=torch.full((batch, max_pages * page_size), -1,
                           dtype=torch.int32, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
        scale_k=scale(), scale_v=scale(), page_size=page_size)


def pages_for(n_tokens, page_size) -> int:
    """Pages needed to hold ``n_tokens`` slots."""
    return -(-int(n_tokens) // int(page_size))


def page_bytes(n_layers, page_size, n_kv, head_dim, kv_dtype) -> int:
    """Device bytes of one pool page across all layers, K+V, including the
    per-page scales of an int8 pool."""
    elt = torch.empty((), dtype=kv_dtype).element_size()
    data = 2 * n_layers * page_size * n_kv * head_dim * elt
    scale = 2 * n_layers * n_kv * 4 if kv_dtype == torch.int8 else 0
    return data + scale


def kv_bytes_per_token(n_layers, n_kv, head_dim, kv_dtype, page_size) -> float:
    """Bytes per reservable token slot (K+V, all layers, amortized scale)."""
    return page_bytes(n_layers, page_size, n_kv, head_dim, kv_dtype) \
        / page_size


def pages_at_fixed_bytes(budget_bytes, n_layers, page_size, n_kv, head_dim,
                         kv_dtype) -> int:
    """Reservable pages a byte budget funds at ``kv_dtype``."""
    return int(budget_bytes) // page_bytes(n_layers, page_size, n_kv,
                                           head_dim, kv_dtype)


class PageAllocator:
    """Host-side free list over the pool's reservable page ids, handed out
    lowest-id-first so runs are deterministic.  Every page handed out is
    held until freed: ``available + outstanding == n_pages`` always holds
    (``conserved``), and freeing a page that is not held raises."""

    def __init__(self, n_pages: int):
        self.n_pages = int(n_pages)
        self._free = list(range(self.n_pages))   # kept sorted
        self._held = set()

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def outstanding(self) -> int:
        return len(self._held)

    @property
    def conserved(self) -> bool:
        return (len(self._free) + len(self._held) == self.n_pages
                and not self._held.intersection(self._free))

    def alloc(self, n: int) -> list:
        """Take exactly ``n`` pages; raises if the pool cannot supply them."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        pages, self._free = self._free[:n], self._free[n:]
        self._held.update(pages)
        return pages

    def alloc_upto(self, n: int) -> list:
        """Take ``min(n, available)`` pages (a partial reservation freezes
        at ``capacity_left`` instead of failing)."""
        return self.alloc(min(n, len(self._free)))

    def free(self, pages) -> None:
        for p in pages:
            p = int(p)
            if p < 0:
                continue
            if p not in self._held:
                raise RuntimeError(f"bad page free: {p}")
            self._held.discard(p)
            self._free.append(p)
        self._free.sort()


def _arm_and_quantize(src_flat, scale, flat_page, P):
    """Quantize one operand's writes under frozen-first-write page scales.

    src_flat: (L, N, Hkv, hd) float sources; scale: (L, P, Hkv), 0.0 =
    unarmed; flat_page: (N,) destination pool page per write (trash writes
    included).  Pages unarmed before this call arm to amax(|writes into the
    page|)/127 per (layer, head); armed pages keep their scale and later
    writes saturate.  Returns (codes (L, N, Hkv, hd) int8, new scale)."""
    src = src_flat.float()
    amax = src.abs().amax(dim=-1)                             # (L, N, Hkv)
    idx = flat_page.long()[None, :, None].expand_as(amax)
    page_amax = torch.zeros(scale.shape, dtype=torch.float32,
                            device=src.device).scatter_reduce_(
        1, idx, amax, "amax", include_self=False).clamp(min=0.0)
    new_scale = torch.where(scale > 0.0, scale, page_amax / 127.0)
    s_w = new_scale[:, flat_page.long()][..., None]           # (L, N, Hkv, 1)
    armed = s_w > 0.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.where(armed, torch.clamp(torch.round(
        src / torch.where(armed, s_w, 1.0)), -127.0, 127.0), 0.0)
    return q.to(torch.int8), new_scale


def _pool_scatter(pool_k, pool_v, tables, k_src, v_src, abs_pos, valid,
                  scale_k=None, scale_v=None):
    """Scatter per-sequence writes through block tables into the shared
    pool, IN PLACE (the reference donates the pool).

    pool_k/pool_v: (L, P, ps, Hkv, hd), P = n_pages + 1 (trash last);
    tables: (B, max_pages); k_src/v_src: (L, B, W, Hkv, hd); abs_pos/valid:
    (B, W); scale_k/scale_v: (L, P, Hkv) for an int8 pool, else None.

    Masked writes and writes on an unreserved table entry go to the last
    slot of the trash page, so a row never writes a page it does not own.
    Several of them may share that slot; an indexed store keeps an
    arbitrary one, which is harmless because the slot is never read.
    Returns (scale_k, scale_v, ok (B, W)); ``ok`` marks the writes that
    landed in real pages."""
    L, P, ps, Hkv, hd = pool_k.shape
    s_log = tables.shape[1] * ps
    logical = abs_pos.remainder(s_log)                        # (B, W)
    page = tables.gather(1, (logical // ps).long())
    ok = valid & (page >= 0)
    phys = torch.where(ok, page * ps + logical.remainder(ps), P * ps - 1)
    flat = phys.reshape(-1).long()
    k_flat = k_src.reshape(L, -1, Hkv, hd)
    v_flat = v_src.reshape(L, -1, Hkv, hd)
    if scale_k is not None:
        k_flat, scale_k = _arm_and_quantize(k_flat, scale_k, flat // ps, P)
        v_flat, scale_v = _arm_and_quantize(v_flat, scale_v, flat // ps, P)
    pool_k.view(L, P * ps, Hkv, hd)[:, flat] = k_flat.to(pool_k.dtype)
    pool_v.view(L, P * ps, Hkv, hd)[:, flat] = v_flat.to(pool_v.dtype)
    return scale_k, scale_v, ok


def _keypos_scatter(key_pos, abs_pos, ok):
    """Mark ``abs_pos`` at its logical slot where ``ok``; rejected writes go
    to a shed column past the row.  Returns a new (B, S_logical) tensor."""
    B, s_log = key_pos.shape
    col = torch.where(ok, abs_pos.remainder(s_log), s_log).long()
    kp = torch.nn.functional.pad(key_pos, (0, 1), value=-1)
    rows = torch.arange(B, device=key_pos.device)[:, None]
    kp[rows, col] = torch.where(ok, abs_pos, -1).to(torch.int32)
    return kp[:, :s_log].contiguous()


def _per_batch(start, batch, device):
    """A scalar or (B,) start position as a (B,) int32 tensor."""
    return torch.broadcast_to(torch.as_tensor(start, dtype=torch.int32,
                                              device=device), (batch,))


def paged_kv_write(kv: PagedKVCache, ks, vs, start) -> PagedKVCache:
    """Write S_new entries per sequence at [start_b, start_b + S_new)
    through the block table.  ks/vs: (L, B, S_new, Hkv, hd).  A run longer
    than one logical ring keeps only its tail, as the dense ring does."""
    B, s_new = ks.shape[1], ks.shape[2]
    start = _per_batch(start, B, kv.pos.device)
    s_log = kv.max_len
    if s_new >= s_log:
        ks, vs = ks[:, :, -s_log:], vs[:, :, -s_log:]
        start = start + (s_new - s_log)
        s_new = s_log
    abs_pos = start[:, None] + torch.arange(s_new, dtype=torch.int32,
                                            device=start.device)[None, :]
    valid = torch.ones(abs_pos.shape, dtype=torch.bool, device=start.device)
    sk, sv, ok = _pool_scatter(kv.pool_k, kv.pool_v, kv.block_table, ks, vs,
                               abs_pos, valid, kv.scale_k, kv.scale_v)
    return dataclasses.replace(
        kv, scale_k=sk, scale_v=sv,
        key_pos=_keypos_scatter(kv.key_pos, abs_pos, ok),
        pos=(start + s_new).to(torch.int32))


def paged_kv_commit(kv: PagedKVCache, k_new, v_new, accept_nodes, n_accept,
                    max_depth) -> PagedKVCache:
    """Write each sequence's accepted tree path through its block table.
    Writes past ``n_accept[b]``, and any write past a row's reservation,
    land in the trash page."""
    dev = kv.pos.device
    idx = torch.arange(max_depth, dtype=torch.int32, device=dev)
    rows = torch.arange(k_new.shape[1], device=dev)[:, None]
    nodes = accept_nodes.long()
    abs_pos = kv.pos[:, None] + idx[None, :]
    valid = idx[None, :] < n_accept[:, None]
    sk, sv, ok = _pool_scatter(kv.pool_k, kv.pool_v, kv.block_table,
                               k_new[:, rows, nodes], v_new[:, rows, nodes],
                               abs_pos, valid, kv.scale_k, kv.scale_v)
    return dataclasses.replace(
        kv, scale_k=sk, scale_v=sv,
        key_pos=_keypos_scatter(kv.key_pos, abs_pos, ok),
        pos=(kv.pos + n_accept).to(torch.int32))


def gather_pages(pool_layer, block_table):
    """One layer's logical (B, S_logical, Hkv, hd) view through the block
    table.  Unreserved entries read the trash page; their slots carry
    key_pos == -1, so every mask rejects them."""
    P, ps = pool_layer.shape[0], pool_layer.shape[1]
    t = torch.where(block_table < 0, P - 1, block_table).long()
    B, maxp = block_table.shape
    return pool_layer[t].reshape((B, maxp * ps) + tuple(pool_layer.shape[2:]))


def gather_pages_dequant(pool_layer, scale_layer, block_table):
    """``gather_pages`` of an int8 pool, dequantized to a float32 view with
    one layer's per-page scales ``scale_layer (P, Hkv)``;
    ``scale_layer=None`` is the verbatim gather of a float pool."""
    if scale_layer is None:
        return gather_pages(pool_layer, block_table)
    P, ps = pool_layer.shape[0], pool_layer.shape[1]
    t = torch.where(block_table < 0, P - 1, block_table).long()
    ck = pool_layer[t].float() * scale_layer[t][:, :, None, :, None]
    B, maxp = block_table.shape
    return ck.reshape((B, maxp * ps) + tuple(pool_layer.shape[2:]))


def paginate_cache(cache: Cache, tables, *, page_size, n_pages,
                   kv_dtype=None) -> Cache:
    """Convert a freshly prefilled DENSE cache (sized to the prompt) into
    the paged layout.  ``tables (B, max_pages)`` come from the host-side
    allocator.  Entries older than one logical ring are dropped.
    ``kv_dtype`` picks the pool dtype (default: the dense cache's own);
    ``torch.int8`` quantizes the prompt KV on the way in, arming each
    destination page's scale from the prefill write."""
    kv = cache.kv
    if kv is None or isinstance(kv, PagedKVCache):
        return cache
    if kv.window:
        raise ValueError("paged KV supports full attention only (window=0)")
    L, B, S, Hkv, hd = kv.k.shape
    dev = kv.k.device
    pool_dtype = kv.k.dtype if kv_dtype is None else kv_dtype
    s_log = tables.shape[1] * page_size
    shape = (L, n_pages + 1, page_size, Hkv, hd)
    pool_k = torch.zeros(shape, dtype=pool_dtype, device=dev)
    pool_v = torch.zeros(shape, dtype=pool_dtype, device=dev)
    scale = (torch.zeros((L, n_pages + 1, Hkv), dtype=torch.float32,
                         device=dev) if pool_dtype == torch.int8 else None)
    abs_pos = kv.key_pos                                      # (B, S)
    valid = (abs_pos >= 0) & (abs_pos >= kv.pos[:, None] - s_log)
    sk, sv, ok = _pool_scatter(pool_k, pool_v, tables, kv.k, kv.v, abs_pos,
                               valid, scale, scale)
    key_pos = _keypos_scatter(
        torch.full((B, s_log), -1, dtype=torch.int32, device=dev),
        abs_pos, ok)
    return dataclasses.replace(cache, kv=PagedKVCache(
        pool_k=pool_k, pool_v=pool_v, block_table=tables, key_pos=key_pos,
        pos=kv.pos, scale_k=sk, scale_v=sv, page_size=page_size))


def _zero_page_scales(scale, pages, mask):
    """Zero (un-arm) the per-page scales of the pool pages in ``pages``
    where ``mask`` holds; returns a new tensor.  scale: (L, P, Hkv); pages:
    int page ids (-1 = unreserved).  Non-targets redirect to the trash page,
    whose scale is never read."""
    P = scale.shape[1]
    tgt = torch.where(mask & (pages >= 0), pages, P - 1).reshape(-1).long()
    out = scale.clone()
    out[:, tgt] = 0.0
    return out


# --------------------------------------------------------------------------
# Per-row slot primitives of the continuous scheduler
# (runtime/continuous.py).  A batched cache is a bank of B independent rows;
# the scheduler admits sequences into rows and evicts them at chunk
# boundaries, and every helper below touches only the rows it names.  The
# non-KV leaves carry batch on axis 1 (Mamba ``ssm``/``conv``, the cross
# memory) or 0 (``pos``, the xLSTM states); ``_state_map`` maps a helper
# over them.
# --------------------------------------------------------------------------
def _set_row(t, row, value):
    """A copy of the small per-row tensor ``t`` with ``t[row] = value``."""
    out = t.clone()
    out[row] = value
    return out


def _mamba_map(fn, *states: MambaState) -> Optional[MambaState]:
    """``MambaState(fn(batch_axis, *leaves) per field)`` over states of one
    structure, or None when the first is None."""
    if states[0] is None:
        return None
    return MambaState(**{f: fn(axis, *(getattr(s, f) for s in states))
                         for f, axis in (("ssm", 1), ("conv", 1),
                                         ("pos", 0))})


def _state_map(fn, *caches: Cache, cross=None) -> dict:
    """The non-KV fields of caches of one structure, as ``Cache``
    keywords: ``fn(batch_axis, *leaves)`` over the recurrent leaves, and
    ``cross(*leaves)`` (default ``fn`` at axis 1) over the cross memory."""
    c = caches[0]
    xl = None
    if c.xlstm is not None:
        xl = XLSTMState(
            layers=tuple({k: fn(0, *(x.xlstm.layers[i][k] for x in caches))
                          for k in layer}
                         for i, layer in enumerate(c.xlstm.layers)),
            pos=fn(0, *(x.xlstm.pos for x in caches)))
    cross = cross or (lambda *ts: fn(1, *ts))
    return dict(
        mamba=_mamba_map(fn, *(x.mamba for x in caches)), xlstm=xl,
        **{f: None if getattr(c, f) is None
           else cross(*(getattr(x, f) for x in caches))
           for f in ("cross_k", "cross_v")})


def _kv_only(cache: Cache, what: str) -> None:
    if cache.mamba is not None or cache.xlstm is not None \
            or cache.cross_k is not None:
        raise ValueError(f"{what} supports KV-only caches (chunked prefill "
                         f"is attention-family only)")


def tile_rows(cache: Cache, batch: int) -> Cache:
    """Broadcast a batch-1 dense cache to ``batch`` identical rows (the
    scheduler bootstraps its resident bank once from the first admission)."""
    def rep(axis, a):
        return a.repeat_interleave(batch, dim=axis)

    kv = cache.kv
    if kv is not None:
        kv = KVCache(k=rep(1, kv.k), v=rep(1, kv.v),
                     key_pos=rep(0, kv.key_pos), pos=rep(0, kv.pos),
                     window=kv.window)
    return Cache(kv=kv, **_state_map(rep, cache))


def blank_paged_rows(row: Cache, batch: int, *, page_size, n_pages, max_len,
                     kv_dtype=None) -> Cache:
    """Paged bootstrap of the scheduler's resident bank from the first B=1
    dense-prefilled admission: an EMPTY shared pool of ``n_pages`` pages
    and ``batch`` unreserved rows, so no slot memory is spent on rows that
    are still free.  ``kv_dtype`` picks the pool dtype (default: the
    prefill's own; ``torch.int8`` = quantized pool).  The non-KV leaves
    are tiled (a row not yet admitted is masked); a cache with no KV
    (xLSTM) is tiled whole."""
    dkv = row.kv
    if dkv is None:
        return tile_rows(row, batch)
    L, _, _, Hkv, hd = dkv.k.shape
    return Cache(kv=init_paged_kv_cache(
        L, batch, max_len, Hkv, hd, page_size=page_size, n_pages=n_pages,
        dtype=dkv.k.dtype if kv_dtype is None else kv_dtype,
        device=dkv.k.device),
        **_state_map(lambda axis, a: a.repeat_interleave(batch, dim=axis),
                     row))


def reset_rows(cache: Cache, rows) -> Cache:
    """Clear the rows where ``rows (B,)`` (a bool tensor) holds: ``key_pos``
    -> -1 (every attention mask rejects the slot), ``pos`` -> 0, dense K/V
    and the cross memory zeroed in place, the recurrent state zeroed.  A
    freed row is inert until ``insert_rows`` installs a freshly prefilled
    sequence (a zeroed xLSTM stabilizer is not a decodable initial state:
    the admission's prefill sets it).

    Paged KV: the row's ``block_table`` entries drop to -1 (its pages go
    back to the allocator host-side) and any write the dead row still
    issues redirects to the trash page.  Quantized pools deliberately do
    NOT touch the freed pages' scales here: the dead row's table is stale
    bookkeeping (the scheduler releases pages at completion and batches row
    resets to the END of the boundary), so by reset time a freed page may
    already carry a new resident admitted earlier in the same boundary, and
    zeroing its just-armed scale would let the next decode write re-arm it
    from the wrong amax.  ``_paged_insert_row`` un-arms a reservation at
    the only sound point: reserve time, zero then arm."""
    kv = cache.kv
    rows = torch.as_tensor(rows, dtype=torch.bool, device=cache.pos.device)

    def zero(axis, a):
        shape = [1] * a.dim()
        shape[axis] = rows.shape[0]
        return torch.where(rows.reshape(shape), torch.zeros_like(a), a)

    def zero_cross(t):
        t[:, torch.nonzero(rows).reshape(-1)] = 0
        return t

    state = _state_map(zero, cache, cross=zero_cross)
    if kv is None:
        return Cache(**state)
    key_pos = torch.where(rows[:, None], -1, kv.key_pos).to(torch.int32)
    pos = torch.where(rows, 0, kv.pos).to(torch.int32)
    if isinstance(kv, PagedKVCache):
        return Cache(kv=dataclasses.replace(
            kv, key_pos=key_pos, pos=pos,
            block_table=torch.where(rows[:, None], -1,
                                    kv.block_table).to(torch.int32)),
            **state)
    idx = torch.nonzero(rows).reshape(-1)
    kv.k[:, idx] = 0
    kv.v[:, idx] = 0
    return Cache(kv=KVCache(k=kv.k, v=kv.v, key_pos=key_pos, pos=pos,
                            window=kv.window), **state)


def insert_rows(cache: Cache, row: int, src: Cache, *, pages=None) -> Cache:
    """Copy row 0 of a batch-1 cache ``src`` into row ``row`` of ``cache``
    (admission: the new request's B=1 prefill takes over the slot).  Dense
    K/V and the cross memory are written in place.

    When ``cache`` is paged, ``src`` is still DENSE (admission prefills at
    B=1 in the dense layout) and ``pages (max_pages,)``, the row's fresh
    reservation padded with -1, must be given: the prompt KV is scattered
    through it into the shared pool.  A cache with no KV ignores
    ``pages``."""
    kv = cache.kv

    def put(axis, big, small):
        out = big.clone()
        out.select(axis, row).copy_(small.select(axis, 0))
        return out

    def put_cross(big, small):
        big[:, row] = small[:, 0].to(big.dtype)
        return big

    state = _state_map(put, cache, src, cross=put_cross)
    if kv is None:
        return Cache(**state)
    if isinstance(kv, PagedKVCache):
        if pages is None:
            raise ValueError("paged insert_rows needs the row's pages")
        return Cache(kv=_paged_insert_row(kv, row, src.kv, pages), **state)
    skv = src.kv
    kv.k[:, row] = skv.k[:, 0].to(kv.k.dtype)
    kv.v[:, row] = skv.v[:, 0].to(kv.v.dtype)
    return Cache(kv=KVCache(k=kv.k, v=kv.v,
                            key_pos=_set_row(kv.key_pos, row, skv.key_pos[0]),
                            pos=_set_row(kv.pos, row, skv.pos[0]),
                            window=kv.window), **state)


def _paged_insert_row(kv: PagedKVCache, row: int, dkv: KVCache, pages
                      ) -> PagedKVCache:
    """Scatter a dense B=1 prefill into ``row``'s fresh page reservation.

    Quantized pools un-arm the fresh reservation's scales FIRST, so the
    prompt write re-arms them from the new resident's own amax.  This is
    the only place recycled-page scales are cleared (``reset_rows`` must not
    touch pool scales; see its docstring)."""
    pages = torch.as_tensor(pages, dtype=torch.int32, device=kv.pos.device)
    s_log = kv.max_len
    abs_pos = dkv.key_pos[0]                                  # (S_dense,)
    valid = (abs_pos >= 0) & (abs_pos >= dkv.pos[0] - s_log)
    sk, sv = kv.scale_k, kv.scale_v
    if sk is not None:
        every = torch.ones(pages.shape, dtype=torch.bool, device=pages.device)
        sk = _zero_page_scales(sk, pages, every)
        sv = _zero_page_scales(sv, pages, every)
    sk, sv, ok = _pool_scatter(kv.pool_k, kv.pool_v, pages[None], dkv.k,
                               dkv.v, abs_pos[None], valid[None], sk, sv)
    kp_row = _keypos_scatter(
        torch.full((1, s_log), -1, dtype=torch.int32, device=pages.device),
        abs_pos[None], ok)[0]
    return dataclasses.replace(
        kv, scale_k=sk, scale_v=sv,
        block_table=_set_row(kv.block_table, row, pages),
        key_pos=_set_row(kv.key_pos, row, kp_row),
        pos=_set_row(kv.pos, row, dkv.pos[0]))


def slice_row(cache: Cache, row: int) -> Cache:
    """B=1 view of one bank row (the attention context a chunked-prefill
    piece extends).  Paged caches share the pool by reference: only the
    row's table, ``key_pos`` and ``pos`` are sliced, so the view costs
    O(max_pages), not a pool copy; dense K/V are views of the bank.
    KV-only caches: recurrent families admit whole prompts."""
    _kv_only(cache, "slice_row")
    kv = cache.kv
    r = slice(row, row + 1)
    if isinstance(kv, PagedKVCache):
        return Cache(kv=dataclasses.replace(
            kv, block_table=kv.block_table[r], key_pos=kv.key_pos[r],
            pos=kv.pos[r]))
    return Cache(kv=KVCache(k=kv.k[:, r], v=kv.v[:, r], key_pos=kv.key_pos[r],
                            pos=kv.pos[r], window=kv.window))


def write_row_at(cache: Cache, row: int, ks, vs, start, n_valid) -> Cache:
    """Partial-row insert at an offset (chunked prefill): write the first
    ``n_valid`` of ``ks/vs (L, W, Hkv, hd)`` into row ``row`` at absolute
    positions [start, start + n_valid) and advance only that row's ``pos``.

    Dense rows take a masked ring write (entries past ``n_valid``, the tail
    piece's padding, leave their slots as they were); paged rows scatter
    through the row's block table, padding into the trash page.  Requires
    W <= the row's logical length (piece slots must not alias).  KV-only
    caches, as ``slice_row``."""
    _kv_only(cache, "write_row_at")
    kv = cache.kv
    dev = kv.pos.device
    W = ks.shape[1]
    idx = torch.arange(W, dtype=torch.int32, device=dev)
    valid = idx < n_valid
    abs_pos = torch.as_tensor(start, dtype=torch.int32, device=dev) + idx
    pos = _set_row(kv.pos, row, abs_pos[0] + n_valid)
    if isinstance(kv, PagedKVCache):
        sk, sv, ok = _pool_scatter(
            kv.pool_k, kv.pool_v, kv.block_table[row:row + 1], ks[:, None],
            vs[:, None], abs_pos[None], valid[None], kv.scale_k, kv.scale_v)
        kp_row = _keypos_scatter(kv.key_pos[row:row + 1], abs_pos[None],
                                 ok)[0]
        return Cache(kv=dataclasses.replace(
            kv, scale_k=sk, scale_v=sv,
            key_pos=_set_row(kv.key_pos, row, kp_row), pos=pos))
    slots = abs_pos.remainder(kv.max_len).long()
    m = valid[None, :, None, None]
    for cur, new in ((kv.k, ks), (kv.v, vs)):
        cur[:, row, slots] = torch.where(m, new.to(cur.dtype),
                                         cur[:, row, slots])
    kp = kv.key_pos[row, slots]
    key_pos = kv.key_pos.clone()
    key_pos[row, slots] = torch.where(valid, abs_pos, kp)
    return Cache(kv=KVCache(k=kv.k, v=kv.v, key_pos=key_pos, pos=pos,
                            window=kv.window))


# --------------------------------------------------------------------------
def _ring_match(abs_pos, valid, size, ar=None):
    """Per-slot source index for a masked ring write, batched over rows.

    abs_pos: (B, D) absolute positions being written; valid: (B, D) write
    mask.  Returns (written (B, n), src (B, n)) over the n ring slots
    ``ar`` (all ``size`` of them by default; a rank's sequence shard
    otherwise): slot ar[s] of row b takes entry src[b, s] iff
    written[b, s].  Duplicate slots (a write run longer than the ring)
    resolve to the LAST write, as in the reference.
    """
    D = abs_pos.shape[1]
    slots = abs_pos.remainder(size)
    if ar is None:
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
    A sequence-sharded cache (DTensors) writes each rank's slice on that
    rank (``_sharded_write``).
    """
    if shd.is_dtensor(kv.k):
        return _sharded_write(_ring_write_slice, kv, sel_k, sel_v, abs_pos,
                              valid)
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


def _ring_write_slice(k, v, key_pos, sel_k, sel_v, abs_pos, valid, *, size,
                      off):
    """``_ring_write`` on the ring slots [off, off + n) that one rank's
    ``k``, ``v`` (L, B, n, Hkv, hd) and ``key_pos`` (B, n) hold.  An entry
    bound for a slot outside them is pointed at the nearest slot inside
    and carries that slot's value, so it changes nothing."""
    n = k.shape[2]
    written, src = _ring_match(                               # (B, n)
        abs_pos, valid, size, off + torch.arange(n, device=k.device))
    local = (abs_pos.remainder(size) - off).clamp(0, n - 1).long()  # (B, D)
    w_at = written.gather(1, local)                           # (B, D)
    src_at = src.gather(1, local)                             # (B, D)
    rows = torch.arange(local.shape[0], device=local.device)[:, None]
    m = w_at[None, :, :, None, None]
    for cur, sel in ((k, sel_k), (v, sel_v)):
        picked = sel[:, rows, src_at].to(cur.dtype)           # (L, B, D, ...)
        cur[:, rows, local] = torch.where(m, picked, cur[:, rows, local])
    kp_src = abs_pos.gather(1, src.long()).to(torch.int32)
    return torch.where(written, kp_src, key_pos)


def _sharded_write(write, kv, *entries, **kw):
    """Run ``write(k, v, key_pos, *entries, size=, off=, **kw)`` on each
    rank's slice of a sequence-sharded cache: the entries ((L, B, D, ...)
    KVs or (B, D) positions and masks; plain ones are alike on every rank)
    reach every rank split over the batch as the cache is and whole along
    the sequence, and each rank writes the slots it holds.  Returns
    key_pos."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = kv.k.device_mesh
    off = shd.shard_offset(kv.k, dim=2)
    rows = [p == Shard(0) for p in kv.key_pos.placements]
    entries = tuple(shd.replicated(t, mesh) for t in entries)
    want = tuple([Shard(0 if t.dim() == 2 else 1) if r else Replicate()
                  for r in rows] for t in entries)

    def on_slice(k, v, key_pos, *entries):
        return write(k, v, key_pos, *entries, size=kv.max_len, off=off, **kw)

    cache = (kv.k, kv.v, kv.key_pos)
    return local_map(on_slice, out_placements=list(kv.key_pos.placements),
                     in_placements=tuple(t.placements for t in cache) + want,
                     device_mesh=mesh, redistribute_inputs=True)(
        *cache, *entries)


def _run_write_slice(k, v, key_pos, ks, vs, *, size, off, first):
    """Prefill's contiguous write of S <= size entries at positions
    [first, first + S) (every row alike) into the ring slots [off, off +
    n) this slice holds: each slot takes the entry whose position lands
    on it, or keeps its content."""
    n, S = k.shape[2], ks.shape[2]
    idx = (off + torch.arange(n, device=k.device) - first).remainder(size)
    hit = idx < S                                             # (n,)
    idx = idx.clamp(max=S - 1)
    for cur, src in ((k, ks), (v, vs)):
        cur.copy_(torch.where(hit[None, None, :, None, None],
                              src.index_select(2, idx).to(cur.dtype), cur))
    return torch.where(hit[None, :], (first + idx).to(torch.int32), key_pos)


def bulk_write(kv: KVCache, ks, vs, start) -> KVCache:
    """Write (L, B, S, Hkv, hd) KVs at [start_b, start_b + S) per sequence
    (counterpart of ``repro/models/transformer.py::_bulk_write``).

    ``start`` is an int (prefill: uniform positions) or a (B,) tensor of
    per-sequence positions (decode after speculative steps).  The ring keeps
    the tail when S exceeds the cache size.  A paged cache writes through
    its block table (``paged_kv_write``).
    """
    if isinstance(kv, PagedKVCache):
        return paged_kv_write(kv, ks, vs, start)
    B, S = ks.shape[1], ks.shape[2]
    size = kv.max_len
    off = 0
    if S >= size:                     # only the last `size` entries survive
        ks, vs = ks[:, :, -size:], vs[:, :, -size:]
        off, S = S - size, size
    dev = kv.key_pos.device

    if isinstance(start, int) and shd.is_dtensor(kv.k):
        key_pos = _sharded_write(_run_write_slice, kv, ks, vs,
                                 first=start + off)
        return KVCache(k=kv.k, v=kv.v, key_pos=key_pos,
                       pos=shd.full(kv.k.device_mesh, ("kv", "pos"), (B,),
                                    start + off + S, torch.int32),
                       window=kv.window)
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
    valid = torch.ones_like(abs_pos, dtype=torch.bool)
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
    advances by n_accept[b].  A paged cache commits through its block
    table (``paged_kv_commit``).
    """
    if isinstance(kv, PagedKVCache):
        return paged_kv_commit(kv, k_new, v_new, accept_nodes, n_accept,
                               max_depth)
    dev = kv.key_pos.device
    idx = torch.arange(max_depth, dtype=torch.int32, device=dev)
    abs_pos = kv.pos[:, None] + idx[None, :]                  # (B, Dmax)
    valid = idx[None, :] < n_accept[:, None]

    def path(t, nodes):                       # (L, B, W, ...) -> (L, B, D, ...)
        rows = torch.arange(nodes.shape[0], device=nodes.device)[:, None]
        return t[:, rows, nodes.long()]

    key_pos = _ring_write(
        kv, *(shd.per_row(path, t, accept_nodes, batch_dim=1,
                          out_batch_dim=1) for t in (k_new, v_new)),
        abs_pos, valid)
    return KVCache(k=kv.k, v=kv.v, key_pos=key_pos,
                   pos=(kv.pos + n_accept).to(torch.int32), window=kv.window)


_UNBOUNDED = 1 << 30


def capacity_left(cache: Cache) -> torch.Tensor:
    """(B,) decode slots left before a full (window=0) KV ring would wrap
    past capacity and silently overwrite its oldest entries.  Sliding-window
    caches wrap by design and report an effectively unbounded budget; the
    chunk driver folds this into its done mask so a row freezes instead of
    corrupting its own attention.  A paged row counts the slots of its
    page reservation: reserved pages times page size, minus ``pos``.  A
    cache with no KV (xLSTM: O(1) state in the context) is unbounded."""
    kv = cache.kv
    if isinstance(kv, PagedKVCache):
        n_alloc = (kv.block_table >= 0).sum(dim=1).to(torch.int32)
        return n_alloc * kv.page_size - kv.pos
    if kv is None or kv.window:
        pos = cache.pos
        return torch.full(pos.shape, _UNBOUNDED, dtype=torch.int32,
                          device=pos.device)
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
