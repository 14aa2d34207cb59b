"""Public kernel entry points with the model-side signatures (counterpart
of ``repro/kernels/ops.py``): they turn ``pos``/``tree_depth``/``window``
into the kernel's per-query ``q_pos``/``lo`` rows and call the wrapper,
which runs the plain version for CPU tensors and the CUDA kernel for CUDA
tensors.  A fake tensor (the dry run) goes through the wrapper's custom op
(``registered.py``), which gives its shape and its FLOP count and
launches nothing.  DTensor inputs (``core/hcmp/sharding.py``) take
``_sharded_tree_attention`` below.

The paged entry points pass a float pool's missing scales on as ``None``
(the reference's ``_pool_scales`` makes all-ones tensors instead): the
kernel then skips the scale reads and multiplies by 1.0, so the result is
exact either way.
"""
from __future__ import annotations

import torch

from repro_torch.core.hcmp import sharding as shd
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import registered
from repro_torch.kernels import tree_partial as _tree
from repro_torch.kernels.verify_attention import verify_attention


def wrappers() -> dict:
    """The port's kernel wrappers by name: each counts its launches in
    ``.launches`` (on a CPU tensor a wrapper runs its plain version and
    counts nothing)."""
    return {"verify_attention": verify_attention,
            "paged_tree_attention": _paged.paged_tree_attention,
            "paged_cache_attention": _paged.paged_cache_attention,
            "sparse_tree_attention_partial":
                _tree.sparse_tree_attention_partial,
            "sparse_tree_attention": _tree.sparse_tree_attention}


def _call(wrapper, op, *args):
    """A fake tensor takes the custom op, a real one the wrapper."""
    return op(*args) if registered.is_fake(args[0]) else wrapper(*args)


def _query_pos(q, pos, tree_depth):
    """(B, W) int32 absolute position of every tree query: ``pos`` (an int
    or (B,)) plus the node's depth."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    pos_b = torch.broadcast_to(pos.to(torch.int32), (q.shape[0],))
    return (pos_b[:, None] + tree_depth[None, :]).to(torch.int32)


def tree_attention(q, ck, cv, k_new, v_new, key_pos, pos, tree_depth,
                   tree_mask, *, window=0):
    """``pos`` is an int or (B,) and ``key_pos`` (S,) or (B, S): sequences
    sit at different absolute positions once batched speculative commits
    diverge, so the kernel takes per-batch ``q_pos``/``lo`` rows."""
    B, S = q.shape[0], ck.shape[1]
    key_pos_b = torch.broadcast_to(key_pos, (B, S)).contiguous()
    q_pos = _query_pos(q, pos, tree_depth)                     # (B, W)
    if window:
        lo = q_pos - window
    else:
        lo = torch.full_like(q_pos, -1)
    args = (q, ck, cv, k_new, v_new, key_pos_b, q_pos, lo, tree_mask)
    if shd.is_dtensor(q):
        return _sharded_tree_attention(*args)
    return _call(verify_attention, registered.verify_attention, *args)


def decode_attention(q, ck, cv, k_new, v_new, key_pos, pos, *, window=0):
    """Plain decode = W=1 tree."""
    dev = q.device
    return tree_attention(q, ck, cv, k_new, v_new, key_pos, pos,
                          torch.zeros((1,), dtype=torch.int32, device=dev),
                          torch.ones((1, 1), dtype=torch.bool, device=dev),
                          window=window)


def paged_tree_attention(q, pool_k, pool_v, k_new, v_new, block_table,
                         key_pos, pos, tree_depth, tree_mask, *,
                         scale_k=None, scale_v=None):
    """Paged verify: ``pool_k/pool_v`` are ONE layer's shared pool
    ``(n_pages + 1, ps, Hkv, hd)`` (trash page last), ``scale_k/scale_v
    (n_pages + 1, Hkv)`` an int8 pool's scales (None = float pool).  Paged
    caches take no window (the ring IS the window, so they stay dense)."""
    q_pos = _query_pos(q, pos, tree_depth)
    return _call(_paged.paged_tree_attention, registered.paged_tree_attention,
                 q, pool_k, pool_v, scale_k, scale_v, k_new, v_new,
                 block_table, key_pos, q_pos, torch.full_like(q_pos, -1),
                 tree_mask)


def paged_cache_attention(q, pool_k, pool_v, block_table, key_pos, pos,
                          tree_depth, *, scale_k=None, scale_v=None):
    """Cache-only half of the split verify (``tree_kernel="sparse"``): the
    page walk without the tree tile, as ``(o, m, l)`` merge partials."""
    q_pos = _query_pos(q, pos, tree_depth)
    return _call(_paged.paged_cache_attention,
                 registered.paged_cache_attention, q, pool_k, pool_v,
                 scale_k, scale_v, block_table, key_pos, q_pos,
                 torch.full_like(q_pos, -1))


def sparse_tree_attention_partial(q, k_new, v_new, tree_mask):
    """Tree half of the split verify: ``(o, m, l)`` partials of the W x W
    masked tree attention, merged with ``paged_cache_attention``'s."""
    return _tree.sparse_tree_attention_partial(q, k_new, v_new, tree_mask)


def sparse_tree_attention(q, k_new, v_new, tree_mask):
    """The W x W tree-correlation attention alone, normalized (the Fig. 10b
    study's block-masked kernel; counterpart of ``repro/kernels/ops.py::
    sparse_tree_attention``): a CUDA tensor launches the kernel, a CPU
    tensor runs its plain version."""
    return _tree.sparse_tree_attention(q, k_new, v_new, tree_mask)


# --------------------------------------------------------------------------
# DTensor inputs: the sequence-sharded cache
# --------------------------------------------------------------------------
def _cache_pages(n):
    """The page size a local cache slice of ``n`` slots is cut into: the
    largest of 16, 8, ..., 1 that divides it."""
    ps = 16
    while n % ps:
        ps //= 2
    return ps


def _local_cache_partial(q, ck, cv, key_pos, q_pos, lo):
    """One shard's ``(o, m, l)`` over its slice of a dense cache, each with
    a leading axis of 1 for the stack of shards.  The slice (B, S_l, Hkv,
    hd) is read in place as a pool of pages (row b's pages numbered b *
    S_l / ps on), so B3's page walk, the cache-only kernel, computes it."""
    B, S = ck.shape[:2]
    ps = _cache_pages(S)
    pages = S // ps
    pool_k = ck.reshape(B * pages, ps, *ck.shape[2:])
    pool_v = cv.reshape(B * pages, ps, *cv.shape[2:])
    table = torch.arange(B * pages, dtype=torch.int32,
                         device=q.device).reshape(B, pages)
    o, m, l = _call(_paged.paged_cache_attention,
                    registered.paged_cache_attention, q, pool_k, pool_v,
                    None, None, table, key_pos, q_pos, lo)
    return o[None], m[None], l[None]


def _tree_partial(q, k_new, v_new, tree_mask):
    return _call(_tree.sparse_tree_attention_partial, registered.tree_partial,
                 q, k_new, v_new, tree_mask)


def _sharded_tree_attention(q, ck, cv, k_new, v_new, key_pos, q_pos, lo,
                            tree_mask):
    """Tree attention over DTensors: the batch may be split on any mesh
    dim (``Shard(0)`` of q, ``Shard(0)`` of the cache), the cache's
    sequence (``Shard(1)`` of ck, cv, key_pos) on others; nothing else may
    be split.  Where no mesh dim of more than one rank splits the
    sequence, every rank holds its rows' whole cache and runs the fused
    kernel (B1) on them.  Otherwise each rank computes its cache slice's
    unnormalized partial (B3) and the tree's (B4; every rank of a
    sequence group the same), and the Eq.-1 online softmax merges them
    across the group: an all-reduce of m (max), then of l and o (sums),
    B x W x Hq x (hd + 2) floats a rank.  The cache is never gathered."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    # the tree's own tensors are the same on every rank; a pending sum is
    # reduced before the softmax (a partial placement is not a split)
    tree_mask = shd.replicated(tree_mask, mesh)
    q, k_new, v_new = (shd.reduced(t) for t in (q, k_new, v_new))
    args = (q, ck, cv, k_new, v_new, key_pos, q_pos, lo, tree_mask)
    seq = [i for i, p in enumerate(ck.placements) if p == Shard(1)]
    batch = [i for i, p in enumerate(q.placements) if p == Shard(0)]
    rows = tuple(Shard(0) if i in batch else Replicate()
                 for i in range(mesh.ndim))
    cache = tuple(Shard(1) if i in seq else p for i, p in enumerate(rows))
    for name, t, want in zip(
            ("q", "ck", "cv", "k_new", "v_new", "key_pos", "q_pos", "lo",
             "tree_mask"), args,
            (rows, cache, cache, rows, rows, cache, rows, rows,
             (Replicate(),) * mesh.ndim)):
        if tuple(t.placements) != want:
            raise ValueError(
                f"sharded tree attention: {name} is {t.placements}, "
                f"expected {want} (the batch split on mesh dims {batch}, "
                f"the cache's sequence on {seq}, nothing else)")
    in_pl = tuple(t.placements for t in args)
    if all(mesh.size(i) == 1 for i in seq):
        return _row_major(local_map(
            lambda *a: _call(verify_attention, registered.verify_attention,
                             *a),
            out_placements=list(q.placements), in_placements=in_pl,
            device_mesh=mesh)(*args))
    stacked = tuple(Shard(0) if i in seq else Shard(1) if i in batch
                    else Replicate() for i in range(mesh.ndim))
    o_c, m_c, l_c = local_map(
        _local_cache_partial, out_placements=(stacked,) * 3,
        in_placements=(in_pl[0], in_pl[1], in_pl[2], in_pl[5], in_pl[6],
                       in_pl[7]), device_mesh=mesh)(
        q, ck, cv, key_pos, q_pos, lo)
    o_t, m_t, l_t = local_map(
        _tree_partial, out_placements=(q.placements,) * 3,
        in_placements=(in_pl[0], in_pl[3], in_pl[4], in_pl[8]),
        device_mesh=mesh)(q, k_new, v_new, tree_mask)
    # one all-reduce each for m (max), l and o (sums) over the sequence's
    # mesh dims
    def whole(t):
        return t.redistribute(mesh, [Replicate() if i in seq else p
                                     for i, p in enumerate(t.placements)])

    return _row_major(_merge((o_c, m_c, l_c), (o_t, m_t, l_t), q.dtype,
                             whole))


def _merge(cache, tree, dtype, whole=lambda t: t):
    """Eq. 1 over the sequence shards' cache partials ``cache = (o, m, l)``
    (each with a leading shard axis: (n, B, W, Hq, hd), (n, B, Hq, W),
    (n, B, Hq, W)) and the tree's ``(o, m, l)``: the normalized output in
    ``dtype``.  ``whole`` completes a max or sum over the shard axis
    across ranks (on one device the axis holds every shard)."""
    o_c, m_c, l_c = cache
    o_t, m_t, l_t = tree
    m_star = torch.maximum(whole(m_c.amax(dim=0)), m_t)      # (B, Hq, W)
    c_c = torch.exp(m_c - m_star)
    c_t = torch.exp(m_t - m_star)
    l_star = whole((l_c * c_c).sum(dim=0)) + l_t * c_t
    o_star = (whole((o_c * c_c.transpose(2, 3)[..., None]).sum(dim=0))
              + o_t * c_t.transpose(1, 2)[..., None])
    l_star = torch.clamp(l_star, min=1e-30)
    return (o_star * (1.0 / l_star.transpose(1, 2)[..., None])).to(dtype)


def sequence_split_attention(q, ck, cv, k_new, v_new, key_pos, q_pos, lo,
                             tree_mask, lengths):
    """The sequence-split route of ``_sharded_tree_attention`` on one
    device: the cache cut along its sequence into slices of ``lengths``
    (one a rank), each slice's partial by ``_local_cache_partial`` (B3
    over the slice read as pages), the tree's by B4, merged by the same
    Eq.-1 code.  Equals ``tree_attention`` on the whole cache; it lets
    one card check what the ranks compute."""
    if sum(lengths) != ck.shape[1]:
        raise ValueError(f"slices {lengths} do not cover the cache's "
                         f"{ck.shape[1]} slots")
    parts, at = [], 0
    for n in lengths:
        cut = slice(at, at + n)
        parts.append(_local_cache_partial(
            q, ck[:, cut].contiguous(), cv[:, cut].contiguous(),
            key_pos[:, cut].contiguous(), q_pos, lo))
        at += n
    cache = tuple(torch.cat(t) for t in zip(*parts))
    return _merge(cache, _tree_partial(q, k_new, v_new, tree_mask), q.dtype)


def _row_major(o):
    """``o`` with the row-major strides of its global shape.  DTensor
    derives a global stride from the local one, and for a size-1 dim (W =
    1 at decode) that stride can break ``matmul``'s fold of (B, W, d) @ (d,
    n) into one matrix product, which then expands (and, redistributed,
    copies) the weight per row."""
    from torch.distributed.tensor import DTensor
    local = o.to_local().contiguous()
    stride = torch.empty(o.shape, device="meta").stride()
    return DTensor.from_local(local, o.device_mesh, o.placements,
                              run_check=False, shape=o.shape, stride=stride)
