"""HCMP sharding rules (paper §III-B) and the Megatron baseline, as DTensor
placements over a ``torch.distributed.DeviceMesh`` (counterpart of
``repro/core/hcmp/sharding.py``).

Intra-step tensor parallelism only: how one forward pass is partitioned
over the ``model`` mesh axis.  The inter-step executor split of the decode
loop is ``executors.py``; the two compose, since the executor split is
made at whole-step granularity.

Two tensor-parallel modes over the ``model`` mesh axis:

  hcmp      column-only split of EVERY linear (paper §III-B1).  Activations
            come out feature-sharded and are re-gathered at the next
            consumer (``regather``): an all-gather of the activation, tiny
            at decode (W <= 64 tokens) against the Megatron all-reduce,
            which moves the same bytes twice (reduce, then broadcast).
  megatron  the paper's baseline (Medusa+EM): (column, row) pairs with an
            all-reduce closing every two linears.

``fsdp`` (a config field) also shards the non-``model`` weight dim on
``data`` (>= 30B weights).  MoE experts shard on ``model`` (expert
parallelism); the KV cache shards its *sequence* dim on ``model``: GQA
kv-head counts (2..8) do not divide a 16-wide axis, and a sequence shard
is what lets each shard's attention partial merge with the others' by the
online softmax (``kernels/dispatch.py::tree_attention``).

The rule tables give the reference's ``PartitionSpec`` as a plain tuple,
one entry per tensor dim (``None``, an axis name, or a tuple of names);
``placements`` turns one into a DTensor placement per mesh dim.  Trees
are walked with ``repro_torch/tree.py::named_map``, whose names are the
reference's key-path names.

XLA's partitioner re-gathers an activation whose layout its consumer
cannot take without a word; DTensor does not (a reshape of a 14-head
projection split 16 ways raises).  So the model code calls ``regather``
where a feature-sharded activation is reshaped into heads, is fed to the
next linear or joins the residual stream; on a plain tensor it returns
its argument, so the one-device path is untouched.
"""
from __future__ import annotations

import sys

from repro_torch import tree

# leaf-name rule tables ----------------------------------------------------
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "up", "w", "out", "lm_head",
        "in_z", "in_x", "conv_wx"}   # mamba z/x paths stay model-sharded
_ROW = {"wo", "w_down", "down", "out_proj"}          # row-split in megatron
_SHARD_1D = {"bq", "bk", "bv", "conv_bx", "norm_mamba"}  # follow column shards
_MOE = {"w_gate", "w_up", "w_down"}                  # 3D (E, ., .)


def _leaf_spec(names, shape, mode, fsdp):
    name = names[-1]
    stacked = any(n in ("layers", "encoder", "decoder") for n in names)
    moe = "moe" in names
    xlstm_block = "block" in names                 # xLSTM internals: replicate
    nd = len(shape)
    lead = (None,) if stacked else ()
    core = nd - len(lead)

    def spec(*axes):
        return lead + axes + (None,) * (core - len(axes))

    if xlstm_block:
        return spec()
    if moe and core == 3 and name in _MOE:
        # experts on model; fsdp shards the d/f dim on data
        return spec("model", "data" if fsdp else None, None)
    if name == "router":
        return spec()
    if name == "embed":
        # (V, d): vocab column-shard; fsdp shards d
        return ("model", "data" if fsdp else None)
    if core == 2 and name in _COL:
        return spec("data" if fsdp else None, "model")
    if core == 2 and name in _ROW:
        if mode == "megatron":
            return spec("model", "data" if fsdp else None)
        return spec("data" if fsdp else None, "model")   # hcmp: column again
    if core == 1 and name in _SHARD_1D:
        return spec("model")
    return spec()                                   # norms, scalars: replicated


def param_specs(cfg, params, mode="hcmp"):
    """params (tensors of any device, fake or meta included) -> the same
    tree of spec tuples."""
    if mode not in ("hcmp", "megatron"):
        raise ValueError(f"mode is hcmp or megatron, got {mode!r}")
    return tree.named_map(
        lambda names, t: _leaf_spec(names, t.shape, mode, cfg.fsdp), params)


def _cache_spec(names, shape, dp, seq_axis):
    name = names[-1]
    nd = len(shape)

    def bax(bdim):
        # batch=1 (long_500k single-sample decode) cannot shard: replicate
        return dp if shape[bdim] > 1 else None

    if name in ("k", "v"):                # (L, B, S, Hkv, hd)
        return (None, bax(1), seq_axis, None, None)
    if name in ("cross_k", "cross_v"):    # (L, B, Senc, Hkv, hd)
        return (None, bax(1), None, "model" if shape[3] % 16 == 0 else None,
                None)
    if name == "ssm":                     # (L, B, nh, hd, N)
        return (None, bax(1), "model" if shape[2] % 16 == 0 else None, None,
                None)
    if name == "conv":                    # (L, B, K-1, C): tiny, replicate C
        return (None, bax(1), None, None)
    if name == "key_pos":                 # (B, S): follow k/v batch + seq
        return (bax(0), seq_axis)
    if name == "pos":                     # (B,) per-sequence positions
        return () if nd == 0 else (bax(0),)
    # xlstm layer states (B, ...): batch only
    if nd >= 1 and "layers" in names:
        return (bax(0),) + (None,) * (nd - 1)
    return (None,) * nd


def cache_specs(cfg, cache, *, batch_axes=("pod", "data"), seq_axis="model"):
    """KV cache: batch on the data axes, SEQUENCE on ``model`` (the
    online-softmax shard merge).  Recurrent states: batch on the data
    axes, heads on ``model`` where 16 divides them."""
    return tree.named_map(
        lambda names, t: _cache_spec(names, t.shape, tuple(batch_axes),
                                     seq_axis), cache)


def _batch_spec(shape, batch_axes):
    if len(shape) == 0:
        return ()
    if shape[0] == 1:
        return (None,) * len(shape)
    return (tuple(batch_axes),) + (None,) * (len(shape) - 1)


def batch_specs(batch, batch_axes=("pod", "data")):
    """Input batches: dim 0 (the global batch) over the data axes; a batch
    of one is replicated."""
    return tree.named_map(lambda names, t: _batch_spec(t.shape, batch_axes),
                          batch)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------
def placements(mesh, spec) -> tuple:
    """A spec tuple -> one placement per mesh dim: ``Shard(d)`` where the
    spec names that dim's axis at tensor dim d, else ``Replicate()``.  A
    tensor dim over several axes (``("pod", "data")``) is split over them
    major to minor, as JAX splits it."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _param_rule(cfg, mode, mesh):
    return lambda names, t: placements(
        mesh, _leaf_spec(names, t.shape, mode, cfg.fsdp))


def _cache_rule(mesh, batch_axes, seq_axis="model"):
    dp = tuple(batch_axes) if batch_axes is not None else data_axes(mesh)
    return lambda names, t: placements(
        mesh, _cache_spec(names, t.shape, dp, seq_axis))


def _batch_rule(mesh, batch_axes):
    dp = tuple(batch_axes) if batch_axes is not None else data_axes(mesh)
    return lambda names, t: placements(mesh, _batch_spec(t.shape, dp))


def param_placements(cfg, params, mode="hcmp", *, mesh):
    return tree.named_map(_param_rule(cfg, mode, mesh), params)


def cache_placements(cfg, cache, *, mesh, batch_axes=None, seq_axis="model"):
    return tree.named_map(_cache_rule(mesh, batch_axes, seq_axis), cache)


def batch_placements(batch, batch_axes=None, *, mesh):
    return tree.named_map(_batch_rule(mesh, batch_axes), batch)


def data_axes(mesh) -> tuple:
    """The mesh's batch axes, in mesh order."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _distribute(rule, tree_, mesh):
    """Whole tensors (every rank holds the same) -> DTensors placed by
    ``rule(names, t)``; each rank keeps its own slice, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return tree.named_map(
        lambda names, t: distribute_tensor(t, mesh, rule(names, t),
                                           src_data_rank=None), tree_)


def distribute_params(cfg, params, mode="hcmp", *, mesh):
    return _distribute(_param_rule(cfg, mode, mesh), params, mesh)


def distribute_cache(cfg, cache, *, mesh, batch_axes=None):
    return _distribute(_cache_rule(mesh, batch_axes), cache, mesh)


def distribute_batch(batch, batch_axes=None, *, mesh):
    return _distribute(_batch_rule(mesh, batch_axes), batch, mesh)


# ---------------------------------------------------------------------------
# the HCMP consumer re-gather
# ---------------------------------------------------------------------------
def regather(x, w=None, mesh_dim="model"):
    """``x`` whole on the ``mesh_dim`` axis, for a consumer that needs it
    so: a feature shard is all-gathered, a partial sum all-reduced.  With
    ``w``, the weight ``x`` is about to be multiplied by: a row-split
    ``w`` (Megatron's second linear) takes ``x``'s feature shard as it is,
    so nothing moves.  A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    i = x.device_mesh.mesh_dim_names.index(mesh_dim)
    if x.placements[i] == Replicate():
        return x
    if (is_dtensor(w) and w.placements[i] == Shard(0)
            and x.placements[i] == Shard(x.dim() - 1)):
        return x
    want = list(x.placements)
    want[i] = Replicate()
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# helpers for the cache and the kernels on DTensors
# ---------------------------------------------------------------------------
def is_dtensor(t) -> bool:
    """A DTensor exists only once ``torch.distributed.tensor`` is loaded,
    so a plain run (which never loads it: ~1 s of import) pays one dict
    lookup a call."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def full(mesh, names, shape, fill, dtype):
    """A DTensor of ``shape`` filled with ``fill``, laid out on ``mesh`` by
    the cache rule of the leaf ``names`` (batch on the mesh's data axes,
    the sequence on ``model``); each rank allocates its slice only."""
    import torch.distributed.tensor as dt
    spec = _cache_spec(tuple(names), tuple(shape), data_axes(mesh), "model")
    return dt.full(tuple(shape), fill, dtype=dtype, device_mesh=mesh,
                   placements=placements(mesh, spec))


def shard_offset(t, dim) -> int:
    """Where this rank's slice of the DTensor ``t`` starts along ``dim``:
    each mesh dim that shards ``dim`` cuts what the ones before it left
    into ``torch.chunk`` pieces, in mesh-dim order."""
    from torch.distributed.tensor import Shard
    coord = t.device_mesh.get_coordinate()
    n, off = t.shape[dim], 0
    for i, p in enumerate(t.placements):
        if p == Shard(dim):
            k = t.device_mesh.size(i)
            piece = -(-n // k)
            off += coord[i] * piece
            n = max(0, min(piece, n - coord[i] * piece))
    return off


def mesh_of(t):
    """The device mesh of a DTensor, None for a plain tensor."""
    return t.device_mesh if is_dtensor(t) else None


def replicated(t, mesh):
    """``t`` as a DTensor replicated on ``mesh`` (a DTensor as it is): for
    tensors every rank builds alike, a tree's mask or depths."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def gather_fsdp(params):
    """A param tree (one layer's, or one weight) whole on the data axes:
    ``fsdp`` shards a weight's non-``model`` dim on ``data``, and each
    layer all-gathers its own as the forward reaches it.  Plain tensors,
    and params no data axis splits, are returned as they are."""
    if not any(is_dtensor(t) for t in tree.leaves(params)):
        return params

    def whole(t):
        from torch.distributed.tensor import Replicate
        names = t.device_mesh.mesh_dim_names
        want = [Replicate() if names[i] in ("pod", "data") else p
                for i, p in enumerate(t.placements)]
        if want == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, want)

    return tree.tree_map(whole, params)


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn`` that DTensor has no rule for
    (``F.logsigmoid``): on a DTensor, ``fn`` of each rank's slice, laid
    out as ``x`` (a partial sum is summed first: ``fn`` is not linear)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


def per_row(fn, x, *rows, batch_dim, out_batch_dim=0):
    """``fn(x, *rows)`` for a ``fn`` that picks, for each row b of a batch,
    entries of ``x`` by the (B, ...) tensors ``rows`` (per-row indices and
    masks): ``x`` holds the batch on ``batch_dim`` (B rows, or B x P
    folded there), the result on ``out_batch_dim``, and ``x``'s dims after
    ``batch_dim`` follow it in the result.  On a DTensor ``x``, ``fn`` of
    each rank's rows with ``rows`` cut as ``x``'s batch is (nothing
    moves); ``x``'s splits after the batch stay on their dims."""
    if not is_dtensor(x):
        return fn(x, *rows)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    out, cut = [], []
    for p in x.placements:
        if p == Shard(batch_dim):
            out.append(Shard(out_batch_dim))
            cut.append(Shard(0))
        elif isinstance(p, Shard) and p.dim > batch_dim:
            out.append(Shard(p.dim - batch_dim + out_batch_dim))
            cut.append(Replicate())
        elif p == Replicate():
            out.append(p)
            cut.append(p)
        else:
            raise ValueError(f"per-row selection of a tensor laid out as "
                             f"{x.placements} (batch on dim {batch_dim})")
    rows = tuple(replicated(r, x.device_mesh) for r in rows)
    return local_map(fn, out_placements=out,
                     in_placements=(x.placements,) + (cut,) * len(rows),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, *rows)


def empty(shape, like, dims):
    """``torch.empty(shape)`` in ``like``'s dtype and device; for a DTensor
    ``like``, a DTensor whose dim ``dims[d]`` is split as ``like``'s dim
    ``d`` is (each rank allocates its slice): per-depth or per-layer
    stacks of a state."""
    import torch
    if not is_dtensor(like):
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    import torch.distributed.tensor as dt
    from torch.distributed.tensor import Replicate, Shard
    pl = []
    for p in like.placements:
        if isinstance(p, Shard):
            pl.append(Shard(dims[p.dim]))
        elif isinstance(p, Replicate):
            pl.append(p)
        else:
            raise ValueError(f"cannot lay a new tensor out as {p}")
    return dt.empty(tuple(shape), dtype=like.dtype,
                    device_mesh=like.device_mesh, placements=pl)


def reduced(t):
    """A DTensor with its pending partial sums reduced (all-reduced into
    ``Replicate``); its splits and a plain tensor stay as they are."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])
