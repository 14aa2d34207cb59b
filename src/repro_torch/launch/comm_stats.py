"""Per-device counters of one step on DTensors: FLOPs, bytes, collective
bytes, live memory and an op histogram (counterpart of
``repro/launch/hlo_stats.py``, which parses them out of the compiled HLO
text; torch has no HLO, so a dispatch mode counts the ops as they run).

``StepCounters`` is a ``TorchDispatchMode``.  It steps aside for a DTensor
op (returns ``NotImplemented``), so DTensor runs first and turns the op
into ops on its local shards and the functional collectives of its
redistributions; those reach the mode as plain (or fake) tensors, and the
mode counts them, on this rank's shards.  The ops DTensor's sharding
propagator runs (on fake tensors of the global shapes, to learn an
output's shape; on index tensors, to cost a redistribution) are not the
step's: the mode marks the propagator's calls while it is entered and
skips what runs inside them.

  flops        ``torch.utils.flop_counter``'s formula of each op (matmuls,
               convolutions, attention, the port's kernels' custom ops
               in ``kernels/registered.py``); elementwise ops count 0
  bytes        each op's tensor inputs read once and outputs written once;
               a view moves nothing and an uninitialised allocation
               writes nothing; an in-place op reads its other operands and
               writes as many bytes into its destination; a gather (index,
               embedding) reads its indices and the rows it returns
  collectives  the result bytes of every collective (per device, as the
               reference sums the result shapes of the per-device HLO),
               keyed by the reference's op names and by mesh dim
  memory       the bytes of live storages made during the step, at their
               peak (weak references, swept every few ops)

On fake tensors the counters also run each rank's row-wise attention
(``models/attention.py::_rowwise``) as meta tensors: the same ops on the
same shapes, which the counters see alike, at a fraction of a fake op's
cost (``meta_rows``, installed as ``attention.ROWS_HOOK`` while counting).

The counters lean on three private names of torch's DTensor (the sharding
propagator's two uncached entry points and ``_StridedShard``'s shard
sizes), checked against torch 2.11 and 2.13; a torch without them fails
on entering the counters.  DTensor's strategy choices differ between
torch versions, so each record carries its ``torch_version`` and counts
compare only within one.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "permute_tensor": "collective-permute"}
_GATHERS = {"index", "gather", "index_select", "embedding", "take"}
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias", "wait_tensor",
         "_local_scalar_dense", "device", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset"}


def _tensors(tree):
    """The tensors of an op's arguments or of a step's (lists, tuples,
    dicts and dataclasses: the caches)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _storage_key(t):
    return t.untyped_storage()._cdata


def _nbytes(t):
    return t.numel() * t.element_size()


class StepCounters(TorchDispatchMode):
    """Counts what the ops run inside ``with StepCounters(mesh):`` do on
    this rank.  ``fake_mode`` is the dry run's ``FakeTensorMode`` (None
    when the tensors are real)."""

    def __init__(self, mesh, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.dim_of_group = {mesh.get_group(i).group_name: name
                             for i, name in enumerate(mesh.mesh_dim_names)}
        self.flops = 0
        self.bytes = 0
        self.collectives = defaultdict(int)
        self.by_mesh_dim = defaultdict(lambda: defaultdict(int))
        self.ops = Counter()
        self._live = {}            # storage key -> (weak ref, bytes)
        self._since_sweep = 0
        self.live_bytes = 0
        self.peak_live = 0
        self._propagating = 0

    def __enter__(self):
        """Mark the sharding propagator's calls (their ops are not the
        step's), and run its strategy search outside the fake mode: its
        index arithmetic for a strided split (a split dim merged with
        another by a reshape) computes on small tensors, which a fake mode
        cannot read back."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.placement_types import _StridedShard

        from repro_torch.models import attention
        prop = DTensor._op_dispatcher.sharding_propagator
        _require(type(prop), "_propagate_tensor_meta_non_cached")
        _require(type(prop), "propagate_op_sharding_non_cached")
        _require(_StridedShard, "local_shard_size_and_offset", own=True)
        self._prop = prop
        self._rows_hook = attention.ROWS_HOOK
        if self.fake_mode is not None:
            attention.ROWS_HOOK = meta_rows

        def mark(name, real=False):
            fn = getattr(type(prop), name)

            def marked(op_schema):
                self._propagating += 1
                try:
                    if real:
                        with unset_fake_temporarily():
                            return fn(prop, op_schema)
                    return fn(prop, op_schema)
                finally:
                    self._propagating -= 1

            setattr(prop, name, marked)

        mark("_propagate_tensor_meta_non_cached")
        mark("propagate_op_sharding_non_cached", real=True)
        # a strided split's shard sizes, computed when it is redistributed
        raw = self._strided = \
            _StridedShard.__dict__["local_shard_size_and_offset"]
        sizes = raw.__func__ if isinstance(raw, staticmethod) else raw

        def real_sizes(*args, **kwargs):
            self._propagating += 1
            try:
                with unset_fake_temporarily():
                    return sizes(*args, **kwargs)
            finally:
                self._propagating -= 1

        _StridedShard.local_shard_size_and_offset = \
            staticmethod(real_sizes) if isinstance(raw, staticmethod) \
            else real_sizes
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor.placement_types import _StridedShard

        from repro_torch.models import attention
        del self._prop._propagate_tensor_meta_non_cached
        del self._prop.propagate_op_sharding_non_cached
        _StridedShard.local_shard_size_and_offset = self._strided
        attention.ROWS_HOOK = self._rows_hook
        return super().__exit__(*exc)

    def _ours(self, tensors):
        from torch._subclasses.fake_tensor import FakeTensor
        return all(not isinstance(t, FakeTensor)
                   or t.fake_mode is self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not self._ours(ins + outs):
            return out            # another fake mode's: propagation again
        name = func._opname
        if func.namespace in ("_c10d_functional",
                              "_c10d_functional_autograd"):
            self._collective(name, args, outs)
        elif name not in _FREE and not func.is_view:
            self._count(func, name, args, kwargs, out, ins, outs)
        self._track(outs, {_storage_key(t) for t in ins})
        return out

    def _collective(self, name, args, outs):
        op = COLLECTIVES.get(name)
        if op is None:
            return
        n = sum(_nbytes(t) for t in outs)
        group = [a for a in args if isinstance(a, str)][-1]
        self.collectives[op] += n
        self.by_mesh_dim[self.dim_of_group.get(group, group)][op] += n
        self.ops[op] += 1

    def _count(self, func, name, args, kwargs, out, ins, outs):
        self.ops[str(func.overloadpacket)] += 1
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if func._schema.is_mutable:
            dest = {_storage_key(t) for t in outs}
            read = sum(_nbytes(t) for t in ins if _storage_key(t) not in dest)
            self.bytes += 2 * read
        elif name in _GATHERS:
            # reads the rows it gathers, not its whole source
            self.bytes += (sum(_nbytes(t) for t in ins[1:])
                           + 2 * sum(_nbytes(t) for t in outs))
        else:
            self.bytes += (sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))

    SWEEP_EVERY = 16

    def _track(self, outs, in_keys):
        """Add the op's new storages (not an input's: a view's or an
        in-place op's output is its input's); every ``SWEEP_EVERY`` ops,
        first drop the storages that died (a death is seen late, so the
        peak errs high by at most the storages freed between sweeps)."""
        from torch.multiprocessing.reductions import StorageWeakRef
        self._since_sweep += 1
        if self._since_sweep >= self.SWEEP_EVERY:
            self._since_sweep = 0
            for key in [k for k, (ref, _) in self._live.items()
                        if ref.expired()]:
                self.live_bytes -= self._live.pop(key)[1]
        for t in outs:
            st = t.untyped_storage()
            if st._cdata not in self._live and st._cdata not in in_keys:
                self._live[st._cdata] = (StorageWeakRef(st), st.nbytes())
                self.live_bytes += st.nbytes()
        self.peak_live = max(self.peak_live, self.live_bytes)

    # ---------------------------------------------------------------
    def collective_bytes(self) -> dict:
        """{op name: bytes, ..., "total": bytes} per device."""
        out = dict(self.collectives)
        out["total"] = sum(self.collectives.values())
        return out

    def collective_bytes_by_mesh_dim(self) -> dict:
        """{mesh dim: {op name: bytes, "total": bytes}} per device."""
        return {d: dict(v, total=sum(v.values()))
                for d, v in self.by_mesh_dim.items()}

    def op_histogram(self, top: int = 15) -> dict:
        """The ``top`` most frequent ops on this rank's shards."""
        return dict(self.ops.most_common(top))

    def live_storages(self, tree) -> int:
        """Bytes of the distinct storages of ``tree``'s tensors (DTensors:
        this rank's shards) that the step made and that are still live."""
        seen = {}
        for t in _tensors(tree):
            t = _local(t)
            key = _storage_key(t)
            if key in self._live:
                seen[key] = t.untyped_storage().nbytes()
        return sum(seen.values())


def _require(owner, name, own=False):
    """Fail loudly where this torch lacks a private name the counters
    patch (``own``: defined on ``owner`` itself, not inherited)."""
    if (name in vars(owner)) if own else hasattr(owner, name):
        return
    raise RuntimeError(
        f"the dry run's counters need torch's private "
        f"{owner.__name__}.{name}, which torch {torch.__version__} does not "
        f"have (checked against torch 2.11 and 2.13)")


def meta_rows(fn):
    """``fn(q, k, v)`` on fake tensors outside autograd run as meta tensors
    (the same ops on the same shapes), its output made a fake tensor of
    its shape again; anything else runs ``fn`` as it is."""
    def run(q, k, v):
        from torch._subclasses.fake_tensor import (FakeTensor,
                                                   unset_fake_temporarily)
        if not isinstance(q, FakeTensor) or (torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v))):
            return fn(q, k, v)
        with unset_fake_temporarily():
            out = fn(*(torch.empty_strided(t.shape, t.stride(),
                                           dtype=t.dtype, device="meta")
                       for t in (q, k, v)))
        return torch.empty_strided(out.shape, out.stride(), dtype=out.dtype,
                                   device=q.device)
    return run


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors on this rank
    (a DTensor's local shard)."""
    seen = {}
    for t in _tensors(tree):
        t = _local(t)
        seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())
