"""The attention kernels on the verify path as ``torch.library`` custom ops,
for the tensors that have no memory to launch on: the fake tensors of the
dry run (``launch/dryrun.py``).

Each op's real implementation is its wrapper (a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises, ``.launches``
counts), its fake implementation gives the output's shape and dtype and
launches nothing, and its FLOP formula (``torch.utils.flop_counter``)
counts the q.k and p.v multiply-adds over every key it is given, as
``PERF.md`` §6's bound does (2 x 2 x B x Hq x W x keys x hd).  The bytes
a counter charges an op are its inputs' and outputs', each once: the same
bound.

``dispatch.py`` sends a fake tensor here and a real one straight to the
wrapper: the custom op's dispatch costs host time on every call, which
the ctypes call does not pay (``PERF.md`` §6 has both times).

  B1  ``repro_torch::verify_attention``        dense cache + tree, fused
  B2  ``repro_torch::paged_tree_attention``    paged pool + tree, fused
  B3  ``repro_torch::paged_cache_attention``   paged pool, (o, m, l); its
                                               split fold runs inside
  B4  ``repro_torch::tree_partial``            W x W tree, (o, m, l)

B3 and B4 lay their three partials out in one buffer; a custom op's
outputs may not share storage, so the real implementations copy them
(the dry run, which never runs them, is unaffected).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import tree_partial as _tree
from repro_torch.kernels.verify_attention import verify_attention as _b1

_Parts = Tuple[Tensor, Tensor, Tensor]


def _partials_like(q):
    """Empty ``(o (B, W, Hq, hd) f32, m (B, Hq, W), l (B, Hq, W))``."""
    B, W, Hq, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (q.new_empty((B, W, Hq, hd), **f32),
            q.new_empty((B, Hq, W), **f32), q.new_empty((B, Hq, W), **f32))


def _flops(q_shape, keys):
    B, W, Hq, hd = q_shape
    return 4 * B * Hq * W * keys * hd


# --------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::verify_attention", mutates_args=())
def verify_attention(q: Tensor, ck: Tensor, cv: Tensor, k_new: Tensor,
                     v_new: Tensor, key_pos: Tensor, q_pos: Tensor,
                     lo: Tensor, tree_mask: Tensor) -> Tensor:
    return _b1(q, ck, cv, k_new, v_new, key_pos, q_pos, lo, tree_mask)


@verify_attention.register_fake
def _(q, ck, cv, k_new, v_new, key_pos, q_pos, lo, tree_mask):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.verify_attention)
def _(q, ck, *args, out_shape=None, **kw):
    return _flops(q, ck[1] + q[1])


# --------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::paged_tree_attention",
                         mutates_args=())
def paged_tree_attention(q: Tensor, pool_k: Tensor, pool_v: Tensor,
                         scale_k: Optional[Tensor], scale_v: Optional[Tensor],
                         k_new: Tensor, v_new: Tensor, block_table: Tensor,
                         key_pos: Tensor, q_pos: Tensor, lo: Tensor,
                         tree_mask: Tensor) -> Tensor:
    return _paged.paged_tree_attention(q, pool_k, pool_v, scale_k, scale_v,
                                       k_new, v_new, block_table, key_pos,
                                       q_pos, lo, tree_mask)


@paged_tree_attention.register_fake
def _(q, pool_k, pool_v, scale_k, scale_v, k_new, v_new, block_table,
      key_pos, q_pos, lo, tree_mask):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.paged_tree_attention)
def _(q, pool_k, pool_v, scale_k, scale_v, k_new, v_new, block_table,
      key_pos, *args, out_shape=None, **kw):
    return _flops(q, key_pos[1] + q[1])


# --------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::paged_cache_attention",
                         mutates_args=())
def paged_cache_attention(q: Tensor, pool_k: Tensor, pool_v: Tensor,
                          scale_k: Optional[Tensor],
                          scale_v: Optional[Tensor], block_table: Tensor,
                          key_pos: Tensor, q_pos: Tensor,
                          lo: Tensor) -> _Parts:
    o, m, l = _paged.paged_cache_attention(q, pool_k, pool_v, scale_k,
                                           scale_v, block_table, key_pos,
                                           q_pos, lo)
    return o.clone(), m.clone(), l.clone()


@paged_cache_attention.register_fake
def _(q, pool_k, pool_v, scale_k, scale_v, block_table, key_pos, q_pos, lo):
    return _partials_like(q)


@register_flop_formula(torch.ops.repro_torch.paged_cache_attention)
def _(q, pool_k, pool_v, scale_k, scale_v, block_table, key_pos, *args,
      out_shape=None, **kw):
    return _flops(q, key_pos[1])


# --------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::tree_partial", mutates_args=())
def tree_partial(q: Tensor, k_new: Tensor, v_new: Tensor,
                 tree_mask: Tensor) -> _Parts:
    o, m, l = _tree.sparse_tree_attention_partial(q, k_new, v_new, tree_mask)
    return o.clone(), m.clone(), l.clone()


@tree_partial.register_fake
def _(q, k_new, v_new, tree_mask):
    return _partials_like(q)


@register_flop_formula(torch.ops.repro_torch.tree_partial)
def _(q, *args, out_shape=None, **kw):
    return _flops(q, q[1])


def is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)
