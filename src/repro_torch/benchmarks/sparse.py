"""Fig. 10b: strategies for the tree-sparse attention component
(counterpart of ``benchmarks/sparse.py``).

The paper compares naive COO sparse, optimized COO SpMM and dense-with-mask
on an ARM CPU.  On the port the comparison is:

  dense-with-mask  the W tree queries against the W tree keys as one dense
                   masked product (plain PyTorch, ``kernels/plain.py``),
  block-masked     the port's B5 kernel (``kernels/dispatch.py::
                   sparse_tree_attention``, ``csrc/tree_partial.cu``): the
                   tree part as one masked W x W block,
  naive            a per-nonzero loop (scalar-style COO; plain PyTorch):
                   why the COO port does not transfer.

The int8 arm (``run_int8``) is the verify path's comparison: the fused page
walk over an fp32 pool (B2) and over an int8 pool (B2, dequant in the
walk) against the split int8 walk (B3) + the block-masked tree part (B4)
merged by Eq. 1 (``tree_kernel=sparse``), with its in-run gate: each int8
output within 3e-2 of the fp32 walk.

FLOPs and bytes are structural; times are of the device the study runs
on (CUDA events on a CUDA device, the host clock on the CPU), labelled
with its name.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks import benchlib
from repro_torch.core.speculative import tree as T
from repro_torch.kernels import dispatch
from repro_torch.kernels.plain import sparse_tree_attention_plain
from repro_torch.models import common as cm
from repro_torch.runtime.cache import (Cache, KVCache, page_bytes,
                                      paginate_cache)

INT8_BOUND = 3e-2             # int8 pool vs fp32 pool (tests/test_kernels.py)
FP32_TOL = 2e-5               # the block kernel vs its plain version, fp32
PAGE_SIZE = 16


def naive_coo(q, k, v, mask):
    """Scalar-style COO: loop over the mask's nonzeros with a gather and a
    reduction each (deliberately unvectorized), then the softmax."""
    B, W, H, hd = q.shape
    scale = hd ** -0.5
    rows, cols = np.nonzero(mask.cpu().numpy())
    out_s = torch.full((B, H, W, W), -1e30, dtype=torch.float32,
                       device=q.device)
    qf = q.float().transpose(1, 2)                      # (B, H, W, hd)
    kf = k.float().transpose(1, 2)
    g = H // k.shape[2]
    for r, c in zip(rows.tolist(), cols.tolist()):
        s = (qf[:, :, r] * kf.repeat_interleave(g, 1)[:, :, c]).sum(-1)
        out_s[:, :, r, c] = s * scale
    p = torch.softmax(out_s, -1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, 1)
    return torch.einsum("bhrc,bhcd->bhrd", p, vf).transpose(1, 2)


def fig10b_outputs(q, kn, vn, mask) -> dict:
    """The three arms' outputs on the same inputs."""
    return {"naive": naive_coo(q, kn, vn, mask),
            "dense": sparse_tree_attention_plain(q, kn, vn, mask),
            "block": dispatch.sparse_tree_attention(q, kn, vn, mask)}


def study_inputs(width, H, Hkv, hd, device, seed=0):
    """q (1, W, H, hd) and the tree's fresh K/V (1, W, Hkv, hd), fp32."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device)

    return rnd(1, width, H, hd), rnd(1, width, Hkv, hd), rnd(1, width, Hkv, hd)


def run(width=64, ctx=256, H=32, Hkv=8, hd=128, device="cuda", reps=5,
        seed=0, watch=benchlib.unwatched) -> list:
    """The Fig. 10b study at the reference's shape (fp32, B=1), then its
    int8 arm.  Raises if the block kernel leaves its plain version."""
    with watch("fig10b"):
        rows, inputs = _study(width, ctx, H, Hkv, hd, device, reps, seed)
    with watch("fig10b int8"):
        rows += run_int8(width=width, ctx=ctx, Hkv=Hkv, hd=hd, reps=reps,
                         seed=seed, **inputs)
    return rows


def _study(width, ctx, H, Hkv, hd, device, reps, seed):
    device = torch.device(device)
    where = benchlib.label(device)
    spec = T.build_tree(T.default_accs(5, 10), width)
    mask = torch.as_tensor(spec.mask, device=device)
    nnz = int(spec.mask.sum())
    q, kn, vn = study_inputs(width, H, Hkv, hd, device, seed)

    dense_flops = 2 * 2 * width * (ctx + width) * H * hd
    block_flops = 2 * 2 * width * width * H * hd      # the masked tree block
    coo_flops = 2 * 2 * nnz * H * hd                  # true nnz work
    print(f"# W={width} nnz={nnz}/{width*width} "
          f"dense-with-mask(ctx+tree)={dense_flops/1e6:.1f}MF "
          f"block-masked={block_flops/1e6:.1f}MF "
          f"true-sparse={coo_flops/1e6:.1f}MF")

    outs = fig10b_outputs(q, kn, vn, mask)
    err = float((outs["block"] - outs["dense"]).abs().max())
    err_naive = float((outs["naive"] - outs["dense"]).abs().max())
    if not err < FP32_TOL:
        raise AssertionError(f"block kernel off its plain version by {err} "
                             f"(fp32 tolerance {FP32_TOL})")
    if not err_naive < FP32_TOL:
        raise AssertionError(f"naive COO off the dense arm by {err_naive}")
    t_block = benchlib.mean_ms(
        lambda: dispatch.sparse_tree_attention(q, kn, vn, mask), device, reps)
    t_dense = benchlib.mean_ms(
        lambda: sparse_tree_attention_plain(q, kn, vn, mask), device, reps)
    t_naive = benchlib.mean_ms(lambda: naive_coo(q, kn, vn, mask), device,
                               reps=1, warm=0)
    print(f"# {where}: block={t_block:.4f}ms dense-masked={t_dense:.4f}ms "
          f"naive-coo={t_naive:.2f}ms; block vs plain max|err| {err:.2e}")
    print(f"# naive/block = {t_naive/t_block:.2f}x (paper: optimized sparse "
          f"3.49x over naive); tree-part FLOP saving vs dense-over-everything "
          f"= {dense_flops/block_flops:.2f}x")
    return [("fig10b_block_kernel_ms", t_block, where),
            ("fig10b_dense_masked_ms", t_dense, where),
            ("fig10b_naive_over_block", t_naive / t_block, "paper=3.49"),
            ("fig10b_flops_saving", dense_flops / block_flops,
             f"nnz={nnz}"),
            ("fig10b_block_err_vs_plain", err, f"tol {FP32_TOL}")], \
        dict(mask=mask, q=q, kn=kn, vn=vn)


def int8_pools(k_ctx, v_ctx, page_size=PAGE_SIZE):
    """One resident sequence per row of ``ctx`` tokens (``k_ctx/v_ctx``:
    (1, B, ctx, Hkv, hd)) paginated into an fp32 and an int8 pool."""
    _, B, ctx = k_ctx.shape[:3]
    dev = k_ctx.device
    n_pages = -(-ctx // page_size)
    dense = KVCache(
        k=k_ctx, v=v_ctx,
        key_pos=torch.broadcast_to(
            torch.arange(ctx, dtype=torch.int32, device=dev), (B, ctx)),
        pos=torch.full((B,), ctx, dtype=torch.int32, device=dev), window=0)
    tables = torch.broadcast_to(
        torch.arange(n_pages, dtype=torch.int32, device=dev),
        (B, n_pages)).contiguous()
    paged32 = paginate_cache(Cache(kv=dense), tables, page_size=page_size,
                             n_pages=n_pages).kv
    paged8 = paginate_cache(Cache(kv=dense), tables, page_size=page_size,
                            n_pages=n_pages, kv_dtype=torch.int8).kv
    return paged32, paged8, n_pages


def _scale(s):
    return None if s is None else s[0]


def fused(q, kn, vn, kv, depth, mask):
    """The fused page walk (B2) over layer 0 of ``kv``."""
    return dispatch.paged_tree_attention(
        q, kv.pool_k[0], kv.pool_v[0], kn, vn, kv.block_table, kv.key_pos,
        kv.pos, depth, mask, scale_k=_scale(kv.scale_k),
        scale_v=_scale(kv.scale_v))


def split(q, kn, vn, kv, depth, mask):
    """The split walk (B3) + the tree part (B4), merged by Eq. 1."""
    cache_part = dispatch.paged_cache_attention(
        q, kv.pool_k[0], kv.pool_v[0], kv.block_table, kv.key_pos, kv.pos,
        depth, scale_k=_scale(kv.scale_k), scale_v=_scale(kv.scale_v))
    tree_part = dispatch.sparse_tree_attention_partial(q, kn, vn, mask)
    return cm.merge_partials([cache_part, tree_part])


def int8_outputs(q, kn, vn, mask, k_ctx, v_ctx, page_size=PAGE_SIZE) -> dict:
    """The int8 arm's three outputs on the same inputs, and the pools."""
    paged32, paged8, n_pages = int8_pools(k_ctx, v_ctx, page_size)
    depth = torch.zeros((q.shape[1],), dtype=torch.int32, device=q.device)
    return {"fused_fp32": fused(q, kn, vn, paged32, depth, mask),
            "fused_int8": fused(q, kn, vn, paged8, depth, mask),
            "split_int8": split(q, kn, vn, paged8, depth, mask),
            "pools": (paged32, paged8, depth), "n_pages": n_pages}


def run_int8(*, width, mask, q, kn, vn, ctx, Hkv, hd, reps=5, seed=0,
             k_ctx=None, v_ctx=None, page_size=PAGE_SIZE) -> list:
    """The int8 arm: cache-side BYTES are the structural story (a decode
    step is bound by the KV read, paper §II): int8 pages move ~4x fewer
    pool bytes; the max errors against the fp32 walk are gated here."""
    device = q.device
    where = benchlib.label(device)
    B = q.shape[0]
    if k_ctx is None:
        g = torch.Generator(device=device).manual_seed(seed + 9)
        k_ctx = torch.randn((1, B, ctx, Hkv, hd), generator=g, device=device)
        v_ctx = torch.randn((1, B, ctx, Hkv, hd), generator=g, device=device)
    outs = int8_outputs(q, kn, vn, mask, k_ctx, v_ctx, page_size)
    o32 = outs["fused_fp32"]
    err_fused = float((outs["fused_int8"] - o32).abs().max())
    err_split = float((outs["split_int8"] - o32).abs().max())
    if not (err_fused < INT8_BOUND and err_split < INT8_BOUND):
        raise AssertionError(
            f"int8 walk off the fp32 walk: fused {err_fused}, split "
            f"{err_split} (bound {INT8_BOUND})")
    paged32, paged8, depth = outs["pools"]
    t32 = benchlib.mean_ms(lambda: fused(q, kn, vn, paged32, depth, mask),
                           device, reps)
    t8 = benchlib.mean_ms(lambda: fused(q, kn, vn, paged8, depth, mask),
                          device, reps)
    t8s = benchlib.mean_ms(lambda: split(q, kn, vn, paged8, depth, mask),
                           device, reps)
    n_pages = outs["n_pages"]
    by32 = n_pages * page_bytes(1, page_size, Hkv, hd, torch.float32)
    by8 = n_pages * page_bytes(1, page_size, Hkv, hd, torch.int8)
    print(f"# int8 verify arm (ctx={ctx}, W={width}): cache bytes/step "
          f"fp32={by32} int8={by8} ({by32/by8:.2f}x fewer); max|err| "
          f"fused={err_fused:.2e} split={err_split:.2e}")
    print(f"# {where}: fused-fp32={t32:.4f}ms fused-int8={t8:.4f}ms "
          f"split-int8={t8s:.4f}ms")
    return [("int8_cache_bytes_reduction", by32 / by8, f"ctx={ctx}"),
            ("int8_fused_err_vs_fp32", err_fused, f"bound {INT8_BOUND}"),
            ("int8_split_err_vs_fp32", err_split, "tree_kernel=sparse"),
            ("int8_fused_fp32_walk_ms", t32, where),
            ("int8_fused_walk_ms", t8, where),
            ("int8_split_walk_ms", t8s, where)]
