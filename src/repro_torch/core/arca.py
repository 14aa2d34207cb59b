"""ARCA: architecture-aware profiling (paper §III-C), counterpart of
``repro/core/arca.py``, name for name.

Determines the *speculative strategy* (verification width + tree) and the
*partitioning strategy* (per-unit ratio), balancing acceptance length
against hardware parallelism and memory contention.

Two time sources feed the same search:

  * ``Soc``: an analytic model of a unified-memory CPU+GPU SoC, calibrated
    to the paper's Jetson Xavier NX testbed (GPU @204 MHz, 6-core ARM
    @1.9 GHz, shared LPDDR4x).  It models the Jetson, not the H100: its
    figures are the paper's board, and the serve's ``--width 0`` uses it
    as the reference's does.
  * ``profile_engine(engine, widths)``: the MEASURED source.  It times the
    step the engine deploys through ``DecodeEngine.time_step``: on a CUDA
    device the replay of the captured step (``runtime/graphs.py``), per
    tree shape, executor partition (``hcmp``) and paged verify kernel
    (``tree_kernel``), and returns the ``time_fn`` the search consumes.
    The search is identical, only the timer changes; the scheduler's
    adaptive mode (``runtime/continuous.py`` ``AdaptiveSpeculation``)
    re-runs the argmax online from the measured table plus the observed
    acceptance EMA.

``roofline_time`` is the reference's roofline time source with the H100
SXM data-sheet figures as its defaults; its dry-run inputs are not ported
yet.

Pure numpy: nothing here touches a tensor except through the engine.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.core.speculative import tree as T

WIDTHS = (1, 2, 4, 8, 16, 32, 64)       # powers of two (§III-C2, wave quant)


# ===========================================================================
# workload model (per decode step)
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class Workload:
    weight_bytes: float          # active weight bytes read once per step
    linear_flops: float          # 2 * N_active * W
    attn_dense_flops: float      # W x ctx (the KV-cache part)
    attn_sparse_flops: float     # tree-mask nnz part
    kv_bytes: float              # KV cache bytes read
    sync_points: int             # layer-boundary synchronizations


def decode_workload(cfg, width: int, ctx: int,
                    spec: Optional[T.TreeSpec] = None,
                    dtype_bytes: int = 2) -> Workload:
    n_active = cfg.active_param_count()
    L = cfg.num_layers
    H, hd, Hkv = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    nnz = int(spec.mask.sum()) if spec is not None else width * (width + 1) // 2
    return Workload(
        weight_bytes=n_active * dtype_bytes,
        linear_flops=2.0 * n_active * width,
        attn_dense_flops=2.0 * 2 * width * ctx * H * hd * L,
        attn_sparse_flops=2.0 * 2 * nnz * H * hd * L,
        kv_bytes=2.0 * ctx * Hkv * hd * L * dtype_bytes,
        sync_points=2 * L,
    )


# ===========================================================================
# unified-memory SoC model (Jetson NX calibration)
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class Unit:
    name: str
    flops: float                 # peak FLOP/s (fp16)
    gemm_eff: float              # achieved fraction on dense GEMM (linears)
    sparse_eff: float            # achieved fraction on tree-sparse work
    attn_eff: float = 0.5        # achieved fraction on dense KV-cache
                                 # attention (streaming, smaller GEMMs; CPUs
                                 # are disproportionately bad here: the
                                 # paper's computing-affinity argument)
    bw_frac: float = 0.6         # fraction of shared DRAM bw one unit can
                                 # pull alone (a single engine cannot
                                 # saturate unified LPDDR: the reason
                                 # hetero parallelism beats the 1-unit
                                 # memory floor)


@dataclasses.dataclass(frozen=True)
class Soc:
    units: Sequence[Unit]
    dram_bw: float               # shared bytes/s (both units together)
    sync_latency: float          # per cross-unit sync (unified-memory page)
    contention: float = 1.08     # concurrent-access DRAM efficiency loss
    em_ratio_err: float = 0.03   # EdgeNN's solo-profiled (contention-
                                 # UNAWARE) partition ratio misallocation,
                                 # what ARCA's contention-aware refinement
                                 # fixes (paper §III-C3)

    @property
    def gpu(self):
        return self.units[0]

    @property
    def cpu(self):
        return self.units[1]


# Jetson Xavier NX, clocks locked per paper §IV-A (GPU 204 MHz, CPU 1.9 GHz).
# flops: 48 Volta tensor cores x 64 FMA x 2 x 204 MHz ~ 1.25e12 fp16;
# 6 Carmel cores x 1.9 GHz x 2x128-bit NEON fp16 FMA ~ 0.18e12.
# gemm_eff / bw_frac are the reference's fit to the paper's Fig. 9.  These
# constants model the Jetson board of the paper; none is a figure of the
# H100 the port runs on.
JETSON_NX = Soc(
    units=(
        Unit("volta-384c@204MHz", flops=1.25e12, gemm_eff=0.62,
             sparse_eff=0.05, attn_eff=0.55, bw_frac=0.55),
        Unit("carmel-6c@1.9GHz", flops=182e9, gemm_eff=0.50,
             sparse_eff=0.35, attn_eff=0.12, bw_frac=0.50),
    ),
    dram_bw=59.7e9,
    sync_latency=1e-4,           # <0.1 ms page sync (paper §II-D)
)


def _mem_time(soc: Soc, bytes_, concurrent: bool, unit: "Unit" = None) -> float:
    if concurrent:
        bw = soc.dram_bw / soc.contention
    else:
        bw = soc.dram_bw * (unit or soc.gpu).bw_frac
    return bytes_ / bw


def step_time_sequential(soc: Soc, cfg, ctx: int) -> float:
    """1-token decode on the GPU (the paper's Sequential baseline)."""
    wl = decode_workload(cfg, 1, ctx)
    g = soc.gpu
    t_c = (wl.linear_flops + wl.attn_dense_flops) / (g.flops * g.gemm_eff)
    t_m = _mem_time(soc, wl.weight_bytes + wl.kv_bytes, concurrent=False)
    return max(t_c, t_m)


def step_time_medusa_gpu(soc: Soc, cfg, width: int, ctx: int,
                         spec=None) -> float:
    """Medusa on the GPU only; sparse part executed as dense-with-mask."""
    wl = decode_workload(cfg, width, ctx, spec)
    g = soc.gpu
    dense_as_sparse = 2.0 * 2 * width * width * cfg.num_heads * cfg.head_dim \
        * cfg.num_layers                      # full WxW, mask applied after
    t_c = (wl.linear_flops + wl.attn_dense_flops + dense_as_sparse) \
        / (g.flops * g.gemm_eff)
    t_m = _mem_time(soc, wl.weight_bytes + wl.kv_bytes, concurrent=False)
    return max(t_c, t_m)


def _split_compute(soc: Soc, flops: float, ratio: float) -> float:
    """Column-split GEMM time when GPU takes ``ratio`` of the columns."""
    g, c = soc.gpu, soc.cpu
    return max(flops * ratio / (g.flops * g.gemm_eff),
               flops * (1 - ratio) / (c.flops * c.gemm_eff))


def optimal_ratio(soc: Soc) -> float:
    g, c = soc.gpu, soc.cpu
    eg, ec = g.flops * g.gemm_eff, c.flops * c.gemm_eff
    return eg / (eg + ec)


def step_time_megatron(soc: Soc, cfg, width: int, ctx: int, spec=None,
                       ratio: Optional[float] = None) -> float:
    """Medusa+EM baseline: Megatron (col,row) TP across CPU+GPU with an
    AllReduce every two linears (extra read+write of activations), attention
    split by heads (both units run dense AND masked-sparse work), zero-copy
    sync at every boundary."""
    wl = decode_workload(cfg, width, ctx, spec)
    if ratio is None:
        ratio = max(0.05, optimal_ratio(soc) - soc.em_ratio_err)
    dense_as_sparse = 2.0 * 2 * width * width * cfg.num_heads * cfg.head_dim \
        * cfg.num_layers
    t_c = _split_compute(soc, wl.linear_flops, ratio)
    # head-split attention: the EdgeNN ratio comes from LINEAR-layer solo
    # times, but each unit also gets that share of dense + masked-sparse
    # attention, where the CPU's achievable efficiency is far lower: the
    # affinity miss Ghidorah fixes (paper §III-B2)
    g, c = soc.gpu, soc.cpu
    attn_work = wl.attn_dense_flops + dense_as_sparse
    t_attn = max(attn_work * ratio / (g.flops * g.attn_eff),
                 attn_work * (1 - ratio) / (c.flops * c.attn_eff))
    # AllReduce: read both partials + write combined (3x activation traffic)
    act_bytes = 2.0 * width * cfg.d_model * cfg.num_layers * 2
    t_m = _mem_time(soc, wl.weight_bytes + wl.kv_bytes + 3 * act_bytes,
                    concurrent=True)
    t_sync = soc.sync_latency * wl.sync_points
    return max(t_c + t_attn, t_m) + t_sync


def step_time_ghidorah(soc: Soc, cfg, width: int, ctx: int, spec=None,
                       ratio: Optional[float] = None) -> float:
    """HCMP: column-only splits (no AllReduce traffic), dense attention to
    the GPU, tree-sparse attention to the CPU (optimized SpMM), online-
    softmax merge fused into the reduce (paper: 'almost no overhead')."""
    wl = decode_workload(cfg, width, ctx, spec)
    ratio = optimal_ratio(soc) if ratio is None else ratio
    g, c = soc.gpu, soc.cpu
    t_lin = _split_compute(soc, wl.linear_flops, ratio)
    t_attn = max(wl.attn_dense_flops / (g.flops * g.attn_eff),
                 wl.attn_sparse_flops / (c.flops * c.sparse_eff))
    t_m = _mem_time(soc, wl.weight_bytes + wl.kv_bytes, concurrent=True)
    t_sync = soc.sync_latency * (wl.sync_points / 2)   # one sync per layer
    return max(t_lin + t_attn, t_m) + t_sync


def contention_aware_ratio(soc: Soc, cfg, width: int, ctx: int,
                           iters: int = 12) -> float:
    """§III-C3: start from solo execution times, refine by bisection on the
    bottleneck unit under the contention model."""
    lo, hi = 0.05, 0.95
    wl = decode_workload(cfg, width, ctx)
    g, c = soc.gpu, soc.cpu
    for _ in range(iters):
        r = 0.5 * (lo + hi)
        tg = wl.linear_flops * r / (g.flops * g.gemm_eff)
        tc = wl.linear_flops * (1 - r) / (c.flops * c.gemm_eff)
        if tg > tc:
            hi = r
        else:
            lo = r
    return 0.5 * (lo + hi)


# ===========================================================================
# strategy search (speculative + partitioning)
# ===========================================================================
@dataclasses.dataclass
class Strategy:
    width: int
    tree: T.TreeSpec
    ratio: float
    acceptance: float
    step_time: float
    throughput: float            # tokens/s
    hcmp: str = "inline"         # measured executor partition for this
                                 # width: "inline" (draft inside the step)
                                 # or "overlap" (draft on the second
                                 # executor, core/hcmp/executors.py), set
                                 # from profile_engine's dual-mode timings
    tree_kernel: str = "dense"   # measured paged verify kernel for this
                                 # width: "dense" (fused page walk + tree
                                 # tile) or "sparse" (page walk + tree
                                 # partial), set from profile_engine's
                                 # per-kernel timings


def choose_strategy(cfg, accs: np.ndarray, ctx: int = 256,
                    soc: Soc = JETSON_NX,
                    time_fn: Optional[Callable] = None,
                    widths: Sequence[int] = WIDTHS,
                    evaluator=None) -> Dict[int, Strategy]:
    """For every candidate width: build the tree (greedy + refine), estimate
    acceptance, time the step, compute tokens/s.  Returns {width: Strategy};
    the deployment choice is the argmax."""
    out = {}
    for w in widths:
        spec = T.candidate_spec(accs, w, evaluator=evaluator)
        al = T.expected_acceptance_length(spec, accs)
        ratio = contention_aware_ratio(soc, cfg, w, ctx)
        hcmp = "inline"
        tkern = "dense"
        if time_fn is not None:
            t = time_fn(cfg, w, ctx, spec)
            # a measured time_fn from profile_engine also knows which
            # executor partition / verify kernel its best time came from:
            # both are chosen exactly the way the speculative strategy is
            part = getattr(time_fn, "partition_for", None)
            if part is not None:
                hcmp = part(spec)
            kern = getattr(time_fn, "kernel_for", None)
            if kern is not None:
                tkern = kern(spec)
        elif w == 1:
            t = step_time_sequential(soc, cfg, ctx)
        else:
            t = step_time_ghidorah(soc, cfg, w, ctx, spec, ratio)
        out[w] = Strategy(width=w, tree=spec, ratio=ratio, acceptance=al,
                          step_time=t, throughput=al / t, hcmp=hcmp,
                          tree_kernel=tkern)
    return out


def best(strategies: Dict[int, Strategy]) -> Strategy:
    return max(strategies.values(), key=lambda s: s.throughput)


def profile_engine(engine, widths: Optional[Sequence[int]] = None, *,
                   accs: Optional[np.ndarray] = None, batch: int = 1,
                   prompt_len: int = 16, reps: int = 3,
                   hcmp_modes: Optional[Sequence[str]] = None,
                   tree_kernels: Optional[Sequence[str]] = None) -> Callable:
    """Measured time source for ``choose_strategy``: returns a
    ``time_fn(cfg, width, ctx, spec)`` that times the engine's deployed
    step for the given tree through ``DecodeEngine.time_step`` (one
    measurement per tree SHAPE and serving batch, ``(width, max_depth,
    n_paths, batch)``, cached, so the search never re-times a same-shape
    candidate and switching back to a profiled width is free).

    ``batch`` must be the SERVING batch (the adaptive scheduler's bank
    width B): per-step cost is strongly batch-dependent, so a width ranked
    at batch=1 can be the wrong pick at B=8; the batch is part of the
    timing cache key for the same reason.

    ``hcmp_modes`` names the executor partitions to time per candidate
    ("inline" / "overlap", core/hcmp/executors.py).  Default: both when
    the engine is already running the overlap schedule, else inline only.
    The returned ``time_fn`` reports each shape's BEST partition time, and
    ``time_fn.partition_for(spec)`` names the winning partition, which
    ``choose_strategy`` stamps on the ``Strategy``.

    ``tree_kernels`` names the paged verify kernels to time per candidate
    and partition ("dense" / "sparse", see ``DecodeEngine.time_step``).
    Default: both when the engine already runs the split kernel, else
    dense only.  ``time_fn.times[skey + (mode,)]`` stays each partition's
    BEST kernel time; per-kernel times land at ``skey + (mode, kernel)``
    (when more than one kernel is timed) and ``time_fn.kernel_for(spec)``
    names the overall winner, which ``choose_strategy`` stamps on the
    ``Strategy``.

    ``widths`` pre-measures those candidates up front (trees built from
    ``accs``, default: the engine model's calibration table shape), which
    also warms each width's step; unseen shapes are measured lazily on
    first use.
    """
    if hcmp_modes is None:
        hcmp_modes = ("inline", "overlap") \
            if getattr(engine, "hcmp", "inline") == "overlap" else ("inline",)
    hcmp_modes = tuple(hcmp_modes)
    for m in hcmp_modes:
        if m == "overlap" and not getattr(engine, "hcmp_capable", False):
            raise ValueError("cannot profile the overlap partition: the "
                             "engine has no draft source to disaggregate")
    if tree_kernels is None:
        tree_kernels = ("dense", "sparse") \
            if getattr(engine, "tree_kernel", "dense") == "sparse" \
            else ("dense",)
    tree_kernels = tuple(tree_kernels)
    for tk in tree_kernels:
        if tk == "sparse" and not getattr(engine, "paged", False):
            raise ValueError("cannot profile the sparse tree kernel: the "
                             "split verify path is paged-only")
    times: Dict[tuple, float] = {}
    partition: Dict[tuple, str] = {}
    kernel: Dict[tuple, str] = {}

    def _measure(spec) -> tuple:
        skey = (spec.width, spec.max_depth, spec.n_paths, batch)
        if skey not in partition:
            strategy = engine.strategy_for(spec)
            per = {}
            for mode in hcmp_modes:
                for tk in tree_kernels:
                    per[(mode, tk)] = engine.time_step(
                        strategy, batch=batch, prompt_len=prompt_len,
                        reps=reps, hcmp=mode, tree_kernel=tk)
                    if len(tree_kernels) > 1:
                        times[skey + (mode, tk)] = per[(mode, tk)]
                # the (mode,) key existing consumers read: the
                # partition's best kernel time
                times[skey + (mode,)] = min(
                    per[(mode, tk)] for tk in tree_kernels)
            mode, tk = min(per, key=per.get)
            partition[skey], kernel[skey] = mode, tk
        return skey

    def time_fn(cfg, width, ctx, spec) -> float:
        skey = _measure(spec)
        return times[skey + (partition[skey],)]

    def partition_for(spec) -> str:
        return partition[_measure(spec)]

    def kernel_for(spec) -> str:
        return kernel[_measure(spec)]

    time_fn.partition_for = partition_for
    time_fn.kernel_for = kernel_for
    time_fn.batch = batch
    time_fn.hcmp_modes = hcmp_modes
    time_fn.tree_kernels = tree_kernels
    time_fn.times = times

    if widths:
        table = accs
        if table is None:
            mcfg = engine.model.cfg
            table = T.default_accs(mcfg.medusa_heads, mcfg.medusa_top_k)
        for w in widths:
            time_fn(None, w, prompt_len, T.candidate_spec(table, w))
    return time_fn


# ===========================================================================
# roofline time source (per-device quantities)
# ===========================================================================
# NVIDIA H100 SXM data-sheet figures: dense bf16 tensor-core rate, HBM3
# rate, NVLink rate per direction.  The reference's defaults are a TPU's.
H100_PEAK_BF16 = 989e12          # FLOP/s
H100_HBM = 3.35e12               # B/s
H100_NVLINK = 450e9              # B/s per direction


def roofline_time(flops_per_dev: float, hbm_bytes_per_dev: float,
                  coll_bytes_per_dev: float, *, peak=H100_PEAK_BF16,
                  hbm=H100_HBM, ici=H100_NVLINK) -> dict:
    t_c = flops_per_dev / peak
    t_m = hbm_bytes_per_dev / hbm
    t_x = coll_bytes_per_dev / ici
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "bound": dom[1], "step_s": max(t_c, t_m, t_x)}
