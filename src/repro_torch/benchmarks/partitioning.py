"""Fig. 10a: static vs dynamic dense/sparse attention partitioning as the
context grows, attention-module time at verification width 64
(counterpart of ``benchmarks/partitioning.py``), on the paper's Jetson
model: the times are its predictions, not the device's.

Static  = all sparse work on the CPU, all dense on the GPU, boundary fixed.
Dynamic = ARCA re-balances the boundary per context length (the dense
part's left columns can move to whichever unit has slack, §III-B2).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import arca
from repro_torch.core.speculative import tree as T

CTXS = (128, 256, 512, 1024, 2048, 4096)
WIDTH = 64


def attn_times(soc, cfg, ctx, spec):
    wl = arca.decode_workload(cfg, WIDTH, ctx, spec)
    g, c = soc.gpu, soc.cpu
    t_static = max(wl.attn_dense_flops / (g.flops * g.gemm_eff),
                   wl.attn_sparse_flops / (c.flops * c.sparse_eff))
    # dynamic: move fraction x of the dense work to the CPU to balance
    best = t_static
    for x in np.linspace(0, 0.4, 41):
        tg = wl.attn_dense_flops * (1 - x) / (g.flops * g.gemm_eff)
        tc = (wl.attn_sparse_flops / c.sparse_eff
              + wl.attn_dense_flops * x / c.gemm_eff) / c.flops
        best = min(best, max(tg, tc))
    return t_static, best


def run() -> list:
    cfg = get_config("vicuna-7b")
    soc = arca.JETSON_NX
    accs = T.default_accs(5, 10)
    spec = T.build_tree(accs, WIDTH)
    print("ctx     static(ms)  dynamic(ms)  gain   (Jetson model)")
    gains = []
    for ctx in CTXS:
        ts, td = attn_times(soc, cfg, ctx, spec)
        gains.append(ts / td)
        print(f"{ctx:6d} {ts*1e3:10.3f} {td*1e3:11.3f}  {ts/td:5.2f}x")
    print(f"# dynamic gain grows with context: {gains[0]:.2f}x @128 -> "
          f"{gains[-1]:.2f}x @4096 (paper Fig10a: 'obvious improvements at "
          f"large context lengths')")
    return [("fig10a_dynamic_gain_ctx128", gains[0],
             "small ctx, jetson-model"),
            ("fig10a_dynamic_gain_ctx4096", gains[-1],
             "large ctx, jetson-model")]
