"""Ablations beyond the paper's headline figures (counterpart of
``benchmarks/ablations.py``), all on the estimator and the paper's Jetson
model: predictions, not device times.

  1. tree refinement (Fig. 8's brute-force step) vs greedy only: the
     acceptance length the local search adds at each width;
  2. contention-aware partition ratio (ARCA §III-C3) vs EdgeNN's
     solo-profiled ratio: the step-time cost of the misallocation;
  3. the verification width's sweet spot across model scales (the wave
     quantization argument, §III-C2): optimum width vs model size.
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core import arca
from repro_torch.core.speculative import tree as T


def tree_refinement_ablation():
    accs = T.default_accs(5, 10)
    print("width  greedy-E[AL]  refined-E[AL]  gain")
    rows = []
    for w in (4, 8, 16, 32):
        g = T.build_tree_greedy(accs, w)
        r = T.refine_tree(g, accs)
        ag = T.expected_acceptance_length(g, accs)
        ar = T.expected_acceptance_length(r, accs)
        print(f"{w:5d} {ag:12.4f} {ar:13.4f} {ar/ag:6.4f}x")
        rows.append((w, ag, ar))
    # greedy is estimator-optimal (top-W path products), so refinement
    # under the same estimator is a no-op; its value shows only with an
    # empirical evaluator (``engine.measure_acceptance``)
    return [("ablation_refine_gain_w16", rows[2][2] / rows[2][1], "estimator")]


def contention_ratio_ablation():
    cfg = get_config("vicuna-7b")
    soc = arca.JETSON_NX
    spec = T.build_tree(T.default_accs(5, 10), 16)
    print("em_ratio_err  step_time(ms)  vs aware   (Jetson model)")
    aware = arca.step_time_ghidorah(
        soc, cfg, 16, 256, spec, arca.contention_aware_ratio(soc, cfg, 16,
                                                             256))
    out = []
    for err in (0.0, 0.03, 0.06, 0.12):
        r = max(0.05, arca.optimal_ratio(soc) - err)
        t = arca.step_time_ghidorah(soc, cfg, 16, 256, spec, r)
        print(f"{err:12.2f} {t*1e3:13.1f} {t/aware:8.2f}x")
        out.append(t / aware)
    return [("ablation_ratio_err12_slowdown", out[-1],
             "vs contention-aware, jetson-model")]


def width_vs_scale_ablation():
    accs = T.default_accs(5, 10)
    print("model        params  ARCA width  (Jetson model)")
    rows = []
    for arch in ("qwen2-0.5b", "stablelm-3b", "vicuna-7b", "glm4-9b"):
        cfg = get_config(arch)
        strats = arca.choose_strategy(cfg, accs, ctx=256)
        best = arca.best(strats)
        print(f"{arch:12s} {cfg.param_count()/1e9:5.1f}B {best.width:8d}")
        rows.append((arch, best.width))
    return [("ablation_width_" + a.replace("-", "_"), float(w), "jetson-sim")
            for a, w in rows]


def run() -> list:
    out = []
    print("-- tree refinement (greedy vs brute-force) --")
    out += tree_refinement_ablation()
    print("-- contention-aware vs solo-profiled ratio --")
    out += contention_ratio_ablation()
    print("-- ARCA width vs model scale --")
    out += width_vs_scale_ablation()
    return out
