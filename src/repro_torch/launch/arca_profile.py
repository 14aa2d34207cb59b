"""ARCA profiling walkthrough (paper §III-C, Fig. 8), counterpart of
``examples/arca_profile.py``: tree construction, width selection and
contention-aware partitioning on the calibrated Jetson model, with the
reference's printout.  Numpy only: it needs no GPU.

  PYTHONPATH=src python -m repro_torch.launch.arca_profile [--arch vicuna-7b]

The reference's last section, the roofline from TPU dry-run artifacts,
has no input here yet: the dry-run tooling is not ported.  The measured
strategy table of the H100 comes from ``arca.profile_engine`` (``serve.py
--spec-width auto``, ``chip_smoke.py``).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.core import arca
from repro_torch.core.speculative import tree as T


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch."
                                      "arca_profile")
    ap.add_argument("--arch", default="vicuna-7b")
    ap.add_argument("--ctx", type=int, default=256)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)

    accs = T.default_accs(cfg.medusa_heads, cfg.medusa_top_k)
    print("== verification-tree construction (width 16, Fig. 8) ==")
    greedy = T.build_tree_greedy(accs, 16)
    refined = T.refine_tree(greedy, accs)
    print(f"greedy  E[AL] = {T.expected_acceptance_length(greedy, accs):.3f}")
    print(f"refined E[AL] = {T.expected_acceptance_length(refined, accs):.3f}")
    print("node (parent, depth, rank):")
    for i in range(refined.width):
        print(f"  n{i:02d} <- p{refined.parent[i]:02d} "
              f"d{refined.depth[i]} r{refined.rank[i]}")

    print(f"\n== strategy table ({args.arch}, ctx={args.ctx}, Jetson sim) ==")
    strats = arca.choose_strategy(cfg, accs, ctx=args.ctx)
    seq_t = arca.step_time_sequential(arca.JETSON_NX, cfg, args.ctx)
    for w, s in strats.items():
        print(f"W={w:3d} E[AL]={s.acceptance:5.2f} ratio={s.ratio:.3f} "
              f"step={s.step_time*1e3:7.1f}ms thr={s.throughput:6.2f} tok/s "
              f"({s.throughput*seq_t:4.2f}x)")
    print(f"ARCA deployment choice: width={arca.best(strats).width}")


if __name__ == "__main__":
    main()
