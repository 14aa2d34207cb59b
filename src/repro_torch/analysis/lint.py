"""torchlint CLI.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch --rules T2,T3
    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch --write-baseline
    PYTHONPATH=src python -m repro_torch.analysis.lint --list-rules

Exit status 0 iff every finding is suppressed inline or present in the
committed baseline (``src/repro_torch/analysis/baseline.txt`` by default);
otherwise each fresh finding prints as ``file:line RULE message`` and the
exit status is 1.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import core

_DEFAULT_BASELINE = Path(__file__).parent / "baseline.txt"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Static invariant checks of the PyTorch/CUDA port "
                    "(capture purity, in-place state, host syncs, locks, "
                    "the state walker, the slot protocol, capture "
                    "hygiene, launch bounds, the boundary-protocol model "
                    "check)")
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset, e.g. T1,T3")
    ap.add_argument("--baseline", default=str(_DEFAULT_BASELINE),
                    help="baseline file of grandfathered finding keys")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline and exit 0")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--root", default=None,
                    help="anchor for relative paths in findings/baseline")
    ap.add_argument("--format", choices=("text", "github"), default="text",
                    help="'github' also prints workflow-command annotations "
                         "(::error file=...) for each finding")
    args = ap.parse_args(argv)

    if args.list_rules:
        core._ensure_rules_loaded()
        for rid in sorted(core.RULE_DOC):
            print(f"{rid}  {core.RULE_DOC[rid]}")
        return 0
    if not args.paths:
        ap.error("no paths given (or use --list-rules)")

    rules = [r.strip() for r in args.rules.split(",")] if args.rules \
        else None
    root = Path(args.root) if args.root else None
    findings = core.lint_paths(args.paths, rules=rules, root=root)

    if args.write_baseline:
        core.write_baseline(args.baseline, findings)
        print(f"torchlint: wrote {len(findings)} finding key(s) to "
              f"{args.baseline}")
        return 0

    baseline = set() if args.no_baseline else \
        core.load_baseline(args.baseline)
    fresh = [f for f in findings if f.key not in baseline]
    for f in fresh:
        print(f.render())
        if args.format == "github":
            msg = f"{f.rule}: {f.message}".replace("%", "%25") \
                .replace("\r", "%0D").replace("\n", "%0A")
            print(f"::error file={f.path},line={f.line},"
                  f"title=torchlint {f.rule}::{msg}")
    n_base = len(findings) - len(fresh)
    if fresh:
        print(f"torchlint: {len(fresh)} finding(s)"
              + (f" ({n_base} baselined)" if n_base else ""),
              file=sys.stderr)
        return 1
    stale = baseline - {f.key for f in findings}
    if stale:
        print(f"torchlint: clean; {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} can be deleted",
              file=sys.stderr)
    print("torchlint: clean"
          + (f" ({n_base} baselined finding(s))" if n_base else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
