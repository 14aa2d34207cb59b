"""The readings the limits of ``correct`` are set from: a cell run on many
seeds in one process, each judged by the reference and, on the same
sample, the fp8 control put in the program's place.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 15 [--out chiprun_out/calib.jsonl]

Each seed prints one JSON line: the program's numbers (``token_gap``,
``draft_gap``, ...) and the control's (``controls``).  The program's
largest reading over a dozen seeds or more is the lower reading, the
control's smallest the upper one (``PERF.md`` gives both and the limit
set between them).  The benchmark's own runs never run the control.
A cell of ``BENCHMARK.json`` or of ``deferred.json``.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != HERE]
    import torch
    from portbench import cell, spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.with_deferred(spec.load_benchmark(ROOT))
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = cell.run(bench, args.workload, seed, args.seconds, False,
                       "cuda", t0, control=True)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "checks": {k: v["value"] for k, v in
                                      res["checks"].items()},
                           "controls": res["controls"],
                           "attempted": res["attempted"],
                           "metrics": {k: v["value"] for k, v in
                                       res["metrics"].items()},
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
