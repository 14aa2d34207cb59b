"""The open-loop cell's rate sweep, run once to fix the rate its traffic
file states: the cell at each offered rate for one window, in one
process, and how the queue of requests due but not yet admitted moves
across the window.  The knee is the highest rate whose queue does not
grow.

    python3 portbench/sweep.py --workload mistral-7b.chat \\
        --rates 3,4,5,6,7 --seconds 30 --seed 1

A cell of ``BENCHMARK.json`` or of ``deferred.json``.  Prints one JSON
line a rate: the queue at each sixth of the window, the
requests due and finished, and the cell's end-to-end metrics.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def queue_at(records, t) -> int:
    """Requests due by ``t`` and not admitted by then."""
    return sum(r.due <= t and (r.t_admit is None or r.t_admit > t)
               for r in records)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != HERE]
    import torch
    from portbench import cell, spec
    bench = spec.with_deferred(spec.load_benchmark(ROOT))
    mix0 = spec.traffic(spec.workload(bench, args.workload)["traffic"])
    for rate in (float(r) for r in args.rates.split(",")):
        mix = copy.deepcopy(mix0)
        n = int(round(rate * args.seconds))
        mix.update(rate_per_s=rate, requests=n, block=n)
        probe = {}
        res = cell.run(bench, args.workload, args.seed, args.seconds, False,
                       "cuda", time.perf_counter(), mix=mix, probe=probe)
        ctx = probe["ctx"]
        w0, w1 = ctx.window
        marks = [w0 + args.seconds * k / 6 for k in range(1, 7)]
        print(json.dumps({
            "rate": rate, "due": len(ctx.records),
            "done": sum(r.state == "DONE" for r in ctx.records),
            "queue": [queue_at(ctx.records, t) for t in marks],
            "correct": res["correct"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()}}),
            flush=True)
        del ctx, probe
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
