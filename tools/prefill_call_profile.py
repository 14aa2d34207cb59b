"""Device and host time of the ``mistral-7b.decode`` cell's prefill calls,
graphed and eager, one call at a time, and the kernels of one graphed
admission and one graphed chunked-prefill piece, on the card:

    python3 tools/prefill_call_profile.py OUT.json

The cell's own engine (``portbench/cell.py::build``: Mistral-7B at its
published widths, random weights from a seed, the bank of 32, pieces of
C = 512) over a bootstrapped bank.  Each case is timed six times with CUDA
events around the call and a sync after it, the first dropped: admissions
of 100-512 tokens (the graphed ones padded to 128, 256 or 512) and pieces
at 512-1536 cached positions; then the same inside ``eager()``.  Prints the
medians and the top kernels by device time (``torch.profiler``), and
writes every reading to OUT.json.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SEED = 2900000201
ROW = 5                         # the bank row every measured call lands in


def main(out_path: str) -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import cell, spec
    from repro_torch.runtime.engine import eager
    from torch.profiler import ProfilerActivity, profile

    bench = spec.load_benchmark(ROOT)
    cfgfile = spec.config_file(bench, "mistral-7b", ROOT)
    eng = cell.build(cfgfile, spec.traffic("decode32", ROOT), SEED,
                     torch.device("cuda")).eng
    C = cfgfile["serve"]["prefill_chunk"]
    rng = np.random.default_rng(1)

    def prompt(n):
        return rng.integers(0, cfgfile["vocab_size"], (1, n)).astype(
            np.int32)

    eng.sched_piece_width(C)
    row = eng.sched_prefill({"tokens": prompt(300)})
    bank = eng.sched_blank(row, cfgfile["serve"]["bank"])
    bank = eng.sched_insert(bank, 0, row, prompt_len=300, n_tokens=8)

    def admit(bank, S, reserve):
        eng.sched_release(ROW)
        return eng.sched_admit(bank, ROW, {"tokens": prompt(S)}, n_tokens=8,
                               reserve_len=reserve)

    def extend(bank, n):
        piece = np.zeros((1, C), np.int32)
        piece[0, :n] = prompt(n)
        return eng.sched_extend(bank, ROW, piece, n)

    def timed(fn, *a):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        res = fn(*a)
        host = time.perf_counter() - t0
        e1.record()
        torch.cuda.synchronize()
        return res, host * 1e3, e0.elapsed_time(e1)

    def cases(bank):
        got = {}
        for S in (100, 128, 200, 256, 400, 512):
            rows = []
            for _ in range(6):
                (bank, _), h, d = timed(admit, bank, S, S)
                rows.append((h, d))
            got[f"admit {S}"] = rows[1:]
        for ctx, n in ((512, 512), (1024, 512), (1536, 300)):
            rows = []
            for _ in range(6):
                bank, _ = admit(bank, C, ctx + n)
                for _ in range(ctx // C - 1):
                    bank, _ = extend(bank, C)
                (bank, _), h, d = timed(extend, bank, n)
                rows.append((h, d))
            got[f"extend ctx {ctx} n {n}"] = rows[1:]
        return bank, got

    out = {"card": cell.card()}
    bank, out["graphed"] = cases(bank)
    with eager():
        bank, out["eager"] = cases(bank)
    out["graph_stats"] = eng.graph_stats
    print(f"card: {out['card']}")
    for path in ("graphed", "eager"):
        for k, rows in out[path].items():
            h = np.median([r[0] for r in rows])
            d = np.median([r[1] for r in rows])
            print(f"{path:7s} {k:24s} host {h:8.3f} ms  device {d:8.3f} ms")
    bank, _ = admit(bank, C, 1536)
    bank, _ = extend(bank, C)
    for label, fn in (("admit 512", lambda b: admit(b, 512, 512)),
                      ("extend ctx 1024", lambda b: extend(b, C))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bank, _ = fn(bank)
            torch.cuda.synchronize()
        rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                       for e in prof.key_averages()), key=lambda r: -r[1])
        out[f"kernels {label}"] = rows[:25]
        print(f"--- kernels of one graphed {label}: "
              f"{sum(r[1] for r in rows):.3f} ms")
        for k, ms, n in rows[:18]:
            print(f"  {ms:8.3f} ms x{n:4d} {k[:110]}")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1, default=str)


if __name__ == "__main__":
    main(sys.argv[1])
