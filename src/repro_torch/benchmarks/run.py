"""The port's evaluation harness, one function per paper table or figure
(counterpart of ``benchmarks/run.py``):

  Table I   -> acceptance.run()     (verification-tree acceptance lengths)
  Fig 9     -> throughput.run()     (4 systems x widths, Jetson model)
  Fig 10a   -> partitioning.run()   (static vs dynamic partitioning)
  ablations -> ablations.run()      (beyond the paper)
  Fig 10b   -> sparse.run()         (tree-sparse strategies; B5, B2-B4)
  micro     -> microbench.run()     (decode / W=16 step, deployed + eager)
  engine    -> engine_bench.run()   (sequential vs speculative, B x K)
  sched     -> sched_bench.run()    (static vs continuous, its five arms)
  roofline  -> roofline.table(), int8_kv_note()

Table I, Fig. 9, Fig. 10a and the ablations are analytic (the estimator
and the paper's Jetson model): they run in a process of their own beside
the measured sections, so their host time does not share the measured
sections' interpreter.  The measured sections run on ``--device`` (cuda
unless asked for the CPU) and their records go to ``results/torch/``
(``--out``), each with the card's name and power limit.  Prints
``name,us_per_call,derived`` CSV at the end.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]

``main(argv, loaded=...)`` reuses a model already on the device (a
``launch.serve.Loaded`` whose ``cfg.name`` is the ``--arch``, the
``--micro-arch`` or the ``--sched-arch``) instead of drawing it again.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import multiprocessing
import time

from repro_torch.benchmarks import (benchlib, engine_bench, microbench,
                                    roofline, sched_bench, sparse)
from repro_torch.devices import resolve_device


def analytic_tables():
    """Table I, Fig. 9, Fig. 10a and the ablations: (printed text, rows)."""
    from repro_torch.benchmarks import (ablations, acceptance, partitioning,
                                        throughput)
    buf = io.StringIO()
    rows = []
    with contextlib.redirect_stdout(buf):
        fit = acceptance.fit_accs()
        print("=" * 70)
        print("## Table I — acceptance length vs width (estimator)")
        rows += acceptance.run(fit)
        print("=" * 70)
        print("## Fig 9 — decoding throughput (Jetson model, predicted)")
        rows += throughput.run(fit)
        print("=" * 70)
        print("## Fig 10a — dynamic partitioning (Jetson model, predicted)")
        rows += partitioning.run()
        print("=" * 70)
        print("## ablations (beyond paper; estimator and Jetson model)")
        rows += ablations.run()
    return buf.getvalue(), rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="record directory (default results/torch/)")
    engine_bench.add_args(ap)
    ap.set_defaults(tokens=32)          # the harness's engine budget
    ap.add_argument("--micro-arch", default="qwen2-0.5b-smoke")
    ap.add_argument("--micro-reps", type=int, default=10)
    sched_bench.add_args(ap)
    ap.add_argument("--sparse-reps", type=int, default=5)
    return ap.parse_args(argv)


def main(argv=None, loaded=None, watch=benchlib.unwatched) -> dict:
    """Run every section; returns ``{"rows": [...], "records": {...},
    "seconds": {...}}``.  ``watch(name)`` wraps each measured arm."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    have = {} if loaded is None else {loaded.cfg.name: loaded}

    def model(arch, config):
        if arch not in have:
            have[arch] = engine_bench.load(config(arch), device)
        return have[arch]

    t0 = time.perf_counter()
    times = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        analytic = pool.submit(analytic_tables)
        rows = []
        records = {}

        def section(title, name, fn):
            print("=" * 70)
            print(f"## {title}", flush=True)
            t = time.perf_counter()
            out = fn()
            times[name] = time.perf_counter() - t
            return out

        rows += section("Fig 10b — sparse strategies (measured)", "sparse",
                        lambda: sparse.run(device=device,
                                           reps=args.sparse_reps,
                                           watch=watch))
        rows += section(
            "micro — step latencies", "micro",
            lambda: microbench.run(model(args.micro_arch,
                                         engine_bench.bench_config),
                                   reps=args.micro_reps, watch=watch))
        records["engine_bench"] = section(
            "engine — measured tokens/sec (batch x chunk)", "engine",
            lambda: engine_bench.run(
                model(args.arch, engine_bench.bench_config),
                width=args.width, n_tokens=args.tokens, reps=args.reps,
                prompt_len=args.prompt_len, train_steps=args.train_steps,
                head_steps=args.head_steps, out_dir=args.out, watch=watch))
        rows += engine_bench.rows_of(records["engine_bench"])
        records["sched_bench"] = section(
            "sched — continuous vs static batching (poisson arrivals)",
            "sched",
            lambda: sched_bench.run(
                model(args.sched_arch, sched_bench.bench_config),
                sizes=sched_bench.sizes_of(args), arms=args.arms,
                out_dir=args.out, watch=watch))
        rows += sched_bench.rows_of(records["sched_bench"])

        tb = roofline.table()
        if tb:
            print("=" * 70)
            print("## Roofline (the port's dry-run records, H100 figures)")
            print(roofline.render_markdown(tb))
            ok = [r for r in tb if r.get("status") == "ok"]
            rows.append(("roofline_cases_ok", float(len(ok)),
                         f"of {len(tb)}"))
        kvn = roofline.int8_kv_note()
        records["int8_kv_note"] = kvn
        rows.append(("roofline_int8_kv_bytes_reduction", kvn["reduction"],
                     f"{kvn['arch']} ps={kvn['page_size']}"))

        t = time.perf_counter()
        text, analytic_rows = analytic.result()
        times["analytic (waited)"] = time.perf_counter() - t
    print(text, end="")
    rows = analytic_rows + rows
    print("=" * 70)
    print(f"# sections (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
          + f"; total {time.perf_counter() - t0:.1f}")
    print("name,us_per_call,derived")
    for name, val, derived in rows:
        print(f"{name},{val:.4f},{derived}")
    return {"rows": rows, "records": records, "seconds": times}


if __name__ == "__main__":
    main()
