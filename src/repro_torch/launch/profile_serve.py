"""Where a serve run's time goes on the GPU: a serve of ``launch/serve.py``
(same flags: the fixed batch, or an in-process ``--arrivals poisson``
replay) run once to warm up, then once more on the same engine under
``torch.profiler`` (device activity only).  Prints the wall time, the
device-busy time (the union of all device activity intervals) and the
idle share, the device activities per decode step, and the device time by
kernel class and by kernel.

With ``--hcmp overlap`` the draft of each step runs on a second stream
beside the commit: the report adds the device time during which two
activities run at once (a single stream never overlaps itself) and the
streams the kernels ran on.  The overlap gate's inline serve is not run
under the profiler.

The serve deploys the compiled chunk (``runtime/graphs.py``): the decode
steps replay a captured CUDA graph, whose kernels the profiler records one
by one like launched ones.  ``main`` profiles that path, then the same
serve with every chunk run op by op (``runtime.engine.eager()``), so the
two read side by side.  The warm-up run on the engine means the profiled
graphed run has no eager warm-up chunk; its own prefill still brings new
K/V, so it captures once more (``capture_s`` in the report).

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch vicuna-7b --mode ghidorah --width 8 --batch 4 \\
      --prompt-len 512 --tokens 64 --chunk 8 [--paged --kv-dtype int8 ...]

Needs a GPU; it exits non-zero if the profiler records no device activity.
"""
from __future__ import annotations

import collections
import contextlib
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve
from repro_torch.runtime.engine import eager

_CLASSES = (
    ("B1 verify", ("verify_flash_kernel", "verify_attention_kernel")),
    ("B2/B3 page walk", ("paged_flash_kernel", "paged_attention_kernel",
                         "cache_flash_kernel")),
    ("split merge and fold", ("merge_kernel", "carry_fold_kernel")),
    ("B4 tree partial", ("tree_warp_kernel", "tree_partial_kernel")),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")),
    ("copy/fill", ("memcpy", "memset", "copy", "fill")),
)


def _class(name: str) -> str:
    low = name.lower()
    for label, keys in _CLASSES:
        if any(k in low for k in keys):
            return label
    return "other (elementwise, reductions, indexing)"


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _overlap_us(intervals) -> float:
    """Length of the time covered by two or more [start, end) intervals."""
    edges = sorted([(s, 1) for s, _ in intervals]
                   + [(e, -1) for _, e in intervals])
    total, depth, last = 0.0, 0, None
    for t, d in edges:
        if depth >= 2:
            total += t - last
        depth += d
        last = t
    return total


def profile_serve(args, loaded) -> dict:
    """Serve ``args`` twice on one engine, the second time under the
    profiler, on the path the caller's context deploys (the graphs, or
    every chunk op by op inside ``eager()``).  Returns the wall, busy and
    idle figures, the device time by class and by kernel, and the engines'
    graph counters of the profiled run."""
    eng, adaptive = serve.prepare(args, loaded)
    kw = dict(engine=eng, adaptive=adaptive, gate=False)
    serve.run(args, loaded, **kw)                        # warm-up
    torch.cuda.synchronize()
    before = eng.graph_stats
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = serve.run(args, loaded, **kw)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    after = eng.graph_stats
    return dict(device_summary(prof, wall_us),
                steps=res["stats"]["device_steps"],
                pieces=res["stats"].get("extend_pieces", 0),
                graphs={k: after[k] - before[k] for k in
                        ("captures", "replays", "capture_s")})


def device_summary(prof, wall_us) -> dict:
    """The device side of a finished ``torch.profiler`` run that took
    ``wall_us`` on the host: busy time (the union of the activities),
    idle share, activities, time with two at once, streams, and the
    device time by kernel class and by kernel.  Raises SystemExit when
    the profiler recorded no device activity."""
    # the raw device activities (building the profiler's event tree for
    # ~170k kernels of an eager run costs tens of seconds of host time)
    dev = [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3,
            e.device_resource_id())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    if not dev:
        raise SystemExit("the profiler recorded no device activity")
    spans = [(start, start + us) for _, start, us, _ in dev]
    busy = _busy_us(spans)
    by_class = collections.Counter()
    by_name = collections.Counter()
    count = collections.Counter()
    for name, _, us, _ in dev:
        by_class[_class(name)] += us
        by_name[name] += us
        count[name] += 1
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                idle_share=1 - busy / wall_us, activities=len(dev),
                overlap_ms=_overlap_us(spans) / 1e3,
                streams=len({stream for *_, stream in dev}),
                by_class={k: v / 1e3 for k, v in by_class.items()},
                by_name={k: v / 1e3 for k, v in by_name.items()},
                count=dict(count))


def report(label, r):
    """The profile's lines, each tagged with ``label``."""
    print(f"[profile] {label}: wall {r['wall_ms']:.2f} ms (prefills + "
          f"{r['steps']} decode steps + {r['pieces']} prefill pieces), "
          f"device busy {r['busy_ms']:.2f} ms, idle share "
          f"{r['idle_share']:.3f}, {r['activities']} device activities "
          f"({r['activities'] / max(r['steps'], 1):.0f} per step incl. "
          f"prefill); graphs: {r['graphs']['captures']} captured in "
          f"{r['graphs']['capture_s']:.3f}s, {r['graphs']['replays']} steps "
          f"replayed; {r['overlap_ms']:.3f} ms of device time with two "
          f"activities at once ({r['overlap_ms'] / max(r['steps'], 1):.4f} "
          f"ms a step) over {r['streams']} stream(s)", flush=True)
    busy = max(r["busy_ms"], 1e-9)
    for name, ms in sorted(r["by_class"].items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}: class {name}: {ms:.2f} ms "
              f"({ms / busy:.3f} of busy)", flush=True)
    top = sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top:
        print(f"[profile] {label}: kernel {ms:9.3f} ms "
              f"x{r['count'][name]:6d} {name[:100]}", flush=True)


def main(argv=None):
    args = serve.parse_args(argv)
    if args.device != "cuda":
        raise SystemExit("profile_serve measures the GPU: use --device cuda")
    if serve._fault_tolerant(args):
        raise SystemExit("profile_serve profiles the in-process serve: the "
                         "router's replicas are not supported")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    loaded = serve.load(args)
    paged = (f" --paged --page-size {args.page_size} --kv-dtype "
             f"{args.kv_dtype} --tree-kernel {args.tree_kernel}"
             if args.paged else "")
    if args.arrivals != "none":
        paged += (f" --arrivals {args.arrivals} --rate {args.rate} "
                  f"--requests {args.requests} --sched {args.sched} "
                  f"--prefill-chunk {args.prefill_chunk}")
    print(f"[profile] {card}; {args.arch} --mode {args.mode} "
          f"--width {args.width} --batch {args.batch} --prompt-len "
          f"{args.prompt_len} --tokens {args.tokens} --chunk {args.chunk}"
          f"{paged}", flush=True)
    for label, ctx in (("graphed", contextlib.nullcontext), ("eager", eager)):
        with ctx():
            report(label, profile_serve(args, loaded))


if __name__ == "__main__":
    sys.exit(main())
