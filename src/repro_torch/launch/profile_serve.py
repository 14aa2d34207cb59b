"""Where a serve run's time goes on the GPU: a serve of ``launch/serve.py``
(same flags: the fixed batch, or an in-process ``--arrivals poisson``
replay) run once to warm up, then once under ``torch.profiler``.  Prints
the wall time, the device-busy time (the union of all device activity
intervals) and the idle share, and the device time by kernel class and by
kernel.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch vicuna-7b --mode ghidorah --width 8 --batch 4 \\
      --prompt-len 512 --tokens 64 --chunk 8 [--paged --kv-dtype int8 ...]

Needs a GPU; it exits non-zero if the profiler records no device activity.
"""
from __future__ import annotations

import collections
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve

_CLASSES = (
    ("verify_attention", ("verify_attention",)),
    ("paged walk (B2/B3)", ("paged_attention_kernel",)),
    ("tree kernels (B4/B5)", ("tree_partial_kernel",)),
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
    serve.run(args, loaded)                           # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = serve.run(args, loaded)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    steps = res["stats"]["device_steps"]
    pieces = res["stats"].get("extend_pieces", 0)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise SystemExit("the profiler recorded no device activity")
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    by_class = collections.Counter()
    by_name = collections.Counter()
    count = collections.Counter()
    for e in dev:
        us = e.time_range.end - e.time_range.start
        by_class[_class(e.name)] += us
        by_name[e.name] += us
        count[e.name] += 1
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
          f"{paged}")
    print(f"[profile] wall {wall_us / 1e3:.2f} ms (prefills + {steps} decode "
          f"steps + {pieces} prefill pieces), device busy "
          f"{busy / 1e3:.2f} ms, idle share "
          f"{1 - busy / wall_us:.3f}, {len(dev)} device activities "
          f"({len(dev) / max(steps, 1):.0f} per step incl. prefill)")
    for label, us in by_class.most_common():
        print(f"[profile] class {label}: {us / 1e3:.2f} ms "
              f"({us / busy:.3f} of busy)")
    for name, us in by_name.most_common(12):
        print(f"[profile] kernel {us / 1e3:9.3f} ms x{count[name]:5d} "
              f"{name[:110]}")


if __name__ == "__main__":
    sys.exit(main())
