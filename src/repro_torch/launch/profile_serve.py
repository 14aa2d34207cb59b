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

The profiler turns the port's tracer on (``runtime/trace.py``): beside the
device classes the report gives the host time by span (calls, wall ms,
thread CPU ms, which some hosts count in 10 ms steps) and the device's
idle time under each span (the innermost span covering it), the device
activities placed on the spans' clock by the tracer's clock anchor.  It
also checks that clock against each decode chunk's ``engine.chunk.wait``
span, which the chunk's last kernel (when the device is still busy as
the host starts waiting) and its device-to-host copy should both end
inside: the largest distance outside, in us, of each (the profiler's
copy records can drift from its kernel records, by up to 0.9% of the
time since the profiler started on the H100; ``PERF.md`` §7).

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch vicuna-7b --mode ghidorah --width 8 --batch 4 \\
      --prompt-len 512 --tokens 64 --chunk 8 [--paged --kv-dtype int8 ...]

Needs a GPU; it exits non-zero if the profiler records no device activity.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve
from repro_torch.runtime import trace
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
    trace.TRACER.clear()
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
                        ("captures", "replays", "capture_s",
                         "piece_replays", "piece_eager")},
                spans=span_summary(prof, trace.snapshot()))


def _innermost(spans) -> list:
    """Disjoint (start, end, name) pieces of time, each named by the
    innermost span covering it (the one that started last)."""
    edges = sorted([(s.t0, 1, i) for i, s in enumerate(spans)]
                   + [(s.t1, 0, i) for i, s in enumerate(spans)])
    open_, out, last = set(), [], None
    for t, starts, i in edges:
        if open_ and t > last:
            j = max(open_, key=lambda j: (spans[j].t0, -spans[j].t1))
            out.append((last, t, spans[j].name))
        (open_.add if starts else open_.discard)(i)
        last = t
    return out


def span_summary(prof, snap) -> dict:
    """The tracer's records of a profiled run: by span name its calls,
    wall ms and thread CPU ms (``host``), and the device idle ms under it
    (``idle``, over the spans' extent, the device activities placed by the
    tracer's anchor); ``kernel_us`` and ``copy_us``, the largest distance
    (us) by which a decode chunk's last kernel and its device-to-host copy
    end outside the chunk's ``engine.chunk.wait`` span, and ``chunks``,
    the chunks checked (None when the activities cannot be placed)."""
    spans = snap["spans"]
    host = collections.defaultdict(lambda: [0, 0.0, 0.0])
    for s in spans:
        h = host[s.name]
        h[0] += 1
        h[1] += (s.t1 - s.t0) / 1e6
        h[2] += s.cpu / 1e6
    out = dict(host=dict(host), idle={}, kernel_us=None, copy_us=None,
               chunks=0, dropped=snap["dropped"])
    dev = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    if not spans or not dev:
        return out
    off = trace.to_span_clock(snap["anchors"][-1], dev[0][1])
    if off is None:
        return out
    t0, t1 = min(s.t0 for s in spans), max(s.t1 for s in spans)
    busy, at, idle = [], t0, collections.Counter()
    for _, start, d in sorted(dev, key=lambda e: e[1]):
        a, b = start + off, start + off + d
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    gaps = []
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, t1)))
        at = max(at, b)
    gaps.append((at, t1))
    pieces, i = _innermost(spans), 0
    for a, b in gaps:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            pa, pb, name = pieces[j]
            idle[name] += max(0, min(b, pb) - max(a, pa)) / 1e6
            j += 1
    out["idle"] = dict(idle)
    copies = sorted(start + off + d for name, start, d in dev
                    if "DtoH" in name)
    kernels = sorted(start + off + d for name, start, d in dev
                     if "Memcpy" not in name)
    worst = dict(kernel_us=0.0, copy_us=0.0)
    for w in (s for s in spans if s.name == "engine.chunk.wait"):
        # the chunk's last kernel: the last to end before the host left
        # the wait; its copy: the first to end after the host asked for it
        i = bisect.bisect_right(kernels, w.t1 + 20_000) - 1
        j = bisect.bisect_left(copies, w.t0 - 20_000)
        for key, e in (("kernel_us", kernels[i] if i >= 0 else None),
                       ("copy_us", copies[j] if j < len(copies) else None)):
            if e is not None:
                worst[key] = max(worst[key], w.t0 - e, e - w.t1, 0)
        out["chunks"] += 1
    out.update({k: v / 1e3 for k, v in worst.items()})
    return out


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
          f"replayed, {r['graphs']['piece_replays']} prefill calls replayed "
          f"and {r['graphs']['piece_eager']} run eagerly; "
          f"{r['overlap_ms']:.3f} ms of device time with two "
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
    sp = r["spans"]
    for name, (n, wall, cpu) in sorted(sp["host"].items(),
                                       key=lambda kv: -kv[1][1]):
        print(f"[profile] {label}: span {name}: {n} calls, {wall:.2f} ms "
              f"on the host ({cpu:.2f} ms of thread CPU), device idle "
              f"under it {sp['idle'].get(name, 0.0):.2f} ms", flush=True)
    print(f"[profile] {label}: tracer clock: over {sp['chunks']} chunks, "
          f"the last kernel ends at most {sp['kernel_us']} us and the "
          f"device-to-host copy at most {sp['copy_us']} us outside the "
          f"chunk's engine.chunk.wait span; {sp['dropped']} records "
          f"dropped", flush=True)


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
