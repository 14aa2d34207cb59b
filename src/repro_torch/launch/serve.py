"""Serving launcher: batched Ghidorah speculative serving or batched
sequential serving with the chunked decode loop (one host sync per
``--chunk`` steps), on the GPU unless ``--device cpu`` is given
(counterpart of ``repro/launch/serve.py``: same flags, defaults, checks
and summary lines).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vicuna-7b \\
      --mode ghidorah --width 8 --tokens 64 --batch 4 --chunk 8

Two serving shapes:

* default (``--arrivals none``): one fixed batch of ``--batch`` prompts,
  prefilled together and decoded to the token budget;
* replay (``--arrivals poisson --rate R --requests N``): N requests arrive
  as a rate-R Poisson process and flow through ``runtime/continuous.py``:
  ``--sched continuous`` admits and evicts per sequence at chunk
  boundaries (``--policy fifo|sjf|lpt``, ``--age-limit N``,
  ``--prefill-chunk N`` for piecewise admission of long prompts), and
  ``--sched static`` is the fixed-group baseline.  ``--replicas N``,
  ``--deadline-s``, ``--cancel-rate`` and ``--inject-faults SEED`` run the
  replay through the async server and router (``runtime/server.py``,
  ``runtime/router.py``) with the seeded chaos plan of
  ``runtime/faults.py``; that run exits non-zero unless every request
  reaches a terminal state and every replica's page pool drains.  The
  replicas share one loaded copy of the weights.

Either runs on the dense per-row KV cache or, with ``--paged``, on the
shared page pool:

  ... --paged [--page-size 16] [--pool-pages 0] [--kv-dtype int8] \
      [--tree-kernel sparse]

``--kv-dtype fp32`` (the default) keeps the pool in the model's dtype, as
in the reference; ``bf16`` and ``int8`` pick the pool's dtype (int8 =
quantized pages).  ``--tree-kernel sparse`` splits the paged verify into
the page walk and the tree partial.  Throughput counts REAL emitted tokens
(``stats["emitted_total"]``), not the EOS padding in the output buffer.
Weights are random, drawn from ``--seed``.

ARCA and HCMP (``core/arca.py``, ``core/hcmp/executors.py``):

* ``--width 0`` (ghidorah): ARCA's analytic choice on the paper's Jetson
  model; ``--spec-width N`` is ``--width N``.
* ``--spec-width auto`` (ghidorah, ``--arrivals poisson --sched
  continuous``): MEASURED ARCA.  ``arca.profile_engine`` times the step
  the engine deploys for widths 1-16 at the serving batch,
  ``choose_strategy`` picks the start, and the continuous scheduler
  re-decides the width at chunk boundaries from the observed acceptance.
* ``--tree-kernel auto`` (``--paged``): ARCA times the dense and the
  sparse paged verify and takes the faster.
* ``--hcmp overlap``: the draft of step t+1 runs on a second stream of
  the card while step t commits (on the CPU, serially); the run is served
  again on an inline twin engine and exits non-zero on any token mismatch
  (fixed batch) or any mismatch or leaked page (replay).  ``--hcmp auto``
  lets ARCA time both partitions and take the faster.

Checkpoints: ``--ckpt`` restores the params and ``--heads-ckpt`` the
Medusa heads (``training/checkpoint.py``: the port's files and the
reference's) into the random ones before any engine is built.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import arca
from repro_torch.core.speculative import tree as T
from repro_torch.core.speculative.medusa import init_medusa
from repro_torch.data.pipeline import MarkovDataset
from repro_torch.devices import resolve_device
from repro_torch.models.api import get_model
from repro_torch.runtime.continuous import (ContinuousScheduler, Request,
                                            poisson_arrivals, serve_static)
from repro_torch.runtime.engine import (BatchEngine, DecodeEngine,
                                        SpeculativeEngine)
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.router import ReplicaRouter
from repro_torch.runtime.router import replay as router_replay
from repro_torch.runtime.server import AsyncEngineServer
from repro_torch.training import checkpoint

# the candidate widths of --spec-width auto, as in the reference
AUTO_WIDTHS = (1, 2, 4, 8, 16)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-0.5b-smoke")
    ap.add_argument("--mode", default="ghidorah",
                    choices=["ghidorah", "sequential"])
    ap.add_argument("--width", type=int, default=0,
                    help="verification width (0 = let ARCA choose "
                         "analytically)")
    ap.add_argument("--spec-width", default=None,
                    help="verification width: an int (same as --width, "
                         "takes precedence) or 'auto': MEASURED ARCA, the "
                         "deployed per-width steps timed on this device "
                         "(arca.profile_engine), choose_strategy over the "
                         "measured times, and the continuous scheduler "
                         "re-deciding the width at chunk boundaries (needs "
                         "--mode ghidorah --arrivals poisson --sched "
                         "continuous)")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=8,
                    help="device-resident steps per host sync")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--arrivals", default="none", choices=["none", "poisson"],
                    help="replay a request-arrival process instead of one "
                         "fixed batch")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="poisson arrival rate, requests/sec")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of requests in the replayed stream")
    ap.add_argument("--sched", default="continuous",
                    choices=["continuous", "static"],
                    help="scheduler for --arrivals replay")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "sjf", "lpt"],
                    help="admission policy for --sched continuous: fifo "
                         "(arrival order), sjf (smallest reserved footprint "
                         "first), lpt (largest first)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="admit prompts longer than N in N-token pieces "
                         "(0 = whole-prompt admission)")
    ap.add_argument("--age-limit", type=int, default=0,
                    help="starvation bound for --policy sjf/lpt: a request "
                         "passed over N boundaries is promoted to FIFO-head "
                         "priority (0 = off)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the async router (>1 "
                         "switches the replay to the server/router plane)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline (seconds, replica serve "
                         "clock); expired requests finalize TIMED_OUT")
    ap.add_argument("--cancel-rate", type=float, default=0.0,
                    help="fraction of clients that disconnect mid-stream "
                         "(deterministic per request id)")
    ap.add_argument("--inject-faults", type=int, default=None,
                    metavar="SEED",
                    help="arm the seeded chaos plan: replica r0 crash (when "
                         "--replicas > 1), chunk stalls, admission-time pool "
                         "exhaustion; exits non-zero on a leaked page or a "
                         "non-terminal request")
    ap.add_argument("--queue-limit", type=int, default=64,
                    help="bounded admission queue per replica; submits over "
                         "it are REJECTED (backpressure)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; fails without a GPU) or cpu (the "
                         "plain PyTorch path)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV: sequences share one page pool and "
                         "reserve pages for prompt + budget instead of a "
                         "dense max_len row each")
    ap.add_argument("--page-size", type=int, default=16,
                    help="slots per KV page (--paged)")
    ap.add_argument("--kv-dtype", default="fp32",
                    choices=["fp32", "bf16", "int8"],
                    help="paged pool storage dtype (--paged): fp32 keeps "
                         "the model-dtype float pool; int8 quantizes KV "
                         "pages with per-page dequant scales")
    ap.add_argument("--tree-kernel", default="dense",
                    choices=["dense", "sparse", "auto"],
                    help="paged verify kernel (ghidorah + --paged): dense = "
                         "fused page walk + tree tile; sparse = page walk "
                         "and tree partial merged by the Eq.-1 rule; auto = "
                         "ARCA times both per shape and takes the faster")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="total reservable pages in the shared pool (0 = "
                         "dense-equivalent: batch * pages(max_len))")
    ap.add_argument("--hcmp", default="inline",
                    choices=["inline", "overlap", "auto"],
                    help="executor partition of the drafted engine "
                         "(core/hcmp/executors.py): inline = draft inside "
                         "the step; overlap = draft(t+1) on a second stream "
                         "beside commit(t), the run served again on an "
                         "inline twin and held to its tokens; auto = ARCA "
                         "times both partitions and takes the faster "
                         "(ghidorah only)")
    ap.add_argument("--ckpt", default=None,
                    help="restore the params from this checkpoint")
    ap.add_argument("--heads-ckpt", default=None,
                    help="restore the Medusa heads from this checkpoint "
                         "(ghidorah)")
    args = ap.parse_args(argv)
    if args.width < 0:
        ap.error("--width must be >= 0 (0 = ARCA's analytic choice)")
    if args.spec_width is not None:
        if args.mode != "ghidorah":
            ap.error("--spec-width is a ghidorah option (sequential decoding "
                     "has no verification width)")
        if args.spec_width != "auto" and not (
                args.spec_width.isdigit() and int(args.spec_width) >= 1):
            ap.error("--spec-width must be 'auto' or a width >= 1")
        if args.spec_width == "auto" and (args.arrivals == "none"
                                          or args.sched != "continuous"):
            ap.error("--spec-width auto needs --arrivals poisson "
                     "--sched continuous")
    if args.hcmp != "inline" and args.mode != "ghidorah":
        ap.error("--hcmp overlap/auto is a ghidorah option (sequential "
                 "decoding has no draft source to disaggregate)")
    if args.tokens < 1:
        ap.error("--tokens must be >= 1")
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    if args.chunk < 1:
        ap.error("--chunk must be >= 1")
    if args.prompt_len < 2:
        ap.error("--prompt-len must be >= 2 (one context token must "
                 "survive the next-token shift)")
    if args.arrivals == "poisson":
        if args.rate <= 0:
            ap.error("--rate must be > 0 (poisson inter-arrivals are "
                     "1/rate)")
        if args.requests < 1:
            ap.error("--requests must be >= 1")
    if args.prefill_chunk < 0:
        ap.error("--prefill-chunk must be >= 0 (0 disables chunked "
                 "prefill)")
    if args.age_limit < 0:
        ap.error("--age-limit must be >= 0 (0 disables aging)")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.deadline_s is not None and args.deadline_s <= 0:
        ap.error("--deadline-s must be > 0")
    if not 0.0 <= args.cancel_rate <= 1.0:
        ap.error("--cancel-rate must be in [0, 1]")
    if args.queue_limit < 1:
        ap.error("--queue-limit must be >= 1")
    if args.paged and args.page_size < 1:
        ap.error("--page-size must be >= 1")
    if args.pool_pages < 0:
        ap.error("--pool-pages must be >= 0 (0 = dense-equivalent pool)")
    if args.kv_dtype == "int8" and not args.paged:
        ap.error("--kv-dtype int8 quantizes the PAGED pool (per-page "
                 "scales live on the page axis): add --paged")
    if args.tree_kernel != "dense":
        if not args.paged:
            ap.error("--tree-kernel sparse/auto splits the PAGED verify "
                     "path: add --paged")
        if args.mode != "ghidorah":
            ap.error("--tree-kernel sparse/auto is a ghidorah option "
                     "(sequential decoding has no verification tree)")
    if _fault_tolerant(args) and (args.arrivals != "poisson"
                                  or args.sched != "continuous"):
        ap.error("--replicas/--deadline-s/--cancel-rate/--inject-faults "
                 "need --arrivals poisson --sched continuous (the async "
                 "plane serves an arrival stream)")
    return args


def _fault_tolerant(args) -> bool:
    """Whether the replay must go through the async server/router plane."""
    return (args.replicas > 1 or args.deadline_s is not None
            or args.cancel_rate > 0 or args.inject_faults is not None)


@dataclasses.dataclass
class Loaded:
    """A model with its random weights (and Medusa heads) on one device."""
    cfg: Any
    model: Any
    params: dict
    heads: Optional[dict]
    device: torch.device


def load(args, *, with_heads: Optional[bool] = None) -> Loaded:
    """Random weights from ``--seed`` (heads from ``--seed + 1``), as the
    reference draws them from ``PRNGKey(seed)`` / ``PRNGKey(seed + 1)``,
    then ``--ckpt`` / ``--heads-ckpt`` restored into them."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = get_model(cfg)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed))
    if args.ckpt:
        params = checkpoint.restore(args.ckpt, params)
    heads = None
    if with_heads if with_heads is not None else args.mode == "ghidorah":
        heads = init_medusa(
            cfg, torch.Generator(device=device).manual_seed(args.seed + 1))
        if args.heads_ckpt:
            heads = checkpoint.restore(args.heads_ckpt, heads)
    return Loaded(cfg=cfg, model=model, params=params, heads=heads,
                  device=device)


def prompts(cfg, args) -> np.ndarray:
    """The reference's fixed-batch prompts: (batch, prompt_len) int32."""
    data = MarkovDataset(cfg.vocab_size, seed=1)
    return data.sample(args.batch, args.prompt_len, seed=7)[:, :-1].astype(
        np.int32)


def _paged_kw(args) -> dict:
    # the reference's quirk: --kv-dtype fp32 means the model's own dtype
    return dict(paged=args.paged, page_size=args.page_size,
                pool_pages=args.pool_pages or None,
                kv_dtype=None if args.kv_dtype == "fp32" else args.kv_dtype)


def _accs(cfg):
    return T.default_accs(cfg.medusa_heads, cfg.medusa_top_k)


def fixed_spec(args, cfg, *, announce=False):
    """The tree of a fixed-width ghidorah serve: ``--spec-width N`` or
    ``--width N``, else (``--width 0``) ARCA's analytic choice, printed
    when ``announce``."""
    width = int(args.spec_width) if args.spec_width not in (None, "auto") \
        else args.width
    accs = _accs(cfg)
    if width:
        return T.build_tree(accs, width)
    strat = arca.best(arca.choose_strategy(cfg, accs, ctx=args.prompt_len))
    if announce:
        print(f"[serve] ARCA chose width={strat.width} "
              f"(E[AL]={strat.acceptance:.2f})")
    return strat.tree


def build_engine(args, loaded: Loaded, spec=None, *, max_len=None):
    """The engine ``args`` ask for, on ``spec`` (default ``fixed_spec``):
    the tree kernel and the partition as given (``auto`` builds the dense
    kernel and the overlap-capable engine, which ARCA then sets).
    ``max_len`` defaults to prompt + tokens + the tree's depth."""
    kw = _paged_kw(args)
    if args.mode == "sequential":
        # prompt + budget slots; the sequential driver writes at most
        # prompt + (tokens - 1) entries before every row is done
        return BatchEngine(loaded.model, loaded.params,
                           max_len=args.prompt_len + args.tokens,
                           chunk=args.chunk, **kw)
    spec = spec or fixed_spec(args, loaded.cfg)
    # one speculative step past the budget can commit up to max_depth
    # tokens, so size the ring for the worst-case overshoot
    return SpeculativeEngine(
        loaded.model, loaded.heads, loaded.params, spec,
        max_len=max_len or args.prompt_len + args.tokens + spec.max_depth,
        chunk=args.chunk,
        hcmp="inline" if args.hcmp == "inline" else "overlap",
        tree_kernel="sparse" if args.tree_kernel == "sparse" else "dense",
        **kw)


def twin(loaded: Loaded, eng, strategy=None, **over):
    """A fresh engine configured like ``eng`` (strategy, sizes, pool, tree
    kernel, partition), with ``over`` replacing any of its keywords: the
    router's other replicas and the overlap gate's inline engine."""
    kw = dict(max_len=eng.max_len, chunk=eng.chunk, paged=eng.paged,
              page_size=eng.page_size, pool_pages=eng.pool_pages,
              kv_dtype=eng.kv_dtype, tree_kernel=eng.tree_kernel,
              hcmp=eng.hcmp)
    kw.update(over)
    return DecodeEngine(loaded.model, loaded.params, heads=eng.heads,
                        strategy=strategy or eng.strategy, **kw)


def prepare(args, loaded: Loaded):
    """The serving engine with every choice the flags leave to ARCA made,
    and the adaptive strategy table (``--spec-width auto``) or None.
    Prints each choice as the reference does."""
    cfg = loaded.cfg
    if args.mode == "sequential":
        return build_engine(args, loaded), None
    accs = _accs(cfg)
    adaptive = None
    if args.spec_width == "auto":
        # measured ARCA + runtime-adaptive speculation: time the deployed
        # per-width steps here, start at the measured argmax, and let the
        # scheduler re-decide at chunk boundaries.  The ring is sized for
        # the DEEPEST candidate: a switch must never outgrow a row
        specs = {w: T.candidate_spec(accs, w) for w in AUTO_WIDTHS}
        depth = max(sp.max_depth for sp in specs.values())
        eng = build_engine(args, loaded, specs[max(AUTO_WIDTHS)],
                           max_len=args.prompt_len + args.tokens + depth)
        _print_executors(args, eng)
        time_fn = arca.profile_engine(
            eng, AUTO_WIDTHS, accs=accs, batch=args.batch,
            prompt_len=args.prompt_len,
            tree_kernels=("dense", "sparse")
            if args.tree_kernel == "auto" else None)
        adaptive = arca.choose_strategy(cfg, accs, ctx=args.prompt_len,
                                        time_fn=time_fn, widths=AUTO_WIDTHS)
        start = arca.best(adaptive)
        print(f"[serve] measured ARCA: start width={start.width} "
              f"(E[AL]={start.acceptance:.2f}, "
              f"step {start.step_time * 1e3:.2f} ms)")
        eng.set_strategy(start.tree)
        if args.tree_kernel == "auto":
            print(f"[serve] tree kernel: {start.tree_kernel} "
                  f"(measured winner for width {start.width})")
            eng.set_tree_kernel(start.tree_kernel)
        if args.hcmp != "inline":
            part = "overlap" if args.hcmp == "overlap" else start.hcmp
            print(f"[serve] hcmp partition: {part} "
                  f"(measured winner for width {start.width}: "
                  f"{start.hcmp})")
            eng.set_hcmp(part)
        return eng, adaptive
    spec = fixed_spec(args, cfg, announce=True)
    eng = build_engine(args, loaded, spec)
    _print_executors(args, eng)
    if args.hcmp == "auto" or args.tree_kernel == "auto":
        # measure the partition / verify kernel for THIS shape on THIS
        # device at the serving batch and keep the faster
        modes = {"auto": ("inline", "overlap"), "overlap": ("overlap",),
                 "inline": ("inline",)}[args.hcmp]
        tks = ("dense", "sparse") if args.tree_kernel == "auto" \
            else (args.tree_kernel,)
        tf = arca.profile_engine(eng, (spec.width,), accs=accs,
                                 batch=args.batch, prompt_len=args.prompt_len,
                                 hcmp_modes=modes, tree_kernels=tks)
        key = (spec.width, spec.max_depth, spec.n_paths, args.batch)
        if args.hcmp == "auto":
            part = tf.partition_for(spec)
            print(f"[serve] measured partition: {part} "
                  f"(inline {tf.times[key + ('inline',)] * 1e3:.2f} ms, "
                  f"overlap {tf.times[key + ('overlap',)] * 1e3:.2f} ms "
                  f"per step)")
            eng.set_hcmp(part)
        if args.tree_kernel == "auto":
            tk = tf.kernel_for(spec)
            mode = tf.partition_for(spec)
            print(f"[serve] measured tree kernel: {tk} (dense "
                  f"{tf.times[key + (mode, 'dense')] * 1e3:.2f} ms, sparse "
                  f"{tf.times[key + (mode, 'sparse')] * 1e3:.2f} ms "
                  f"per step)")
            eng.set_tree_kernel(tk)
    return eng, None


def _print_executors(args, eng):
    if args.hcmp != "inline":
        v, d = eng.hcmp_executors
        note = " (one serial executor: no overlap)" if v == d else ""
        print(f"[serve] hcmp {args.hcmp}: verify on {v}, draft on {d}{note}")


def requests(cfg, args):
    """The reference's replay stream: ``--requests`` Markov prompts with
    Poisson arrivals at ``--rate`` from ``--seed``, ``--tokens`` each."""
    data = MarkovDataset(cfg.vocab_size, seed=1)
    toks = data.sample(args.requests, args.prompt_len, seed=11)[:, :-1]
    arrivals = poisson_arrivals(args.requests, args.rate, seed=args.seed)
    return [Request(req_id=i, tokens=toks[i].astype(np.int32),
                    n_tokens=args.tokens, arrival=float(arrivals[i]))
            for i in range(args.requests)]


def _scheduler(args, eng, adaptive=None, faults=None):
    return ContinuousScheduler(
        eng, batch=args.batch, chunk=args.chunk, policy=args.policy,
        prefill_chunk=args.prefill_chunk, age_limit=args.age_limit,
        adaptive=adaptive, faults=faults)


def _replay(args, loaded, eng, adaptive=None) -> dict:
    """Arrival replay through the continuous or the static scheduler, in
    process; prints the reference's summary line."""
    reqs = requests(loaded.cfg, args)
    if args.sched == "continuous":
        results, stats = _scheduler(args, eng, adaptive).serve(reqs)
        label = f"{args.sched}/{stats['policy']}"
        if stats["prefill_chunk"]:
            label += f"+pc{stats['prefill_chunk']}"
        if adaptive is not None:
            label += "/adaptive"
            sw = stats["strategy_switches"]
            print(f"[serve] adaptive: width {stats['width_final']} at drain, "
                  f"{len(sw)} switch(es)"
                  + (f" {[(x['from'], x['to']) for x in sw]}" if sw else ""))
    else:
        results, stats = serve_static(eng, reqs, batch=args.batch)
        label = args.sched
    print(f"[serve] {label} x{args.requests} reqs "
          f"(poisson rate {args.rate}/s, B={args.batch}): "
          f"{stats['emitted_total']} tokens in {stats['makespan_s']:.2f}s "
          f"({stats['tok_s']:.1f} tok/s aggregate), "
          f"latency mean {stats['latency_mean_s']:.2f}s "
          f"p50 {stats['latency_p50_s']:.2f}s "
          f"p95 {stats['latency_p95_s']:.2f}s, "
          f"queue wait mean {stats['queue_wait_mean_s']:.2f}s "
          f"p95 {stats['queue_wait_p95_s']:.2f}s")
    return {"results": results, "stats": stats, "requests": reqs,
            "engines": [eng]}


def _replay_async(args, loaded, eng, adaptive=None) -> dict:
    """Fault-tolerant replay: the arrival stream flows through
    ``--replicas`` servers behind the router (replica r0 serves on ``eng``,
    the others on fresh engines configured like it, over the same
    weights); with ``--inject-faults`` the seeded chaos plan crashes r0 at
    its 6th boundary, stalls chunks and blocks admissions.  Exits non-zero
    unless every request is terminal and no replica leaked pages."""
    reqs = requests(loaded.cfg, args)
    plan = None
    if args.inject_faults is not None:
        crash = {"r0": 6} if args.replicas > 1 else {}
        plan = FaultPlan(seed=args.inject_faults, crash=crash,
                         stall_rate=0.05, stall_s=0.01, exhaust_rate=0.05,
                         cancel_rate=args.cancel_rate)
    elif args.cancel_rate > 0:
        plan = FaultPlan(seed=args.seed, cancel_rate=args.cancel_rate)
    engines = [eng] + [twin(loaded, eng) for _ in range(args.replicas - 1)]
    servers = []
    for i, e in enumerate(engines):
        name = f"r{i}"
        sched = _scheduler(args, e, adaptive,
                           plan.injector(name) if plan is not None else None)
        servers.append(AsyncEngineServer(sched, name=name,
                                         queue_limit=args.queue_limit))
    router = ReplicaRouter(
        servers, seed=args.seed,
        client_faults=plan.client() if plan is not None else None)

    async def go():
        await router.start(health_every_s=0.2)
        try:
            return await router_replay(router, reqs,
                                       deadline_s=args.deadline_s)
        finally:
            await router.stop()

    results, stats = asyncio.run(go())
    drained = router.drained()
    faulty = "faults on" if args.inject_faults is not None else "faults off"
    print(f"[serve] router x{args.requests} reqs over {args.replicas} "
          f"replica(s) ({faulty}): {stats['delivered_total']} tokens in "
          f"{stats['makespan_s']:.2f}s ({stats['tok_s']:.1f} tok/s, "
          f"goodput {stats['goodput_tok_s']:.1f} tok/s), "
          f"states {stats['states']}, {stats['retries']} retried, "
          f"routed {stats['routed']}, "
          f"latency mean {stats['latency_mean_s']:.2f}s "
          f"p95 {stats['latency_p95_s']:.2f}s, "
          f"pages drained: {drained}")
    if not stats["terminal"] or not drained:
        raise SystemExit(
            f"[serve] FAULT-TOLERANCE VIOLATION: terminal="
            f"{stats['terminal']} drained={drained}")
    return {"results": results, "stats": stats, "requests": reqs,
            "engines": engines, "drained": drained}


def _gate_line(eng) -> str:
    hs = eng.hcmp_stats or {}
    return (f"predraft hits {hs.get('predraft_hits', 0)} / discards "
            f"{hs.get('predraft_discards', 0)} over {hs.get('chunks', 0)} "
            f"chunks on {hs.get('executors', 1)} executor(s)")


def _hcmp_gate(args, loaded, eng, results, inline, adaptive=None) -> dict:
    """--hcmp overlap replay gate: serve the SAME arrival stream on the
    inline engine ``inline`` and require equal per-request tokens, plus a
    leak-free drained pool on the overlap engine.  Exits non-zero on any
    parity or leak failure."""
    leak = not (eng.sched_pool_conserved() and eng.sched_drained())
    if args.sched == "continuous":
        ref, stats = _scheduler(args, inline, adaptive).serve(
            requests(loaded.cfg, args))
    else:
        ref, stats = serve_static(inline, requests(loaded.cfg, args),
                                  batch=args.batch)
    bad = [r.req_id for r, q in zip(results, ref)
           if not np.array_equal(r.tokens, q.tokens)]
    print(f"[serve] hcmp overlap gate: parity "
          f"{'OK' if not bad else 'FAIL ' + str(bad)}, "
          f"pages {'LEAKED' if leak else 'OK'}; {_gate_line(eng)}")
    if bad or leak:
        raise SystemExit(f"[serve] HCMP OVERLAP VIOLATION: overlapped "
                         f"draft/verify diverged from the inline engine "
                         f"(mismatched req ids {bad}, leaked pages: "
                         f"{leak})")
    return {"results": ref, "stats": stats, "engine": inline}


def run(args, loaded: Optional[Loaded] = None, engine=None,
        adaptive=None, gate: bool = True) -> dict:
    """Serve once and print the reference's summary line.  The fixed batch
    returns the tokens, the engine's stats, the wall time and the engine;
    a replay returns its results, stats, requests and engines.  ``engine``
    (with its ``adaptive`` table) reuses an engine of ``prepare(args,
    loaded)`` (its captured chunk graphs included) instead of preparing
    one.  With ``--hcmp overlap`` (and ``gate``) the run is served again
    on an inline twin, whose run the result holds under ``"inline"``."""
    loaded = loaded or load(args)
    if engine is None:
        engine, adaptive = prepare(args, loaded)
    eng = engine
    gate = gate and args.hcmp == "overlap" and eng.hcmp == "overlap"
    # the inline twin starts where this engine starts (an adaptive run
    # switches the engine's strategy as it goes)
    start = eng.strategy
    if args.arrivals != "none":
        if _fault_tolerant(args):
            return _replay_async(args, loaded, eng, adaptive)
        res = _replay(args, loaded, eng, adaptive)
        if gate:
            res["inline"] = _hcmp_gate(
                args, loaded, eng, res["results"],
                twin(loaded, eng, start, hcmp="inline"), adaptive)
        return res
    batch = {"tokens": prompts(loaded.cfg, args)}
    if loaded.device.type == "cuda":
        torch.cuda.synchronize(loaded.device)
    t0 = time.perf_counter()
    out, stats = eng.generate(batch, args.tokens)
    dt = time.perf_counter() - t0
    n_out = stats["emitted_total"]           # real tokens, not EOS padding
    if args.mode == "sequential":
        print(f"[serve] sequential: {n_out} tokens "
              f"({args.batch} seq x chunk {args.chunk}) in {dt:.2f}s "
              f"({n_out / dt:.1f} tok/s)")
    else:
        print(f"[serve] ghidorah: {n_out} tokens "
              f"({args.batch} seq x chunk {args.chunk}) in {dt:.2f}s "
              f"({n_out / dt:.1f} tok/s), "
              f"acceptance length {stats['acceptance_length']:.2f} "
              f"over {stats['steps']} seq-steps")
    res = {"out": out, "stats": stats, "seconds": dt,
           "prompts": batch["tokens"], "engines": [eng]}
    if gate:
        # fixed-batch parity gate: the overlapped schedule must emit the
        # exact token stream of the inline engine
        inline = twin(loaded, eng, start, hcmp="inline")
        if loaded.device.type == "cuda":
            torch.cuda.synchronize(loaded.device)
        t0 = time.perf_counter()
        ref_out, ref_stats = inline.generate(batch, args.tokens)
        ref_s = time.perf_counter() - t0
        ok = np.array_equal(np.asarray(out), np.asarray(ref_out))
        print(f"[serve] hcmp overlap gate: parity "
              f"{'OK' if ok else 'FAIL'}; {_gate_line(eng)}")
        if not ok:
            raise SystemExit("[serve] HCMP OVERLAP VIOLATION: overlapped "
                             "draft/verify diverged from the inline "
                             "engine on the fixed batch")
        res["inline"] = {"out": ref_out, "stats": ref_stats,
                         "seconds": ref_s, "engine": inline}
    return res


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
