"""Measured continuous-batching gain: static batches vs per-sequence
admission and eviction under staggered Poisson arrivals (counterpart of
``benchmarks/sched_bench.py``), on the device the port runs on, over
``runtime/continuous.py``, ``router.py``, ``server.py`` and ``faults.py``.

Workload: N requests with alternating short/long budgets (``budgets``):
a finished short request's row idles under static batching until its whole
group drains, while the continuous scheduler refills it at the next chunk
boundary.  Arrivals are a Poisson process whose rate is calibrated against
a measured warm static makespan, so the stream is staggered at any speed.

Arms beside the grid, each with the reference's in-run gates:

* ``paged``: at FIXED pool memory a double-width bank over the shared pool
  holds a larger resident batch than the dense bank (gated); the pool is
  updated in place across a chunk (its storage pointers unchanged and, on
  a CUDA device, a bank with twice the pool peaks by less than the extra
  pool's bytes more over the chunk: ``donation_in_place``, the port's
  form of the reference's donation check); an int8 pool at the same bytes
  funds >= 1.8x the reservable tokens (gated).
* ``policies``: FIFO vs SJF vs FIFO + chunked prefill on a convoy trace
  (burst arrivals, a pool that funds ten short reservations but no long
  one beside them); SJF or chunked prefill must beat FIFO on p95 latency.
* ``adaptive``: one bank under each fixed width and under measured-ARCA
  adaptive speculation; adaptive must match or beat the worst fixed arm.
* ``faults``: the trace through the async router over two paged replicas,
  faults off vs a seeded chaos plan (a replica crash, client disconnects,
  deadlines): every request ends in a typed terminal state, no replica
  leaks a page, goodput under faults >= 0.8x fault-free.
* ``hcmp``: inline vs the HCMP overlap through the same scheduler, tokens
  bit-identical per request, ARCA's measured partition choice.

  PYTHONPATH=src python -m repro_torch.benchmarks.sched_bench \
      [--requests 32 --budgets 16,192 --reps 2] [--device cpu]

Writes ``results/torch/sched_bench.json`` (``--out`` to put it elsewhere)
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.benchmarks import benchlib
from repro_torch.benchmarks.engine_bench import (engine_smoke_cfg, load,
                                                 pinned, release)
from repro_torch.configs import get_config
from repro_torch.core import arca
from repro_torch.core.speculative import tree as T
from repro_torch.launch.serve import Loaded
from repro_torch.runtime.cache import (page_bytes, pages_at_fixed_bytes,
                                      pages_for)
from repro_torch.runtime.continuous import (ContinuousScheduler, Request,
                                            poisson_arrivals, serve_static)
from repro_torch.runtime.engine import (BatchEngine, DecodeEngine,
                                        DecodeStrategy, SpeculativeEngine,
                                        _eos_scalar)
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.router import ReplicaRouter
from repro_torch.runtime.router import replay as router_replay
from repro_torch.runtime.server import AsyncEngineServer

SCHED_SMOKE_ARCH = "qwen2-sched-smoke"


def sched_smoke_cfg():
    """The engine bench's smoke model at twice its width: a chunk's device
    time has to outweigh an admission's dispatch (B=1 prefill + row
    insert) or the bench measures Python, not scheduling."""
    return dataclasses.replace(engine_smoke_cfg(), name=SCHED_SMOKE_ARCH,
                               d_model=256, num_heads=4, num_kv_heads=4,
                               d_ff=512)


def bench_config(arch):
    return sched_smoke_cfg() if arch == SCHED_SMOKE_ARCH else get_config(arch)


BATCH = 8
PROMPT_LEN = 16
WIDTH = 4                     # the fixed tree's width
PAGE_SIZE = 16


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The bench's workload sizes; the defaults are the reference's."""
    requests: int = 32
    budgets: tuple = (16, 192)   # alternating short/long generation budgets
    reps: int = 2
    chunk: int = 8
    policy_requests: int = 0     # the policy arm's trace (0: ``requests``)
    adapt_widths: tuple = (1, 2, 8)   # sequential-degenerate, narrow, wide


def _requests(cfg, sz: Sizes, n, arrivals):
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (n, PROMPT_LEN)).astype(np.int32)
    return [Request(req_id=i, tokens=prompts[i],
                    n_tokens=sz.budgets[i % len(sz.budgets)],
                    arrival=float(arrivals[i]))
            for i in range(n)]


def _best_of(fn, reps):
    """Highest-throughput run of ``reps`` (a busy host's scheduling
    makespans are noisy in one direction only: slowdowns)."""
    best = None
    for _ in range(reps):
        _, s = fn()
        if best is None or s["tok_s"] > best["tok_s"]:
            best = s
    return best


def _chunk_growth(paged, sz: Sizes, paged_batch, device) -> tuple:
    """Admit one request into a fresh paged bank and run two chunks (on a
    CUDA device the warm-up and the capture); the pool must keep its
    storage across each.  Returns the pool's bytes (K and V) and, on a
    CUDA device, each chunk's peak allocation over its start."""
    on_card = torch.device(device).type == "cuda"
    row = paged.sched_prefill(
        {"tokens": np.zeros((1, PROMPT_LEN), np.int32)})
    state = paged.sched_blank(row, paged_batch)
    state = paged.sched_insert(state, 0, row, prompt_len=PROMPT_LEN,
                               n_tokens=sz.budgets[0])
    kv = state.cache.kv
    ptrs = (kv.pool_k.data_ptr(), kv.pool_v.data_ptr())
    pool_nbytes = sum(t.numel() * t.element_size()
                      for t in (kv.pool_k, kv.pool_v))
    done = np.ones((paged_batch,), bool)
    done[0] = False
    rem = np.zeros((paged_batch,), np.int32)
    rem[0] = sz.budgets[0]
    peaks = []
    for _ in range(2):
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        state, done, rem, _ = paged.sched_step(state, done, rem, sz.chunk,
                                               int(_eos_scalar(None)))
        kv = state.cache.kv
        if (kv.pool_k.data_ptr(), kv.pool_v.data_ptr()) != ptrs:
            raise AssertionError("a chunk replaced the KV pool (per-chunk "
                                 "pool copy): the update is not in place")
        if on_card:
            torch.cuda.synchronize(device)
            peaks.append(torch.cuda.max_memory_allocated(device) - base)
        if bool(done[0]):
            break
    paged.sched_release(0)
    return pool_nbytes, peaks


def _in_place_chunks(loaded: Loaded, spec, max_len, pool_pages, sz: Sizes,
                     paged_batch, device) -> dict:
    """The pool is updated in place: across a chunk its storage pointers
    stay, and on a CUDA device the chunk's peak allocation grows by less
    than a pool's bytes.  A chunk's own activations can be of a small
    pool's size, so the peak is compared between two banks that differ
    only in their pool (``pool_pages`` and twice as many): a per-chunk copy
    of the pool would add the larger pool's extra bytes to its peak, the
    activations add the same to both."""
    runs = []
    for pages in (pool_pages, 2 * pool_pages):
        eng = SpeculativeEngine(loaded.model, loaded.heads, loaded.params,
                                spec, max_len=max_len, chunk=sz.chunk,
                                paged=True, page_size=PAGE_SIZE,
                                pool_pages=pages)
        runs.append(_chunk_growth(eng, sz, paged_batch, device))
        del eng
        release(device)
    (small, g_small), (big, g_big) = runs
    for a, b in zip(g_small, g_big):
        if b - a >= big - small:
            raise AssertionError(
                f"a chunk's peak allocation grew {b - a} bytes more over a "
                f"pool {big - small} bytes larger: the pool was copied")
    return {"pool_bytes": [small, big],
            "chunk_peak_growth_bytes": [g_small, g_big]}


def paged_compare(loaded: Loaded, spec, max_len, sz: Sizes, device) -> dict:
    """Fixed-memory paged-vs-dense resident batch, the in-place pool
    update and the int8 pool's reservable tokens at fixed bytes."""
    cfg, model, params, heads = (loaded.cfg, loaded.model, loaded.params,
                                 loaded.heads)
    n, chunk, reps, B, ps = (sz.requests, sz.chunk, sz.reps, BATCH,
                             PAGE_SIZE)
    # FIXED MEMORY: the pool's reservable slots round DOWN from the dense
    # B-row bank's (the +1 trash page is bookkeeping, not capacity); the
    # paged bank is twice as wide and lives off reservations
    pool_pages = (B * max_len) // ps
    paged_batch = 2 * B
    dense = SpeculativeEngine(model, heads, params, spec, max_len=max_len,
                              chunk=chunk)
    paged = SpeculativeEngine(model, heads, params, spec, max_len=max_len,
                              chunk=chunk, paged=True, page_size=ps,
                              pool_pages=pool_pages)
    in_place = _in_place_chunks(loaded, spec, max_len, pool_pages, sz,
                                paged_batch, device)

    zero = np.zeros(n)
    for eng, b in ((dense, B), (paged, paged_batch)):      # warm / capture
        ContinuousScheduler(eng, batch=b, chunk=chunk).serve(
            _requests(cfg, sz, n, zero))
    dn = _best_of(lambda: ContinuousScheduler(
        dense, batch=B, chunk=chunk).serve(_requests(cfg, sz, n, zero)), reps)
    pg = _best_of(lambda: ContinuousScheduler(
        paged, batch=paged_batch, chunk=chunk).serve(
            _requests(cfg, sz, n, zero)), reps)
    if n > B and pg["max_resident"] <= dn["max_resident"]:
        raise AssertionError(
            f"paged resident batch {pg['max_resident']} not larger than "
            f"dense {dn['max_resident']} at fixed pool memory")
    del dense

    # int8 pages: hold the pool's BYTE budget and re-derive the page count
    # at int8 (page_bytes counts the per-page scales); token agreement with
    # the float pool is recorded, not gated (quantization can flip a
    # near-tie; the bounded-error gate is the kernels')
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    pool_dt = getattr(torch, cfg.dtype)
    budget_bytes = pool_pages * page_bytes(L, ps, Hkv, hd, pool_dt)
    int8_pages = pages_at_fixed_bytes(budget_bytes, L, ps, Hkv, hd,
                                      torch.int8)
    token_gain = int8_pages / pool_pages
    if token_gain < 1.8:
        raise AssertionError(
            f"int8 pages fund only {token_gain:.2f}x reservable tokens at "
            f"fixed pool bytes (>= 1.8x required)")
    int8 = SpeculativeEngine(model, heads, params, spec, max_len=max_len,
                             chunk=chunk, paged=True, page_size=ps,
                             pool_pages=int8_pages, kv_dtype="int8")

    def serve_int8():
        return ContinuousScheduler(int8, batch=paged_batch,
                                   chunk=chunk).serve(
            _requests(cfg, sz, n, zero))

    res8, _ = serve_int8()                                 # warm / capture
    res32, _ = ContinuousScheduler(paged, batch=paged_batch,
                                   chunk=chunk).serve(
        _requests(cfg, sz, n, zero))
    by_id8 = {r.req_id: r.tokens for r in res8}
    match = sum(np.array_equal(by_id8[r.req_id], r.tokens) for r in res32)
    i8 = _best_of(serve_int8, reps)
    del paged, int8
    release(device)
    return {
        "page_size": ps, "pool_pages": pool_pages,
        "pool_slots": pool_pages * ps,
        "dense_batch": B, "paged_batch": paged_batch,
        "dense_max_resident": dn["max_resident"],
        "paged_max_resident": pg["max_resident"],
        "dense_tok_s": dn["tok_s"], "paged_tok_s": pg["tok_s"],
        "dense_makespan_s": dn["makespan_s"],
        "paged_makespan_s": pg["makespan_s"],
        "dense_latency_mean_s": dn["latency_mean_s"],
        "paged_latency_mean_s": pg["latency_mean_s"],
        "paged_latency_p95_s": pg["latency_p95_s"],
        "resident_gain": pg["max_resident"] / max(dn["max_resident"], 1),
        "speedup_paged_vs_dense": pg["tok_s"] / dn["tok_s"],
        "donation_in_place": True, "in_place": in_place,
        "int8_pool_pages": int8_pages,
        "int8_pool_bytes_budget": int(budget_bytes),
        "int8_reservable_token_gain": token_gain,
        "int8_max_resident": i8["max_resident"],
        "int8_tok_s": i8["tok_s"],
        "int8_makespan_s": i8["makespan_s"],
        "int8_latency_mean_s": i8["latency_mean_s"],
        "int8_token_match_frac": match / max(len(res32), 1),
    }


FAULT_SEED = 9
FAULT_REPLICAS = 2
FAULT_BATCH = 4               # per replica: half the single bank
FAULT_CANCEL_RATE = 0.10
FAULT_REQUESTS = 12


def faults_compare(loaded: Loaded, spec, max_len, sz: Sizes, device) -> dict:
    """``faults_run``, then its goodput gate: goodput under faults (tokens
    of DONE requests per second of makespan) >= 0.8x fault-free: the
    crash's lost work is re-decoded on the surviving replica and the
    cancelled clients' budgets leave the denominator with them."""
    out = faults_run(loaded, spec, max_len, sz, device)
    if out["goodput_ratio_faulted_vs_fault_free"] < 0.8:
        raise AssertionError(
            f"faulted goodput {out['faulted']['goodput_tok_s']:.1f} tok/s "
            f"fell below 0.8x fault-free "
            f"{out['fault_free']['goodput_tok_s']:.1f} tok/s")
    return out


def faults_run(loaded: Loaded, spec, max_len, sz: Sizes, device) -> dict:
    """The mixed-budget Poisson trace through the async router over
    ``FAULT_REPLICAS`` paged replicas, faults off vs on (replica r0
    crashes mid-serve, ~10% of clients hang up, every request has a
    finite deadline), best goodput of ``reps`` each: every request ends in
    a typed terminal state and no replica leaks a page (free + held ==
    pool after drain, through ``fail_all`` on the crashed replica too)."""
    cfg = loaded.cfg
    n = min(sz.requests, FAULT_REQUESTS)
    chunk, ps = sz.chunk, PAGE_SIZE
    pool_pages = FAULT_BATCH * pages_for(max_len, ps)
    engines = [SpeculativeEngine(loaded.model, loaded.heads, loaded.params,
                                 spec, max_len=max_len, chunk=chunk,
                                 paged=True, page_size=ps,
                                 pool_pages=pool_pages)
               for _ in range(FAULT_REPLICAS)]

    # warm each replica's bank and measure one replica's throughput
    warm = None
    for eng in engines:
        _, warm = ContinuousScheduler(eng, batch=FAULT_BATCH,
                                      chunk=chunk).serve(
            _requests(cfg, sz, 4, np.zeros(4)))
    total_budget = sum(sz.budgets[i % len(sz.budgets)] for i in range(n))
    w1 = total_budget / warm["tok_s"]           # est. 1-replica makespan
    # arrivals span ~35% of the fleet's makespan; deadlines bind at 2x one
    # replica's: real pressure once a crash serializes the fleet
    rate = n / max(0.35 * w1 / FAULT_REPLICAS, 1e-6)
    arrivals = poisson_arrivals(n, rate, seed=3)
    deadline_s = 2.0 * w1
    # r0 dies ~60% through its share of the trace
    crash_boundary = max(6, int(0.6 * warm["chunks"]))

    def arm(plan):
        scheds = [ContinuousScheduler(
            eng, batch=FAULT_BATCH, chunk=chunk,
            faults=None if plan is None else plan.injector(f"r{i}"))
            for i, eng in enumerate(engines)]
        servers = [AsyncEngineServer(s, name=f"r{i}")
                   for i, s in enumerate(scheds)]
        router = ReplicaRouter(
            servers, seed=FAULT_SEED,
            client_faults=None if plan is None else plan.client())

        async def go():
            await router.start()
            try:
                return await router_replay(
                    router, _requests(cfg, sz, n, arrivals),
                    deadline_s=deadline_s)
            finally:
                await router.stop()

        _, stats = asyncio.run(go())
        if not stats["terminal"]:
            raise AssertionError(
                f"non-terminal request states: {stats['states']}")
        if not (router.pages_conserved() and router.drained()):
            raise AssertionError("leaked pool pages after drain (faults "
                                 f"{'on' if plan else 'off'})")
        stats["pages_drained"] = True
        return stats

    plan = FaultPlan(seed=FAULT_SEED, crash={"r0": crash_boundary},
                     cancel_rate=FAULT_CANCEL_RATE)

    def best(fn):
        runs = [fn() for _ in range(sz.reps)]
        return max(runs, key=lambda s: s["goodput_tok_s"])

    clean = best(lambda: arm(None))
    chaos = best(lambda: arm(plan))
    del engines
    release(device)
    ratio = chaos["goodput_tok_s"] / max(clean["goodput_tok_s"], 1e-9)
    return {"replicas": FAULT_REPLICAS, "batch": FAULT_BATCH,
            "requests": n, "page_size": ps, "pool_pages": pool_pages,
            "seed": FAULT_SEED, "cancel_rate": FAULT_CANCEL_RATE,
            "crash_boundary": crash_boundary, "deadline_s": deadline_s,
            "fault_free": clean, "faulted": chaos,
            "goodput_ratio_faulted_vs_fault_free": ratio}


def hcmp_compare(loaded: Loaded, spec, max_len, sz: Sizes, device) -> dict:
    """Inline vs the HCMP overlap (the draft on a second CUDA stream; one
    serial executor on the CPU) through the same continuous scheduler on
    the burst trace: per-request tokens must match exactly; ARCA's
    measured partition choice recorded."""
    cfg, n = loaded.cfg, sz.requests
    inline = SpeculativeEngine(loaded.model, loaded.heads, loaded.params,
                               spec, max_len=max_len, chunk=sz.chunk)
    overlap = SpeculativeEngine(loaded.model, loaded.heads, loaded.params,
                                spec, max_len=max_len, chunk=sz.chunk,
                                hcmp="overlap")
    zero = np.zeros(n)

    def serve(eng):
        return ContinuousScheduler(eng, batch=BATCH, chunk=sz.chunk).serve(
            _requests(cfg, sz, n, zero))

    r_i, _ = serve(inline)                            # warm / capture + gate
    r_o, _ = serve(overlap)
    bad = [a.req_id for a, b in zip(r_i, r_o)
           if not np.array_equal(a.tokens, b.tokens)]
    if bad:
        raise AssertionError(
            f"overlap diverged from inline for requests {bad}: the arm is "
            f"meaningless without bit-identity")
    si = _best_of(lambda: serve(inline), sz.reps)
    so = _best_of(lambda: serve(overlap), sz.reps)
    tf = arca.profile_engine(overlap, batch=BATCH,
                             prompt_len=PROMPT_LEN, reps=1)
    part = tf.partition_for(spec)
    hs = overlap.hcmp_stats
    on_card = torch.device(device).type == "cuda"
    out = {"devices": 1, "streams": 2 if on_card else 1,
           "host_cores": os.cpu_count(), "batch": BATCH, "requests": n,
           "inline_tok_s": si["tok_s"], "overlap_tok_s": so["tok_s"],
           "inline_makespan_s": si["makespan_s"],
           "overlap_makespan_s": so["makespan_s"],
           "speedup_overlap_vs_inline": so["tok_s"] / si["tok_s"],
           "arca_partition": part,
           "predraft_hits": hs["predraft_hits"],
           "predraft_discards": hs["predraft_discards"]}
    del inline, overlap
    release(device)
    if out["speedup_overlap_vs_inline"] <= 1.0:
        out["note"] = (
            f"overlap did not beat inline under the scheduler on "
            f"{benchlib.label(device)} ({out['streams']} stream(s)): the "
            f"draft/commit window freed no wall time; ARCA's measured "
            f"choice ({part}) records it")
    return out


def adaptive_compare(loaded: Loaded, sz: Sizes, device) -> dict:
    """One ``DecodeEngine`` bank serves the mixed-budget trace under each
    fixed candidate width and under the scheduler's adaptive mode (starts
    at the widest, re-decides from the observed-acceptance EMA x the
    measured step times); adaptive must match or beat the worst fixed arm
    on aggregate tok/s; every strategy switch is logged."""
    cfg, n, chunk, reps = loaded.cfg, sz.requests, sz.chunk, sz.reps
    widths = sz.adapt_widths
    accs = T.default_accs(cfg.medusa_heads, cfg.medusa_top_k)
    specs = {w: T.candidate_spec(accs, w) for w in widths}
    max_len = PROMPT_LEN + max(sz.budgets) + max(
        s.max_depth for s in specs.values())
    eng = DecodeEngine(loaded.model, loaded.params, heads=loaded.heads,
                       strategy=DecodeStrategy.medusa(specs[max(widths)],
                                                      loaded.device),
                       max_len=max_len, chunk=chunk)
    time_fn = arca.profile_engine(eng, widths, accs=accs, batch=BATCH,
                                  prompt_len=PROMPT_LEN, reps=reps)
    strategies = arca.choose_strategy(cfg, accs, ctx=PROMPT_LEN,
                                      time_fn=time_fn, widths=widths)
    zero = np.zeros(n)
    out = {"widths": list(widths), "batch": BATCH,
           "step_time_measured_s": {w: strategies[w].step_time
                                    for w in widths},
           "arms": {}}
    for w in widths:
        eng.set_strategy(specs[w])
        ContinuousScheduler(eng, batch=BATCH, chunk=chunk).serve(
            _requests(cfg, sz, n, zero))                   # warm / capture
        s = _best_of(lambda: ContinuousScheduler(
            eng, batch=BATCH, chunk=chunk).serve(
                _requests(cfg, sz, n, zero)), reps)
        out["arms"][f"fixed_w{w}"] = {
            "tok_s": s["tok_s"], "makespan_s": s["makespan_s"],
            "latency_p95_s": s["latency_p95_s"]}

    def adaptive_run():
        eng.set_strategy(specs[max(widths)])               # wide start
        return ContinuousScheduler(eng, batch=BATCH, chunk=chunk,
                                   adaptive=strategies).serve(
            _requests(cfg, sz, n, zero))

    adaptive_run()                                         # warm / capture
    best_stats = _best_of(adaptive_run, reps)
    del eng
    release(device)
    out["arms"]["adaptive"] = {
        "tok_s": best_stats["tok_s"],
        "makespan_s": best_stats["makespan_s"],
        "latency_p95_s": best_stats["latency_p95_s"],
        "width_start": max(widths),
        "width_final": best_stats["width_final"],
        "al_observed": best_stats["al_observed"],
        "strategy_switches": best_stats["strategy_switches"]}
    worst = min(out["arms"][f"fixed_w{w}"]["tok_s"] for w in widths)
    out["worst_fixed_tok_s"] = worst
    out["gain_adaptive_vs_worst_fixed"] = \
        out["arms"]["adaptive"]["tok_s"] / worst
    if out["arms"]["adaptive"]["tok_s"] < worst:
        raise AssertionError(
            f"adaptive ({out['arms']['adaptive']['tok_s']:.1f} tok/s) lost "
            f"to the worst fixed width ({worst:.1f} tok/s)")
    return out


POLICY_PROMPTS = (16, 64)     # short budget <-> short prompt, long <-> long
POLICY_PREFILL_CHUNK = 16
POLICY_LONG_EVERY = 16        # one long request per 16 shorts
POLICY_BATCH = 12


def _policy_requests(cfg, sz: Sizes, n):
    """Burst trace of the policy comparison: short/long budgets with the
    long requests in the MIDDLE of each ``policy_long_every`` block (the
    convoy shape: a long request at the FIFO head whose reservation the
    pool cannot fund beside the resident shorts holds back every fundable
    short behind it; SJF lets them pass).  Long requests are ~6% of the
    trace, so p95 latency sits on the shorts the convoy delays."""
    short_p, long_p = POLICY_PROMPTS
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (n, long_p)).astype(np.int32)
    reqs = []
    for i in range(n):
        is_long = i % POLICY_LONG_EVERY == POLICY_LONG_EVERY // 2
        reqs.append(Request(
            req_id=i, tokens=prompts[i, :long_p if is_long else short_p],
            n_tokens=max(sz.budgets) if is_long else min(sz.budgets),
            arrival=0.0))
    return reqs


def policy_compare(loaded: Loaded, spec, sz: Sizes, device) -> dict:
    """FIFO vs SJF vs FIFO + chunked prefill on the convoy trace, on a
    paged bank whose pool holds ten short reservations but never a long
    one beside them (the head-of-line regime).  One burst, so every
    latency difference is scheduling.  p50/p95 are the headline; SJF's
    cost (the long request starved to ~the makespan) is recorded too."""
    cfg, chunk, ps = loaded.cfg, sz.chunk, PAGE_SIZE
    n = sz.policy_requests or sz.requests
    max_len = max(POLICY_PROMPTS) + max(sz.budgets) + spec.max_depth
    short_pages = pages_for(
        min(POLICY_PROMPTS) + min(sz.budgets) + spec.max_depth, ps)
    # ten shorts fit with one page to spare; a long never fits beside a
    # full complement of shorts, so FIFO's head of line defers
    pool_pages = 10 * short_pages + 1
    eng = SpeculativeEngine(loaded.model, loaded.heads, loaded.params, spec,
                            max_len=max_len, chunk=chunk, paged=True,
                            page_size=ps, pool_pages=pool_pages)

    def serve(**kw):
        return ContinuousScheduler(eng, batch=POLICY_BATCH, chunk=chunk,
                                   **kw).serve(_policy_requests(cfg, sz, n))

    arms = {
        "fifo": dict(policy="fifo"),
        "sjf": dict(policy="sjf"),
        "chunked_prefill": dict(policy="fifo",
                                prefill_chunk=POLICY_PREFILL_CHUNK),
    }
    out = {"page_size": ps, "pool_pages": pool_pages,
           "batch": POLICY_BATCH, "prompt_lens": list(POLICY_PROMPTS),
           "budgets": list(sz.budgets),
           "prefill_chunk": POLICY_PREFILL_CHUNK, "requests": n,
           "arms": {}}
    for name, kw in arms.items():
        serve(**kw)                                    # warm / capture
        s = _best_of(lambda: serve(**kw), sz.reps)
        out["arms"][name] = {
            "tok_s": s["tok_s"], "makespan_s": s["makespan_s"],
            "max_resident": s["max_resident"],
            "latency_mean_s": s["latency_mean_s"],
            "latency_p50_s": s["latency_p50_s"],
            "latency_p95_s": s["latency_p95_s"],
            "latency_max_s": s["latency_max_s"],
            "queue_wait_p95_s": s["queue_wait_p95_s"]}
    del eng
    release(device)
    fifo95 = out["arms"]["fifo"]["latency_p95_s"]
    best95 = min(out["arms"]["sjf"]["latency_p95_s"],
                 out["arms"]["chunked_prefill"]["latency_p95_s"])
    if best95 >= fifo95:
        raise AssertionError(
            f"neither sjf ({out['arms']['sjf']['latency_p95_s']:.2f}s) nor "
            f"chunked prefill "
            f"({out['arms']['chunked_prefill']['latency_p95_s']:.2f}s) beat "
            f"fifo ({fifo95:.2f}s) on p95 latency")
    out["p95_gain_best_vs_fifo"] = fifo95 / best95
    out["p50_gain_sjf_vs_fifo"] = (
        out["arms"]["fifo"]["latency_p50_s"]
        / max(out["arms"]["sjf"]["latency_p50_s"], 1e-9))
    return out


def grid(loaded: Loaded, spec, max_len, sz: Sizes, device) -> dict:
    """Static vs continuous for the sequential and the speculative engine
    under calibrated Poisson arrivals."""
    cfg, n, chunk, B = loaded.cfg, sz.requests, sz.chunk, BATCH
    record = {"arch": cfg.name, "dtype": cfg.dtype, "requests": n,
              "batch": B, "chunk": chunk, "prompt_len": PROMPT_LEN,
              "budgets": list(sz.budgets), "tree_width": spec.width,
              "grid": []}
    engines = {
        "sequential": lambda: BatchEngine(loaded.model, loaded.params,
                                          max_len=max_len, chunk=chunk),
        "speculative": lambda: SpeculativeEngine(
            loaded.model, loaded.heads, loaded.params, spec,
            max_len=max_len, chunk=chunk),
    }
    for name, make in engines.items():
        eng = make()
        zero = np.zeros(n)
        # warm up both paths AND measure the warm static makespan
        serve_static(eng, _requests(cfg, sz, n, zero), batch=B)
        ContinuousScheduler(eng, batch=B, chunk=chunk).serve(
            _requests(cfg, sz, n, zero))
        _, warm = serve_static(eng, _requests(cfg, sz, n, zero), batch=B)
        # arrivals span ~35% of the warm static makespan: staggered (static
        # pays batch-formation waits), continuous stays decode-bound
        rate = n / (0.35 * warm["makespan_s"])
        arrivals = poisson_arrivals(n, rate, seed=3)
        st = _best_of(lambda: serve_static(
            eng, _requests(cfg, sz, n, arrivals), batch=B), sz.reps)
        ct = _best_of(lambda: ContinuousScheduler(
            eng, batch=B, chunk=chunk).serve(
                _requests(cfg, sz, n, arrivals)), sz.reps)
        for sched, s in (("static", st), ("continuous", ct)):
            record["grid"].append({
                "engine": name, "sched": sched, "rate": rate,
                "tok_s": s["tok_s"], "makespan_s": s["makespan_s"],
                "emitted_total": s["emitted_total"],
                "latency_mean_s": s["latency_mean_s"],
                "latency_p90_s": s["latency_p90_s"],
                "latency_p95_s": s["latency_p95_s"],
                "queue_wait_mean_s": s["queue_wait_mean_s"]})
        record[f"speedup_continuous_vs_static_{name}"] = \
            ct["tok_s"] / st["tok_s"]
        record[f"latency_ratio_static_vs_continuous_{name}"] = \
            st["latency_mean_s"] / max(ct["latency_mean_s"], 1e-9)
        del eng
        release(device)
    record["speedup_continuous_vs_static"] = min(
        record["speedup_continuous_vs_static_sequential"],
        record["speedup_continuous_vs_static_speculative"])
    return record


ARMS = ("grid", "paged", "policies", "adaptive", "faults", "hcmp")


def worker(loaded: Loaded, sz: Sizes = Sizes(), arms=ARMS,
           watch=benchlib.unwatched) -> dict:
    """The record of ``arms`` on ``loaded``'s device."""
    device = loaded.device
    cfg = loaded.cfg
    spec = T.build_tree(T.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                        WIDTH)
    max_len = PROMPT_LEN + max(sz.budgets) + spec.max_depth
    record = {"arch": cfg.name, "dtype": cfg.dtype, "requests": sz.requests,
              "chunk": sz.chunk, "sizes": dataclasses.asdict(sz)}
    timings = {}
    with pinned(device), torch.no_grad():
        for arm in arms:
            t0 = time.perf_counter()
            with watch(f"sched {arm}"):
                _arm(record, arm, loaded, spec, max_len, sz, device)
            timings[arm] = time.perf_counter() - t0
    record["arm_wall_s"] = timings
    record["card"] = benchlib.card(device)
    return record


def _arm(record, arm, loaded, spec, max_len, sz, device):
    """Run one arm into ``record``."""
    if arm == "grid":
        record.update(grid(loaded, spec, max_len, sz, device))
    elif arm == "paged":
        record["paged"] = paged_compare(loaded, spec, max_len, sz, device)
    elif arm == "policies":
        record["policies"] = policy_compare(loaded, spec, sz, device)
    elif arm == "adaptive":
        record["adaptive"] = adaptive_compare(loaded, sz, device)
    elif arm == "faults":
        record["faults"] = faults_compare(loaded, spec, max_len, sz, device)
    elif arm == "hcmp":
        record["hcmp"] = hcmp_compare(loaded, spec, max_len, sz, device)
    else:
        raise ValueError(f"unknown arm {arm!r} (one of {ARMS})")


def rows_of(record) -> list:
    """The harness's CSV rows."""
    where = record["card"]["name"]
    rows = []
    for g in record.get("grid", ()):
        name = f"sched_{g['sched'][:4]}_{g['engine'][:4]}_b{record['batch']}"
        rows.append((name, 1e6 / g["tok_s"],
                     f"{g['tok_s']:.1f} tok/s agg, lat p95 "
                     f"{g['latency_p95_s']:.3f}s, {where}"))
    if "grid" in record:
        for eng in ("sequential", "speculative"):
            rows.append((f"sched_speedup_cont_vs_static_{eng[:4]}",
                         record[f"speedup_continuous_vs_static_{eng}"],
                         "x aggregate tok/s"))
            rows.append((f"sched_latencyx_static_vs_cont_{eng[:4]}",
                         record[f"latency_ratio_static_vs_continuous_{eng}"],
                         "x mean latency (higher = static worse)"))
    if "paged" in record:
        pg = record["paged"]
        rows.append(("sched_paged_resident_gain", pg["resident_gain"],
                     f"{pg['paged_max_resident']} vs "
                     f"{pg['dense_max_resident']} resident at "
                     f"{pg['pool_slots']} pool slots"))
        rows.append(("sched_paged_vs_dense_tok_s",
                     pg["speedup_paged_vs_dense"],
                     f"{pg['paged_tok_s']:.1f} vs {pg['dense_tok_s']:.1f} "
                     f"tok/s agg at fixed pool memory, {where}"))
        rows.append(("sched_int8_reservable_token_gain",
                     pg["int8_reservable_token_gain"],
                     f"{pg['int8_pool_pages']} int8 pages at "
                     f"{pg['int8_pool_bytes_budget']} bytes"))
    if "policies" in record:
        pol = record["policies"]
        for name, a in pol["arms"].items():
            rows.append((f"sched_policy_{name}", a["latency_p95_s"],
                         f"p95 lat s (p50 {a['latency_p50_s']:.3f}s, "
                         f"{a['tok_s']:.1f} tok/s, "
                         f"resident {a['max_resident']}), {where}"))
        rows.append(("sched_policy_p95_gain_vs_fifo",
                     pol["p95_gain_best_vs_fifo"],
                     "x fifo p95 latency (best of sjf/chunked-prefill)"))
    if "adaptive" in record:
        ad = record["adaptive"]
        for name, a in ad["arms"].items():
            extra = ""
            if name == "adaptive":
                extra = (f", w {a['width_start']}->{a['width_final']}, "
                         f"{len(a['strategy_switches'])} switch(es)")
            rows.append((f"sched_{name}", 1e6 / a["tok_s"],
                         f"{a['tok_s']:.1f} tok/s agg{extra}, {where}"))
        rows.append(("sched_adaptive_vs_worst_fixed",
                     ad["gain_adaptive_vs_worst_fixed"],
                     "x worst fixed-width arm (measured-ARCA selection)"))
    if "hcmp" in record:
        hc = record["hcmp"]
        rows.append(("sched_hcmp_overlap_vs_inline",
                     hc["speedup_overlap_vs_inline"],
                     f"x inline ({hc['overlap_tok_s']:.1f} vs "
                     f"{hc['inline_tok_s']:.1f} tok/s agg, "
                     f"{hc['streams']} stream(s), arca picks "
                     f"{hc['arca_partition']}, predraft "
                     f"{hc['predraft_hits']}h/{hc['predraft_discards']}d)"))
    if "faults" in record:
        fl = record["faults"]
        for name in ("fault_free", "faulted"):
            a = fl[name]
            rows.append((f"sched_{name}", a["goodput_tok_s"],
                         f"goodput tok/s ({a['tok_s']:.1f} raw, "
                         f"states {a['states']}, {a['retries']} retried, "
                         f"pages drained {a['pages_drained']})"))
        rows.append(("sched_faults_goodput_ratio",
                     fl["goodput_ratio_faulted_vs_fault_free"],
                     f"x fault-free goodput under crash@"
                     f"{fl['crash_boundary']} + "
                     f"{fl['cancel_rate']:.0%} cancel + "
                     f"{fl['deadline_s']:.2f}s deadline "
                     f"({fl['replicas']} replicas)"))
    return rows


def run(loaded: Loaded = None, *, arch=SCHED_SMOKE_ARCH, device="cuda",
        sizes: Sizes = Sizes(), arms=ARMS, out_dir=None,
        watch=benchlib.unwatched) -> dict:
    """Measure, write ``sched_bench.json`` and print the CSV rows,
    return the record; ``loaded`` reuses weights already on the device."""
    if loaded is None:
        loaded = load(bench_config(arch), device)
    t0 = time.perf_counter()
    record = worker(loaded, sizes, arms, watch)
    record["wall_s"] = time.perf_counter() - t0
    path = benchlib.write_record("sched_bench", record, out_dir)
    for name, val, derived in rows_of(record):
        print(f"{name},{val:.4f},{derived}")
    print(f"[sched_bench] wrote {path}")
    return record


def _ints(text):
    return tuple(int(x) for x in text.split(","))


def add_args(ap):
    ap.add_argument("--sched-arch", default=SCHED_SMOKE_ARCH)
    ap.add_argument("--requests", type=int, default=Sizes.requests)
    ap.add_argument("--budgets", type=_ints, default=Sizes.budgets,
                    help="short,long generation budgets (alternating)")
    ap.add_argument("--policy-requests", type=int, default=0,
                    help="requests of the policy arm's convoy trace "
                         "(0: --requests)")
    ap.add_argument("--sched-reps", type=int, default=Sizes.reps)
    ap.add_argument("--chunk", type=int, default=Sizes.chunk)
    ap.add_argument("--adapt-widths", type=_ints, default=Sizes.adapt_widths,
                    help="the adaptive arm's candidate widths")
    ap.add_argument("--arms", type=lambda s: tuple(s.split(",")),
                    default=ARMS, help=f"comma list of {','.join(ARMS)}")


def sizes_of(args) -> Sizes:
    return Sizes(requests=args.requests, budgets=args.budgets,
                 reps=args.sched_reps, chunk=args.chunk,
                 policy_requests=args.policy_requests,
                 adapt_widths=args.adapt_widths)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks."
                                      "sched_bench")
    add_args(ap)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="record directory (default results/torch/)")
    args = ap.parse_args(argv)
    return run(arch=args.sched_arch, device=args.device,
               sizes=sizes_of(args), arms=args.arms, out_dir=args.out)


if __name__ == "__main__":
    main()
