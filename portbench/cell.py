"""One run of one cell: set-up, the measured window, the check.

The path every cell drives: asyncio clients submit to the port's
``runtime.server.AsyncEngineServer``, which runs one
``runtime.continuous.ContinuousScheduler`` over one
``runtime.engine.DecodeEngine`` (Medusa-drafted, the tree fixed at the
configuration's width, HCMP inline, the dense paged verify on a paged pool
in the model's dtype, chunked prefill).  Clients read each request's token
stream.

Set-up (``setup_s``, from process start to the window): weights from the
seed, the engine, and a warm-up through the same server and bank that the
window then uses, so the bank's CUDA graph is captured and every kernel is
built before the window opens.

The benchmark's spans wrap the engine's slot-protocol calls
(``sched_prefill``/``sched_insert``/``sched_admit``/``sched_extend``/
``sched_step``/``sched_reset``/``sched_release``/``sched_abort``); each
decode chunk's rows (request, context, tokens produced) are read from the
scheduler's own rows as the chunk starts.  ``--trace 1`` synchronises the device after each
admission and prefill piece (so their spans hold their device work) and
profiles the last ``trace_slice_s`` seconds of the window (the profiler
is started once during set-up, so its own start-up stays out of the
window).
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import inspect
import subprocess
import sys
import threading
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from portbench import devtrace, spec, traffic, weights, window, yardstick
from portbench.reference import model as refmodel
from portbench.reference import oracle

WARM_ID = 1 << 40             # request ids of the warm-up
SNAP_WAIT_S = 30.0            # longest wait for the first step after close
BIG = 1e30                    # a check with nothing to read


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them (a
    card set below its maximum power runs slower under load); a copy of
    the port's ``benchmarks/benchlib.py::card``."""
    try:
        smi = subprocess.run(["nvidia-smi", "--id=0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return smi.stdout.strip() if smi.returncode == 0 else \
            f"nvidia-smi failed: {smi.stderr.strip()[:200]}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


@dataclasses.dataclass
class Rec:
    """One request as its client saw it (host clock: perf_counter)."""
    o: traffic.Offered
    rid: int
    due: float
    chunks: list = dataclasses.field(default_factory=list)   # (t, n)
    tokens: list = dataclasses.field(default_factory=list)
    state: str = ""
    t_admit: Optional[float] = None
    cancelled_by_bench: bool = False

    @property
    def first(self):
        return self.chunks[0][0] if self.chunks else None

    @property
    def last(self):
        return self.chunks[-1][0] if self.chunks else None


class Tap:
    """Spans around the engine's slot-protocol calls.  What a span needs
    of its call (the prompt tokens it landed, a decode chunk's rows) is
    read from the call's named arguments and from the scheduler's own rows
    (``ContinuousScheduler._slots``: each row's request, output so far and
    prompt still to land)."""

    NAMES = ("sched_prefill", "sched_insert", "sched_admit", "sched_extend",
             "sched_step", "sched_reset", "sched_release", "sched_abort")

    def __init__(self, eng, sched, traced: bool, device):
        self.eng, self.sched = eng, sched
        self.traced = traced and device.type == "cuda"
        self.spans = []          # (name, t0, t1, info)
        self.steps = []          # (t0, t1, K, ctx0 (B,), live0 (B,), ns (K, B))
        self._depth = 0
        self.snap_at = None
        self.snapshot = None
        self.snapped = threading.Event()
        self._fn_step = eng.sched_step
        for name in self.NAMES:
            setattr(eng, name, self._wrap(name, getattr(eng, name)))

    def _wrap(self, name, fn):
        if name == "sched_step":
            return self._step
        sig = inspect.signature(fn)

        def call(*a, **kw):
            self._depth += 1
            info = self._info(name, sig.bind(*a, **kw).arguments)
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                if self._depth == 1 and "tokens" in info and self.traced:
                    torch.cuda.synchronize()
            finally:
                self._depth -= 1
            if self._depth == 0:
                self.spans.append((name, t0, time.perf_counter(), info))
            return out
        return call

    def _info(self, name, arg):
        """Prompt tokens a prefill call lands; a piece's row context and
        padded width."""
        if name in ("sched_prefill", "sched_admit"):
            return {"tokens": int(arg["batch"]["tokens"].shape[-1])}
        if name == "sched_extend":
            s = self.sched._slots[int(arg["b"])]
            return {"tokens": int(arg["n_valid"]),
                    "ctx": len(s["req"].tokens) - len(s["pending"]),
                    "W": int(arg["tokens"].shape[1])}
        return {}

    def _rows(self):
        """Each bank row before a chunk: its cached tokens, whether it
        decodes, its request id and the tokens it has produced."""
        B = len(self.sched._slots)
        ctx, live = np.zeros(B, np.int64), np.zeros(B, bool)
        rid, m = [None] * B, np.zeros(B, np.int64)
        for b, s in enumerate(self.sched._slots):
            if s is None:
                continue
            S = len(s["req"].tokens)
            if s["pending"] is not None:
                ctx[b] = S - len(s["pending"])
            else:
                rid[b], m[b], live[b] = s["req"].req_id, len(s["out"]), True
                ctx[b] = S + m[b] - 1
        return ctx, live, rid, m

    def _step(self, state, done, rem, K, eos_val):
        ctx, live, rid, m = self._rows()
        t0 = time.perf_counter()
        out = self._fn_step(state, done, rem, K, eos_val)
        t1 = time.perf_counter()
        ns = np.asarray(out[3][1])
        self.steps.append((t0, t1, int(K), ctx, live, ns))
        self.spans.append(("sched_step", t0, t1, {"K": int(K)}))
        if self.snap_at is not None and self.snapshot is None \
                and t0 >= self.snap_at:
            st = out[0]
            hid = getattr(st, "hidden", None)
            cur = getattr(st, "cur_token", None)
            m = m + ns.sum(0)
            self.snapshot = dict(
                hidden=None if hid is None else hid.detach().clone(),
                cur=None if cur is None else cur.detach().cpu().numpy(),
                rows=[(rid[b], int(m[b])) if live[b] else None
                      for b in range(len(rid))])
            self.snapped.set()
        return out


def build_kernels():
    """Build the port's CUDA libraries that this checkout lacks, before
    anything else; returns the seconds that took.  Only a checkout's first
    run builds: its ``setup_s`` holds that time, which the result line
    gives apart as ``setup_build_s``."""
    from repro_torch.kernels import build as kb
    t0 = time.perf_counter()
    missing = [n for n in kb.SOURCES if not kb.library_path(n).exists()]
    kb.build(missing)
    build_s = time.perf_counter() - t0
    log(f"kernel libraries built in this run: {missing or 'none'} "
        f"({build_s:.3f} s)")
    return build_s


def build(cfgfile: dict, mix: dict, seed: int, device):
    """Weights, engine, scheduler and server of a cell (not started)."""
    from repro_torch.core.speculative import tree as T
    from repro_torch.models.api import get_model
    from repro_torch.runtime.continuous import ContinuousScheduler
    from repro_torch.runtime.engine import DecodeEngine, DecodeStrategy
    from repro_torch.runtime.server import AsyncEngineServer
    pcfg = spec.port_config(cfgfile)
    sv = cfgfile["serve"]
    params, heads = weights.make(pcfg, seed, device)
    tree = T.build_tree(T.default_accs(pcfg.medusa_heads, pcfg.medusa_top_k),
                        sv["tree_width"])
    eng = DecodeEngine(
        get_model(pcfg), params, heads=heads,
        strategy=DecodeStrategy.medusa(tree, device),
        max_len=traffic.max_context(mix) + tree.max_depth,
        chunk=sv["chunk"], paged=True, page_size=sv["page_size"],
        hcmp=sv["hcmp"], kv_dtype=None, tree_kernel=sv["tree_kernel"])
    sched = ContinuousScheduler(eng, batch=sv["bank"], chunk=sv["chunk"],
                                prefill_chunk=sv["prefill_chunk"])
    server = AsyncEngineServer(sched, queue_limit=1 << 20)
    return SimpleNamespace(pcfg=pcfg, params=params, heads=heads, tree=tree,
                           eng=eng, sched=sched, server=server)


async def _one(server, rec: Rec, Request):
    h = await server.submit(Request(req_id=rec.rid, tokens=rec.o.prompt,
                                    n_tokens=rec.o.n_tokens))
    async for toks in h.stream():
        rec.chunks.append((time.perf_counter(), len(toks)))
        rec.tokens.extend(toks)
    res = await h.result()
    rec.state = res.state
    rec.t_admit = res.t_admit


async def _serve(sys_, mix, reqs, warm, seconds, tap, t_proc, prof):
    """Warm-up, then the window, then the drain; returns (records, (window
    start, window end, end of the drain), setup_s, spans before the
    window)."""
    from repro_torch.runtime.continuous import Request
    server = sys_.server
    await server.start()
    offset = time.perf_counter() - sys_.sched.now()
    # warm-up: the cell's own shapes through the same bank
    wrecs = [Rec(o=o, rid=WARM_ID + i, due=0.0) for i, o in enumerate(warm)]
    await asyncio.gather(*[_one(server, r, Request) for r in wrecs])
    if tap.eng.device.type == "cuda":
        torch.cuda.synchronize()
    log(f"warm-up: {len(wrecs)} requests done at "
        f"{time.perf_counter() - t_proc:.3f} s")
    graphs0 = dict(tap.eng.graph_stats)
    n_spans0 = len(tap.spans)
    gc.collect()
    gc.freeze()       # set-up's objects leave the collector's generations
    recs, tasks = [], []
    w0 = time.perf_counter()
    w1 = w0 + seconds
    setup_s = w0 - t_proc
    tap.snap_at = w1

    async def slice_start():
        await asyncio.sleep(max(0.0, w1 - prof.length - time.perf_counter()))
        prof.start()

    starter = asyncio.ensure_future(slice_start()) if prof else None
    it = iter(reqs)
    if mix["loop"] == "closed":
        async def client():
            while time.perf_counter() < w1:
                o = next(it, None)
                if o is None:
                    raise RuntimeError("the mix's request set ran out: "
                                       "raise its 'requests'")
                rec = Rec(o=o, rid=o.idx, due=time.perf_counter())
                recs.append(rec)
                await _one(server, rec, Request)

        tasks = [asyncio.ensure_future(client())
                 for _ in range(mix["clients"])]
        await asyncio.sleep(max(0.0, w1 - time.perf_counter()))
    else:
        late = []
        for o in it:
            due = w0 + o.due
            if due >= w1:
                break
            delay = due - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            late.append(time.perf_counter() - due)
            rec = Rec(o=o, rid=o.idx, due=due)
            recs.append(rec)
            tasks.append(asyncio.ensure_future(_one(server, rec, Request)))
        await asyncio.sleep(max(0.0, w1 - time.perf_counter()))
        if late:
            log(f"generator lateness: mean {np.mean(late) * 1e3:.3f} ms, "
                f"p95 {np.percentile(late, 95) * 1e3:.3f} ms, max "
                f"{np.max(late) * 1e3:.3f} ms over {len(late)} arrivals")
    if starter is not None:
        await starter
        prof.mark_end()
    # the window is closed: wait for the first decode step after it (the
    # draft check's snapshot), then end what is still running
    await asyncio.get_running_loop().run_in_executor(
        None, tap.snapped.wait, SNAP_WAIT_S)
    if mix["loop"] == "closed":
        for r in recs:
            if not r.state:
                r.cancelled_by_bench = True
                await server.cancel(r.rid)
        await asyncio.gather(*tasks)
    else:
        await asyncio.wait(tasks, timeout=mix["drain_s"])
        for r in recs:
            if not r.state:
                await server.cancel(r.rid)
        await asyncio.gather(*tasks)
    t_end = time.perf_counter()
    await server.stop()
    if prof is not None:
        prof.stop()
    gc.unfreeze()
    graphs1 = dict(tap.eng.graph_stats)
    for r in recs:
        if r.t_admit is not None:
            r.t_admit += offset
    log(f"window: {w1 - w0:.3f} s, then {t_end - w1:.3f} s to the last "
        f"answer; graphs: {graphs0.get('graphs')} built before the window, "
        f"captures in the window "
        f"{graphs1.get('captures', 0) - graphs0.get('captures', 0)}, "
        f"steps replayed {graphs1.get('replays', 0) - graphs0.get('replays', 0)}")
    return recs, (w0, w1, t_end), setup_s, n_spans0


def run(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
        device, t_proc: float, cfgfile: dict = None, mix: dict = None,
        fault=None, control: bool = False, probe: dict = None) -> dict:
    """One run of ``cell``: its result line as a dict.  ``cfgfile``/``mix``
    replace the named files (the CPU tests' small sizes); ``fault`` is
    called with the built system before the serve (the fault tests);
    ``control`` also judges the fp8 control on the same sample
    (``calibrate.py``; the benchmark's runs never do); ``probe``, a dict,
    receives the run's records (``sweep.py``)."""
    device = torch.device(device)
    w = spec.workload(bench, cell)
    cfgfile = cfgfile or spec.config_file(bench, w["config"])
    mix = mix or spec.traffic(w["traffic"])
    build_s = 0.0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        log(f"card: {card()}; torch {torch.__version__}")
        build_s = build_kernels()
    sys_ = build(cfgfile, mix, seed, device)
    vocab = cfgfile["vocab_size"]
    reqs = traffic.offered(mix, vocab, seed)
    # warm-up: the longest prompt of the set (a first piece and prefill
    # pieces) and the shortest (a whole-prompt admission), reversed so they
    # are no request of the window, each long enough for the bank's step
    # to run eagerly, be captured and replay
    by_len = sorted(reqs, key=lambda o: len(o.prompt))
    warm = [traffic.Offered(idx=i, prompt=o.prompt[::-1].copy(),
                            n_tokens=3 * cfgfile["serve"]["chunk"], due=0.0)
            for i, o in enumerate((by_len[-1], by_len[0]))]
    if fault is not None:         # inside the program, under the spans
        fault(sys_)
    tap = Tap(sys_.eng, sys_.sched, trace, device)
    prof = devtrace.Slice(mix["trace_slice_s"]) if trace else None
    log(f"built at {time.perf_counter() - t_proc:.3f} s")
    recs, (w0, w1, t_end), setup_s, n_spans0 = asyncio.run(
        _serve(sys_, mix, reqs, warm, seconds, tap, t_proc, prof))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    ctx = SimpleNamespace(
        cell=cell, cfg=cfgfile, mix=mix, seconds=seconds, window=(w0, w1),
        t_end=t_end, records=recs, spans=tap.spans[n_spans0:],
        steps=[s for s in tap.steps if s[0] >= w0], setup_s=setup_s,
        bank=cfgfile["serve"]["bank"], W=sys_.tree.width,
        nnz=yardstick.tree_nnz(sys_.tree.mask), trace=None, yardstick=yardstick)
    steps = [st for st in ctx.steps if st[1] <= w1]
    n_steps = sum(st[2] for st in steps)
    pre = [sp for sp in ctx.spans if sp[0] in window.PREFILL and sp[2] <= w1]
    log(f"window: {n_steps} decode steps in {len(steps)} chunks, "
        f"{sum(st[1] - st[0] for st in steps):.3f} s in them "
        f"({1e3 * sum(st[1] - st[0] for st in steps) / max(n_steps, 1):.3f} "
        f"ms a step); {len(pre)} prefill calls, "
        f"{sum(sp[2] - sp[1] for sp in pre):.3f} s in them over "
        f"{sum(sp[3].get('tokens', 0) for sp in pre)} prompt tokens")
    if probe is not None:
        probe["ctx"] = ctx
    if prof is not None and prof.t1 is not None:
        ev = devtrace.device_events(prof.prof)
        ctx.trace = devtrace.summary(ev, prof.t0, prof.t1, prof.clock,
                                     tap.spans)
        log(f"traced slice: the last {prof.t1 - prof.t0:.3f} s of the "
            f"window, from {prof.t0 - w0:.3f} s ({len(ev)} device "
            f"activities; clocks aligned: {ctx.trace['aligned']})")
    # draft candidates of the snapshot, by the program's own draft function
    snap = tap.snapshot
    if snap is not None and snap["hidden"] is not None:
        from repro_torch.core.speculative.medusa import draft_candidates
        with torch.no_grad():
            cands, _ = draft_candidates(sys_.pcfg, sys_.heads, snap["hidden"],
                                        sys_.pcfg.medusa_top_k)
        snap["top1"] = cands[:, :, 0].cpu().numpy()
    params, heads = sys_.params, sys_.heads
    sys_.server = sys_.sched = sys_.eng = tap.eng = None
    del sys_
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, controls = check(cfgfile, mix, params, heads, recs, snap, seed,
                             control)
    log(f"reference check: {time.perf_counter() - t_ref:.3f} s")
    metrics = {}
    for m in spec.metrics_for(bench, cell, trace):
        v = spec.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    bench_fail = [r for r in recs if r.state not in ("DONE", "")
                  and not r.cancelled_by_bench]
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": len(recs),
        "failed": len(bench_fail),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name()
                   if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    result["setup_build_s"] = build_s
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace["busy_s"]
        result["device"]["window_s"] = ctx.trace["window_s"]
        top = sorted(ctx.trace["by_name"].items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in top[:10]],
            "idle_gaps": ctx.trace["gaps"]}
        for name, s in sorted(devtrace.by_class(ctx.trace["by_name"]).items(),
                              key=lambda kv: -kv[1]):
            log(f"device time by class: {name}: {s:.6f} s "
                f"({s / max(ctx.trace['busy_s'], 1e-12):.4f} of busy)")
    # no sample reads as a number no limit passes
    checks = {k: (min(v, BIG), lim) for k, (v, lim) in checks.items()}
    if control:
        result["controls"] = controls
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    return result


def _reduce(outs, key, ckey, name, got, controls):
    """The widest and the mean gap of ``outs``' ``key`` arrays into
    ``got``; the control's (``ckey``) into ``controls``."""
    if not outs:
        return
    g = np.concatenate([o[key] for o in outs])
    got[f"{name}_gap"], got[f"{name}_mean"] = float(g.max()), float(g.mean())
    if ckey in outs[0]:
        c = np.concatenate([o[ckey] for o in outs])
        controls[f"{name}_gap"] = float(c.max())
        controls[f"{name}_mean"] = float(c.mean())


def check(cfgfile, mix, params, heads, recs, snap, seed, control=False):
    """``{name: (number, limit)}``: the reference's judgement of a sample
    of what the window served (see ``reference/oracle.py``), for each
    number the configuration's ``limits`` name (each gap's widest, ``_gap``,
    or mean, ``_mean``), and the counts that must be 0; with ``control``,
    also the fp8 control's numbers on the same sample."""
    lim = cfgfile["limits"]
    rng = np.random.default_rng([seed & traffic.SEED_MASK, 7])
    done = [r for r in recs if r.state == "DONE"]
    short = sum(len(r.tokens) < r.o.n_tokens for r in done)
    failed = sum(r.state not in ("DONE", "") and not r.cancelled_by_bench
                 for r in recs)
    ref = refmodel.Ref(cfgfile, params, heads)
    ctl = refmodel.Ref(cfgfile, params, heads, quant="fp8") \
        if control else None
    got, controls = {}, {}
    pick, rows = [], []
    if done:
        longest = max(done, key=lambda r: len(r.o.prompt) + len(r.tokens))
        rest = [r for r in done if r is not longest]
        n = min(mix["check_requests"] - 1, len(rest))
        pick = [longest] + [rest[i] for i in
                            rng.choice(len(rest), n, replace=False)]
    outs = [oracle.served(ref, r.o.prompt, np.asarray(r.tokens), ctl)
            for r in pick]
    _reduce(outs, "token_gap", "control_gap", "token", got, controls)
    # the draft heads: rows live at the first decode step after the close
    by_rid = {r.rid: r for r in recs}
    if snap is not None and "top1" in snap:
        for b, row in enumerate(snap["rows"]):
            r = by_rid.get(row[0]) if row else None
            if r is not None and 1 <= row[1] <= len(r.tokens):
                rows.append((b, r, row[1]))
    if rows:
        rows = [rows[i] for i in rng.choice(
            len(rows), min(mix["check_rows"], len(rows)), replace=False)]
    outs, carry = [], 0
    for b, r, m in rows:
        toks = np.asarray(r.tokens)
        outs.append(oracle.drafts(ref, r.o.prompt, toks, m,
                                  snap["top1"][b], ctl))
        carry += int(snap["cur"][b] != toks[m - 1])
    _reduce(outs, "draft_gap", "control_draft_gap", "draft", got, controls)
    log(f"check: {sum(len(r.tokens) for r in pick)} served tokens of "
        f"{len(pick)} requests, draft heads of {len(rows)} rows; "
        + ", ".join(f"{k} {v:.6g}" for k, v in got.items()))
    if control:
        controls.update({f"program_{k}": v for k, v in got.items()})
    checks = {k: (got.get(k, float("inf")), lim[k]) for k in lim}
    checks.update(carry=(carry, 0), failed=(failed, 0), short=(short, 0))
    return checks, controls
