"""The CUDA-graph capture budget of the serving hot path (the port's
counterpart of ``repro/analysis/tracecount.py``, which counts jit
compiles).

The port's compile cache is ``runtime/graphs.py::ChunkGraphs``: one
captured decode step per key, captured at the key's second chunk, a new
capture when the K/V tensors under the key change (a new prefill or
bank).  A key that stops repeating (a dtype flip, a tensor or a fresh
object in the key, a tree rebuilt per call) shows up as extra captures,
each costing a capture on the card and a graph's memory.  This module runs
a PINNED smoke (fixed reduced model, fixed request set, every arrival at
t=0, no deadline: deterministic) and counts the graphs built per named
captured step, ``ChunkGraphs.stats["captures"]`` split by the graph key's
partition, draft and tree kernel (``inline/ghidorah/dense``,
``overlap/ghidorah/dense``, ``inline/sequential/dense``, ...) and the
captured prefill calls by kind (``piece/admit``, ``piece/extend``), then
diffs the counts against the committed ``capture_budget.json``: a count
above or below its budget fails, with the bucket named.

The smoke is the reference's (``tracecount.py``) on the port:
``qwen2-0.5b`` reduced; a paged scheduler stream with chunked prefill,
abort, eviction and re-admission over pages of 4 in a pool of 5; dense
and paged ``generate``; an int8 stream; an HCMP overlap segment.

``ChunkGraphs`` counts a graph whether or not it really captures, so the
one budget holds on the CPU (the engines' static-buffer step with
``capture=False``: ``_graphed`` set on CPU engines) and on the card (real
captures); a bucket that differs between the two is a finding, not a
second budget.  It runs on the card (``--device cuda``, the default) and
raises when none is visible; ``--device cpu`` runs it on the CPU.

Re-baseline only after an intentional change of capture behaviour (a new
chunk width in the smoke, a new captured step):
``python -m repro_torch.analysis.capturecount --device cpu --write``
(or on the card without ``--device cpu``), and commit the
``capture_budget.json`` diff with the change that explains it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

BUDGET_PATH = Path(__file__).resolve().parent / "capture_budget.json"
_DRAFTS = {"medusa": "ghidorah", "none": "sequential"}


def bucket(strategy, tree_kernel, tree_tokens) -> str:
    """A captured step's name: the graph key's partition, draft and tree
    kernel (``runtime/graphs.py::ChunkGraphs.key``)."""
    partition = "inline" if tree_tokens is None else "overlap"
    return f"{partition}/{_DRAFTS.get(strategy.draft, strategy.draft)}/" \
        f"{tree_kernel}"


@contextlib.contextmanager
def count_captures():
    """Counts every graph ``ChunkGraphs`` builds (its ``stats["captures"]``)
    by bucket, in any engine, while entered; a captured prefill call
    (``PieceGraphs``) counts as ``piece/<kind>`` (``admit``, ``extend``)."""
    from repro_torch.runtime.graphs import ChunkGraphs, PieceGraphs
    counts: Dict[str, int] = {}
    build = ChunkGraphs._build
    build_piece = PieceGraphs._build

    def tally(stats, before, name):
        counts[name] = counts.get(name, 0) + stats["captures"] - before

    def counted(self, step_fn, strategy, state, done, rem, eos_val,
                tree_kernel, tree_tokens):
        before = self.stats["captures"]
        g = build(self, step_fn, strategy, state, done, rem, eos_val,
                  tree_kernel, tree_tokens)
        tally(self.stats, before, bucket(strategy, tree_kernel, tree_tokens))
        return g

    def counted_piece(self, key, fn, row, warm):
        before = self.chunk.stats["captures"]
        g = build_piece(self, key, fn, row, warm)
        tally(self.chunk.stats, before, f"piece/{key[0]}")
        return g

    ChunkGraphs._build, PieceGraphs._build = counted, counted_piece
    try:
        yield counts
    finally:
        ChunkGraphs._build, PieceGraphs._build = build, build_piece


def run_smoke(device: str = "cuda") -> Dict[str, int]:
    """The pinned workload on ``device`` (the card unless the caller asks
    for the CPU); returns the captures per bucket."""
    import numpy as np
    import torch

    from repro_torch.devices import resolve_device

    from repro_torch.configs import get_config
    from repro_torch.core.speculative import tree as T
    from repro_torch.core.speculative.medusa import init_medusa
    from repro_torch.models.api import get_model
    from repro_torch.runtime.continuous import ContinuousScheduler, Request
    from repro_torch.runtime.engine import BatchEngine, SpeculativeEngine

    device = str(resolve_device(device))
    cfg = get_config("qwen2-0.5b").reduced()
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen)
    rng = np.random.default_rng(11)

    def req(rid, prompt_len, n_tokens):
        toks = rng.integers(0, cfg.vocab_size, size=prompt_len)
        return Request(req_id=rid, tokens=np.asarray(toks, np.int32),
                       n_tokens=n_tokens)

    def graphed(eng):
        # the card's path: on the CPU the static-buffer step, uncaptured
        eng._graphed = True
        return eng

    with count_captures() as counts:
        # the paged stepping stream of the model check's default bound
        eng = graphed(BatchEngine(model, params, max_len=64, chunk=2,
                                  paged=True, page_size=4, pool_pages=5))
        sched = ContinuousScheduler(eng, batch=2, chunk=2, prefill_chunk=2)
        sched.start([], eos=None)
        sched.submit(req(1, 3, 2))
        sched.submit(req(3, 2, 2))
        sched.boundary()
        sched.boundary()
        sched.submit(req(2, 5, 3))          # chunked prefill (5 > 2)
        sched.submit(req(4, 3, 2))
        sched.abort(4)
        for _ in range(6):
            sched.boundary()
        sched.finish()
        # dense and paged generate: 6 tokens in chunks of 2, 2 and 1 (the
        # key's warm-up, its capture, a replay)
        dense = graphed(BatchEngine(model, params, max_len=32, chunk=2))
        prompts = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, size=(2, 4)).astype(np.int32),
            device=device)}
        dense.generate(prompts, 6)
        eng.generate(prompts, 6)
        # the int8 pool: the same slot protocol over quantized pages
        eng8 = graphed(BatchEngine(model, params, max_len=64, chunk=2,
                                   paged=True, page_size=4, pool_pages=5,
                                   kv_dtype="int8"))
        sched8 = ContinuousScheduler(eng8, batch=2, chunk=2)
        sched8.start([], eos=None)
        sched8.submit(req(5, 3, 2))
        sched8.submit(req(6, 2, 2))
        for _ in range(4):
            sched8.boundary()
        sched8.finish()
        eng8.generate(prompts, 6)
        # the speculative step: dense, then over the int8 pool with the
        # split tree kernel, then the HCMP overlap step (its own key
        # partition)
        heads = init_medusa(cfg, torch.Generator(device=device)
                            .manual_seed(1))
        spec = T.build_tree(T.default_accs(cfg.medusa_heads,
                                           cfg.medusa_top_k), 4)
        for kw in (dict(max_len=32),
                   dict(max_len=64, paged=True, page_size=4,
                        kv_dtype="int8", tree_kernel="sparse"),
                   dict(max_len=32, hcmp="overlap")):
            graphed(SpeculativeEngine(model, heads, params, spec, chunk=2,
                                      **kw)).generate(prompts, 6)
    return dict(sorted(counts.items()))


def diff_counts(observed: Dict[str, int],
                budget: Dict[str, int]) -> Dict[str, str]:
    """Per-bucket drift; empty means the audit passes."""
    out: Dict[str, str] = {}
    for name in sorted(set(observed) | set(budget)):
        got, want = observed.get(name, 0), budget.get(name, 0)
        if got == want:
            continue
        if got > want:
            out[name] = (f"{name}: {got} captures, budget {want} "
                         f"(+{got - want} EXTRA CAPTURE)")
        else:
            out[name] = (f"{name}: {got} captures, budget {want} "
                         f"({want - got} fewer — re-baseline if the "
                         f"workload changed)")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.capturecount",
        description="Run the pinned engine + scheduler smoke, count the "
                    "CUDA graphs built per captured step and diff them "
                    "against capture_budget.json.")
    ap.add_argument("--budget", type=Path, default=BUDGET_PATH,
                    help="budget file (default: the committed one)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="cpu: the uncaptured static-buffer step; cuda: "
                         "real captures on the card")
    ap.add_argument("--write", action="store_true",
                    help="re-baseline: write the observed counts")
    args = ap.parse_args(argv)
    observed = run_smoke(args.device)
    width = max(len(n) for n in observed) if observed else 0
    for name, n in observed.items():
        print(f"capturecount: {name:<{width}} {n}")
    if args.write:
        args.budget.write_text(json.dumps(observed, indent=2,
                                          sort_keys=True) + "\n")
        print(f"capturecount: wrote {args.budget}")
        return 0
    if not args.budget.exists():
        print(f"capturecount: FAIL — no budget at {args.budget} (run with "
              f"--write to create it)")
        return 1
    drift = diff_counts(observed, json.loads(args.budget.read_text()))
    if drift:
        for msg in drift.values():
            print(f"capturecount: DRIFT {msg}")
        return 1
    print(f"capturecount: OK — every capture is budgeted ({args.device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
