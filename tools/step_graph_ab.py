"""The captured decode step of a benchmark configuration, on the card: the
node count of its CUDA graph and its replay time a step, and for a model
with experts the same step captured without the expert tap's timing
events (``runtime/trace.py::ExpertTap``), so the events' cost can be read:

    python3 tools/step_graph_ab.py --config qwen3-moe-30b-a3b [--out F]

The configuration's own engine (``portbench/cell.py::build``: published
widths, random weights from a seed, the cell's bank, tree and pool) over a
full bank of random prompts, served by ``generate`` until its step graph
is captured (kept, so its nodes can be counted).  Then each variant's
graph is replayed on the bank it was left with (every row's routing that
of real tokens) in turns: ``--rounds`` windows of 20 replays each, timed
by CUDA events; prints the medians and writes every reading to ``--out``
(JSON); the events' cost is the median of the rounds' paired
differences.  A checkout without the expert tap measures its one
variant.
"""
import argparse
import ctypes
import functools
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SEED = 3100000901


def _nodes(graph) -> int:
    """The nodes of a kept graph (the driver's ``cuGraphGetNodes``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                              ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes returned {rc}")
    return n.value


def _captured(cfgfile, params, heads, prompt_len, tokens):
    """A fresh engine of the cell's shape (``portbench/cell.py::build``) on
    the shared weights, served until its step graph is captured; returns
    (engine, its step graph)."""
    from portbench import spec
    from repro_torch.core.speculative import tree as T
    from repro_torch.models.api import get_model
    from repro_torch.runtime.engine import DecodeEngine, DecodeStrategy
    pcfg, sv = spec.port_config(cfgfile), cfgfile["serve"]
    dev = torch.device("cuda")
    tree = T.build_tree(T.default_accs(pcfg.medusa_heads, pcfg.medusa_top_k),
                        sv["tree_width"])
    eng = DecodeEngine(
        get_model(pcfg), params, heads=heads,
        strategy=DecodeStrategy.medusa(tree, dev),
        max_len=prompt_len + tokens + 2 * tree.max_depth, chunk=sv["chunk"],
        paged=True, page_size=sv["page_size"], hcmp=sv["hcmp"],
        kv_dtype=None, tree_kernel=sv["tree_kernel"])
    toks = np.random.default_rng(1).integers(
        0, cfgfile["vocab_size"], (sv["bank"], prompt_len)).astype(np.int32)
    eng.generate({"tokens": toks}, tokens)
    torch.cuda.synchronize()
    (g,) = eng._graphs._graphs.values()
    return eng, g


def _time(g, n=20) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import spec, weights
    from repro_torch.runtime import trace

    cfgfile = spec.config_file(spec.load_benchmark(ROOT), args.config, ROOT)
    params, heads = weights.make(spec.port_config(cfgfile), SEED,
                                 torch.device("cuda"))
    # graphs.py builds each graph by ``torch.cuda.CUDAGraph()``: keep its
    # cudaGraph_t after the capture, so its nodes can be counted
    torch.cuda.CUDAGraph = functools.partial(torch.cuda.CUDAGraph,
                                             keep_graph=True)
    variants = {"events": _captured(cfgfile, params, heads, args.prompt_len,
                                    40)}
    tap = getattr(trace, "ExpertTap", None)
    if tap is not None and cfgfile.get("num_experts"):
        init = tap.__init__

        def untimed(self, layers, experts, device, timed):
            init(self, layers, experts, device, False)

        tap.__init__ = untimed
        try:
            variants["no events"] = _captured(cfgfile, params, heads,
                                              args.prompt_len, 40)
        finally:
            tap.__init__ = init
    out = {"config": args.config, "card": torch.cuda.get_device_name(),
           "torch": torch.__version__, "bank": cfgfile["serve"]["bank"]}
    for name, (_, g) in variants.items():
        out[name] = dict(nodes=_nodes(g.graph), ms=[])
        _time(g.graph, 5)                                     # warm
    for _ in range(args.rounds):
        for name, (_, g) in variants.items():
            out[name]["ms"].append(_time(g.graph))
    for name in variants:
        ms = out[name]["ms"]
        out[name]["median_ms"] = statistics.median(ms)
        print(f"{args.config} [{name}]: {out[name]['nodes']} graph nodes, "
              f"replay {out[name]['median_ms']:.4f} ms a step (median of "
              f"{len(ms)} windows; {min(ms):.4f}-{max(ms):.4f})", flush=True)
    if len(variants) == 2:
        # paired by round: the card's clocks may shift between rounds
        d = [a - b for a, b in zip(out["events"]["ms"],
                                   out["no events"]["ms"])]
        share = [100 * x / b for x, b in zip(d, out["no events"]["ms"])]
        out["cost_ms"], out["cost_pct"] = d, share
        print(f"the expert events cost {statistics.median(d):+.4f} ms a "
              f"step ({statistics.median(share):+.3f}%; median of the "
              f"rounds' differences, {min(share):+.3f}% to "
              f"{max(share):+.3f}%)", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
