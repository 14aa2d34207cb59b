"""Serving launcher: batched Ghidorah speculative serving or batched
sequential serving with the chunked decode loop (one host sync per
``--chunk`` steps), on the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vicuna-7b \\
      --mode ghidorah --width 8 --tokens 64 --batch 4 --chunk 8

It serves one fixed batch of ``--batch`` prompts, prefilled together and
decoded to the token budget (the fixed-batch path of
``repro/launch/serve.py``, same flags, defaults, checks and summary
lines), on the dense per-row KV cache or, with ``--paged``, on the shared
page pool:

  ... --paged [--page-size 16] [--pool-pages 0] [--kv-dtype int8] \
      [--tree-kernel sparse]

``--kv-dtype fp32`` (the default) keeps the pool in the model's dtype, as
in the reference; ``bf16`` and ``int8`` pick the pool's dtype (int8 =
quantized pages).  ``--tree-kernel sparse`` splits the paged verify into
the page walk and the tree partial.  Throughput counts REAL emitted tokens
(``stats["emitted_total"]``), not the EOS padding in the output buffer.
Weights are random, drawn from ``--seed``.  The flags of later slices
(``--tree-kernel auto``, HCMP, arrival replay, measured ARCA, checkpoints)
exit with a "not yet ported" error.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.speculative import tree as T
from repro_torch.core.speculative.medusa import init_medusa
from repro_torch.data.pipeline import MarkovDataset
from repro_torch.devices import resolve_device
from repro_torch.models.api import get_model
from repro_torch.runtime.engine import BatchEngine, SpeculativeEngine

# flag -> (default, ROADMAP item that ports it)
_LATER = {
    "hcmp": ("inline", "A9"),
    "arrivals": ("none", "A8"), "spec_width": (None, "A9"),
    "ckpt": (None, "A12"), "heads_ckpt": (None, "A12"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-0.5b-smoke")
    ap.add_argument("--mode", default="ghidorah",
                    choices=["ghidorah", "sequential"])
    ap.add_argument("--width", type=int, default=0,
                    help="verification width (0 = ARCA's analytic choice, "
                         "not yet ported)")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=8,
                    help="device-resident steps per host sync")
    ap.add_argument("--prompt-len", type=int, default=32)
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
                         "and tree partial merged by the Eq.-1 rule; auto "
                         "is not yet ported")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="total reservable pages in the shared pool (0 = "
                         "dense-equivalent: batch * pages(max_len))")
    # flags of later slices: parsed so that they fail with a clear message
    ap.add_argument("--hcmp", default="inline",
                    choices=["inline", "overlap", "auto"])
    ap.add_argument("--arrivals", default="none", choices=["none", "poisson"])
    ap.add_argument("--spec-width", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--heads-ckpt", default=None)
    args = ap.parse_args(argv)
    for name, (default, item) in _LATER.items():
        if getattr(args, name) != default:
            ap.error(f"--{name.replace('_', '-')} is not yet ported to "
                     f"repro_torch (ROADMAP {item})")
    if args.tree_kernel == "auto":
        ap.error("--tree-kernel auto (ARCA's measured kernel choice) is not "
                 "yet ported to repro_torch (ROADMAP A9)")
    if args.mode == "ghidorah" and args.width == 0:
        ap.error("--width 0 (the ARCA strategy chooser) is not yet ported "
                 "to repro_torch (ROADMAP A9); pass --width N")
    if args.width < 0:
        ap.error("--width must be >= 1")
    if args.tokens < 1:
        ap.error("--tokens must be >= 1")
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    if args.chunk < 1:
        ap.error("--chunk must be >= 1")
    if args.prompt_len < 2:
        ap.error("--prompt-len must be >= 2 (one context token must "
                 "survive the next-token shift)")
    if args.paged and args.page_size < 1:
        ap.error("--page-size must be >= 1")
    if args.pool_pages < 0:
        ap.error("--pool-pages must be >= 0 (0 = dense-equivalent pool)")
    if args.kv_dtype == "int8" and not args.paged:
        ap.error("--kv-dtype int8 quantizes the PAGED pool (per-page "
                 "scales live on the page axis): add --paged")
    if args.tree_kernel != "dense":
        if not args.paged:
            ap.error("--tree-kernel sparse splits the PAGED verify path: "
                     "add --paged")
        if args.mode != "ghidorah":
            ap.error("--tree-kernel sparse is a ghidorah option (sequential "
                     "decoding has no verification tree)")
    return args


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
    reference draws them from ``PRNGKey(seed)`` / ``PRNGKey(seed + 1)``."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = get_model(cfg)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed))
    heads = None
    if with_heads if with_heads is not None else args.mode == "ghidorah":
        heads = init_medusa(
            cfg, torch.Generator(device=device).manual_seed(args.seed + 1))
    return Loaded(cfg=cfg, model=model, params=params, heads=heads,
                  device=device)


def prompts(cfg, args) -> np.ndarray:
    """The reference's fixed-batch prompts: (batch, prompt_len) int32."""
    data = MarkovDataset(cfg.vocab_size, seed=1)
    return data.sample(args.batch, args.prompt_len, seed=7)[:, :-1].astype(
        np.int32)


def build_engine(args, loaded: Loaded):
    cfg = loaded.cfg
    # the reference's quirk: --kv-dtype fp32 means the model's own dtype
    paged_kw = dict(paged=args.paged, page_size=args.page_size,
                    pool_pages=args.pool_pages or None,
                    kv_dtype=None if args.kv_dtype == "fp32"
                    else args.kv_dtype)
    if args.mode == "sequential":
        # prompt + budget slots; the sequential driver writes at most
        # prompt + (tokens - 1) entries before every row is done
        return BatchEngine(loaded.model, loaded.params,
                           max_len=args.prompt_len + args.tokens,
                           chunk=args.chunk, **paged_kw)
    accs = T.default_accs(cfg.medusa_heads, cfg.medusa_top_k)
    spec = T.build_tree(accs, args.width)
    # one speculative step past the budget can commit up to max_depth
    # tokens, so size the ring for the worst-case overshoot
    return SpeculativeEngine(loaded.model, loaded.heads, loaded.params, spec,
                             max_len=args.prompt_len + args.tokens
                             + spec.max_depth, chunk=args.chunk,
                             tree_kernel=args.tree_kernel, **paged_kw)


def run(args, loaded: Optional[Loaded] = None) -> dict:
    """Serve the fixed batch once and print the reference's summary line.
    Returns the tokens, the engine's stats and the wall time."""
    loaded = loaded or load(args)
    eng = build_engine(args, loaded)
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
    return {"out": out, "stats": stats, "seconds": dt,
            "prompts": batch["tokens"]}


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
