"""End-to-end driver, the paper's pipeline at laptop scale (counterpart of
``examples/e2e_train_serve.py``: same stages, flags and printout), on the
GPU unless ``--device cpu`` is given:

  1. train a small LM (``qwen2-0.5b`` reduced) on the Markov corpus,
  2. train Medusa drafting heads on the frozen base model,
  3. ARCA: measure REAL per-head top-k accuracies on calibration data,
     build a verification tree per width, pick the width by measured
     throughput,
  4. serve: sequential against Ghidorah speculative decoding; report the
     measured acceptance length and the wall-clock speedup, and fail
     unless the speculative tokens equal the sequential ones.

  PYTHONPATH=src python -m repro_torch.launch.e2e_train_serve [--steps 200]

On a CUDA device both engines serve through the compiled chunk (each
decode step a CUDA-graph replay) and the verify kernel.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.speculative import tree as T
from repro_torch.core.speculative.medusa import head_accuracies, init_medusa
from repro_torch.data.pipeline import MarkovDataset
from repro_torch.devices import resolve_device
from repro_torch.models.api import get_model
from repro_torch.runtime.engine import BatchEngine, SpeculativeEngine
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train import medusa_step, train_step

WIDTHS = (2, 4, 8, 16, 32)


def measure_head_accuracies(cfg, model, params, heads, data, n_batches=4,
                            seq=128):
    """Real per-head top-k accuracy table over sampled calibration
    batches."""
    return head_accuracies(
        cfg, model, params, heads,
        (data.sample(8, seq, seed=100 + s)[:, :-1] for s in range(n_batches)))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.e2e_train_serve")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--head-steps", type=int, default=150)
    ap.add_argument("--tokens", type=int, default=96)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; fails without a GPU) or cpu")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The four stages.  Returns the accuracy table, each width's measured
    acceptance and throughput, the chosen width, the serve's acceptance
    length, both runs' seconds and whether their tokens match; raises
    (AssertionError) on a mismatch, as the reference does."""
    device = resolve_device(args.device)
    cfg = get_config("qwen2-0.5b").reduced()
    model = get_model(cfg)
    data = MarkovDataset(cfg.vocab_size, seed=1)

    # ---- 1. base model training ------------------------------------
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    opt = adamw_init(params)
    print(f"[1/4] training base model ({cfg.param_count() / 1e6:.1f}M "
          f"params, {args.steps} steps)")
    for i, batch in enumerate(data.batches(8, 64, args.steps)):
        params, opt, m = train_step(cfg, model, params, opt, batch, lr=1e-3)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"  step {i:4d} ce={float(m['ce']):.3f}")

    # ---- 2. Medusa heads (base frozen) -------------------------------
    heads = init_medusa(cfg, torch.Generator(device=device).manual_seed(1))
    hopt = adamw_init(heads)
    print(f"[2/4] training {cfg.medusa_heads} Medusa heads "
          f"({args.head_steps} steps, base frozen)")
    for i, batch in enumerate(data.batches(8, 64, args.head_steps,
                                           seed=500)):
        heads, hopt, m = medusa_step(cfg, model, params, heads, hopt, batch)
        if i % 50 == 0 or i == args.head_steps - 1:
            print(f"  step {i:4d} head-loss={float(m['loss']):.3f}")

    # ---- 3. ARCA: real accuracies -> trees -> MEASURED strategy -------
    print("[3/4] ARCA: head accuracies + measured step times (this machine)")
    accs = measure_head_accuracies(cfg, model, params, heads, data)
    print("  top-1 accuracy per head:", np.round(accs[:, 0], 3).tolist())
    cal_prompt = {"tokens": data.sample(1, 32, seed=777)[:, :-1].astype(
        np.int32)}
    best_w, best_thr, chosen = None, 0.0, None
    widths = {}
    for w in WIDTHS:
        spec = T.build_tree(accs, w)
        eng = SpeculativeEngine(model, heads, params, spec, max_len=256)
        eng.generate(cal_prompt, 48)                      # warm-up (capture)
        out, st = eng.generate(cal_prompt, 48)            # measure
        t = float(np.sum(st["step_times"]))               # per-CHUNK times
        thr = len(out) / t
        e_al = T.expected_acceptance_length(spec, accs)
        widths[w] = dict(expected_al=e_al, al=st["acceptance_length"],
                         tok_s=thr)
        print(f"  W={w:3d}: E[AL]={e_al:.2f} "
              f"measured AL={st['acceptance_length']:.2f} "
              f"thr={thr:.1f} tok/s")
        if thr > best_thr:
            best_w, best_thr, chosen = w, thr, spec
        del eng
    print(f"  ARCA chose width={best_w} (measured-throughput mode)")

    # ---- 4. serve: sequential vs Ghidorah ---------------------------
    print(f"[4/4] serving {args.tokens} tokens")
    prompt = {"tokens": data.sample(1, 32, seed=999)[:, :-1].astype(
        np.int32)}
    max_len = 32 + args.tokens + 8

    seq_eng = BatchEngine(model, params, max_len=max_len)
    out_seq, _ = seq_eng.generate(prompt, args.tokens)       # warm + result
    t0 = time.perf_counter()
    out_seq, _ = seq_eng.generate(prompt, args.tokens)
    t_seq = time.perf_counter() - t0

    spec_eng = SpeculativeEngine(model, heads, params, chosen,
                                 max_len=max_len)
    out_spec, stats = spec_eng.generate(prompt, args.tokens)
    t0 = time.perf_counter()
    out_spec, stats = spec_eng.generate(prompt, args.tokens)
    t_spec = time.perf_counter() - t0

    match = np.array_equal(out_spec[:args.tokens], out_seq[0][:args.tokens])
    print(f"  sequential: {args.tokens / t_seq:7.1f} tok/s")
    print(f"  ghidorah:   {args.tokens / t_spec:7.1f} tok/s  "
          f"(REAL acceptance length {stats['acceptance_length']:.2f}, "
          f"{stats['steps']} steps)")
    print(f"  lossless: {match}; wall speedup {t_seq / t_spec:.2f}x "
          f"({device.type} at smoke scale)")
    assert match, "speculative output diverged from sequential!"
    return dict(accs=accs, widths=widths, width=best_w,
                acceptance_length=stats["acceptance_length"],
                steps=stats["steps"], seq_s=t_seq, spec_s=t_spec,
                speedup=t_seq / t_spec, match=match)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
