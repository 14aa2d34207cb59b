"""Training launcher (counterpart of ``repro/launch/train.py``: same flags,
the same ``[train]`` lines), on the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b-smoke \\
      --steps 50 --batch 8 --seq 64 [--save ckpt.npz] [--device cpu]

Params are random from ``--seed`` (the port's generator); batches come
from the Markov corpus (``data/pipeline.py``).  An enc-dec (audio) arch
gets zero frame embeds of ``(batch, encoder_seq_len, d_model)`` in the
model's dtype with every batch, as the reference feeds its stubbed
frontend.  ``--save`` writes the
trained params through ``training/checkpoint.py``, which ``serve --ckpt``
restores.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import MarkovDataset
from repro_torch.devices import resolve_device
from repro_torch.models.api import get_model
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train import train_step

WARMUP = 2          # steps left out of the timed window


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-0.5b-smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    return args


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    """Train and print the reference's lines.  Returns the params, the
    optimizer state, every step's loss and ce, and the mean seconds a step
    past the first ``WARMUP`` steps (None for shorter runs; the device is
    synchronized at the window's ends)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = get_model(cfg)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed))
    opt = adamw_init(params)
    data = MarkovDataset(cfg.vocab_size, seed=1)
    metrics = []
    t0 = time.perf_counter()
    tw = None
    for i, batch in enumerate(data.batches(args.batch, args.seq,
                                           args.steps)):
        if i == WARMUP:
            _sync(device)
            tw = time.perf_counter()
        if cfg.frontend == "audio":
            batch["frame_embeds"] = torch.zeros(
                (args.batch, cfg.encoder_seq_len, cfg.d_model),
                dtype=getattr(torch, cfg.dtype), device=device)
        params, opt, m = train_step(cfg, model, params, opt, batch,
                                    lr=args.lr)
        metrics.append(m)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"[train] step {i:4d} loss={float(m['loss']):.4f} "
                  f"ce={float(m['ce']):.4f} "
                  f"({(i + 1) / (time.perf_counter() - t0):.2f} it/s)",
                  flush=True)
    _sync(device)
    step_s = None if tw is None else \
        (time.perf_counter() - tw) / (args.steps - WARMUP)
    if args.save:
        checkpoint.save(args.save, params)
        print(f"[train] saved {args.save}")
    return {"params": params, "opt": opt, "cfg": cfg,
            "losses": [float(m["loss"]) for m in metrics],
            "ces": [float(m["ce"]) for m in metrics], "step_s": step_s}


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
