"""The Medusa-head loss at several learning rates on the frozen main-path
model, to choose ``chip_smoke.HEADS_FULL``'s lr: ``vicuna-7b`` at full
width with random bf16 weights from seed 0 (the serve's ``load``), its
random heads from seed 1, ``HEADS_FULL``'s batch, sequence and data seed,
``--steps`` ``medusa_step``s per lr, each from the same heads.

    python3 tools/medusa_lr_sweep.py [--lrs 1e-3 3e-4 1e-4 3e-5 1e-5] \\
        [--steps 20]

Prints the card, one line per lr with every step's loss and the means of
the first and last five, and a JSON line of them last.  It needs a CUDA
card and exits non-zero without one.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", type=float, nargs="+",
                    default=[1e-3, 3e-4, 1e-4, 3e-5, 1e-5])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.data.pipeline import MarkovDataset
    from repro_torch.launch import serve
    from repro_torch.training import train
    from repro_torch.training.optimizer import adamw_init
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs.phase_device(torch)
    loaded = serve.load(serve.parse_args(cs.argv("ghidorah")),
                        with_heads=True)
    c = cs.HEADS_FULL
    batches = list(MarkovDataset(loaded.cfg.vocab_size, seed=1).batches(
        c["batch"], c["seq"], args.steps, seed=c["data_seed"]))
    out = {}
    for lr in args.lrs:
        heads, opt, losses = loaded.heads, adamw_init(loaded.heads), []
        for b in batches:
            heads, opt, m = train.medusa_step(loaded.cfg, loaded.model,
                                              loaded.params, heads, opt, b,
                                              lr=lr)
            losses.append(float(m["loss"]))
        del heads, opt
        torch.cuda.empty_cache()
        out[lr] = dict(losses=losses, first5=float(np.mean(losses[:5])),
                       last5=float(np.mean(losses[-5:])))
        print(f"lr {lr:g}: mean of the first 5 {out[lr]['first5']:.4f}, "
              f"of the last 5 {out[lr]['last5']:.4f}; "
              f"{[round(x, 3) for x in losses]}", flush=True)
    print(json.dumps({str(k): v for k, v in out.items()}), flush=True)


if __name__ == "__main__":
    main()
