"""Roofline terms per (arch x shape) from the port's dry-run records
(counterpart of ``benchmarks/roofline.py``), on the H100's data-sheet
figures (``core/arca.py``: 989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s
NVLink per direction):

  compute    = FLOPs per device / peak FLOP/s
  memory     = bytes per device / HBM rate
  collective = collective bytes per device / NVLink rate

plus MODEL_FLOPS = 6 N D (train) or 2 N_active tokens (serve) and the
useful-compute ratio MODEL_FLOPS / FLOPs.

``table()`` reads the port's own records, which ``launch/dryrun.py``
writes to ``results/torch/dryrun/`` (per device: ``flops``,
``bytes_accessed`` and ``collectives`` counted on each rank's shards); it
never reads the reference's TPU records.  The port runs every layer, so a
record needs no scan correction.  ``int8_kv_note`` needs no record: it is
a shape computation.
"""
from __future__ import annotations

import glob
import json
import os

import torch

from repro_torch.benchmarks.benchlib import RESULT_DIR
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core.arca import H100_HBM, H100_NVLINK, H100_PEAK_BF16
from repro_torch.runtime.cache import kv_bytes_per_token

DRYRUN_DIR = RESULT_DIR / "dryrun"


def model_flops_per_device(rec) -> float:
    shape = INPUT_SHAPES[rec["shape"]]
    n_act = rec["model_params_active"]
    dev = rec["n_devices"]
    if shape.kind == "train":
        return 6.0 * n_act * shape.seq_len * shape.global_batch / dev
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.seq_len * shape.global_batch / dev
    return 2.0 * n_act * shape.global_batch / dev   # decode: 1 token a row


def load(results_dir=None, mesh="single", mode="hcmp", variant="baseline"):
    rows = []
    for f in sorted(glob.glob(os.path.join(results_dir or DRYRUN_DIR,
                                           "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("mesh") != mesh or rec.get("mode") != mode:
            continue
        if rec.get("variant", "baseline") != variant:
            continue
        rows.append(rec)
    return rows


def analyse(rec) -> dict:
    if rec["status"] != "ok":
        return {"arch": rec["arch"], "shape": rec["shape"],
                "status": rec["status"]}
    flops, hbytes = rec["flops"], rec["bytes_accessed"]
    cbytes = rec["collectives"]["total"]
    t_c = flops / H100_PEAK_BF16
    t_m = hbytes / H100_HBM
    t_x = cbytes / H100_NVLINK
    bound = max([(t_c, "compute"), (t_m, "memory"), (t_x, "collective")])[1]
    mf = model_flops_per_device(rec)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "status": "ok",
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "bound": bound, "step_s": max(t_c, t_m, t_x),
        "model_flops": mf, "useful_ratio": mf / max(flops, 1.0),
        "peak_gb_per_dev": rec["memory"]["peak_bytes"] / 1e9,
    }


def table(mesh="single", mode="hcmp", results_dir=None) -> list:
    return [analyse(r) for r in load(results_dir, mesh, mode)]


def render_markdown(rows) -> str:
    hdr = ("| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
           "bound | useful FLOP ratio | peak GB/dev |\n"
           "|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"{r['status']} | — | — |\n")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']*1e3:.3f} | "
            f"{r['memory_s']*1e3:.3f} | {r['collective_s']*1e3:.3f} | "
            f"**{r['bound']}** | {min(r['useful_ratio'],9.99):.2f} | "
            f"{r['peak_gb_per_dev']:.2f} |\n")
    return "".join(out)


def int8_kv_note(arch="qwen2-0.5b", page_size=16) -> dict:
    """Structural bytes reduction of the decode roofline: a decode step is
    bound by its KV-cache read (paper §II), so int8 pages, which move ~4x
    fewer pool bytes per attended token with the per-page scales counted
    (``runtime/cache.py::page_bytes``), shift the decode memory term by
    the same factor.  Per-token cache traffic: a shape computation."""
    cfg = get_config(arch)
    b32 = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads,
                             cfg.head_dim, torch.float32, page_size)
    b8 = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads,
                            cfg.head_dim, torch.int8, page_size)
    return {"arch": arch, "page_size": page_size,
            "kv_bytes_per_token_fp32": b32, "kv_bytes_per_token_int8": b8,
            "reduction": b32 / b8}


def main():
    rows = table()
    if rows:
        print(render_markdown(rows))
    else:
        print(f"no dry-run records in {DRYRUN_DIR}: write them with "
              f"python -m repro_torch.launch.dryrun --all")
    n = int8_kv_note()
    print(f"\nint8 KV pages ({n['arch']}, ps={n['page_size']}): "
          f"{n['kv_bytes_per_token_fp32']:.0f} -> "
          f"{n['kv_bytes_per_token_int8']:.0f} cache bytes/token "
          f"({n['reduction']:.2f}x less decode KV traffic)")


if __name__ == "__main__":
    main()
