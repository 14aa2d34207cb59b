"""Shared pieces of the port's evaluation harness (counterpart of
``repro/benchlib.py``): the paper's MBPP acceptance row, the card's
identity, device timers and the measured records' directory.

Timing is on the device the harness runs on and is labelled with it: on a
CUDA device CUDA events (a kernel's time) or the host clock around work
that ends in a synchronize (a step's or a request's time); on the CPU the
host clock.  A CPU time is the CPU's, never a number of the card.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from pathlib import Path

import torch

# Paper Table I, MBPP row (widths 4..64): the measured-AL input of the
# Fig. 9 prediction (the paper's headline speedup is quoted on MBPP).
PAPER_MBPP_AL = [2.54, 2.89, 3.27, 3.55, 3.74]

# the port's measured records: <repo>/results/torch/ (never the
# reference's benchmarks/results/)
RESULT_DIR = Path(__file__).resolve().parents[3] / "results" / "torch"


def card(device) -> dict:
    """The device a record was measured on: for a CUDA device its name and
    the line ``nvidia-smi --query-gpu=name,power.limit`` prints for it (a
    card set below its maximum power runs slower under load)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "name": "cpu"}
    index = device.index if device.index is not None else 0
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        line = smi.stdout.strip() if smi.returncode == 0 else \
            f"nvidia-smi failed: {smi.stderr.strip()[:200]}"
    except (OSError, subprocess.TimeoutExpired) as e:
        line = f"nvidia-smi failed: {e}"
    return {"device": "cuda", "name": torch.cuda.get_device_name(index),
            "nvidia_smi": line}


def label(device) -> str:
    """What a timed number was measured on, for the CSV's derived column."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device.index or 0)


def unwatched(name):
    """The default ``watch``: a context around each measured arm of the
    harness, named (``chip_smoke.py`` passes one that counts each arm's
    kernel launches)."""
    return contextlib.nullcontext()


def sync(device) -> None:
    """Wait for the device's queued work (the CPU runs synchronously)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def best_s(fn, device, reps=3, warm=True) -> float:
    """Best-of-``reps`` seconds of ``fn()`` on the host clock, each run
    ending in a synchronize, after one warm-up run (compile, capture)
    unless the caller ran one (``warm=False``)."""
    if warm:
        fn()
    sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def mean_ms(fn, device, reps=5, warm=1) -> float:
    """Mean milliseconds of one ``fn()`` call over ``reps`` back-to-back
    calls: CUDA events around the loop on a CUDA device, the host clock
    on the CPU."""
    for _ in range(warm):
        fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def write_record(name: str, record: dict, out_dir=None) -> Path:
    """Write one measured record as ``<out_dir>/<name>.json`` (default
    ``RESULT_DIR``)."""
    out = Path(out_dir) if out_dir is not None else RESULT_DIR
    os.makedirs(out, exist_ok=True)
    path = out / f"{name}.json"
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=str)
    return path
