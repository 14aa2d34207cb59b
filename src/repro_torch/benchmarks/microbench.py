"""Microbenchmarks: one sequential decode step and one W=16 speculative
step (counterpart of ``benchmarks/microbench.py``), timed through
``DecodeEngine.time_step``: the deployed chunk (on a CUDA device the
replay of the captured step) and, beside it on a CUDA device, the same
chunk op by op inside ``eager()``.  Best of ``reps`` chunks of
``chunk`` steps, synchronized, per step.  On the CPU the deployed chunk is
the eager one.
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks import benchlib
from repro_torch.benchmarks.engine_bench import load
from repro_torch.configs import get_config
from repro_torch.core.speculative import tree as T
from repro_torch.launch.serve import Loaded
from repro_torch.runtime.engine import (BatchEngine, SpeculativeEngine,
                                        eager)

PROMPT_LEN = 16
MAX_LEN = 128


def run(loaded: Loaded = None, *, arch="qwen2-0.5b-smoke", device="cuda",
        reps=10, chunk=8, watch=benchlib.unwatched) -> list:
    if loaded is None:
        loaded = load(get_config(arch), device)
    device = loaded.device
    on_card = device.type == "cuda"
    where = benchlib.label(device)
    name = loaded.cfg.name
    spec = T.build_tree(T.default_accs(4, 4), 16)
    engines = {
        "decode_step": (BatchEngine(loaded.model, loaded.params,
                                    max_len=MAX_LEN, chunk=chunk),
                        "1 token"),
        "spec_step_w16": (SpeculativeEngine(loaded.model, loaded.heads,
                                            loaded.params, spec,
                                            max_len=MAX_LEN, chunk=chunk),
                          "verify 16 nodes"),
    }
    rows = []
    with watch("micro"), torch.no_grad():
        for key, (eng, what) in engines.items():
            us = eng.time_step(batch=1, prompt_len=PROMPT_LEN,
                               reps=reps) * 1e6
            path = "graph replay" if on_card else "eager"
            rows.append((f"{key}_{name}", us, f"{what}, {path}, {where}"))
            if on_card:
                with eager():
                    us = eng.time_step(batch=1, prompt_len=PROMPT_LEN,
                                       reps=reps) * 1e6
                rows.append((f"{key}_eager_{name}", us,
                             f"{what}, eager, {where}"))
    del engines
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return rows
