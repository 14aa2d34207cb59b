"""Small sizes of the benchmark's cells for the CPU tests: each cell's
configuration and mix with every width cut down and the model in float32,
run by the same harness on the CPU (``cell.run(..., device="cpu")``).
The cells of ``deferred.json`` run here too."""
from __future__ import annotations

import copy
import time

from portbench import cell, spec

SEED = 2 ** 31 + 12345


def bench() -> dict:
    """BENCHMARK.json with the deferred cells."""
    return spec.with_deferred(spec.load_benchmark())


def tiny_config(bench: dict, cell_name: str) -> dict:
    c = copy.deepcopy(spec.config_file(bench, spec.workload(
        bench, cell_name)["config"]))
    c.update(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=32,
             vocab_size=512, torch_dtype="float32", medusa_top_k=4)
    if "moe_intermediate_size" in c:
        c.update(moe_intermediate_size=64, num_experts=8,
                 num_experts_per_tok=2)
    # bank 4 x width 8 and pieces of 16: every routed call of the port's
    # MoE is at most 32 tokens, which it routes without capacity drops
    c["serve"] = dict(c["serve"], bank=4, page_size=4, prefill_chunk=16)
    # the program runs in float32 here, as the reference: its gaps are 0
    c["limits"] = {k: 1e-3 for k in c["limits"]}
    return c


def tiny_mix(bench: dict, cell_name: str) -> dict:
    mix = copy.deepcopy(spec.traffic(spec.workload(bench, cell_name)
                                     ["traffic"]))
    mix.update(prompt=dict(min=8, max=40, median=24, sigma=0.6),
               output=dict(min=4, max=24, median=10, sigma=0.5),
               requests=400, check_requests=8, check_rows=4,
               trace_slice_s=1, drain_s=20)
    if mix["loop"] == "closed":
        mix["clients"] = 4
    else:
        mix.update(rate_per_s=20.0, requests=60)
    return mix


def run(cell_name: str, seconds: float = 2.0, cfgfile: dict = None,
        mix: dict = None, **kw) -> dict:
    b = bench()
    return cell.run(b, cell_name, SEED, seconds, False, "cpu",
                    time.perf_counter(),
                    cfgfile=cfgfile or tiny_config(b, cell_name),
                    mix=mix or tiny_mix(b, cell_name), **kw)
