"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its model
configuration file, its traffic mix (``portbench/traffic/<name>.json``)
and the readers of its metrics (``portbench/metrics/<metric>.py``).

A later change adds a cell, a mix or a metric by adding files and entries;
nothing here names one.  ``portbench/deferred.json`` holds, in the same
shape, cells that are ready in files but not yet in ``BENCHMARK.json``
(``PERF.md`` says why each waits); the benchmark's runs never read it, the
CPU tests and the sweep do.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the source config's key -> the port's ModelConfig field.  A key of the
# configuration file that is here overrides the port arch's value, so the
# file's numbers are the ones that run.
PORT_FIELDS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "rmsnorm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "num_experts": "num_experts",
    "num_experts_per_tok": "experts_per_token",
    "medusa_heads": "medusa_heads",
    "medusa_top_k": "medusa_top_k",
}
# the feed-forward width: the experts' own width in an MoE model
FFN_KEYS = ("moe_intermediate_size", "intermediate_size")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def with_deferred(bench: dict, root: Path = ROOT) -> dict:
    """``bench`` with the deferred cells of ``portbench/deferred.json``
    added: their configurations, cells and metrics.  ``bench`` wins: an
    entry whose name it already holds keeps its own fields (a bound among
    them), and a metric of that name lists each deferred cell beside its
    own, once.  So a later change moves a ready cell in by adding its
    entries to ``BENCHMARK.json`` alone; dropping them from
    ``deferred.json`` is then an edit of its own."""
    with open(root / "portbench" / "deferred.json") as f:
        more = json.load(f)
    out = copy.deepcopy(bench)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        have = {x["name"]: x for x in out[group]}
        for x in more[group]:
            mine = have.get(x["name"])
            if mine is None:
                out[group].append(copy.deepcopy(x))
            elif "workloads" in mine:
                for w in x.get("workloads", ()):
                    if w not in mine["workloads"]:
                        mine["workloads"].append(w)
    return out


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have: {[w['name'] for w in bench['workloads']]})")


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "portbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if applies(m, cell)]


def reader(name: str, root: Path = ROOT):
    """The module ``portbench/metrics/<name>.py``; its ``read(ctx)`` returns
    the metric's value, or None when the run holds nothing to read."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file: the port arch
    the file names, with every size the file gives put in its place."""
    from repro_torch.configs import get_config
    base = get_config(cfg["port_arch"])
    over = {PORT_FIELDS[k]: v for k, v in cfg.items() if k in PORT_FIELDS}
    for k in FFN_KEYS:
        if k in cfg:
            over["d_ff"] = cfg[k]
            break
    over["qk_norm"] = bool(cfg.get("qk_norm", False))
    over["dtype"] = cfg["torch_dtype"]
    if not cfg.get("num_experts"):
        over["num_experts"], over["experts_per_token"] = 0, 0
    return dataclasses.replace(base, **over)
