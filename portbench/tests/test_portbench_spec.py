"""Cells, mixes, configurations and metrics are found by name from files,
and BENCHMARK.json keeps to the benchmark's rules."""
import copy
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import spec, testing, traffic, weights

BENCH = spec.load_benchmark()
ALL = testing.bench()          # with the deferred cells
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


MOE_CELL = "qwen3-moe-30b-a3b.decode"


def move_in(bench: dict, cell: str) -> dict:
    """``bench`` with a deferred cell moved in by added entries alone: its
    configuration and cell, and the cell in ``tok_s``'s workloads (each
    where ``bench`` lacks it)."""
    with open(Path(spec.HERE, "deferred.json")) as f:
        more = json.load(f)
    out = copy.deepcopy(bench)
    w = spec.workload(more, cell)
    if all(x["name"] != cell for x in out["workloads"]):
        out["workloads"].append(w)
    if all(c["name"] != w["config"] for c in out["configs"]):
        out["configs"] += [c for c in more["configs"]
                           if c["name"] == w["config"]]
    tok = next(m for m in out["end_to_end"] if m["name"] == "tok_s")
    if cell not in tok["workloads"]:
        tok["workloads"].append(cell)
    return out


MOVED = move_in(BENCH, MOE_CELL)


@pytest.fixture(scope="module")
def moved_root(tmp_path_factory):
    """A root whose BENCHMARK.json holds the MoE cell moved in, beside the
    benchmark's files with ``deferred.json`` as it is."""
    root = tmp_path_factory.mktemp("moved")
    shutil.copytree(spec.HERE, root / "portbench", ignore=shutil.
                    ignore_patterns("__pycache__", ".cache"))
    (root / "BENCHMARK.json").write_text(json.dumps(MOVED, indent=2))
    return root


def moved_all(root):
    return spec.with_deferred(spec.load_benchmark(root), root)


def finds_its_files(bench, w, root=spec.ROOT):
    cfg = spec.config_file(bench, w["config"], root)
    mix = spec.traffic(w["traffic"], root)
    assert cfg["serve"]["bank"] >= 1 and mix["loop"] in ("closed", "open")
    if mix["loop"] == "closed":
        assert mix["clients"] == cfg["serve"]["bank"]
    for trace in (False, True):
        ms = spec.metrics_for(bench, w["name"], trace)
        assert ms, (w["name"], trace)
        for m in ms:
            assert callable(spec.reader(m["name"], root).read)
    e2e = {m["name"] for m in spec.metrics_for(bench, w["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in spec.metrics_for(bench, w["name"], True):
        assert m["moves"] in e2e, (m["name"], w["name"])


@pytest.mark.parametrize("w", ALL["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    finds_its_files(ALL, w)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.with_deferred(MOVED)["workloads"]])
def test_each_cell_finds_its_files_once_one_is_moved_in(moved_root, cell):
    b = moved_all(moved_root)
    finds_its_files(b, spec.workload(b, cell), moved_root)


def test_a_moved_in_cell_joins_without_a_duplicate(moved_root):
    assert (moved_root / "portbench" / "deferred.json").read_bytes() == \
        Path(spec.HERE, "deferred.json").read_bytes()
    b = moved_all(moved_root)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in b[k]]
        assert len(names) == len(set(names)), (k, names)
    assert [w["name"] for w in b["workloads"]].count(MOE_CELL) == 1
    for m in b["end_to_end"] + b["per_layer"]:
        ws = m.get("workloads", [])
        assert len(ws) == len(set(ws)), (m["name"], ws)
        assert set(ws) <= {w["name"] for w in b["workloads"]}, m["name"]


def test_the_accepted_entry_wins(moved_root):
    """A metric in both files keeps BENCHMARK.json's fields: ``tok_s``
    keeps its bound, not the deferred entry's, and lists the deferred
    cells beside its own."""
    with open(Path(spec.HERE, "deferred.json")) as f:
        deferred = next(m for m in json.load(f)["end_to_end"]
                        if m["name"] == "tok_s")
    accepted = next(m for m in BENCH["end_to_end"] if m["name"] == "tok_s")
    assert accepted["bound"] != deferred["bound"]
    for b in (ALL, moved_all(moved_root)):
        tok = next(m for m in b["end_to_end"] if m["name"] == "tok_s")
        assert tok["bound"] == accepted["bound"]
        assert "mistral-7b.decode" in tok["workloads"]
        assert MOE_CELL in tok["workloads"]
    assert "qwen3-moe-30b-a3b" in {c["name"] for c in ALL["configs"]}


def test_names_units_and_keys():
    top = {"command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer"}
    assert set(BENCH) == top
    for b in (BENCH, ALL):
        names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in b[k]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in ALL["end_to_end"] + ALL["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    layers = {m["layer"] for m in ALL["per_layer"]}
    assert layers <= {"front end and scheduler", "speculative core",
                      "engine and compiled chunk", "model step", "kernels",
                      "device"}
    for c in ALL["configs"]:
        assert c["file"].startswith("portbench/") and not c["reduced"]
        assert Path(spec.ROOT, c["file"]).exists()
    assert all(w["chips"] == 1 for w in ALL["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_file_under_paths_has_a_name_of_names():
    for p in Path(spec.ROOT, "portbench").rglob("*"):
        if "__pycache__" in p.parts or ".cache" in p.parts:
            continue
        rel = p.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_mix_sizes_are_a_fixed_set_in_seed_order():
    mix = spec.traffic("decode32")
    a = traffic.offered(mix, 1000, 1, n=64)
    b = traffic.offered(mix, 1000, 2 ** 31 + 7, n=64)
    s, o, _ = traffic.sizes(mix)
    full = traffic.offered(mix, 1000, 3)
    blk = mix["block"]
    assert len(full) == mix["requests"] and len(s) == blk
    for i in range(0, len(full), blk):        # every copy: the same sizes
        assert sorted(len(x.prompt) for x in full[i:i + blk]) \
            == sorted(s.tolist())
        assert sorted(x.n_tokens for x in full[i:i + blk]) \
            == sorted(o.tolist())
    assert [len(x.prompt) for x in a] != [len(x.prompt) for x in b]
    again = traffic.offered(mix, 1000, 1, n=64)
    assert all((x.prompt == y.prompt).all() for x, y in zip(a, again))
    for x in a:
        assert mix["prompt"]["min"] <= len(x.prompt) <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= x.n_tokens <= mix["output"]["max"]


def test_open_loop_set_spans_requests_over_rate():
    mix = spec.traffic("chat")
    due = [x.due for x in traffic.offered(mix, 1000, 5)]
    assert due[0] == 0.0 and all(b > a for a, b in zip(due, due[1:]))
    span = mix["requests"] / mix["rate_per_s"]
    assert span * 0.95 < due[-1] <= span


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b-smoke",
                                  "qwen3-moe-30b-a3b-smoke"])
def test_weights_have_the_ports_layout(arch):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.speculative.medusa import init_medusa
    from repro_torch.models.api import get_model
    cfg = get_config(arch)
    gen = torch.Generator().manual_seed(0)
    want = get_model(cfg).init_params(gen)
    want_heads = init_medusa(cfg, gen)
    got, heads = weights.make(cfg, 2 ** 31 + 3, "cpu")

    def flat(t, pre=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from flat(v, pre + (k,))
            else:
                yield pre + (k,), (tuple(v.shape), v.dtype)
    assert dict(flat(got)) == dict(flat(want))
    assert dict(flat(heads)) == dict(flat(want_heads))
    again, _ = weights.make(cfg, 2 ** 31 + 3, "cpu")
    assert torch.equal(got["layers"]["attn"]["wq"],
                       again["layers"]["attn"]["wq"])


@pytest.mark.parametrize("c", ALL["configs"], ids=lambda c: c["name"])
def test_config_files_run_as_the_port_config(c):
    cfg = spec.config_file(ALL, c["name"])
    p = spec.port_config(cfg)
    assert p.d_model == cfg["hidden_size"]
    assert p.num_layers == cfg["num_hidden_layers"]
    assert p.num_heads == cfg["num_attention_heads"]
    assert p.num_kv_heads == cfg["num_key_value_heads"]
    assert p.head_dim == cfg.get("head_dim", 128)
    assert p.vocab_size == cfg["vocab_size"]
    assert p.rope_theta == cfg["rope_theta"]
    assert p.rmsnorm_eps == cfg["rms_norm_eps"]
    assert p.num_experts == cfg.get("num_experts", 0)
    assert p.dtype == "bfloat16" and not p.tie_embeddings
