"""Cells, mixes, configurations and metrics are found by name from files,
and BENCHMARK.json keeps to the benchmark's rules."""
import json
import re
from pathlib import Path

import pytest

from portbench import spec, testing, traffic, weights

BENCH = spec.load_benchmark()
ALL = testing.bench()          # with the deferred cells
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", ALL["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    cfg = spec.config_file(ALL, w["config"])
    mix = spec.traffic(w["traffic"])
    assert cfg["serve"]["bank"] >= 1 and mix["loop"] in ("closed", "open")
    if mix["loop"] == "closed":
        assert mix["clients"] == cfg["serve"]["bank"]
    for trace in (False, True):
        ms = spec.metrics_for(ALL, w["name"], trace)
        assert ms, (w["name"], trace)
        for m in ms:
            assert callable(spec.reader(m["name"]).read)
    e2e = {m["name"] for m in spec.metrics_for(ALL, w["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in spec.metrics_for(ALL, w["name"], True):
        assert m["moves"] in e2e, (m["name"], w["name"])


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
