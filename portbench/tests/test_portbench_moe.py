"""The expert layers' readers (``moe.expert_ms``, ``moe_roofline``,
``moe.load_max_over_mean``) and their byte and operation counts
(``portbench/moe_yardstick.py``) on a made-up traced slice with
hand-worked values; a program without expert records (the phase records
of a step with no tap, or an older tracer) reads nothing."""
import collections
from types import SimpleNamespace

import pytest

from portbench import moe_yardstick as my
from portbench import spec, yardstick
from repro_torch.runtime.trace import SpanRecord

# the fields of the tracer's records the readers read, by name (a program
# whose records lack ``moe`` or ``routes`` reads nothing)
PhaseRecord = collections.namedtuple(
    "PhaseRecord", "t draft verify accept commit moe", defaults=(None,))
RouteRecord = collections.namedtuple("RouteRecord", "t rows hit top")
S = 1_000_000_000
# d 128, f 64, E 8, K 2 (two layers)
CFG = dict(hidden_size=128, moe_intermediate_size=64, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=32, vocab_size=512, num_experts=8, num_experts_per_tok=2)
SPAN = SpanRecord("engine.chunk", 1, round(10.1 * S), round(10.2 * S), 0,
                  0, 0, 8)


def ctx(phases, routes=None, cfg=CFG):
    snap = dict(spans=[SPAN], device=[], phases=phases, anchors=[],
                dropped=0)
    if routes is not None:
        snap["routes"] = routes
    return SimpleNamespace(trace=dict(t0=10.0, t1=11.0), tracer=snap,
                           cfg=cfg)


def read(name, c):
    return spec.reader(name).read(c)


def test_layer_counts_by_hand():
    # 16 rows into 5 of the 8 experts: 2 B x (3 x 128 x 64 x 5 weights +
    # 2 x 16 x 128 rows in and out); 6 x 128 x 64 a row, and the router's
    # 2 x 128 x 8 over 16 / 2 = 8 tokens
    assert my.layer_bytes(CFG, 16, 5) == 2 * (122_880 + 4_096) == 253_952
    assert my.layer_ops(CFG, 16) == 786_432 + 16_384 == 802_816
    # bytes bind: 253952 / 3.35e12 against 802816 / 989e12
    assert my.bound_s(CFG, (16,), (5,)) == pytest.approx(253_952 / 3.35e12)
    # a second layer with all 8 experts hit: 2 x (3 x 128 x 64 x 8 + 4096)
    assert my.bound_s(CFG, (16, 16), (5, 8)) == pytest.approx(
        (253_952 + 401_408) / 3.35e12)


def test_operations_bind_where_few_experts_take_many_rows():
    # one expert, 20000 rows: 2 x (3 x 128 x 64 + 2 x 20000 x 128) B =
    # 10.29 MB (3.07 us) against 6 x 128 x 64 x 20000 + 2 x 128 x 8 x
    # 10000 = 1.004 GFLOP (1.015 us): bytes still bind; at f = 4096 the
    # products bind
    wide = dict(CFG, moe_intermediate_size=4096)
    ops = 6 * 128 * 4096 * 20_000 + 2 * 128 * 8 * 10_000
    assert my.bound_s(wide, (20_000,), (1,)) == pytest.approx(ops / 989e12)


def test_the_cells_step_hits_every_expert_and_streams_58_gb():
    """128 tree tokens x top-8 over 128 experts: in expectation all but
    0.03 of the experts take a row, so every expert's weights stream in
    each of the 48 layers: about 58 GB and 17.4 ms a step."""
    cfg = spec.config_file(spec.load_benchmark(), "qwen3-moe-30b-a3b")
    m = yardstick.dims(cfg)
    E, K, L = m["E"], m["K"], m["L"]
    rows = 128 * K
    assert E - E * (1 - K / E) ** 128 > E - 0.05
    step = L * my.layer_bytes(cfg, rows, E)
    assert step == pytest.approx(58.38e9, rel=1e-3)
    assert my.bound_s(cfg, (rows,) * L, (E,) * L) == pytest.approx(
        step / 3.35e12)
    assert 17.0e-3 < step / 3.35e12 < 17.6e-3


def test_readers_by_hand():
    b1 = my.bound_s(CFG, (16, 16), (5, 8))
    b2 = my.bound_s(CFG, (32, 32), (8, 8))
    phases = [PhaseRecord(round(10.2 * S), 1.0, 5.0, 0.1, 0.5, moe=0.002),
              PhaseRecord(round(10.6 * S), 1.0, 5.0, 0.1, 0.5, moe=0.004),
              PhaseRecord(round(10.7 * S), 1.0, 5.0, 0.1, 0.5, moe=None),
              PhaseRecord(round(9.0 * S), 1.0, 5.0, 0.1, 0.5, moe=99.0)]
    routes = [RouteRecord(round(10.2 * S), (16, 16), (5, 8), (6, 4)),
              RouteRecord(round(10.6 * S), (32, 32), (8, 8), (8, 4)),
              RouteRecord(round(9.0 * S), (1, 1), (1, 1), (1, 1))]
    c = ctx(phases, routes)
    assert read("moe.expert_ms", c) == pytest.approx(0.003)
    assert read("moe_roofline", c) == pytest.approx(
        100 * (b1 + b2) / 6e-6)
    # per layer top / (rows / 8): 3.0, 2.0, 2.0, 1.0
    assert read("moe.load_max_over_mean", c) == pytest.approx(2.0)


def test_the_roofline_reads_100_where_the_device_time_is_the_least():
    b = my.bound_s(CFG, (16, 16), (5, 8))
    t = round(10.5 * S)
    c = ctx([PhaseRecord(t, 1.0, 5.0, 0.1, 0.5, moe=1e3 * b)],
            [RouteRecord(t, (16, 16), (5, 8), (6, 4))])
    assert read("moe_roofline", c) == pytest.approx(100.0, rel=1e-12)


OldPhase = collections.namedtuple("OldPhase", "t draft verify accept commit")


@pytest.mark.parametrize("name", ["moe.expert_ms", "moe_roofline",
                                  "moe.load_max_over_mean"])
def test_nothing_to_read_reads_none(name):
    t = round(10.5 * S)
    dense = [PhaseRecord(t, 1.0, 5.0, 0.1, 0.5)]          # moe None
    assert read(name, ctx(dense, [])) is None
    # an older tracer: phase records without the field, no routes
    assert read(name, ctx([OldPhase(t, 1.0, 5.0, 0.1, 0.5)])) is None
    assert read(name, SimpleNamespace(trace=None, cfg=CFG)) is None
    # routes without any timed phase: the roofline has no time to divide
    if name == "moe_roofline":
        assert read(name, ctx(dense, [RouteRecord(t, (16,), (5,), (6,))])) \
            is None


def test_the_new_metrics_are_the_moe_cells_alone():
    bench = spec.load_benchmark()
    by = {m["name"]: m for m in bench["per_layer"]}
    for name, layer in (("moe.expert_ms", "model step"),
                        ("moe_roofline", "kernels"),
                        ("moe.load_max_over_mean", "model step")):
        m = by[name]
        assert m["workloads"] == ["qwen3-moe-30b-a3b.decode"]
        assert (m["moves"], m["layer"]) == ("tok_s", layer)
