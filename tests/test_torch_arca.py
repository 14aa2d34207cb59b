"""The port's ARCA (``repro_torch/core/arca.py``) against the reference's
(``repro/core/arca.py``): every analytic function of the Jetson SoC model
and ``choose_strategy``'s table equal the JAX package's to a relative
1e-12 on three configurations, with the same trees and the same argmax;
the measured-time-source cases of ``tests/test_strategy.py`` run on the
port's engine; ``roofline_time`` takes the H100's data-sheet figures."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import arca as JA
from repro.core.speculative import tree as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import arca as TA
from repro_torch.core.speculative import tree as TT
from repro_torch.runtime.engine import SpeculativeEngine as TSpec
from test_torch_engine import ARCHS, _setup

CONFIGS = ["vicuna-7b", "qwen2-0.5b", "qwen3-32b"]
REL = 1e-12
WIDTH, CTX = 16, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(arch):
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    jaccs = JT.default_accs(jcfg.medusa_heads, jcfg.medusa_top_k)
    taccs = TT.default_accs(tcfg.medusa_heads, tcfg.medusa_top_k)
    np.testing.assert_array_equal(jaccs, taccs)
    return jcfg, tcfg, JT.build_tree(jaccs, WIDTH), TT.build_tree(taccs, WIDTH)


def _close(got, want):
    assert got == pytest.approx(want, rel=REL, abs=0), (got, want)


# each analytic function of the SoC model: name -> call(arca, cfg, spec)
ANALYTIC = {
    "decode_workload": lambda A, c, sp: A.decode_workload(c, WIDTH, CTX),
    "decode_workload(spec)": lambda A, c, sp: A.decode_workload(
        c, WIDTH, CTX, sp),
    "_mem_time": lambda A, c, sp: (
        A._mem_time(A.JETSON_NX, 1e9, True),
        A._mem_time(A.JETSON_NX, 1e9, False),
        A._mem_time(A.JETSON_NX, 1e9, False, A.JETSON_NX.cpu)),
    "step_time_sequential": lambda A, c, sp: A.step_time_sequential(
        A.JETSON_NX, c, CTX),
    "step_time_medusa_gpu": lambda A, c, sp: A.step_time_medusa_gpu(
        A.JETSON_NX, c, WIDTH, CTX, sp),
    "_split_compute": lambda A, c, sp: A._split_compute(
        A.JETSON_NX, A.decode_workload(c, WIDTH, CTX).linear_flops, 0.7),
    "optimal_ratio": lambda A, c, sp: A.optimal_ratio(A.JETSON_NX),
    "step_time_megatron": lambda A, c, sp: (
        A.step_time_megatron(A.JETSON_NX, c, WIDTH, CTX, sp),
        A.step_time_megatron(A.JETSON_NX, c, WIDTH, CTX, sp, ratio=0.6)),
    "step_time_ghidorah": lambda A, c, sp: (
        A.step_time_ghidorah(A.JETSON_NX, c, WIDTH, CTX, sp),
        A.step_time_ghidorah(A.JETSON_NX, c, WIDTH, CTX, sp, ratio=0.6)),
    "contention_aware_ratio": lambda A, c, sp: A.contention_aware_ratio(
        A.JETSON_NX, c, WIDTH, CTX),
}


def _flat(x):
    if isinstance(x, tuple):
        return [v for item in x for v in _flat(item)]
    if hasattr(x, "__dataclass_fields__"):
        return [getattr(x, f) for f in x.__dataclass_fields__]
    return [x]


@pytest.mark.parametrize("fn", list(ANALYTIC))
@pytest.mark.parametrize("arch", CONFIGS)
def test_analytic_soc_model_equals_jax(arch, fn):
    jcfg, tcfg, jspec, tspec = _both(arch)
    got = _flat(ANALYTIC[fn](TA, tcfg, tspec))
    want = _flat(ANALYTIC[fn](JA, jcfg, jspec))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _close(g, w)


def test_jetson_constants_and_widths_equal_jax():
    assert TA.WIDTHS == JA.WIDTHS
    assert dataclasses.asdict(TA.JETSON_NX) == \
        dataclasses.asdict(JA.JETSON_NX)


@pytest.mark.parametrize("arch,ctx", [(a, 256) for a in CONFIGS]
                         + [("vicuna-7b", 64)])
def test_choose_strategy_table_equals_jax(arch, ctx):
    """Same widths, trees (parents, depths, ranks), acceptance, ratio,
    step time and throughput, stamps, and the same argmax."""
    jcfg, tcfg, _, _ = _both(arch)
    accs = JT.default_accs(jcfg.medusa_heads, jcfg.medusa_top_k)
    want = JA.choose_strategy(jcfg, accs, ctx=ctx)
    got = TA.choose_strategy(tcfg, accs, ctx=ctx)
    assert list(got) == list(want) == list(TA.WIDTHS)
    for w in got:
        g, j = got[w], want[w]
        for f in ("depth", "parent", "rank", "mask", "paths"):
            np.testing.assert_array_equal(getattr(g.tree, f),
                                          getattr(j.tree, f))
        for f in ("acceptance", "ratio", "step_time", "throughput"):
            _close(getattr(g, f), getattr(j, f))
        assert (g.width, g.hcmp, g.tree_kernel) == (j.width, j.hcmp,
                                                    j.tree_kernel)
    assert TA.best(got).width == JA.best(want).width
    if arch == "vicuna-7b":
        assert 4 <= TA.best(got).width < 64      # tests/test_arca.py's pin


def test_choose_strategy_measured_time_fn():
    """tests/test_strategy.py's measured-time-fn case on the port."""
    cfg = t_get_config("qwen2-0.5b").reduced()
    accs = TT.default_accs(cfg.medusa_heads, cfg.medusa_top_k)
    widths = (1, 2, 4, 8)
    flat = TA.choose_strategy(cfg, accs, ctx=32, widths=widths,
                              time_fn=lambda c, w, ctx, s: 1e-3)
    assert flat[1].tree.width == 1 and flat[1].tree.max_depth == 1
    assert flat[1].acceptance == pytest.approx(1.0)
    assert TA.best(flat).width == widths[-1]
    steep = TA.choose_strategy(cfg, accs, ctx=32, widths=widths,
                               time_fn=lambda c, w, ctx, s: 1e-3 * w)
    assert TA.best(steep).width < widths[-1]
    for w in widths:
        assert steep[w].step_time == pytest.approx(1e-3 * w)
        assert steep[w].throughput == pytest.approx(
            steep[w].acceptance / (1e-3 * w))


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_profile_engine_measures_deployed_steps(graphed):
    """tests/test_strategy.py's profile_engine case on the port: one
    ``time_step`` per width up front, none when the search rebuilds the
    same trees, finite positive times, an argmax among the widths."""
    cfg, _, _, _, tm, tp, th, _, _, _ = _setup(ARCHS[0])
    accs = TT.default_accs(cfg.medusa_heads, cfg.medusa_top_k)
    eng = TSpec(tm, th, tp, TT.build_tree(accs, 4), max_len=96, chunk=4)
    eng._graphed = graphed
    calls = {"n": 0}
    real = eng.time_step

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    eng.time_step = counting
    widths = (1, 2, 4)
    time_fn = TA.profile_engine(eng, widths, accs=accs, reps=1)
    assert calls["n"] == len(widths)
    strats = TA.choose_strategy(cfg, accs, ctx=16, time_fn=time_fn,
                                widths=widths)
    assert calls["n"] == len(widths)
    for w in widths:
        assert np.isfinite(strats[w].step_time) and strats[w].step_time > 0
        assert strats[w].hcmp == "inline" and strats[w].tree_kernel == "dense"
    assert TA.best(strats).width in widths
    assert time_fn.batch == 1 and time_fn.hcmp_modes == ("inline",)
    if graphed:
        assert eng.graph_stats["graphs"] == 0    # released once timed


def test_roofline_time_h100_defaults():
    r = TA.roofline_time(1e12, 1e9, 1e8)
    assert r["bound"] == "compute"
    assert r["step_s"] == pytest.approx(1e12 / 989e12)
    r2 = TA.roofline_time(1e9, 1e12, 1e8)
    assert r2["bound"] == "memory"
    assert r2["step_s"] == pytest.approx(1e12 / 3.35e12)
    r3 = TA.roofline_time(1e9, 1e9, 1e12)
    assert r3["bound"] == "collective"
    assert r3["step_s"] == pytest.approx(1e12 / 450e9)
    # the same arithmetic as the reference under the reference's figures
    kw = dict(peak=197e12, hbm=819e9, ici=50e9)
    assert TA.roofline_time(3e12, 2e9, 5e8, **kw) == \
        JA.roofline_time(3e12, 2e9, 5e8)
