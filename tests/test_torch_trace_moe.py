"""The tracer's expert records (``runtime/trace.py::ExpertTap``,
``RouteRecord`` and ``PhaseRecord.moe``).

On the CPU an engine with ``_graphed`` set runs the static-buffer step
without capture, which holds the tap's counts but no timing events:
* with the tracer on, each chunk that replayed a step yields a route
  record whose rows, experts hit and largest expert equal the counts taken
  on the host from the same router output, for the chunk's last step;
  with it off, nothing is recorded;
* a dense model's step holds no tap and records no route;
* ``Tracer.after_transfer`` puts the tap's summed expert time into
  ``PhaseRecord.moe``, and None there without a tap.
On the card (``gpu``): every replayed chunk's phase record carries a
positive ``moe`` inside its verify time, and a dense model's reads None.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.speculative import tree as T
from repro_torch.core.speculative.medusa import init_medusa
from repro_torch.models import mlp
from repro_torch.models.api import get_model
from repro_torch.runtime import trace
from repro_torch.runtime.engine import SpeculativeEngine

MOE, DENSE = "qwen3-moe-30b-a3b-smoke", "qwen2-0.5b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.TRACER.clear()
    yield
    trace.disable()
    trace.TRACER.clear()


@functools.lru_cache(maxsize=None)
def _model(arch, device="cpu"):
    cfg = get_config(arch)
    if device != "cpu":
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = get_model(cfg)
    params = model.init_params(torch.Generator(device).manual_seed(0))
    heads = init_medusa(cfg, torch.Generator(device).manual_seed(1))
    return cfg, model, params, heads


def _engine(arch, device="cpu"):
    cfg, model, params, heads = _model(arch, device)
    spec = T.build_tree(T.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                        8)
    eng = SpeculativeEngine(model, heads, params, spec, max_len=64, chunk=2,
                            paged=True, page_size=4)
    eng._graphed = True          # on the CPU: the static-buffer step
    return cfg, eng


def _generate(eng, cfg, traced, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)
    if traced:
        trace.enable()
    try:
        return eng.generate({"tokens": toks}, 10)
    finally:
        trace.disable()


def test_routes_are_recorded_with_the_tracer_on_and_not_off():
    cfg, eng = _engine(MOE)
    _generate(eng, cfg, traced=False)
    snap = trace.snapshot()
    assert snap["routes"] == [] and snap["phases"] == []
    assert eng._graphs.tap is not None          # the step holds its tap
    trace.TRACER.clear()
    _, stats = _generate(eng, cfg, traced=True)
    snap = trace.snapshot()
    chunks = [s for s in snap["spans"] if s.name == "engine.chunk"]
    # the untraced run warmed the key up: every chunk here replayed
    assert stats["replay_steps"] > 0
    assert len(snap["routes"]) == len(chunks) > 0
    L, B, W, K = cfg.num_layers, 3, 8, cfg.experts_per_token
    for r in snap["routes"]:
        assert r.rows == (B * W * K,) * L
        assert all(1 <= h <= cfg.num_experts for h in r.hit)
        assert all(B * W * K / cfg.num_experts <= t <= B * W for t in r.top)
    assert snap["phases"] == []                 # no timing events here


def test_recorded_rows_equal_host_counts_of_the_same_router(monkeypatch):
    """The route record of a chunk's last step against counts taken on
    the host from the router output of that step's L routed calls."""
    cfg, eng = _engine(MOE)
    real = mlp._route
    seen = []

    def watched(cfg_, p, x):
        out = real(cfg_, p, x)
        seen.append(out[2].detach().clone())
        return out

    monkeypatch.setattr(mlp, "_route", watched)
    _generate(eng, cfg, traced=True, seed=3)
    rec = trace.snapshot()["routes"][-1]
    E, L = cfg.num_experts, cfg.num_layers
    host = [torch.bincount(idx.reshape(-1), minlength=E)
            for idx in seen[-L:]]
    assert rec.rows == tuple(int(c.sum()) for c in host)
    assert rec.hit == tuple(int((c > 0).sum()) for c in host)
    assert rec.top == tuple(int(c.max()) for c in host)
    assert eng._graphs.tap.counts.tolist() == [c.tolist() for c in host]


def test_a_dense_model_holds_no_tap_and_records_no_route():
    cfg, eng = _engine(DENSE)
    _, stats = _generate(eng, cfg, traced=True)
    assert stats["replay_steps"] > 0
    assert eng._graphs.tap is None
    assert trace.snapshot()["routes"] == []


class _Marks:
    def elapsed_ms(self):
        return (1.0, 12.0, 0.5, 2.0)


class _Tap:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_ms(self):
        return self.ms

    def read(self):
        return (16, 16), (3, 4), (8, 6)


@pytest.mark.parametrize("tap,moe", [(None, None), (_Tap(None), None),
                                     (_Tap(7.5), 7.5)],
                         ids=["dense", "untimed", "timed"])
def test_the_phase_record_carries_the_expert_time(tap, moe):
    tr = trace.Tracer()
    tr.after_transfer(_Marks(), tap)
    snap = tr.snapshot()
    (ph,) = snap["phases"]
    assert (ph.draft, ph.verify, ph.accept, ph.commit) == (1.0, 12.0, 0.5,
                                                           2.0)
    assert ph.moe == moe
    if tap is None:
        assert snap["routes"] == []
    else:
        (r,) = snap["routes"]
        assert (r.t, r.rows, r.hit, r.top) == (ph.t, (16, 16), (3, 4),
                                                (8, 6))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("arch", [MOE, DENSE])
def test_captured_step_times_its_expert_blocks_on_card(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the timing events are graph nodes")
    cfg, eng = _engine(arch, "cuda")
    _, stats = _generate(eng, cfg, traced=True)
    torch.cuda.synchronize()
    snap = trace.snapshot()
    assert stats["replay_steps"] > 0 and snap["phases"]
    for ph in snap["phases"]:
        if arch == MOE:
            assert 0 < ph.moe < ph.verify
        else:
            assert ph.moe is None
    assert bool(snap["routes"]) == (arch == MOE)
