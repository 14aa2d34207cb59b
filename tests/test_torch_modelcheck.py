"""The port's boundary-protocol model check (``repro_torch/analysis/
modelcheck.py``) against the reference's (``repro/analysis/modelcheck.py``)
and against both schedulers.

* Seeded protocol bugs (a page leak in the abort sweep, a ``fail_all``
  that keeps the queue, admissions before the abort sweep) are each caught
  with a counterexample trace.
* The default bound is the reference's, and the two explore the same
  number of canonical states and transitions, complete and clean, inside
  the wall-clock cap; an exhausted cap fails loudly.
* The same action traces replayed on the model, on the port's
  ``ContinuousScheduler`` over its paged ``BatchEngine`` (CPU) and on the
  reference's scheduler and engine give identical flushes, pool occupancy
  after every action, and terminal states and counts.
"""
import jax
import numpy as np
import pytest
import torch

from repro.analysis import modelcheck as rmc
from repro.configs import get_config as j_get_config
from repro.models.api import get_model as j_get_model
from repro.runtime.engine import BatchEngine as JBatch
from repro.runtime.scheduler import ContinuousScheduler as JSched
from repro.runtime.scheduler import Request as JRequest
from repro_torch.analysis import modelcheck as mc
from repro_torch.configs import get_config
from repro_torch.models.api import get_model
from repro_torch.runtime.continuous import ContinuousScheduler, Request
from repro_torch.runtime.engine import BatchEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    test workers share the machine's cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _LeakyAbortModel(mc.SchedModel):
    """The abort sweep frees a row without returning its pages."""

    def _release(self, slot, kind):
        if kind == "abort_release":
            slot["pages"] = 0
            self.boundary_events.append(kind)
            return
        super()._release(slot, kind)


class _UndrainedFailModel(mc.SchedModel):
    """``fail_all`` keeps the queue: a boundary after it can admit."""

    def fail_all(self):
        self.failed = True
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            kept = min(s["out"], self.reqs[s["id"]].n_tokens)
            self._finalize(s["id"], kept, mc.FAILED)
            self._release(s, "fail_release")
            self.slots[b] = None
        self.aborts = {}


class _AdmitFirstModel(mc.SchedModel):
    """Admissions run before the abort sweep."""

    def boundary(self):
        ev_admit = []
        c = self.cfg
        for b in range(c.batch):
            if self.slots[b] is not None or not self.pending:
                continue
            req = self.reqs[self.pending[0]]
            need = self._need_pages(req)
            if self.started and self.free < need:
                break
            self.pending.pop(0)
            self.free -= need
            self.started = True
            self.slots[b] = {"id": req.req_id, "out": 1,
                             "rem": max(req.n_tokens - 1, 0),
                             "done": False, "left": None, "pages": need}
            self.state_of[req.req_id] = mc.DECODING
            ev_admit.append("admit")
        flushed = super().boundary()
        self.boundary_events = ev_admit + self.boundary_events
        self._check_boundary_order()
        return flushed


def _explore_with(model_cls, monkeypatch):
    monkeypatch.setattr(mc, "SchedModel", model_cls)
    return mc.explore(mc.DEFAULT_REQUESTS, mc.DEFAULT_CONFIG,
                      max_seconds=60.0)


@pytest.mark.parametrize("model_cls,invariant,action", [
    (_LeakyAbortModel, "I1", "abort("),
    (_UndrainedFailModel, "I4", "crash"),
    (_AdmitFirstModel, "I3", "boundary"),
])
def test_seeded_protocol_bug_is_caught_with_a_trace(model_cls, invariant,
                                                    action, monkeypatch):
    res = _explore_with(model_cls, monkeypatch)
    hits = [(p, m) for p, m in res.violations if m.startswith(invariant)]
    assert hits, res.violations[:3]
    trace = mc.render_trace(hits[0][0])
    assert action in trace and "boundary" in trace


def test_default_bound_equals_the_references():
    assert mc.DEFAULT_CONFIG.__dict__ == rmc.DEFAULT_CONFIG.__dict__
    assert [r.__dict__ for r in mc.DEFAULT_REQUESTS] == \
        [r.__dict__ for r in rmc.DEFAULT_REQUESTS]
    mine = mc.explore(mc.DEFAULT_REQUESTS, mc.DEFAULT_CONFIG,
                      max_seconds=60.0)
    ref = rmc.explore(rmc.DEFAULT_REQUESTS, rmc.DEFAULT_CONFIG,
                      max_seconds=60.0)
    assert mine.complete and not mine.violations
    assert (mine.states, mine.transitions) == (ref.states, ref.transitions)
    assert mine.states > 100 and mine.transitions > mine.states


def test_cli_and_a_loud_incomplete_run(capsys):
    assert mc.main(["--max-seconds", "60"]) == 0
    out = capsys.readouterr().out
    assert "OK" in out and "states" in out
    assert mc.main(["--max-seconds", "0"]) == 1
    assert "NOT verified" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the model against both schedulers
# ---------------------------------------------------------------------------
TRACES = {
    "plain": [("submit", 1), ("submit", 3), ("boundary",), ("boundary",),
              ("submit", 2), ("boundary",), ("boundary",), ("boundary",),
              ("boundary",), ("boundary",)],
    "abort-resident": [("submit", 1), ("submit", 2), ("boundary",),
                       ("abort", 1), ("boundary",), ("submit", 3),
                       ("boundary",), ("boundary",), ("boundary",),
                       ("boundary",)],
    "abort-queued-and-prefilling": [("submit", 2), ("submit", 3),
                                    ("abort", 3), ("boundary",),
                                    ("abort", 2), ("boundary",),
                                    ("boundary",)],
    "crash-mid-flight": [("submit", 3), ("submit", 1), ("submit", 2),
                         ("boundary",), ("boundary",), ("crash",),
                         ("boundary",)],
    "crash-before-start": [("submit", 1), ("crash",), ("boundary",)],
}
_PAIRS = {}


def _pairs():
    """The port's and the reference's paged sequential engines at the
    default bound (pages of 4, a pool of 5)."""
    if not _PAIRS:
        c = mc.DEFAULT_CONFIG
        cfg = get_config("qwen2-0.5b").reduced()
        model = get_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0))
        _PAIRS["port"] = (cfg, BatchEngine(
            model, params, max_len=c.max_len, chunk=c.chunk, paged=True,
            page_size=c.page_size, pool_pages=c.n_pages), ContinuousScheduler,
            Request)
        jcfg = j_get_config("qwen2-0.5b").reduced()
        jm = j_get_model(jcfg)
        _PAIRS["reference"] = (jcfg, JBatch(
            jm, jm.init_params(jax.random.PRNGKey(0)), max_len=c.max_len,
            chunk=c.chunk, paged=True, page_size=c.page_size,
            pool_pages=c.n_pages), JSched, JRequest)
    return _PAIRS


def _replay(side, trace):
    """(flushes per boundary, free pages after each action, terminal
    results) of ``trace`` on one scheduler."""
    cfg, eng, Sched, Req = _pairs()[side]
    c = mc.DEFAULT_CONFIG
    assert c.overshoot == eng._overshoot
    rng = np.random.default_rng(11)
    reqs = {r.req_id: Req(req_id=r.req_id, tokens=np.asarray(
        rng.integers(0, cfg.vocab_size, size=r.prompt_len), np.int32),
        n_tokens=r.n_tokens) for r in mc.DEFAULT_REQUESTS}
    sched = Sched(eng, batch=c.batch, chunk=c.chunk,
                  prefill_chunk=c.prefill_chunk)
    sched.start([], eos=None)
    flushes, free = [], []
    for act in trace:
        if act[0] == "submit":
            sched.submit(reqs[act[1]])
        elif act[0] == "abort":
            sched.abort(act[1])
        elif act[0] == "crash":
            sched.fail_all()
        else:
            rep = sched.boundary()
            flushes.append({rid: len(t) for rid, t in rep.emitted.items()
                            if len(t)})
        free.append(eng._alloc.available if eng._alloc is not None
                    else c.n_pages)
        assert eng._alloc is None or eng.sched_pool_conserved()
    results = {rid: (r.state, r.n_emitted)
               for rid, r in sched._results.items()}
    drained = eng._alloc is None or eng.sched_drained()
    return flushes, free, results, drained


def _replay_model(trace):
    model = mc.SchedModel(mc.DEFAULT_CONFIG, mc.DEFAULT_REQUESTS)
    flushes, free = [], []
    for act in trace:
        if act[0] == "submit":
            model.submit(act[1])
        elif act[0] == "abort":
            model.abort(act[1])
        elif act[0] == "crash":
            model.fail_all()
        else:
            flushes.append(model.boundary())
        free.append(model.free)
    return flushes, free, model.results, model.all_terminal()


@pytest.mark.parametrize("trace_name", sorted(TRACES))
def test_model_and_both_schedulers_agree(trace_name):
    trace = TRACES[trace_name]
    flushes, free, results, terminal = _replay_model(trace)
    for side in ("port", "reference"):
        got = _replay(side, trace)
        assert got[0] == flushes, (side, "flushes")
        assert got[1] == free, (side, "pool occupancy")
        assert got[2] == results, (side, "terminal states")
        if terminal:
            assert got[3], (side, "pool drained")
