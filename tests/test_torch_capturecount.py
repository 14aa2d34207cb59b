"""The CUDA-graph capture budget (``repro_torch/analysis/capturecount.py``)
on the CPU, where the engines run the card's static-buffer step without
capturing (``ChunkGraphs(..., capture=False)``) and count each graph they
build as the card does: the pinned smoke meets the committed
``capture_budget.json`` bucket by bucket (the captured prefill calls
included), every bucket of the smoke is non-empty, and a forced extra
capture shows as ``+1`` in its bucket and fails the CLI.
"""
import json

import pytest
import torch

from repro_torch.analysis import capturecount as cc
from repro_torch.runtime import graphs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_cpu_smoke_meets_the_budget(capsys):
    budget = json.loads(cc.BUDGET_PATH.read_text())
    observed = cc.run_smoke("cpu")
    assert cc.diff_counts(observed, budget) == {}
    assert set(budget) == {"inline/sequential/dense",
                           "inline/ghidorah/dense",
                           "inline/ghidorah/sparse",
                           "overlap/ghidorah/dense",
                           "piece/admit", "piece/extend"}
    assert all(n >= 1 for n in observed.values())
    assert cc.main(["--device", "cpu"]) == 0
    assert "OK" in capsys.readouterr().out


def test_a_forced_extra_capture_is_reported_in_its_bucket(monkeypatch,
                                                          tmp_path, capsys):
    real = graphs.StepGraph.holds
    forced = []

    def holds(self, state):
        # the overlap step's graph "loses" its K/V once: one more capture
        if self.tree_tokens is not None and not forced:
            forced.append(True)
            return False
        return real(self, state)

    monkeypatch.setattr(graphs.StepGraph, "holds", holds)
    budget = json.loads(cc.BUDGET_PATH.read_text())
    drift = cc.diff_counts(cc.run_smoke("cpu"), budget)
    assert list(drift) == ["overlap/ghidorah/dense"]
    assert "(+1 EXTRA CAPTURE)" in drift["overlap/ghidorah/dense"]
    forced.clear()
    assert cc.main(["--device", "cpu"]) == 1
    assert "DRIFT overlap/ghidorah/dense" in capsys.readouterr().out
    # a re-baseline writes what it saw; a budget one below it fails too
    path = tmp_path / "budget.json"
    forced.append(True)                      # no forced capture this time
    assert cc.main(["--budget", str(path), "--device", "cpu",
                    "--write"]) == 0
    written = json.loads(path.read_text())
    assert written == budget
    written["inline/sequential/dense"] += 1
    assert "fewer" in cc.diff_counts(
        cc.run_smoke("cpu"), written)["inline/sequential/dense"]
