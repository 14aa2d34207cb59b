"""Whole runs of the harness on the CPU at a tiny size (the card check
skipped): a sound program comes out correct, and each fault a serving
cell can have, planted in the program under the benchmark's spans, comes
out not correct.  (One chip: no exchange between chips to leave out.)"""
import dataclasses

import pytest

from portbench import testing


def wrap_step(post):
    def fault(sys_):
        step = sys_.eng.sched_step

        def faulty(state, done, rem, K, eos_val):
            return post(state, step(state, done, rem, K, eos_val))
        sys_.eng.sched_step = faulty
    return fault


def unchanged(state, out):
    """The step hands back the state it was given."""
    return (state,) + tuple(out[1:])


def half_bank(state, out):
    """The second half of the bank's rows left out: the first half's
    results serve in their place."""
    toks, ns = out[3]
    toks = toks.copy()
    h = toks.shape[1] // 2
    toks[:, h:] = toks[:, :toks.shape[1] - h]
    return out[:3] + ((toks, ns),)


def altered_token(state, out):
    """Every token altered where the step produces it."""
    toks, ns = out[3]
    return out[:3] + (((toks + 1) % 512, ns),)


def altered_draft_carry(state, out):
    """The residual that drives the next step's drafts altered."""
    st = out[0]
    return (dataclasses.replace(st, hidden=st.hidden.flip(0)),) + \
        tuple(out[1:])


@pytest.mark.parametrize("cell", ["mistral-7b.decode", "mistral-7b.chat",
                                  "qwen3-moe-30b-a3b.decode"])
def test_sound_runs_are_correct(cell):
    res = testing.run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e = set(res["metrics"])
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("post", [unchanged, half_bank, altered_token,
                                  altered_draft_carry],
                         ids=lambda f: f.__name__)
def test_each_fault_is_not_correct(post):
    res = testing.run("mistral-7b.decode", fault=wrap_step(post))
    assert not res["correct"], res["checks"]


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def lost_expert(layer):
    """Every choice of one expert lost in ``layer``: the down projection
    of expert 0 zeroed in place in the tensors the program holds, while
    the reference judges with a clean copy of the weights."""
    def fault(sys_):
        clean = clone(sys_.params)
        sys_.params["layers"]["moe"]["w_down"][layer, 0].zero_()
        sys_.params = clean
    return fault


# token_mean over its limit at least: the fault read 0.143-0.298 in eight
# runs (first and last layer) against the tiny size's 1e-3; a sound run
# reads 0.0
MARGIN = 20


@pytest.mark.parametrize("layer", [0, -1], ids=["first", "last"])
def test_an_moe_that_loses_an_experts_choices_is_not_correct(layer):
    """A served MoE that loses expert choices (as a capacity that drops
    them would) comes out not correct, whatever the port's dispatch does:
    at the tiny size the port routes without drops, and the fault is
    planted in the weights it serves."""
    res = testing.run("qwen3-moe-30b-a3b.decode", fault=lost_expert(layer))
    assert res["attempted"] > 0 and res["failed"] == 0
    mean = res["checks"]["token_mean"]
    assert mean["value"] > MARGIN * mean["limit"], res["checks"]
    assert not res["correct"]


@pytest.mark.parametrize("cell", ["mistral-7b.decode",
                                  "qwen3-moe-30b-a3b.decode"])
def test_the_control_is_not_correct_at_the_tiny_size(cell):
    res = testing.run(cell, control=True)
    lim = {k: v["limit"] for k, v in res["checks"].items()}
    assert res["correct"], res["checks"]
    assert any(res["controls"][k] > lim[k] for k in lim if k in
               res["controls"]), (res["controls"], lim)
