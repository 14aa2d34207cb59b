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


@pytest.mark.parametrize("where", ["verify", "prefill"])
def test_the_ports_moe_capacity_drops_are_not_correct(where):
    """The port's MoE keeps at most about 1.25 x its share of a routed
    group's choices an expert once a group passes 32 tokens; the reference
    is dropless, as the published model.  A verify over a bank of 16 (128
    tree tokens a group), or prompt pieces of 64 tokens, drop choices,
    and the run comes out not correct (``PERF.md``, Open questions)."""
    cell = "qwen3-moe-30b-a3b.decode"
    b = testing.bench()
    cfg, mix = testing.tiny_config(b, cell), testing.tiny_mix(b, cell)
    if where == "verify":
        cfg["serve"]["bank"] = mix["clients"] = 16
    else:
        cfg["serve"]["prefill_chunk"] = 64
        mix["prompt"] = dict(mix["prompt"], min=64, max=150, median=96)
    res = testing.run(cell, cfgfile=cfg, mix=mix)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["mistral-7b.decode",
                                  "qwen3-moe-30b-a3b.decode"])
def test_the_control_is_not_correct_at_the_tiny_size(cell):
    res = testing.run(cell, control=True)
    lim = {k: v["limit"] for k, v in res["checks"].items()}
    assert res["correct"], res["checks"]
    assert any(res["controls"][k] > lim[k] for k in lim if k in
               res["controls"]), (res["controls"], lim)
