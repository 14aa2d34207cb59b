"""The plain reference against the port at a tiny size on the CPU (both in
float32): prefill logits, the dropless MoE, the Medusa heads; the fp8
control departs from it; and the reference imports nothing of the port."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import spec, testing, weights
from portbench.reference import model as refmodel
from portbench.reference import oracle

BENCH = testing.bench()


def setup(cell, seed=11):
    cfg = testing.tiny_config(BENCH, cell)
    pcfg = spec.port_config(cfg)
    params, heads = weights.make(pcfg, seed, "cpu")
    return cfg, pcfg, params, heads


@pytest.mark.parametrize("cell", ["mistral-7b.decode",
                                  "qwen3-moe-30b-a3b.decode"])
def test_reference_matches_the_port_prefill(cell):
    from repro_torch.models.api import get_model
    cfg, pcfg, params, heads = setup(cell)
    S = cfg["serve"]["prefill_chunk"]          # one whole piece
    toks = np.random.default_rng(0).integers(0, cfg["vocab_size"], S)
    with torch.no_grad():
        got, extras, _ = get_model(pcfg).prefill(
            params, {"tokens": torch.as_tensor(toks[None])}, max_len=S)
        ref = refmodel.Ref(cfg, params, heads)
        want, hid = ref.forward(toks, 0, hidden_at=[S - 1])
    torch.testing.assert_close(got[0].float(), want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(extras["hidden"][0, -1].float(), hid[0],
                               atol=2e-4, rtol=2e-4)


def test_reference_heads_match_the_ports():
    from repro_torch.core.speculative.medusa import medusa_logits
    cfg, pcfg, params, heads = setup("mistral-7b.decode")
    h = torch.randn(3, pcfg.d_model)
    want = refmodel.Ref(cfg, params, heads).draft_logits(h)
    torch.testing.assert_close(medusa_logits(pcfg, heads, h), want,
                               atol=1e-4, rtol=1e-4)


def test_reference_moe_keeps_every_choice():
    """As published, no expert has a capacity: 64 tokens that all choose
    the same two experts each get both, gated by the renormalised top-2."""
    cfg, _, params, heads = setup("qwen3-moe-30b-a3b.decode")
    ref = refmodel.Ref(cfg, params, heads)
    m, i = params["layers"]["moe"], 0
    bias = torch.zeros(cfg["num_experts"])
    bias[3], bias[5] = 60.0, 59.0
    router = m["router"].clone()
    router[i] = 0.0
    h = torch.randn(64, cfg["hidden_size"])
    h[:, 0] = 1.0
    router[i, 0] = bias
    lp = {"moe": dict(m, router=router)}
    got = ref.moe(lp, i, h)
    p = torch.softmax(bias, -1)[[3, 5]]
    p = p / p.sum()
    want = sum(p[j] * ref.swiglu(h, m["w_gate"][i, e], m["w_up"][i, e],
                                 m["w_down"][i, e])
               for j, e in enumerate((3, 5)))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_served_gaps_and_the_control():
    cfg, _, params, heads = setup("mistral-7b.decode")
    ref = refmodel.Ref(cfg, params, heads)
    ctl = refmodel.Ref(cfg, params, heads, quant="fp8")
    prompt = np.arange(20, dtype=np.int64) % cfg["vocab_size"]
    # greedy continuation by the reference itself: every gap is 0
    toks = []
    for _ in range(6):
        lg, _ = ref.forward(np.concatenate([prompt, toks]).astype(np.int64),
                            len(prompt) + len(toks) - 1)
        toks.append(int(lg[-1].argmax()))
    out = oracle.served(ref, prompt, np.asarray(toks), ctl)
    assert np.all(out["token_gap"] == 0)
    assert out["control_gap"].max() > 0
    wrong = np.asarray(toks)
    wrong[2] = (wrong[2] + 1) % cfg["vocab_size"]
    assert oracle.served(ref, prompt, wrong)["token_gap"][2] > 0


def test_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "math", "numpy", "torch"}
    for p in Path(refmodel.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed | {"portbench"}, (p, n)
                assert not n.startswith("portbench.") or \
                    n.startswith("portbench.reference"), (p, n)
