"""The port's dense decoder on the other dense configs the reference runs
(``tests/test_smoke_archs.py``): ``qwen3-32b-smoke`` (``qk_norm``, which
no other port test turns on), ``glm4-9b-smoke`` (GQA with 2 kv heads, and
a sliding-window case as in the reference's ``tests/test_models.py``) and
``stablelm-3b-smoke`` (qkv bias, MHA).  The same numpy inputs and bridged
weights go through the JAX and the port's functions, at the tolerances of
``tests/test_torch_model.py`` (logits 1e-4 over two fp32 layers), and the
greedy token streams of both engines must be equal (``np.array_equal``) on
the boosted weights of ``tests/test_torch_engine.py``.
"""
import numpy as np
import pytest

from repro.runtime.engine import BatchEngine as JBatch
from repro.runtime.engine import SpeculativeEngine as JSpec
from repro_torch.runtime.engine import BatchEngine as TBatch
from repro_torch.runtime.engine import SpeculativeEngine as TSpec
from test_torch_engine import _setup
from test_torch_model import \
    test_prefill_verify_commit_decode_logits_match_reference as \
    _logits_match

ARCHS = ["qwen3-32b-smoke", "glm4-9b-smoke", "stablelm-3b-smoke"]
N = 16


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_verify_commit_decode_logits_match_reference(arch):
    """Prefill, two verify + commit rounds with diverging positions, and a
    decode step: logits, hidden states and the cache as the reference's."""
    _logits_match(arch)


def _engines(arch, engine, **kw):
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = _setup(arch)
    kw = dict({"max_len": toks.shape[1] + N + spec.max_depth, "chunk": 4},
              **kw)
    if engine == "speculative":
        return (JSpec(jm, jh, jp, spec, **kw),
                TSpec(tm, th, tp, tspec, **kw), toks)
    return JBatch(jm, jp, **kw), TBatch(tm, tp, **kw), toks


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("engine", ["speculative", "batch"])
def test_greedy_tokens_equal_jax(arch, engine):
    jeng, teng, toks = _engines(arch, engine)
    jo, js = jeng.generate({"tokens": toks}, N)
    to, ts = teng.generate({"tokens": toks}, N)
    assert np.array_equal(np.asarray(jo), to)
    np.testing.assert_array_equal(ts["n_emitted"], np.asarray(js["n_emitted"]))
    if engine == "speculative":
        assert ts["acceptance_length"] == pytest.approx(
            js["acceptance_length"])


def test_glm4_sliding_window_tokens_equal_jax():
    """``glm4-9b-smoke`` with an 8-slot ring, smaller than prompt + budget:
    the prefill keeps the ring's tail and the decode wraps."""
    jeng, teng, toks = _engines("glm4-9b-smoke", "speculative", window=8)
    jo, js = jeng.generate({"tokens": toks}, N)
    to, ts = teng.generate({"tokens": toks}, N)
    assert np.array_equal(np.asarray(jo), to)
    np.testing.assert_array_equal(ts["n_emitted"], np.asarray(js["n_emitted"]))
