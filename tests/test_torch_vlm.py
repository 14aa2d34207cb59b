"""The port's VLM family against the JAX reference
(``llava-next-mistral-7b`` smoke config: 16 stubbed patch embeds before
the text, float32, CPU), with the helpers of ``tests/test_torch_moe.py``.

The prefix joins the decoder sequence (``tests/test_models.py:77``): the
logits cover patches and text, and decode continues after the prefix;
through prefill, verify, commit and decode the logits are within 2e-5 of
the reference's.  ``generate`` takes the batch dict with its
``patch_embeds``: greedy streams equal the JAX engines' on the dense and
paged engines and the static-buffer graph step, and a paged row reserves
pages for its whole prefix.  The continuous scheduler serves text
requests through the VLM engine as the JAX one does.  ``lm_loss`` takes
the loss on the text tail, its grads within 2e-6 x max|g| of JAX's.
"""
import numpy as np
import pytest
import torch

from repro_torch.runtime.cache import pages_for
from repro_torch.runtime.engine import _prompt_len
from test_torch_moe import (N, continuous_equal_jax, engine_pair,
                            engines_equal_jax, family_setup, logits_match,
                            lm_loss_and_grads_match)

ARCH = "llava-next-mistral-7b-smoke"
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_logits_match_reference():
    assert logits_match(ARCH) < TOL


def test_prefix_joins_the_decoder_sequence():
    """``tests/test_models.py::test_vlm_prefix_embeddings`` on the port:
    the logits cover the prefix and the text, decode continues after it."""
    cfg, jm, jp, jh, tm, tp, th, spec, tspec, toks = family_setup(ARCH)
    B, S = toks.shape
    pe = torch.randn((B, cfg.num_frontend_tokens, cfg.d_model),
                     generator=torch.Generator().manual_seed(2))
    logits, _, cache = tm.prefill(tp, {"tokens": torch.as_tensor(toks),
                                       "patch_embeds": pe}, max_len=64)
    assert logits.shape == (B, S + cfg.num_frontend_tokens, cfg.vocab_size)
    assert int(cache.kv.pos[0]) == S + cfg.num_frontend_tokens
    lg, cache = tm.decode(tp, cache, torch.as_tensor(toks[:, :1]))
    assert lg.shape == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(lg).all())
    # a batch without the prefix is plain text, as in the reference
    lt, _, _ = tm.prefill(tp, {"tokens": torch.as_tensor(toks)}, max_len=64)
    assert lt.shape[1] == S


def tspec_depth():
    """The W=8 tree's depth: one accepted chain past the budget."""
    return family_setup(ARCH)[8].max_depth


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kind", ["spec", "batch"])
def test_engines_equal_jax(kind, layout):
    engines_equal_jax(ARCH, kind, layout)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_static_graph_step_equals_jax(layout):
    engines_equal_jax(ARCH, "spec", layout, graphed=True)


def test_paged_rows_reserve_the_prefix():
    """Each row's reservation covers prefix + text + budget + one accepted
    chain, as the reference's ``_prompt_len`` sizes it."""
    _, teng, batch = engine_pair(ARCH, "spec", paged=True, page_size=4)
    plen = _prompt_len(batch)
    assert plen == batch["tokens"].shape[1] + \
        batch["patch_embeds"].shape[1]
    seen = {}
    orig = teng._reserve_tables

    def spy(B, prompt_len, budget):
        tables, n_total = orig(B, prompt_len, budget)
        seen.update(prompt_len=prompt_len, tables=tables.clone())
        return tables, n_total

    teng._reserve_tables = spy
    _, stats = teng.generate(batch, N)
    assert seen["prompt_len"] == plen
    want = pages_for(plen + N + tspec_depth(), 4)
    assert ((seen["tables"] >= 0).sum(dim=1) == want).all()
    assert (stats["n_emitted"] == N).all()


def test_scheduler_admission_reserves_the_prefix():
    """``sched_admit`` with patch embeds reserves pages for the prefix."""
    _, teng, batch = engine_pair(ARCH, "spec", paged=True, page_size=4)
    row = {k: v[:1] for k, v in batch.items()}
    state = teng.sched_blank(teng.sched_prefill({"tokens": row["tokens"]}),
                             2)
    state, first = teng.sched_admit(state, 0, row, n_tokens=N)
    want = pages_for(_prompt_len(row) + N + tspec_depth(), 4)
    assert len(teng._row_pages[0]) == want
    assert int(state.cache.kv.pos[0]) == _prompt_len(row)
    teng.sched_release(0)
    assert teng.sched_drained()


@pytest.mark.parametrize("kind,layout", [("spec", "paged"),
                                         ("batch", "dense")])
def test_continuous_scheduler_equals_jax(kind, layout):
    continuous_equal_jax(ARCH, kind, layout)


def test_training_parity_on_the_text_tail():
    loss, ce, aux = lm_loss_and_grads_match(ARCH)
    assert aux == 0.0 and loss == pytest.approx(ce)
