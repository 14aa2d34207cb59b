"""The serving forward's dropless MoE (``models/mlp.py::moe_dropless``) at
the ``qwen3-moe-30b-a3b-smoke`` size (E=4 experts, top-2, float32, CPU).

* The dispatch equals a per-expert float32 loop over the same router
  (within 2e-5: both are float32 sums of the same products, in another
  order) at T = 64 and 256 tokens, with a router biased so that one
  expert takes every token's first choice too; in that case the capacity
  form (``moe_apply``, as training calls it) drops choices, so the test
  tells the two forms apart.
* The three expert products run over exactly T x K rows; slices of the
  experts (expert parallelism) give parts that add up to the whole.
* Prefill, a W=8 verify over a paged pool, commit and decode agree with
  the benchmark's plain float32 reference
  (``portbench/reference/model.py::Ref``, the published MoE, every
  choice kept) on the same weights: logits, row by row and node by node.
* On the card (``gpu``): the dispatch captured in a CUDA graph replays
  equal to the eager call.
"""
import dataclasses

import numpy as np
import pytest
import torch

from portbench.reference.model import Ref
from repro_torch.configs import get_config
from repro_torch.core.speculative import tree as T
from repro_torch.models import mlp
from repro_torch.models.api import get_model
from repro_torch.runtime import cache as tcache

ARCH = "qwen3-moe-30b-a3b-smoke"
TOL = 2e-5                 # the dispatch against the loop, fp32
# the served logits against the reference: both float32, but the port's
# attention reads the paged pool through its own kernels' plain versions
# (another summation order) and its rmsnorm, rope and residual adds are
# not the reference's operation for operation; at this size (2 layers,
# logits of magnitude ~3) they differ by at most 5.3e-6 (both routers):
# ten times that
LOGIT_TOL = 5e-5
SKEW = 6.0                 # router bias toward expert 0 (see ``_skew``)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_config(ARCH)


def _moe_params(cfg, seed=4, skew=0.0):
    p = mlp.moe_init(cfg, torch.Generator().manual_seed(seed))
    if skew:
        p["router"][:, 0] += skew / cfg.d_model
    return p


def _tokens(cfg, T_, seed, skew=0.0):
    x = torch.randn((1, T_, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed))
    return x + 1.0 if skew else x       # the bias needs a mean > 0


def loop_moe(cfg, p, x):
    """The MoE as published, one expert at a time in float32: every
    choice kept."""
    E, K = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(-1, x.shape[-1]).float()
    probs = torch.softmax(xt @ p["router"].float(), dim=-1)
    gate, idx = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(xt)
    for e in range(E):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        h = torch.nn.functional.silu(xt[tok] @ p["w_gate"][e].float()) \
            * (xt[tok] @ p["w_up"][e].float())
        out.index_add_(0, tok, (h @ p["w_down"][e].float())
                       * gate[tok, slot][:, None])
    return out.reshape(x.shape)


def dropped(cfg, p, x) -> int:
    """Choices the capacity form drops on ``x``, counted on the host."""
    B, S, d = x.shape
    g, G, cap = mlp.moe_groups(cfg, B * S)
    logits = x.reshape(G, g, d).double() @ p["router"].double()
    idx = torch.topk(logits, cfg.experts_per_token, dim=-1).indices
    n = 0
    for grp in idx:
        seen = np.zeros(cfg.num_experts, int)
        for e in grp.reshape(-1).tolist():
            n += seen[e] >= cap
            seen[e] += 1
    return n


# --------------------------------------------------------------------------
# the dispatch
# --------------------------------------------------------------------------
@pytest.mark.parametrize("T_", [64, 256])
def test_dispatch_equals_a_per_expert_loop(T_):
    cfg = _cfg()
    p, x = _moe_params(cfg), _tokens(cfg, T_, seed=T_)
    out, aux = mlp.moe_dropless(cfg, p, x)
    assert aux is None
    torch.testing.assert_close(out, loop_moe(cfg, p, x), atol=TOL, rtol=TOL)
    # the load-balance term, when asked, is the capacity form's
    _, aux = mlp.moe_dropless(cfg, p, x, aux=True)
    assert float(aux) == pytest.approx(float(mlp.moe_apply(cfg, p, x)[1]),
                                       rel=1e-6)


@pytest.mark.parametrize("T_", [64, 256])
def test_skewed_router_keeps_every_choice_where_capacity_drops(T_):
    cfg = _cfg()
    p, x = _moe_params(cfg, skew=50.0), _tokens(cfg, T_, seed=T_, skew=1.0)
    first = torch.topk(x.reshape(-1, cfg.d_model) @ p["router"],
                       cfg.experts_per_token).indices
    assert (first == 0).any(dim=-1).float().mean() > 0.9   # one expert leads
    assert dropped(cfg, p, x) > 0
    want = loop_moe(cfg, p, x)
    out, _ = mlp.moe_dropless(cfg, p, x)
    torch.testing.assert_close(out, want, atol=TOL, rtol=TOL)
    capacity, _ = mlp.moe_apply(cfg, p, x)
    assert float((capacity - want).abs().max()) > 100 * TOL


@pytest.mark.parametrize("skew", [0.0, 50.0], ids=["even", "skewed"])
def test_expert_products_run_over_exactly_t_k_rows(skew, monkeypatch):
    cfg = _cfg()
    T_, K = 96, cfg.experts_per_token
    p, x = _moe_params(cfg, skew=skew), _tokens(cfg, T_, seed=1, skew=skew)
    real = torch._grouped_mm
    calls = []

    def counted(a, b, *, offs):
        calls.append((tuple(a.shape), tuple(b.shape), offs.clone()))
        return real(a, b, offs=offs)

    monkeypatch.setattr(torch, "_grouped_mm", counted)
    counts = torch.zeros(cfg.num_experts, dtype=torch.int64)
    mlp.moe_dropless(cfg, p, x, counts=counts)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert [(a, b) for a, b, _ in calls] == [
        ((T_ * K, d), (E, d, f)), ((T_ * K, d), (E, d, f)),
        ((T_ * K, f), (E, f, d))]
    host = torch.bincount(torch.topk(x.reshape(-1, d) @ p["router"], K)
                          .indices.reshape(-1), minlength=E)
    assert counts.tolist() == host.tolist()
    for _, _, offs in calls:
        assert offs.tolist() == torch.cumsum(host, 0).tolist()


@pytest.mark.parametrize("slices", [2, 4])
def test_expert_slices_add_up_to_the_whole(slices):
    """Expert parallelism: each slice of the stacks (a rank's experts)
    computes only its own experts' part, the other choices' rows left out;
    the parts add up to the whole layer."""
    cfg = _cfg()
    p, x = _moe_params(cfg, skew=50.0), _tokens(cfg, 80, seed=5, skew=1.0)
    xt = x.reshape(80, cfg.d_model)
    _, gates, idx = mlp._route(cfg, p, xt)
    whole = mlp._experts(cfg, p, xt, gates, idx)
    n = cfg.num_experts // slices
    parts = [mlp._experts(cfg, {k: p[k][r * n:(r + 1) * n] for k in
                                ("w_gate", "w_up", "w_down")},
                          xt, gates, idx, lo=r * n) for r in range(slices)]
    torch.testing.assert_close(sum(parts), whole, atol=TOL, rtol=TOL)
    torch.testing.assert_close(whole, loop_moe(cfg, p, x)[0], atol=TOL,
                               rtol=TOL)


# --------------------------------------------------------------------------
# the served model against the plain reference
# --------------------------------------------------------------------------
def ref_config(cfg) -> dict:
    """The reference's configuration keys (the source config's names) of a
    port config."""
    return dict(hidden_size=cfg.d_model, num_hidden_layers=cfg.num_layers,
                num_attention_heads=cfg.num_heads,
                num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                vocab_size=cfg.vocab_size, rms_norm_eps=cfg.rmsnorm_eps,
                rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                tie_word_embeddings=cfg.tie_embeddings,
                num_experts=cfg.num_experts,
                num_experts_per_tok=cfg.experts_per_token)


def _skew(cfg, params, strength):
    """Every hidden state leans along one direction ``u`` (added to every
    embedding row; the residual keeps it), and every layer's router
    favours expert 0 along ``u``: expert 0 takes nearly every token."""
    u = torch.randn(cfg.d_model, generator=torch.Generator().manual_seed(9))
    u = u / u.norm()
    params["embed"] += u
    params["layers"]["moe"]["router"][:, :, 0] += strength * u


def served_model(skew=0.0):
    cfg = _cfg()
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    if skew:
        _skew(cfg, params, skew)
    return cfg, model, params


def _paged(cache, B, page_size=4, pages_a_row=16):
    tables = torch.arange(B * pages_a_row, dtype=torch.int32).reshape(
        B, pages_a_row)
    return tcache.paginate_cache(cache, tables, page_size=page_size,
                                 n_pages=B * pages_a_row)


def _close(got, want, what):
    err = float((got - want).abs().max())
    assert err <= LOGIT_TOL, (what, err)
    return err


@pytest.mark.parametrize("skew", [0.0, SKEW], ids=["even", "skewed"])
def test_served_logits_equal_the_plain_reference(skew, monkeypatch):
    """Prefill of 2 rows x 40 tokens (one routed call of 80 tokens), a W=8
    verify over the paged pool (16 tokens), a commit of a different path
    length a row, then a decode: every logit the port serves against
    ``Ref.forward`` of the same row's whole sequence."""
    cfg, model, params = served_model(skew)
    ref = Ref(ref_config(cfg), params, heads=None)
    B, P = 2, 40
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P)))
    seen = []
    real = mlp.moe_dropless

    def watched(cfg_, p, x, **kw):
        seen.append((p, x))
        return real(cfg_, p, x, **kw)

    monkeypatch.setattr("repro_torch.models.transformer.moe_dropless",
                        watched)
    logits, _, cache = model.prefill(params, {"tokens": prompt},
                                     max_len=P + 8)
    if skew:
        # the capacity form would drop choices of this very prefill
        assert sum(dropped(cfg, p, x) for p, x in seen) > 0
    for b in range(B):
        want, _ = ref.forward(prompt[b], 0)
        _close(logits[b], want, ("prefill", b))

    spec = T.build_tree(T.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                        8)
    tree = T.Tree.from_spec(spec, "cpu")
    cache = _paged(cache, B)
    tt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, spec.width)))
    lv, extras = model.verify(params, cache, tt, tree)
    for b in range(B):
        for j in range(spec.width):
            path, node = [], j
            while node >= 0:
                path.append(int(tt[b, node]))
                node = int(spec.parent[node])
            seq = torch.cat([prompt[b], torch.tensor(path[::-1])])
            want, _ = ref.forward(seq, len(seq) - 1)
            _close(lv[b, j], want[0], ("verify", b, j))

    # row 0 commits the root and its first child, row 1 the root alone
    child = next(j for j in range(1, spec.width) if spec.parent[j] == 0)
    chain = torch.zeros((B, spec.max_depth), dtype=torch.int64)
    chain[0, 1] = child
    n = torch.tensor([2, 1])
    cache = model.commit(cache, extras, tree, chain, n, torch.zeros(B))
    step = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
    ld, _ = model.decode(params, cache, step)
    for b in range(B):
        kept = [int(tt[b, 0])] + ([int(tt[b, child])] if b == 0 else [])
        seq = torch.cat([prompt[b], torch.tensor(kept), step[b]])
        want, _ = ref.forward(seq, len(seq) - 1)
        _close(ld[b, 0], want[0], ("decode", b))


def test_pad_rows_change_no_real_rows_output():
    """A prompt padded at its end routes the pad's tokens too; the real
    positions' logits are the unpadded prompt's (causal attention, every
    choice kept)."""
    cfg, model, params = served_model(SKEW)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 37)))
    padded = torch.cat([prompt, torch.zeros((1, 27), dtype=prompt.dtype)],
                       dim=1)
    a, _, _ = model.prefill(params, {"tokens": prompt}, max_len=64)
    b, _, _ = model.prefill(params, {"tokens": padded}, max_len=64)
    torch.testing.assert_close(b[:, :37], a, atol=TOL, rtol=TOL)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("T_", [16, 128])
def test_dispatch_replays_in_a_cuda_graph_equal_to_eager(T_):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dispatch is captured there")
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = mlp.moe_init(cfg, gen)
    x = torch.randn((1, T_, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    counts = torch.zeros(cfg.num_experts, dtype=torch.int64, device=dev)
    want, _ = mlp.moe_dropless(cfg, p, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mlp.moe_dropless(cfg, p, x, counts=counts)    # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = mlp.moe_dropless(cfg, p, x, counts=counts)
    counts.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(counts.sum()) == T_ * cfg.experts_per_token
