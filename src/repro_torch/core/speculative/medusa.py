"""Medusa drafting heads (counterpart of
``repro/core/speculative/medusa.py``).

Each head h predicts the token at offset h+1 from the current hidden state:
  head_h(x) = (x + silu(x @ W_h)) @ O_h        (ResBlock + linear)
Heads are stacked on a leading H axis: {"w": (H, d, d), "out": (H, d, Vp)}.
``head_accuracies`` measures the heads' real per-rank accuracy table.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def init_medusa(cfg, gen):
    """Random heads from ``gen`` (a ``torch.Generator``), on its device."""
    dt = getattr(torch, cfg.dtype)

    def head_init():
        return {
            "w": cm.dense_init(gen, cfg.d_model, cfg.d_model, dt, scale=0.02),
            "out": cm.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt),
        }

    return cm.stack_init(cfg.medusa_heads, head_init)


def medusa_logits(cfg, heads, hidden):
    """hidden: (..., d) -> (..., H, V)."""
    lead = hidden.shape[:-1]
    x = hidden.reshape(1, -1, hidden.shape[-1])                # (1, N, d)
    h = x + F.silu(x @ heads["w"])                            # (H, N, d)
    out = h @ heads["out"]                                    # (H, N, Vp)
    out = out.permute(1, 0, 2).reshape(*lead, out.shape[0], out.shape[-1])
    return out[..., :cfg.vocab_size]


def draft_candidates(cfg, heads, hidden, top_k):
    """hidden: (B, d) -> candidate tokens (B, H, K) + probs (B, H, K).

    The reference's ``lax.top_k`` breaks ties toward the lower index, and
    bf16 logits tie often; ``torch.topk`` promises no tie order.  A stable
    descending sort keeps equal probabilities in index order, so the first
    K match the reference's candidates."""
    logits = medusa_logits(cfg, heads, hidden)                # (B, H, V)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return idx[..., :top_k], vals[..., :top_k]


def head_accuracies(cfg, model, params, heads, token_batches):
    """REAL per-head top-k accuracy table: ``accs[h, k]`` = P(head h's
    rank-k candidate is the target), the quantity ARCA's tree construction
    and expected-acceptance estimator consume.  ``token_batches``: an
    iterable of (B, S) integer token arrays (calibration prompts).
    Returns an (H, K) numpy table.  Ranks break ties toward the lower
    index, as the reference's ``lax.top_k`` does (a stable descending
    sort)."""
    H, K = cfg.medusa_heads, cfg.medusa_top_k
    dev = params["embed"].device
    hits = np.zeros((H, K))
    counts = 0
    for toks in token_batches:
        toks = torch.as_tensor(np.asarray(toks, np.int32), device=dev)
        seq = int(toks.shape[1])
        with torch.no_grad():
            _, extras, _ = model.prefill(params, {"tokens": toks},
                                         return_cache=False)
            logits = medusa_logits(cfg, heads, extras["hidden"])  # (B,S,H,V)
            top = torch.sort(logits, dim=-1, descending=True,
                             stable=True)[1][..., :K]           # (B,S,H,K)
        top = top.cpu().numpy()
        tk = toks.cpu().numpy()
        for h in range(H):
            off = h + 2       # hidden at t drives head h toward token t+h+2
            if off >= seq:
                continue
            tgt = tk[:, off:]                                 # (B, S-off)
            pred = top[:, :seq - off, h]                      # (B, S-off, K)
            for k in range(K):
                hits[h, k] += float(np.mean(pred[..., k] == tgt))
        counts += 1
    return hits / max(counts, 1)


def expand_tree_tokens(tree, cur_token, candidates):
    """Fill tree slots: node 0 = cur committed token; node n (depth d>0) =
    head (d-1)'s rank[n] candidate.

    cur_token: (B,), candidates: (B, H, K) -> (B, W) int64.
    """
    head_idx = torch.clamp(tree.depth - 1, min=0)             # (W,)
    cand = candidates[:, head_idx, tree.rank]                 # (B, W)
    root = (tree.depth == 0)[None, :]
    return torch.where(root, cur_token[:, None], cand)
