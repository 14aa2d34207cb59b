"""Greedy tree acceptance and the full Ghidorah speculative decoding step
(counterpart of ``repro/core/speculative/verify.py``).

Acceptance walk (fixed shapes, no host sync): start at the root; at each
depth pick the child whose token equals the argmax of the current node's
logits; stop when none matches.  The last accepted node's argmax becomes
the *bonus* token: tokens emitted per step = (accepted chain - root) + 1
bonus = the paper's acceptance length.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.speculative.medusa import (draft_candidates,
                                                 expand_tree_tokens)


def accept_walk(tree, tree_tokens, logits):
    """tree_tokens: (B, W); logits: (B, W, V).

    Returns dict(n_accept (B,) total accepted incl. root, chain (B, Dmax)
    node ids padded with the last accepted node, bonus (B,) next token,
    last_node (B,)).
    """
    B = logits.shape[0]
    dev = logits.device
    targets = torch.argmax(logits, dim=-1)                    # (B, W)
    parent = tree.parent                                      # (W,)
    cur = torch.zeros((B,), dtype=torch.int64, device=dev)
    n_acc = torch.ones((B,), dtype=torch.int64, device=dev)   # root counts
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    chain = torch.zeros((B, tree.max_depth), dtype=torch.int64, device=dev)
    for d in range(1, tree.max_depth):
        # child of `cur` whose token matches target[cur]
        tgt = targets.gather(1, cur[:, None])[:, 0]          # (B,)
        is_child = parent[None, :] == cur[:, None]            # (B, W)
        match = (is_child & (tree_tokens == tgt[:, None])
                 & (tree.depth[None, :] == d))
        any_match = match.any(dim=1)
        # first matching node, as jnp.argmax on a bool row
        nxt = torch.argmax(match.to(torch.int32), dim=1)
        alive = alive & any_match
        cur = torch.where(alive, nxt, cur)
        n_acc = n_acc + alive.to(torch.int64)
        chain[:, d] = torch.where(alive, nxt, chain[:, d - 1])
    bonus = targets.gather(1, cur[:, None])[:, 0]
    return {"n_accept": n_acc, "chain": chain, "bonus": bonus,
            "last_node": cur}


@dataclasses.dataclass
class SpecState:
    """Carry between decode steps (any batch size B); also the
    ``DecodeEngine`` state, where a draft-free (sequential) strategy
    carries ``hidden=None``."""
    cache: Any
    cur_token: torch.Tensor          # (B,) last committed token (next root)
    hidden: Optional[torch.Tensor]   # (B, d) hidden at that token, or None


def spec_step(model, params, heads, tree, state: SpecState, *,
              tree_kernel="dense", active=None, marks=None, tap=None):
    """One Ghidorah speculative decoding step, batched over sequences.

    Each sequence accepts its own chain length; the commit is a per-sequence
    masked ring write, so positions diverge across the batch.  Returns
    (new_state, out_tokens (B, Dmax) emitted tokens padded with the bonus,
    n_out (B,) = acceptance length this step).

    ``active (B,) bool`` freezes the rows where it is False: their
    acceptance count is forced to 0 (nothing committed, ``pos`` does not
    advance) and their carry (``cur_token``/``hidden``) is left untouched.

    ``marks`` (``runtime.trace.PhaseMarks``, given by the captured step)
    records a timing event at each phase boundary: start, after the draft,
    after the verify forward, after the accept walk, after the commit and
    emit.  ``tap`` (``runtime.trace.ExpertTap``, given by the captured step
    of a model with experts) goes to the verify forward.
    """
    cfg = model.cfg
    if marks is not None:
        marks.at(0)
    cands, _ = draft_candidates(cfg, heads, state.hidden, cfg.medusa_top_k)
    tree_tokens = expand_tree_tokens(tree, state.cur_token, cands)
    if marks is not None:
        marks.at(1)
    logits, extras = model.verify(params, state.cache, tree_tokens, tree,
                                  tree_kernel=tree_kernel, tap=tap)
    if marks is not None:
        marks.at(2)
    acc = accept_walk(tree, tree_tokens, logits)
    if marks is not None:
        marks.at(3)

    n_accept = acc["n_accept"]
    if active is not None:
        n_accept = torch.where(active, n_accept, 0)
    path_idx = tree.node_path[acc["last_node"]]              # (B,)
    cache = model.commit(state.cache, extras, tree, acc["chain"],
                         n_accept, path_idx)

    hidden = extras["hidden"]                                 # (B, W, d)
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    new_hidden = hidden[rows, acc["last_node"]]
    cur_token = acc["bonus"]
    if active is not None:
        cur_token = torch.where(active, cur_token, state.cur_token)
        new_hidden = torch.where(active[:, None], new_hidden, state.hidden)
    new_state = SpecState(cache=cache, cur_token=cur_token,
                          hidden=new_hidden)

    # emitted tokens: accepted children (chain[1:n]) then the bonus token.
    # position j < n-1 emits tree_tokens[chain[j+1]]; position n-1 the bonus.
    idx = torch.arange(tree.max_depth, device=hidden.device)[None, :]
    chain_tokens = tree_tokens.gather(1, acc["chain"])
    child_shift = torch.cat([chain_tokens[:, 1:], chain_tokens[:, -1:]],
                            dim=1)
    n_all = acc["n_accept"][:, None]
    emitted = torch.where(idx < n_all - 1, child_shift, 0)
    emitted = torch.where(idx == n_all - 1, acc["bonus"][:, None], emitted)
    if marks is not None:
        marks.at(4)
    return new_state, emitted, n_accept


def spec_prefill(model, params, heads, batch, *, max_len, window=0):
    """Prefill + initial draft state."""
    logits, extras, cache = model.prefill(params, batch, max_len=max_len,
                                          window=window)
    cur = torch.argmax(logits[:, -1], dim=-1)
    hidden = extras["hidden"][:, -1]
    return SpecState(cache=cache, cur_token=cur, hidden=hidden)
