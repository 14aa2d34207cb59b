"""Runtime HCMP: the draft/verify executor split (paper §III-B at runtime),
counterpart of ``repro/core/hcmp/executors.py``.

The ``DecodeStrategy``'s two compute phases run on separate executors and
the step pipeline overlaps them:

  * the **verify executor**: the full-model tree forward (``model.verify``
    + ``accept_walk``) and the KV commit.  Weight- and bandwidth-heavy;
    owns the KV cache.
  * the **draft executor**: the Medusa heads (``draft_candidates`` +
    ``expand_tree_tokens``).  It reads the engine's heads, which are never
    written, so it shares them: no copy.

On a CUDA device the two executors are two streams of one card: the
stream the engine runs on (the capture stream, when the step is captured)
and a second ``torch.cuda.Stream``.  On the CPU they are one serial
executor, the reference's single-device case: the same three phases in
the same order, no overlap.  Drafting stays on the card: it reads every
head's weights each step (5 x (4096^2 + 4096 x 32000) bf16, ~1.48 GB at
``vicuna-7b``), which the host cannot stream within a ~12 ms step, and
host work cannot sit inside the captured step.

Pipeline: Medusa drafts from the verifier's hidden state, so draft(t+1)
cannot start before verify(t)'s forward ends.  The overlap window is the
verifier's commit: after ``verify_front(t)`` an event forks the draft
stream, ``draft_step(t+1)`` runs on it while ``commit_step(t)`` runs on
the verify stream, and the verify stream waits for the draft stream (the
join) before step t+1's verify.  The last step's draft is the next
chunk's first ("pre-draft"), tagged with the engine's bank epoch, the
strategy's shape and the batch; any bank mutation between chunks
(admission, reset, strategy switch, a new stream) bumps the epoch, and
the stale pre-draft is DISCARDED and redrafted from the committed state.
Greedy tree verification commits the greedy chain whatever the draft
proposes, and the draft is a function of the committed carry, so the
overlap engine emits exactly the inline engine's tokens.

Ownership: the verify stream owns the cache (only ``verify_front`` reads
it, only ``commit_step`` writes it, both in that stream's order); the
draft stream reads the verify stream's ``cur_token``/``hidden``, which the
step holds until the join, and its tree tokens are recorded on the verify
stream that reads them.  The runner's pre-draft slot and counters are
entered only from the engine's chunk calls.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.speculative.medusa import (draft_candidates,
                                                 expand_tree_tokens)
from repro_torch.core.speculative.verify import SpecState, accept_walk
from repro_torch.runtime.cache import capacity_left


def executor_pair(device):
    """(verify executor, draft executor) on ``device``.  On a CUDA device:
    the stream current there (the engine's) and a new stream on the same
    card.  On the CPU: the device twice (one serial executor)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.current_stream(device), torch.cuda.Stream(device)
    return device, device


def _name(executor) -> str:
    if isinstance(executor, torch.cuda.Stream):
        return f"{executor.device} stream {executor.stream_id}"
    return str(executor)


# ---------------------------------------------------------------------------
# the three phases of a step, as plain functions on tensors
# ---------------------------------------------------------------------------
def draft_step(cfg, heads, tree, cur, hidden):
    """The draft executor's phase: the heads' candidates from the
    committed hidden state, placed in the tree: (B, W) tree tokens."""
    cands, _ = draft_candidates(cfg, heads, hidden, cfg.medusa_top_k)
    return expand_tree_tokens(tree, cur, cands)


def verify_front(model, params, tree, cache, cur, hidden, tree_tokens, done,
                 rem, eos, tree_kernel):
    """The inline step (``engine._decode_step`` with ``spec_step``) split
    open: the tree forward, the acceptance walk and the whole emission /
    EOS / budget fold; the commit is deferred to ``commit_step``.  Returns
    (done, rem, cur_token, hidden, emitted, n_eff, chain, n_accept,
    path_idx, extras)."""
    done = done | (rem <= 0) | (capacity_left(cache) < tree.max_depth)
    active = ~done
    logits, extras = model.verify(params, cache, tree_tokens, tree,
                                  tree_kernel=tree_kernel)
    acc = accept_walk(tree, tree_tokens, logits)
    n_accept = torch.where(active, acc["n_accept"], 0)
    path_idx = tree.node_path[acc["last_node"]]
    rows = torch.arange(cur.shape[0], device=cur.device)
    new_hidden = extras["hidden"][rows, acc["last_node"]]
    cur_token = torch.where(active, acc["bonus"], cur)
    new_hidden = torch.where(active[:, None], new_hidden, hidden)
    # emission: accepted children then the bonus, then the chunk driver's
    # EOS truncation and budget fold
    idx = torch.arange(tree.max_depth, device=cur.device)[None, :]
    chain_tokens = tree_tokens.gather(1, acc["chain"])
    child_shift = torch.cat([chain_tokens[:, 1:], chain_tokens[:, -1:]],
                            dim=1)
    n_all = acc["n_accept"][:, None]
    emitted = torch.where(idx < n_all - 1, child_shift, 0)
    emitted = torch.where(idx == n_all - 1, acc["bonus"][:, None], emitted)
    valid = idx < n_accept[:, None]
    is_eos = valid & (emitted == eos)
    has_eos = is_eos.any(dim=1)
    n_cut = torch.where(
        has_eos, torch.argmax(is_eos.to(torch.int32), dim=1) + 1, n_accept)
    n_eff = torch.where(active, n_cut, 0)
    emitted = torch.where(idx < n_eff[:, None], emitted, eos)
    return (done | has_eos, rem - n_eff, cur_token, new_hidden, emitted,
            n_eff, acc["chain"], n_accept, path_idx, extras)


def commit_step(model, cache, extras, tree, chain, n_accept, path_idx):
    """The verify executor's second phase: write the accepted KVs."""
    return model.commit(cache, extras, tree, chain, n_accept, path_idx)


def overlap_step(model, params, heads, draft_stream, strategy, state, done,
                 rem, eos, tree_kernel, tree_tokens, out=None):
    """One overlapped step from ``tree_tokens`` (this step's draft):
    verify, then draft(t+1) on ``draft_stream`` beside commit(t) on the
    current stream, then the join.  ``draft_stream`` None runs the three
    phases serially.  ``out`` receives the next draft (the static buffer
    of a captured step).  Returns (state, done, rem, emitted, n_eff, next
    tree tokens)."""
    tree = strategy.tree
    (done, rem, cur, hidden, emitted, n_eff, chain, n_accept, path_idx,
     extras) = verify_front(model, params, tree, state.cache,
                            state.cur_token, state.hidden, tree_tokens,
                            done, rem, eos, tree_kernel)
    if draft_stream is None:
        nxt = draft_step(model.cfg, heads, tree, cur, hidden)
        if out is not None:
            out.copy_(nxt)
            nxt = out
        cache = commit_step(model, state.cache, extras, tree, chain,
                            n_accept, path_idx)
    else:
        verify = torch.cuda.current_stream(cur.device)
        draft_stream.wait_stream(verify)           # fork after verify(t)
        with torch.cuda.stream(draft_stream):
            nxt = draft_step(model.cfg, heads, tree, cur, hidden)
            if out is not None:
                out.copy_(nxt)
                nxt = out
        cache = commit_step(model, state.cache, extras, tree, chain,
                            n_accept, path_idx)
        verify.wait_stream(draft_stream)           # join before t+1
        if out is None:
            nxt.record_stream(verify)               # read there next step
    return (SpecState(cache=cache, cur_token=cur, hidden=hidden), done, rem,
            emitted, n_eff, nxt)


class HcmpOverlapRunner:
    """Disaggregated chunk driver: the engine's chunk signature and its
    exact tokens, with each step split across the two executors.  The
    final step's draft becomes the next chunk's pre-draft.

    ``run_chunk(..., graphs=ChunkGraphs)`` replays the overlapped step
    captured on static buffers (``runtime/graphs.py``: the capture forks
    the draft stream and joins it, so the graph holds two concurrent
    branches); without it the steps run op by op."""

    def __init__(self, model, heads, *, tree_kernel: str = "dense",
                 executors=None):
        self.verify_exec, self.draft_exec = \
            executors or executor_pair(heads["w"].device)
        self.draft_stream = self.draft_exec \
            if isinstance(self.draft_exec, torch.cuda.Stream) else None
        self.model, self.heads, self.tree_kernel = model, heads, tree_kernel
        # pre-draft slot: (epoch, strategy shape, batch, tree_tokens)
        self._predraft: Optional[tuple] = None
        self.chunks = 0
        self.steps = 0
        self.predraft_hits = 0
        self.predraft_discards = 0

    def draft(self, tree, cur, hidden):
        return draft_step(self.model.cfg, self.heads, tree, cur, hidden)

    def step_fn(self, params):
        """The overlapped step with its weights bound: ``fn(strategy,
        state, done, rem, eos, tree_kernel, tree_tokens, out=None)``."""
        return functools.partial(overlap_step, self.model, params,
                                 self.heads, self.draft_stream)

    # ---- pre-draft lifecycle ---------------------------------------------
    def _take_predraft(self, epoch, strategy, B):
        """Consume the stored pre-draft if it matches the bank's current
        epoch/strategy/width; count a hit or a mis-speculation discard."""
        slot, self._predraft = self._predraft, None
        if slot is None:
            return None
        tag_epoch, tag_shape, tag_b, tokens = slot
        if tag_epoch == epoch and tag_shape == strategy.shape() \
                and tag_b == B:
            self.predraft_hits += 1
            return tokens
        self.predraft_discards += 1
        return None

    def _loop(self, params, K, strategy, state, done, rem, eos, tree_tokens):
        """K overlapped steps op by op; returns the chunk and the dangling
        draft."""
        step = self.step_fn(params)
        toks, ns = [], []
        for _ in range(K):
            state, done, rem, emitted, n, tree_tokens = step(
                strategy, state, done, rem, eos, self.tree_kernel,
                tree_tokens)
            toks.append(emitted)
            ns.append(n)
        return (state, done, rem, torch.stack(toks), torch.stack(ns),
                tree_tokens)

    def run_chunk(self, params, strategy, state, done, rem, K, eos, epoch,
                  graphs=None):
        """K overlapped steps; returns ``(state, done, rem, toks (K, B,
        Dmax), ns (K, B))``, the inline chunk's signature.  No host sync
        (the caller's boundary sync reads the outputs)."""
        if strategy.draft != "medusa":
            raise ValueError("overlap needs a drafted strategy")
        B = int(state.cur_token.shape[0])
        tree_tokens = self._take_predraft(epoch, strategy, B)
        if tree_tokens is None:
            tree_tokens = self.draft(strategy.tree, state.cur_token,
                                     state.hidden)
        if graphs is None:
            out = self._loop(params, K, strategy, state, done, rem, eos,
                             tree_tokens)
        else:
            out = graphs.run(
                K, strategy, state, done, rem, eos, self.tree_kernel,
                functools.partial(self._loop, params),
                overlap=(self.step_fn(params), tree_tokens))
        state, done, rem, toks, ns, tree_tokens = out
        self.steps += K
        # the dangling draft is next chunk's pre-draft (valid while the
        # bank is untouched between chunks; any mutation bumps the epoch)
        self._predraft = (epoch, strategy.shape(), B, tree_tokens)
        self.chunks += 1
        return state, done, rem, toks, ns

    @property
    def stats(self) -> dict:
        return {
            "verify_executor": _name(self.verify_exec),
            "draft_executor": _name(self.draft_exec),
            "executors": 1 if self.draft_stream is None else 2,
            "chunks": self.chunks,
            "steps": self.steps,
            "predraft_hits": self.predraft_hits,
            "predraft_discards": self.predraft_discards,
        }
