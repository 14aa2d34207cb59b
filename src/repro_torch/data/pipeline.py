"""Synthetic data pipeline (a numpy copy of ``repro/data/pipeline.py``):
deterministic, seedable token streams with enough structure for a tiny model (and Medusa heads) to learn.

The generator is a small order-2 Markov chain over the vocabulary with a
skewed transition table — learnable by a ~100M model in a few hundred steps,
which is what the end-to-end example needs to show real acceptance-length
gains.  Batches are (tokens, labels) with labels = next token.
"""
from __future__ import annotations

import numpy as np


class MarkovDataset:
    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 4):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        # each (prev, cur) context maps to `branch` likely next tokens with
        # skewed probabilities -> predictable continuations (good for heads)
        self.table = self.rng.integers(0, vocab_size,
                                       size=(vocab_size, branch))
        p = np.array([0.7, 0.18, 0.08, 0.04][:branch], np.float64)
        self.p = p / p.sum()
        self.branch = branch

    def sample(self, batch: int, seq_len: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        toks = np.empty((batch, seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq_len):
            nxt = self.table[toks[:, t]]                       # (B, branch)
            choice = rng.choice(self.branch, size=batch, p=self.p)
            # occasional uniform noise keeps entropy non-zero
            noise = rng.random(batch) < 0.02
            rand = rng.integers(0, self.vocab, size=batch)
            toks[:, t + 1] = np.where(noise, rand,
                                      nxt[np.arange(batch), choice])
        return toks

    def batches(self, batch: int, seq_len: int, steps: int, seed: int = 0):
        for i in range(steps):
            toks = self.sample(batch, seq_len, seed=seed + i)
            yield {"tokens": toks[:, :-1].astype(np.int32),
                   "labels": toks[:, 1:].astype(np.int32)}
