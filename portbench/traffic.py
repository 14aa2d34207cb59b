"""The one traffic generator: every mix is a data file of parameters that
this module reads (``portbench/traffic/<name>.json``).

A mix fixes the SET of request sizes and arrival gaps from its own
``sizes_seed``: one block of ``block`` requests, repeated.  ``--seed``
shuffles each copy of the block and draws the prompt tokens, so every
seed offers the same work in another order, and any stretch of a run's
requests holds about the same sizes whatever the seed.

Prompt tokens come from a Markov chain over the vocabulary (a frozen copy of
``repro_torch/data/pipeline.py::MarkovDataset``).  Lengths are log-normal
around the mix's median, clipped to its range.

Keys of a mix file:
  loop             "closed" (each client sends its next request when the
                   last one ends) or "open" (Poisson arrivals at a fixed
                   rate, independent of the system)
  clients          closed loop: concurrent callers
  rate_per_s       open loop: offered requests a second
  prompt, output   {"min", "max", "median", "sigma"}: token lengths
  sizes_seed       seed of the size set (and of the open loop's gaps)
  block            requests in the block of sizes the set repeats
  requests         size of the set (a multiple of ``block``); an open
                   loop's set spans requests / rate_per_s seconds, its
                   gaps scaled to a mean of exactly 1 / rate_per_s
  check_requests   served requests the reference re-runs after a run
  check_rows       bank rows whose draft heads the reference re-runs
  trace_slice_s    seconds of the window that ``--trace 1`` profiles
  drain_s          open loop: how long requests due in the window may take
                   to finish after it closes before they count as missing
"""
from __future__ import annotations

import dataclasses

import numpy as np

SEED_MASK = (1 << 63) - 1


class MarkovDataset:
    """Frozen copy of the port's synthetic token stream: an order-1 table
    of ``branch`` likely successors per token with skewed probabilities,
    plus 2% uniform noise."""

    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 4):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
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
            nxt = self.table[toks[:, t]]
            choice = rng.choice(self.branch, size=batch, p=self.p)
            noise = rng.random(batch) < 0.02
            rand = rng.integers(0, self.vocab, size=batch)
            toks[:, t + 1] = np.where(noise, rand,
                                      nxt[np.arange(batch), choice])
        return toks


def lengths(spec: dict, n: int, rng) -> np.ndarray:
    """``n`` log-normal lengths around ``median``, clipped to [min, max]."""
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], size=n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


@dataclasses.dataclass
class Offered:
    """One request the benchmark will send."""
    idx: int
    prompt: np.ndarray          # (S,) int32
    n_tokens: int               # output tokens asked for
    due: float                  # open loop: seconds after the window opens


def sizes(mix: dict):
    """The mix's block: prompt lengths, output lengths and (open loop)
    inter-arrival gaps, from ``sizes_seed`` alone."""
    rng = np.random.default_rng(mix["sizes_seed"])
    n = mix["block"]
    s = lengths(mix["prompt"], n, rng)
    o = lengths(mix["output"], n, rng)
    gaps = rng.exponential(1.0, size=n)
    return s, o, gaps / gaps.mean()


def offered(mix: dict, vocab: int, seed: int, n: int = None,
            stream: int = 0) -> list:
    """The run's requests: the mix's set (its block repeated), each copy
    of the block in an order ``seed`` draws, with prompt tokens from
    ``seed``.  ``stream`` picks an independent draw of the same seed."""
    s, o, gaps = sizes(mix)
    rng = np.random.default_rng([seed & SEED_MASK, stream])
    blk = len(s)
    n = mix["requests"] if n is None else n
    order = np.concatenate([rng.permutation(blk)
                            for _ in range(-(-n // blk))])[:n]
    s, o, gaps = s[order], o[order], gaps[order]
    data = MarkovDataset(vocab, seed=int(rng.integers(1 << 31)))
    toks = data.sample(n, int(s.max()), seed=int(rng.integers(1 << 31)))
    rate = mix.get("rate_per_s")
    due = np.cumsum(gaps / rate) - gaps[0] / rate if rate else np.zeros(n)
    return [Offered(idx=i, prompt=toks[i, :s[i]].astype(np.int32),
                    n_tokens=int(o[i]), due=float(due[i]))
            for i in range(n)]


def max_context(mix: dict) -> int:
    return int(mix["prompt"]["max"] + mix["output"]["max"])
