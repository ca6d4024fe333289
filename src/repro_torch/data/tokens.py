"""Synthetic LM token pipeline (a copy of ``repro.data.tokens``).

``MarkovCorpus`` samples from a fixed random bigram chain, so a trained LM
can push loss well below uniform entropy: a real learning signal without
external datasets.  Numpy only, so both packages draw the same tokens from
the same seed.
"""
from __future__ import annotations

import numpy as np


class MarkovCorpus:
    """Order-1 Markov token stream with a skewed transition matrix."""

    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 8):
        self.vocab = vocab_size
        rng = np.random.RandomState(seed)
        # each token transitions to `branching` likely successors
        succ = rng.randint(0, vocab_size, size=(vocab_size, branching))
        probs = rng.dirichlet(np.ones(branching) * 0.5,
                              size=vocab_size)
        self.succ = succ
        self.probs = probs.astype(np.float64)
        self._rng = np.random.RandomState(seed + 1)

    def entropy_bound(self) -> float:
        """Per-token entropy of the chain (nats): the loss floor."""
        h = -np.sum(self.probs * np.log(np.maximum(self.probs, 1e-12)),
                    axis=1)
        return float(h.mean())

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len + 1), np.int32)
        state = self._rng.randint(0, self.vocab, size=batch)
        out[:, 0] = state
        for t in range(1, seq_len + 1):
            u = self._rng.rand(batch, 1)
            cdf = np.cumsum(self.probs[state], axis=1)
            choice = (u < cdf).argmax(axis=1)
            state = self.succ[state, choice]
            out[:, t] = state
        return out

    def batch(self, batch: int, seq_len: int) -> dict:
        toks = self.sample(batch, seq_len)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class UniformTokens:
    """i.i.d. uniform tokens (for pure-throughput runs)."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self._rng = np.random.RandomState(seed)

    def batch(self, batch: int, seq_len: int) -> dict:
        toks = self._rng.randint(0, self.vocab,
                                 size=(batch, seq_len + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
