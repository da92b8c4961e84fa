"""Deterministic synthetic corpora (the port's own copy of
``repro.data.synthetic``'s numpy generators; no torch here).

:class:`MarkovCorpus` is a fixed random first-order Markov chain over the
vocabulary (seeded).  Its entropy rate is well below log(V), so models
learn on it.  :func:`lm_batches` yields causal-LM batches from it.  The
masked-LM batches come with the encoder slice.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class MarkovCorpus:
    vocab: int
    seed: int = 0
    branching: int = 32          # out-degree of each state (entropy knob)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        nexts = rng.integers(0, self.vocab, size=(self.vocab, self.branching))
        probs = rng.dirichlet(np.ones(self.branching) * 0.5,
                              size=self.vocab)
        self._nexts = nexts
        self._cum = np.cumsum(probs, axis=1)

    def sample(self, rng: np.random.Generator, batch: int,
               seq: int) -> np.ndarray:
        """(batch, seq) int32 token matrix."""
        out = np.empty((batch, seq), np.int32)
        state = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            out[:, t] = state
            u = rng.random(batch)
            choice = (self._cum[state] < u[:, None]).sum(axis=1)
            choice = np.minimum(choice, self.branching - 1)
            state = self._nexts[state, choice]
        return out


def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
               start_step: int = 0) -> Iterator[dict]:
    """Causal-LM batches: inputs/targets shifted by one, full mask."""
    corpus = MarkovCorpus(vocab)
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        toks = corpus.sample(rng, batch, seq + 1)
        yield {"inputs": toks[:, :-1], "targets": toks[:, 1:],
               "mask": np.ones((batch, seq), np.float32)}
        step += 1
