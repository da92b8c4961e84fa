"""Deterministic synthetic corpora (the port's own copy of
``repro.data.synthetic``'s numpy generators; no torch here).

:class:`MarkovCorpus` is a fixed random first-order Markov chain over the
vocabulary (seeded).  Its entropy rate is well below log(V), so models
learn on it.  :func:`lm_batches` yields causal-LM batches from it and
:func:`mlm_batches` the encoder's masked-LM batches; both draw from
``np.random.default_rng((seed, step))`` in the reference's order, so a batch
equals the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

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


def mlm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
                mask_rate: float = 0.15, mask_id: Optional[int] = None,
                start_step: int = 0) -> Iterator[dict]:
    """Masked-LM batches (the paper's §5 objective).  Of the masked
    positions (``mask_rate``), 80% become ``mask_id`` (default
    ``vocab - 1``), 10% a random token and 10% stay; the targets are the
    original tokens and the loss mask is the masked positions."""
    corpus = MarkovCorpus(vocab)
    mask_id = vocab - 1 if mask_id is None else mask_id
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        toks = corpus.sample(rng, batch, seq)
        is_masked = rng.random((batch, seq)) < mask_rate
        u = rng.random((batch, seq))
        inputs = toks.copy()
        inputs[is_masked & (u < 0.8)] = mask_id
        rand_pos = is_masked & (u >= 0.8) & (u < 0.9)
        inputs[rand_pos] = rng.integers(0, vocab, size=rand_pos.sum())
        yield {"inputs": inputs, "targets": toks,
               "mask": is_masked.astype(np.float32)}
        step += 1
