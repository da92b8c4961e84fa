"""Serving step builders (port of the serving half of
``repro.launch.steps``).

The reference jits its steps and folds generation into one ``lax.scan``;
here PyTorch runs eagerly and generation is a Python loop of decode steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import Model, build_model


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature == 0: argmax over the padded vocab, first index
    on ties) or temperature sampling."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


@dataclasses.dataclass
class ServeSetup:
    """Serving entry points for one (cfg, batch shape) on one device.

    ``prefill_fn(params, batch) -> (last logits, caches)``;
    ``decode_fn(params, caches, token, pos) -> (logits, caches)``;
    ``make_generate(steps, temperature)`` returns
    ``gen(params, caches, tok, pos0, generator) -> (tokens (B, steps),
    caches)``, a loop of ``steps`` decode steps starting from token ``tok``
    at absolute position ``pos0``.  All rows advance in lockstep.
    """
    model: Model
    prefill_fn: Any
    decode_fn: Any
    make_generate: Any
    batch: int
    seq_len: int

    @property
    def device(self) -> torch.device:
        return self.model.device


def make_serve_setup(cfg: ArchConfig, shape: ShapeSpec,
                     device=None) -> ServeSetup:
    """Serving steps for ``cfg`` at ``shape`` on ``device`` (the CUDA card
    unless the caller asks for another device)."""
    model = build_model(cfg, device)

    def make_generate(steps: int, temperature: float = 0.0):
        def gen(params, caches, tok, pos0: int, generator=None):
            toks = []
            for i in range(steps):
                logits, caches = model.decode(params, caches, tok, pos0 + i)
                tok = sample_token(logits, temperature, generator)
                toks.append(tok)
            return torch.stack(toks, 1), caches
        return gen

    return ServeSetup(model=model, prefill_fn=model.prefill,
                      decode_fn=model.decode, make_generate=make_generate,
                      batch=shape.global_batch, seq_len=shape.seq_len)
