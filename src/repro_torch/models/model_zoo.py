"""build_model(cfg) -> Model: the port's uniform interface per family.

The dense decoder (yi-9b) and the bidirectional encoder (roberta-lln) are
ported; other families raise.  Batch convention: ``{"inputs" (B,N),
"targets" (B,N), "mask" (B,N)}`` int64 tokens in [0, vocab) (for the
encoder's MLM batches the targets are the original tokens and the mask
the masked positions).

``loss``: params, batch -> scalar (chunked xent + router aux);
``hidden``: params, batch -> (final hidden (B,N,D), aux);
``prefill`` / ``decode`` / ``cache_init``: the serving path (the encoder
has none and raises).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from . import encoder as enc
from . import transformer as tr
from .layers import chunked_xent


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable            # seed -> params (an nn.Module on ``device``)
    loss: Callable            # params, batch -> scalar loss
    hidden: Callable          # params, batch -> (hidden, aux)
    prefill: Callable         # params, batch -> (last logits, caches)
    decode: Callable          # params, caches, token, position -> (logits, caches)
    cache_init: Callable      # params, batch size -> caches
    param_count: Callable


def _xent_loss(cfg, h, head, batch):
    return chunked_xent(h, head, batch["targets"], batch["mask"],
                        vocab=cfg.vocab, dtype=cfg.cdtype,
                        softcap=cfg.logit_softcap)


def _count(params) -> int:
    return int(sum(p.numel() for p in params.parameters()))


def build_model(cfg: ArchConfig, device=None) -> Model:
    """The interface of ``cfg`` on ``device`` (the CUDA card unless the
    caller asks for another device)."""
    dev = resolve_device(device)
    if cfg.family not in ("dense", "encoder") or cfg.qk_norm:
        raise NotImplementedError(
            f"family {cfg.family!r} (qk_norm={cfg.qk_norm}) is not ported "
            "yet; see ROADMAP.md queue 1")
    if cfg.family == "encoder":
        def mlm_loss(params, batch):
            h, _ = enc.encoder_hidden(params, batch["inputs"], cfg)
            return _xent_loss(cfg, h, params.lm_head, batch)

        def no_serve(*a, **k):
            raise NotImplementedError("encoder-only models have no decode "
                                      "step")

        return Model(
            cfg=cfg, device=dev,
            init=lambda seed=0: enc.encoder_init(cfg, dev, seed),
            loss=mlm_loss,
            hidden=lambda params, batch: enc.encoder_hidden(
                params, batch["inputs"], cfg),
            prefill=no_serve, decode=no_serve, cache_init=no_serve,
            param_count=_count)

    def loss(params, batch):
        h, aux = tr.lm_hidden(params, batch["inputs"], cfg)
        return (_xent_loss(cfg, h, tr.lm_head_of(params), batch)
                + cfg.router_aux_coef * aux)

    return Model(
        cfg=cfg, device=dev,
        init=lambda seed=0: tr.lm_init(cfg, dev, seed),
        loss=loss,
        hidden=lambda params, batch: tr.lm_hidden(params, batch["inputs"],
                                                  cfg),
        prefill=lambda params, batch: tr.lm_prefill(params, batch["inputs"],
                                                    cfg),
        decode=lambda params, caches, token, pos: tr.lm_decode(
            params, caches, token, cfg, pos),
        cache_init=lambda params, b: tr.lm_cache_init(params, cfg, b),
        param_count=_count)


def synthetic_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                    text_seq: Optional[int] = None,
                    device=None) -> dict[str, Any]:
    """Deterministic synthetic token batch from a numpy generator."""
    n = text_seq if text_seq is not None else seq
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, n + 1)))
    toks = toks.to(resolve_device(device))
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:],
            "mask": torch.ones(batch, n, device=toks.device)}
