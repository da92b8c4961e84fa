"""build_model(cfg) -> Model: the port's uniform serving interface.

Only the dense family is ported (yi-9b); other families raise.  Batch
convention: ``{"inputs" (B,N), "targets" (B,N), "mask" (B,N)}`` int64
tokens in [0, vocab).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from . import transformer as tr


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable            # seed -> params (a DenseLM on ``device``)
    prefill: Callable         # params, batch -> (last logits, caches)
    decode: Callable          # params, caches, token, position -> (logits, caches)
    cache_init: Callable      # params, batch size -> caches
    param_count: Callable


def _count(params) -> int:
    return int(sum(p.numel() for p in params.parameters()))


def build_model(cfg: ArchConfig, device=None) -> Model:
    """The serving interface of ``cfg`` on ``device`` (the CUDA card unless
    the caller asks for another device)."""
    dev = resolve_device(device)
    if cfg.family != "dense" or cfg.qk_norm:
        raise NotImplementedError(
            f"family {cfg.family!r} (qk_norm={cfg.qk_norm}) is not ported "
            "yet; see ROADMAP.md queue 1")
    return Model(
        cfg=cfg, device=dev,
        init=lambda seed=0: tr.lm_init(cfg, dev, seed),
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
