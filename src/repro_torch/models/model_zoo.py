"""build_model(cfg) -> Model: the port's uniform interface per family.

Every family of the reference: the dense decoders (yi-9b, qwen3-14b with
qk-norm, stablelm-1.6b, chatglm3-6b), the MoE decoders (qwen3-moe-235b-a22b,
and deepseek-v2-236b with MLA), the encoder-decoder (seamless-m4t-medium),
the VLM (paligemma-3b), the bidirectional encoder (roberta-lln) and the SSM
/ hybrid LMs (mamba2-130m, zamba2-7b).  Batch convention: ``{"inputs"
(B,N), "targets" (B,N), "mask" (B,N)}`` int64 tokens in [0, vocab) (for
the encoder's MLM batches the targets are the original tokens and the mask
the masked positions); the encoder-decoder adds ``"src"`` (B,M,
frontend_dim) and the VLM ``"patches"`` (B,P, frontend_dim), float.

``loss``: params, batch -> scalar (chunked xent + router aux);
``hidden``: params, batch -> (final hidden (B,N,D), aux);
``prefill``: params, batch, max_len -> (last logits (B, 1, Vpad),
caches); ``decode``: params, caches, token (B,) or (B, T), position,
optionally ``row_mask`` / ``commit_len`` (the serving contract of
``AttentionEngine.decode``) -> (logits, caches); ``cache_init``: params,
batch size, max_len (and ``per_row``, accepted as in the reference: the
port's states are always per row) -> zeroed caches on the model's device
(the params may be None).  ``max_len`` sizes softmax KV caches; the LLN
impls and the SSM layers ignore it.  The encoder has no serving path and
raises.  The dense and MoE decoders (not MLA) also have ``score`` and
``commit``, the two halves of the speculative verify; :func:`draft_config`
and :func:`draft_params` give the tied first-k-layers draft.  The
encoder-decoder and the VLM decode one token at a time and take no
``row_mask`` / ``commit_len``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from . import encdec as ed
from . import encoder as enc
from . import hybrid as hy
from . import transformer as tr
from . import vlm as vl
from .layers import chunked_xent


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable            # seed -> params (an nn.Module on ``device``)
    loss: Callable            # params, batch -> scalar loss
    hidden: Callable          # params, batch -> (hidden, aux)
    prefill: Callable         # params, batch, max_len -> (last logits, caches)
    decode: Callable          # params, caches, token, position -> (logits, caches)
    cache_init: Callable      # params, batch size, max_len -> caches
    param_count: Callable
    # Speculative decoding (dense and MoE, not MLA; None elsewhere): ``score`` =
    # logits and per-layer (k, v) residuals without advancing the caches,
    # ``commit`` = the parameter-free O(T d^2) fold of the accepted prefix
    # (transformer.py:lm_score / lm_commit).
    score: Optional[Callable] = None
    commit: Optional[Callable] = None


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
    if cfg.family not in ("dense", "moe", "mla_moe", "encoder", "ssm",
                          "hybrid", "encdec", "vlm"):
        raise ValueError(f"unknown family: {cfg.family}")
    if cfg.family == "encdec":
        def ed_hidden(params, batch):
            return ed.encdec_hidden(params, batch["src"], batch["inputs"],
                                    cfg)

        return Model(
            cfg=cfg, device=dev,
            init=lambda seed=0: ed.encdec_init(cfg, dev, seed),
            loss=lambda params, batch: _xent_loss(
                cfg, ed_hidden(params, batch)[0], params.lm_head, batch),
            hidden=ed_hidden,
            prefill=lambda params, batch, max_len: ed.encdec_prefill(
                params, batch["src"], batch["inputs"], cfg, max_len),
            decode=lambda params, caches, token, pos: ed.encdec_decode(
                params, caches, token, cfg, pos),
            cache_init=lambda params, b, max_len: ed.encdec_cache_init(
                params, cfg, b, max_len, enc_len=max_len, device=dev),
            param_count=_count)

    if cfg.family == "vlm":
        def vl_hidden(params, batch):
            return vl.vlm_hidden(params, batch["patches"], batch["inputs"],
                                 cfg)

        return Model(
            cfg=cfg, device=dev,
            init=lambda seed=0: vl.vlm_init(cfg, dev, seed),
            loss=lambda params, batch: _xent_loss(
                cfg, vl_hidden(params, batch)[0], tr.lm_head_of(params),
                batch),
            hidden=vl_hidden,
            prefill=lambda params, batch, max_len: vl.vlm_prefill(
                params, batch["patches"], batch["inputs"], cfg, max_len),
            decode=lambda params, caches, token, pos: vl.vlm_decode(
                params, caches, token, cfg, pos),
            cache_init=lambda params, b, max_len: vl.vlm_cache_init(
                params, cfg, b, max_len, device=dev),
            param_count=_count)

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

    if cfg.family in ("ssm", "hybrid"):
        def hidden(params, batch):
            return hy.hybrid_hidden(params, batch["inputs"], cfg)

        return Model(
            cfg=cfg, device=dev,
            init=lambda seed=0: hy.hybrid_init(cfg, dev, seed),
            loss=lambda params, batch: _xent_loss(
                cfg, hidden(params, batch)[0], params.head, batch),
            hidden=hidden,
            prefill=lambda params, batch, max_len: hy.hybrid_prefill(
                params, batch["inputs"], cfg, max_len),
            decode=lambda params, caches, token, pos, row_mask=None,
            commit_len=None: hy.hybrid_decode(
                params, caches, token, cfg, pos, row_mask=row_mask,
                commit_len=commit_len),
            cache_init=lambda params, b, max_len, per_row=False:
            hy.hybrid_cache_init(params, cfg, b, max_len, per_row, dev),
            param_count=_count)

    def loss(params, batch):
        h, aux = tr.lm_hidden(params, batch["inputs"], cfg)
        return (_xent_loss(cfg, h, tr.lm_head_of(params), batch)
                + cfg.router_aux_coef * aux)

    mla = cfg.kv_lora > 0
    return Model(
        cfg=cfg, device=dev,
        init=lambda seed=0: tr.lm_init(cfg, dev, seed),
        loss=loss,
        hidden=lambda params, batch: tr.lm_hidden(params, batch["inputs"],
                                                  cfg),
        prefill=lambda params, batch, max_len: tr.lm_prefill(
            params, batch["inputs"], cfg, max_len),
        decode=lambda params, caches, token, pos, row_mask=None,
        commit_len=None: tr.lm_decode(params, caches, token, cfg, pos,
                                      row_mask, commit_len),
        cache_init=lambda params, b, max_len, per_row=False:
        tr.lm_cache_init(params, cfg, b, max_len, per_row, dev),
        param_count=_count,
        score=None if mla else (
            lambda params, caches, token, pos, row_mask=None: tr.lm_score(
                params, caches, token, cfg, pos, row_mask)),
        commit=None if mla else (
            lambda caches, resid, commit_len, row_mask=None: tr.lm_commit(
                caches, resid, cfg, commit_len, row_mask)))


# ---------------------------------------------------------------------------
# Speculative decoding: the tied first-k-layers draft model.
# ---------------------------------------------------------------------------

def draft_config(cfg: ArchConfig, draft_layers: int = 0) -> ArchConfig:
    """The draft model's config: the target cut to its first
    ``draft_layers`` blocks (embedding, final norm and LM head shared), the
    early-exit draft of draft-then-verify decoding.  ``draft_layers``
    defaults to ``cfg.draft_layers``; at ``cfg.n_layers`` it is the tied
    full model (every draft accepted)."""
    k = draft_layers or cfg.draft_layers
    if not 1 <= k <= cfg.n_layers:
        raise ValueError(f"draft_layers must be in [1, {cfg.n_layers}], "
                         f"got {k}")
    if cfg.family not in ("dense", "moe") or cfg.first_dense_layers:
        raise NotImplementedError(
            "first-k-layers draft supports dense/moe decoders without "
            f"first_dense_layers (family={cfg.family})")
    return cfg.replace(name=f"{cfg.name}-draft{k}", n_layers=k)


def draft_params(params, cfg: ArchConfig, draft_layers: int = 0):
    """The draft's parameters: a ``DenseLM`` whose ``layers`` are the
    target's first k blocks and whose embedding, final norm and head are
    the target's, the same ``nn.Parameter`` objects (no copy: the draft is
    tied to the target and has no weights of its own)."""
    k = draft_layers or cfg.draft_layers
    draft_config(cfg, k)                 # validates k and the family
    view = tr.DenseLM.__new__(tr.DenseLM)
    torch.nn.Module.__init__(view)
    view.embed_table = params.embed_table
    view.final_norm = params.final_norm
    view.layers = torch.nn.ModuleList(list(params.layers)[:k])
    if hasattr(params, "lm_head"):
        view.lm_head = params.lm_head
    return view


def synthetic_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                    text_seq: Optional[int] = None,
                    device=None) -> dict[str, Any]:
    """Deterministic synthetic batch with the family's inputs, from a numpy
    generator: tokens, and ``src`` (B, seq, frontend_dim) frames for the
    encoder-decoder or ``patches`` (B, num_prefix_tokens, frontend_dim)
    for the VLM, standard normal fp32.  As in the reference, the VLM's
    text is ``max(seq - num_prefix_tokens, 8)`` tokens long whatever
    ``text_seq`` says."""
    n = text_seq if text_seq is not None else seq
    if cfg.family == "vlm":
        n = max(seq - cfg.num_prefix_tokens, 8)
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, n + 1)))
    toks = toks.to(dev)
    out = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
           "mask": torch.ones(batch, n, device=dev)}
    if cfg.family == "encdec":
        out["src"] = torch.from_numpy(rng.standard_normal(
            (batch, seq, cfg.frontend_dim), np.float32)).to(dev)
    if cfg.family == "vlm":
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.num_prefix_tokens, cfg.frontend_dim),
            np.float32)).to(dev)
    return out
