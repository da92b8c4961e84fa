"""Decoder-only transformer LM, dense family (port of
``repro.models.transformer``: the training forward and the serving path).

The reference stacks layers along a leading axis and runs them with
``lax.scan`` under ``jax.checkpoint``; here the layers are a ``ModuleList``
and a Python loop, each block under ``torch.utils.checkpoint`` when
``cfg.remat == "full"``.  Parameter names match the reference pytree
(``embed.table``, ``final_norm``, ``layers[i].{ln1, ln2, attn, mlp}``,
``lm_head``) so ``convert.py`` is a copy.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention_block import (Attention, attn_apply, serve_decode,
                              serve_prefill, serve_state_init)
from .layers import (MLP, Norm, apply_mlp, apply_norm, embed_lookup,
                     logits_from_hidden, trunc_normal)


class Block(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = Attention(cfg, dtype, device, generator)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device,
                       generator)


class DenseLM(nn.Module):
    """Parameters of a dense decoder LM (random init from ``generator``)."""

    def __init__(self, cfg, device, generator=None):
        super().__init__()
        dtype = cfg.pdtype
        self.embed_table = nn.Parameter(
            trunc_normal((cfg.padded_vocab, cfg.d_model), cfg.d_model ** -0.5,
                         dtype, device, generator))
        self.final_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.layers = nn.ModuleList(
            Block(cfg, dtype, device, generator) for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                trunc_normal((cfg.d_model, cfg.padded_vocab),
                             cfg.d_model ** -0.5, dtype, device, generator))

    @property
    def head(self) -> torch.Tensor:
        return self.lm_head if hasattr(self, "lm_head") else self.embed_table.T


def lm_init(cfg, device, seed: int = 0) -> DenseLM:
    """Random parameters with the reference's shapes and names, drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device`` (the values
    differ from the reference's ``jax.random`` init)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return DenseLM(cfg, device, gen)


def block_apply(p: Block, x, cfg, positions, *, causal: bool = True):
    """One block of the training forward: x + attn(ln1 x), then + mlp."""
    h = apply_norm(p.ln1, x)
    x = x + attn_apply(p.attn, h, cfg, positions, causal=causal).to(x.dtype)
    h = apply_norm(p.ln2, x)
    return x + apply_mlp(p.mlp, h, cfg.cdtype).to(x.dtype)


def _remat(fn, cfg):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save the matmul outputs) is not ported yet; see "
            "ROADMAP.md queue 1, item 7")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def lm_head_of(p: DenseLM) -> torch.Tensor:
    return p.head


def lm_hidden(p: DenseLM, tokens, cfg):
    """Token ids (B, N) -> final hidden states (B, N, D) and the MoE aux
    loss (0 for the dense family)."""
    x = embed_lookup(p.embed_table, tokens, cfg.cdtype, cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)
    block = _remat(block_apply, cfg)
    for lp in p.layers:
        x = block(lp, x, cfg, positions)
    x = apply_norm(p.final_norm, x)
    return x, torch.zeros((), device=x.device)


def lm_logits(p: DenseLM, tokens, cfg):
    h, aux = lm_hidden(p, tokens, cfg)
    return logits_from_hidden(lm_head_of(p), h, cfg.cdtype,
                              cfg.logit_softcap), aux


def block_prefill(p: Block, x, cfg, positions):
    h = apply_norm(p.ln1, x)
    attn_out, cache = serve_prefill(p.attn, h, cfg, positions)
    x = x + attn_out.to(x.dtype)
    h = apply_norm(p.ln2, x)
    return x + apply_mlp(p.mlp, h, cfg.cdtype).to(x.dtype), cache


def block_decode(p: Block, x, cache, cfg, position: int):
    h = apply_norm(p.ln1, x)
    attn_out, cache = serve_decode(p.attn, h, cache, cfg, position)
    x = x + attn_out.to(x.dtype)
    h = apply_norm(p.ln2, x)
    return x + apply_mlp(p.mlp, h, cfg.cdtype).to(x.dtype), cache


def lm_cache_init(p: DenseLM, cfg, batch: int) -> dict:
    """Per-layer decode states, ``{"layers": [AttentionState, ...]}``."""
    device = p.embed_table.device
    return {"layers": [serve_state_init(cfg, batch, device)
                       for _ in range(cfg.n_layers)]}


@torch.inference_mode()
def lm_prefill(p: DenseLM, tokens, cfg):
    """Prompt forward.  Returns (last-position logits (B, 1, Vpad),
    caches)."""
    x = embed_lookup(p.embed_table, tokens, cfg.cdtype, cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)
    caches = []
    for lp in p.layers:
        x, cache = block_prefill(lp, x, cfg, positions)
        caches.append(cache)
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.head, x[:, -1:], cfg.cdtype,
                                cfg.logit_softcap)
    return logits, {"layers": caches}


@torch.inference_mode()
def lm_decode(p: DenseLM, caches, token, cfg, position: int):
    """Decode step.  token: (B,) or (B, T) int; ``position`` the absolute
    index of the first new token.  Returns logits (B, Vpad) for (B,) input,
    (B, T, Vpad) for chunked input, and the new caches."""
    single = token.ndim == 1
    toks = token[:, None] if single else token
    x = embed_lookup(p.embed_table, toks, cfg.cdtype, cfg.embed_scale)
    new = []
    for lp, cache in zip(p.layers, caches["layers"]):
        x, cache = block_decode(lp, x, cache, cfg, position)
        new.append(cache)
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.head, x, cfg.cdtype, cfg.logit_softcap)
    return (logits[:, 0] if single else logits), {"layers": new}
