"""Bidirectional encoder LM (RoBERTa-style): the paper's §5 setting.

Port of ``repro.models.encoder``: token embeddings, ``n_layers``
bidirectional blocks (``transformer.block_apply`` with ``causal=False``),
a final norm and the MLM head.  With ``lln`` / ``lln_diag`` the blocks run
the bidirectional LLN form (eq. 8), the paper's published configuration.
The parameters have the dense decoder's names (``embed_table``,
``layers[i].{ln1, attn, ln2, mlp}``, ``final_norm``) and always their own
``lm_head``, as the reference's ``encoder_init``.
"""
from __future__ import annotations

import functools

import torch

from .layers import apply_norm, embed_lookup, logits_from_hidden
from .transformer import DenseLM, _remat, block_apply


class Encoder(DenseLM):
    """Parameters of the encoder (random init from ``generator``)."""

    def __init__(self, cfg, device, generator=None):
        super().__init__(cfg.replace(tie_embeddings=False), device, generator)


def encoder_init(cfg, device, seed: int = 0) -> Encoder:
    """Random parameters with the reference's shapes and names, drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Encoder(cfg, device, gen)


def encoder_hidden(p: Encoder, tokens, cfg):
    """Token ids (B, N) -> final hidden states (B, N, D) and a zero aux
    loss; every block attends over the whole sequence."""
    x = embed_lookup(p.embed_table, tokens, cfg.cdtype, cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)
    block = _remat(functools.partial(block_apply, causal=False), cfg)
    for lp in p.layers:
        x = block(lp, x, cfg, positions)
    x = apply_norm(p.final_norm, x)
    return x, torch.zeros((), device=x.device)


def encoder_logits(p: Encoder, tokens, cfg):
    h, aux = encoder_hidden(p, tokens, cfg)
    return logits_from_hidden(p.lm_head, h, cfg.cdtype,
                              cfg.logit_softcap), aux
