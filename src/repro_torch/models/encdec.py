"""Encoder-decoder transformer (seamless-m4t-medium backbone); port of
``repro.models.encdec``.

The audio frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings (B, M, frontend_dim), and a linear
``frontend_proj`` maps them to d_model.  The encoder is bidirectional (the
paper's published setting for LLN attention: with ``lln`` / ``lln_diag``
it runs the bidirectional LLN form and a non-causal block-diagonal
softmax).  The decoder has causal self-attention through the engine and
softmax cross-attention over the encoder output (the ``ck`` / ``cv``
cache of each layer), which the paper does not linearize.  Standard RoPE
stands in for the released checkpoints' relative positions, as in the
reference.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.attention import flash_softmax
from repro_torch.distributed.sharding import constrain, split_heads
from .attention_block import (Attention, attn_apply, serve_decode,
                              serve_prefill, serve_state_init)
from .layers import (MLP, Norm, _dense_param, apply_mlp, apply_norm, dense,
                     embed_lookup, logits_from_hidden, trunc_normal)
from .transformer import _remat


class EncBlock(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = Attention(cfg, dtype, device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device,
                       generator)


class DecBlock(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = Attention(cfg, dtype, device, generator)
        self.ln_x = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.cross = Attention(cfg, dtype, device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device,
                       generator)


class EncDec(nn.Module):
    """Parameters of the encoder-decoder (random init from ``generator``),
    named as the reference's pytree."""

    def __init__(self, cfg, device, generator=None):
        super().__init__()
        dtype, d = cfg.pdtype, cfg.d_model
        self.frontend_proj = _dense_param(cfg.frontend_dim, d, dtype, device,
                                          generator)
        self.embed_table = nn.Parameter(
            trunc_normal((cfg.padded_vocab, d), d ** -0.5, dtype, device,
                         generator))
        self.enc_final_norm = Norm(d, cfg.norm, dtype, device)
        self.final_norm = Norm(d, cfg.norm, dtype, device)
        self.enc_layers = nn.ModuleList(
            EncBlock(cfg, dtype, device, generator)
            for _ in range(cfg.enc_layers))
        self.layers = nn.ModuleList(
            DecBlock(cfg, dtype, device, generator)
            for _ in range(cfg.n_layers))
        self.lm_head = nn.Parameter(
            trunc_normal((d, cfg.padded_vocab), d ** -0.5, dtype, device,
                         generator))

    @property
    def head(self) -> torch.Tensor:
        return self.lm_head


def encdec_init(cfg, device, seed: int = 0) -> EncDec:
    """Random parameters with the reference's shapes and names, drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    gen = None                 # seed None: an abstract init (FakeTensorMode)
    if seed is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    return EncDec(cfg, device, gen)


def _placed(x):
    """The residual stream by (batch, sequence, embed) on a mesh, as the
    transformer's blocks place it; ``x`` itself without a mesh."""
    return constrain(x, "act_batch", "act_seq", "embed")


def _enc_block(lp: EncBlock, x, cfg, positions):
    x = _placed(x)
    h = apply_norm(lp.ln1, x)
    x = x + attn_apply(lp.attn, h, cfg, positions, causal=False).to(x.dtype)
    h = apply_norm(lp.ln2, x)
    return x + apply_mlp(lp.mlp, h, cfg.cdtype).to(x.dtype)


def encode(p: EncDec, src_embed, cfg):
    """src_embed (B, M, frontend_dim) stub frame embeddings -> (B, M, D)."""
    x = dense(p.frontend_proj, src_embed, cfg.cdtype)
    positions = torch.arange(x.shape[1], device=x.device)
    block = _remat(_enc_block, cfg)
    for lp in p.enc_layers:
        x = block(lp, x, cfg, positions)
    return apply_norm(p.enc_final_norm, x)


def _dec_block(lp: DecBlock, x, cfg, positions, enc_out):
    x = _placed(x)
    h = apply_norm(lp.ln1, x)
    x = x + attn_apply(lp.attn, h, cfg, positions, causal=True).to(x.dtype)
    h = apply_norm(lp.ln_x, x)
    x = x + attn_apply(lp.cross, h, cfg, positions,
                       kv=enc_out).to(x.dtype)
    h = apply_norm(lp.ln2, x)
    return x + apply_mlp(lp.mlp, h, cfg.cdtype).to(x.dtype)


def encdec_hidden(p: EncDec, src_embed, tgt_tokens, cfg):
    """The decoder's final hidden states over the target tokens (B, N, D)
    and a zero aux loss."""
    enc_out = encode(p, src_embed, cfg)
    x = embed_lookup(p.embed_table, tgt_tokens, cfg.cdtype, cfg.embed_scale)
    positions = torch.arange(tgt_tokens.shape[1], device=x.device)
    block = _remat(_dec_block, cfg)
    for lp in p.layers:
        x = block(lp, x, cfg, positions, enc_out)
    x = apply_norm(p.final_norm, x)
    return x, torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------

def encdec_cache_init(p, cfg, batch: int, max_len: int, enc_len: int,
                      device=None) -> dict:
    """Per-layer decoder caches ``{"layers": [{"self": AttentionState,
    "ck", "cv"}, ...]}``: the self-attention state and the cross keys and
    values (B, enc_len, G, hd) in the compute dtype, on ``device`` (by
    default the parameters')."""
    if device is None:
        device = p.embed_table.device
    g, hd = cfg.n_kv_heads, cfg.hd

    def cross():
        return torch.zeros(batch, enc_len, g, hd, dtype=cfg.cdtype,
                           device=device)
    return {"layers": [{"self": serve_state_init(cfg, batch, max_len,
                                                 device),
                        "ck": cross(), "cv": cross()}
                       for _ in range(cfg.n_layers)]}


def _cross(lp: DecBlock, h, ck, cv, cfg):
    """Softmax cross-attention of ``h`` (B, N, d) over the cached encoder
    keys and values."""
    b, n, _ = h.shape
    q = split_heads(dense(lp.cross.q_w, h, cfg.cdtype), cfg.n_heads,
                    cfg.hd)
    q = constrain(q, "act_batch", "attn_seq", "heads", None)
    ck = constrain(ck, "act_batch", None, "kv_heads", None)
    cv = constrain(cv, "act_batch", None, "kv_heads", None)
    xa = flash_softmax(q, ck, cv, causal=False,
                       chunk=min(cfg.softmax_chunk, ck.shape[1]))
    return dense(lp.cross.o_w, xa.reshape(b, n, -1), cfg.cdtype)


@torch.inference_mode()
def encdec_prefill(p: EncDec, src_embed, tgt_tokens, cfg, max_len: int):
    """Encode the source and prefill the decoder over the target prefix;
    returns (last logits (B, 1, Vpad), caches)."""
    enc_out = encode(p, src_embed, cfg)
    x = embed_lookup(p.embed_table, tgt_tokens, cfg.cdtype, cfg.embed_scale)
    b, n = tgt_tokens.shape
    m = enc_out.shape[1]
    g, hd = cfg.n_kv_heads, cfg.hd
    positions = torch.arange(n, device=x.device)
    caches = []
    for lp in p.layers:
        x = _placed(x)
        h = apply_norm(lp.ln1, x)
        a, self_cache = serve_prefill(lp.attn, h, cfg, positions,
                                      max_len=max_len)
        x = x + a.to(x.dtype)
        h = apply_norm(lp.ln_x, x)
        ck = split_heads(dense(lp.cross.k_w, enc_out, cfg.cdtype), g, hd)
        cv = split_heads(dense(lp.cross.v_w, enc_out, cfg.cdtype), g, hd)
        x = x + _cross(lp, h, ck, cv, cfg).to(x.dtype)
        h = apply_norm(lp.ln2, x)
        x = x + apply_mlp(lp.mlp, h, cfg.cdtype).to(x.dtype)
        caches.append({"self": self_cache, "ck": ck, "cv": cv})
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.lm_head, x[:, -1:], cfg.cdtype,
                                cfg.logit_softcap)
    return logits, {"layers": caches}


@torch.inference_mode()
def encdec_decode(p: EncDec, caches, token, cfg, position):
    """One decode step: token (B,) at ``position`` -> (logits (B, Vpad),
    caches).  A (B, T) chunk is refused, as in the reference."""
    if token.ndim != 1:
        raise NotImplementedError(
            "chunked (B, T) decode is not wired for the encdec family")
    x = embed_lookup(p.embed_table, token[:, None], cfg.cdtype,
                     cfg.embed_scale)
    new = []
    for lp, cache in zip(p.layers, caches["layers"]):
        x = _placed(x)
        h = apply_norm(lp.ln1, x)
        a, self_cache = serve_decode(lp.attn, h, cache["self"], cfg,
                                     position)
        x = x + a.to(x.dtype)
        h = apply_norm(lp.ln_x, x)
        x = x + _cross(lp, h, cache["ck"], cache["cv"], cfg).to(x.dtype)
        h = apply_norm(lp.ln2, x)
        x = x + apply_mlp(lp.mlp, h, cfg.cdtype).to(x.dtype)
        new.append({"self": self_cache, "ck": cache["ck"],
                    "cv": cache["cv"]})
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.lm_head, x, cfg.cdtype, cfg.logit_softcap)
    return logits[:, 0], {"layers": new}
