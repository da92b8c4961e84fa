"""Decoder-only transformer LM, dense family (port of
``repro.models.transformer``: the training forward and the serving path).

The reference stacks layers along a leading axis and runs them with
``lax.scan`` under ``jax.checkpoint``; here the layers are a ``ModuleList``
and a Python loop, each block under ``torch.utils.checkpoint`` when
``cfg.remat`` is ``"full"`` or ``"dots"`` (a selective checkpoint that
keeps the matrix products' outputs).  Parameter names match the reference pytree
(``embed.table``, ``final_norm``, ``layers[i].{ln1, ln2, attn, mlp}``,
``lm_head``) so ``convert.py`` is a copy.  The speculative verify's
single pass is :func:`lm_score` (a ``commit_len=0`` decode that returns the
layers' (k, v)) and :func:`lm_commit` (the fold of the accepted prefix).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention_block import (Attention, attn_apply, serve_commit,
                              serve_decode, serve_prefill, serve_state_init)
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


# The products ``remat="dots"`` keeps: matrix products without batch
# dimensions (the reference's ``dots_with_no_batch_dims_saveable``).
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, cfg):
    """``fn`` under the config's rematerialization: ``none``; ``full``
    (keep the inputs, recompute everything in the backward); ``dots``
    (keep the outputs of the matrix products without batch dimensions,
    recompute everything else, the kernels' autograd Functions included)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=_dots_context)
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


def block_prefill(p: Block, x, cfg, positions, max_len: int):
    h = apply_norm(p.ln1, x)
    attn_out, cache = serve_prefill(p.attn, h, cfg, positions,
                                    max_len=max_len)
    x = x + attn_out.to(x.dtype)
    h = apply_norm(p.ln2, x)
    return x + apply_mlp(p.mlp, h, cfg.cdtype).to(x.dtype), cache


def block_decode(p: Block, x, cache, cfg, position, *, row_mask=None,
                 commit_len=None):
    h = apply_norm(p.ln1, x)
    attn_out, cache = serve_decode(p.attn, h, cache, cfg, position,
                                   row_mask=row_mask, commit_len=commit_len)
    x = x + attn_out.to(x.dtype)
    h = apply_norm(p.ln2, x)
    return x + apply_mlp(p.mlp, h, cfg.cdtype).to(x.dtype), cache


def block_score(p: Block, x, cache, cfg, position, *, row_mask=None):
    """The speculative score pass over one block: a ``commit_len=0`` decode
    that leaves ``cache`` as it was and returns the attention layer's
    ``{"k", "v"}`` commit residuals beside the activations."""
    h = apply_norm(p.ln1, x)
    zeros = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    attn_out, _, resid = serve_decode(p.attn, h, cache, cfg, position,
                                      row_mask=row_mask, commit_len=zeros,
                                      return_residuals=True)
    x = x + attn_out.to(x.dtype)
    h = apply_norm(p.ln2, x)
    return x + apply_mlp(p.mlp, h, cfg.cdtype).to(x.dtype), resid


def lm_cache_init(p: DenseLM, cfg, batch: int, max_len: int,
                  per_row: bool = False, device=None) -> dict:
    """Per-layer decode states, ``{"layers": [AttentionState, ...]}``
    (softmax KV caches of ``max_len`` positions).  The state is always per
    row ((B,) ``len``/``pos``, (B, H) alpha/beta; the static lockstep batch
    is the degenerate case), so ``per_row`` is accepted, as the
    reference's is, and changes nothing.  The caches go on ``device``,
    by default the parameters'."""
    del per_row
    if device is None:
        device = p.embed_table.device
    return {"layers": [serve_state_init(cfg, batch, max_len, device)
                       for _ in range(cfg.n_layers)]}


@torch.inference_mode()
def lm_prefill(p: DenseLM, tokens, cfg, max_len: int):
    """Prompt forward.  Returns (last-position logits (B, 1, Vpad),
    caches); softmax KV caches hold ``max(max_len, N)`` positions."""
    x = embed_lookup(p.embed_table, tokens, cfg.cdtype, cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)
    caches = []
    for lp in p.layers:
        x, cache = block_prefill(lp, x, cfg, positions, max_len)
        caches.append(cache)
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.head, x[:, -1:], cfg.cdtype,
                                cfg.logit_softcap)
    return logits, {"layers": caches}


#: Full target passes per config name: :func:`lm_decode` and
#: :func:`lm_score` each add one per call (the speculative loop's audit of
#: target passes per emitted token).
DECODE_PASS_COUNTS: dict = {}


def _count_pass(cfg):
    """Count one full decode pass of ``cfg``.  The reference counts traces
    (its decode is jitted, so a count is a compiled pass); the port runs
    eagerly, so this counts calls."""
    DECODE_PASS_COUNTS[cfg.name] = DECODE_PASS_COUNTS.get(cfg.name, 0) + 1


@torch.inference_mode()
def lm_decode(p: DenseLM, caches, token, cfg, position, row_mask=None,
              commit_len=None):
    """Decode step.  token: (B,) or (B, T) int; ``position`` the absolute
    index of the first new token, an int or a per-row (B,) tensor.
    ``row_mask`` (B,) bool: masked rows leave every cache untouched (their
    logits are to be discarded).  ``commit_len`` (B,) int in [0, T]: logits
    cover all T positions, every layer folds only the accepted prefix
    (0 is the masked row).  Returns logits (B, Vpad) for (B,) input,
    (B, T, Vpad) for chunked input, and the new caches."""
    single = token.ndim == 1
    _count_pass(cfg)
    toks = token[:, None] if single else token
    x = embed_lookup(p.embed_table, toks, cfg.cdtype, cfg.embed_scale)
    new = []
    for lp, cache in zip(p.layers, caches["layers"]):
        x, cache = block_decode(lp, x, cache, cfg, position,
                                row_mask=row_mask, commit_len=commit_len)
        new.append(cache)
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.head, x, cfg.cdtype, cfg.logit_softcap)
    return (logits[:, 0] if single else logits), {"layers": new}


@torch.inference_mode()
def lm_score(p: DenseLM, caches, token, cfg, position, row_mask=None):
    """The speculative score pass: logits for a (B, T) draft chunk without
    advancing the caches, and each layer's commit residuals.  Every layer
    decodes with ``commit_len=0``, which leaves its cache as it was; once
    the acceptance rule has given per-row commit lengths, :func:`lm_commit`
    folds the accepted prefix from the residuals (one full pass per verify
    instead of two).  Returns ``(logits (B, T, Vpad), residuals)``, the
    residuals ``{"layers": [{"k", "v"}, ...]}`` beside the caches."""
    _count_pass(cfg)
    x = embed_lookup(p.embed_table, token, cfg.cdtype, cfg.embed_scale)
    resids = []
    for lp, cache in zip(p.layers, caches["layers"]):
        x, resid = block_score(lp, x, cache, cfg, position,
                               row_mask=row_mask)
        resids.append(resid)
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.head, x, cfg.cdtype, cfg.logit_softcap)
    return logits, {"layers": resids}


@torch.inference_mode()
def lm_commit(caches, residuals, cfg, commit_len, row_mask=None):
    """Fold the accepted prefix of a scored chunk into every layer's cache,
    with no parameters: the residuals carry the post-RoPE (k, v) of the
    score pass, so the commit is one O(T d^2) fold per layer
    (``AttentionEngine.commit``), the same caches bit for bit as
    :func:`lm_decode` with this ``commit_len``.  Returns the new caches."""
    return {"layers": [serve_commit(c, r, cfg, commit_len=commit_len,
                                    row_mask=row_mask)
                       for c, r in zip(caches["layers"],
                                       residuals["layers"])]}
