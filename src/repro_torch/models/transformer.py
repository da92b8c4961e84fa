"""Decoder-only transformer LM, the dense and MoE families (port of
``repro.models.transformer``: the training forward and the serving path).
A block's attention is standard (``attention_block.py``) or, with
``cfg.kv_lora > 0``, MLA (``mla.py``); its FFN a dense MLP or, in the MoE
family, a routed MoE (``moe.py``), whose aux loss ``lm_hidden`` sums.
deepseek-v2 keeps a dense FFN in its first ``first_dense_layers`` blocks
(``first_layers``).  ``prefix_embed`` prepends a continuous prefix (a
VLM's patches) under a prefix-LM mask.

The reference stacks layers along a leading axis and runs them with
``lax.scan`` under ``jax.checkpoint``; here the layers are a ``ModuleList``
and a Python loop, each block under ``torch.utils.checkpoint`` when
``cfg.remat`` is ``"full"`` or ``"dots"`` (a selective checkpoint that
keeps the matrix products' outputs).  Parameter names match the reference pytree
(``embed.table``, ``final_norm``, ``first_layers[i]`` and
``layers[i].{ln1, ln2, attn, mlp | moe}``, ``lm_head``) so ``convert.py``
is a copy.  The speculative verify's
single pass is :func:`lm_score` (a ``commit_len=0`` decode that returns the
layers' (k, v)) and :func:`lm_commit` (the fold of the accepted prefix).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import constrain, replicated_like

from . import mla as mla_mod
from .attention_block import (Attention, attn_apply, serve_commit,
                              serve_decode, serve_prefill, serve_state_init)
from .layers import (MLP, Norm, apply_mlp, apply_norm, embed_lookup,
                     logits_from_hidden, trunc_normal)
from .moe import MoE, moe_apply


def _use_mla(cfg) -> bool:
    return cfg.kv_lora > 0


def _layer_groups(cfg):
    """(dense first layers, main layers, whether the main ones are MoE)."""
    is_moe = cfg.n_experts > 0
    first = cfg.first_dense_layers if is_moe else 0
    return first, cfg.n_layers - first, is_moe


class Block(nn.Module):
    """ln1, the attention (``attn``: standard or MLA), ln2 and the FFN
    (``mlp``, or ``moe`` with ``use_moe``)."""

    def __init__(self, cfg, dtype, device, generator, use_moe: bool = False):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = (mla_mod.MLA if _use_mla(cfg) else Attention)(
            cfg, dtype, device, generator)
        if use_moe:
            self.moe = MoE(cfg, dtype, device, generator)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device,
                           generator)


def block_init(cfg, device, generator=None, *, use_moe: bool) -> Block:
    return Block(cfg, cfg.pdtype, device, generator, use_moe)


class DenseLM(nn.Module):
    """Parameters of a decoder LM, dense or MoE (random init from
    ``generator``); ``first_layers`` holds deepseek-v2's dense first
    blocks."""

    def __init__(self, cfg, device, generator=None):
        super().__init__()
        dtype = cfg.pdtype
        first, n_main, is_moe = _layer_groups(cfg)
        self.embed_table = nn.Parameter(
            trunc_normal((cfg.padded_vocab, cfg.d_model), cfg.d_model ** -0.5,
                         dtype, device, generator))
        self.final_norm = Norm(cfg.d_model, cfg.norm, dtype, device)
        if first:
            self.first_layers = nn.ModuleList(
                Block(cfg, dtype, device, generator) for _ in range(first))
        self.layers = nn.ModuleList(
            Block(cfg, dtype, device, generator, is_moe)
            for _ in range(n_main))
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
    gen = None                 # seed None: an abstract init (FakeTensorMode)
    if seed is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    return DenseLM(cfg, device, gen)


def _ffn(p: Block, h, cfg):
    """The block's FFN on ``h``: (out, MoE aux loss or None)."""
    if hasattr(p, "moe"):
        return moe_apply(p.moe, h, cfg)
    return apply_mlp(p.mlp, h, cfg.cdtype), None


def block_apply(p: Block, x, cfg, positions, *, causal: bool = True,
                prefix_len: int = 0):
    """One block of the training forward: x + attn(ln1 x), then + the FFN.
    Returns (x, the MoE aux loss, 0 for a dense FFN)."""
    x = constrain(x, "act_batch", "act_seq", "embed")
    h = apply_norm(p.ln1, x)
    if _use_mla(cfg):
        attn_out = mla_mod.mla_apply(p.attn, h, cfg, positions, causal=causal)
    else:
        attn_out = attn_apply(p.attn, h, cfg, positions, causal=causal,
                              prefix_len=prefix_len)
    x = x + attn_out.to(x.dtype)
    h = apply_norm(p.ln2, x)
    ffn_out, aux = _ffn(p, h, cfg)
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return constrain(x + ffn_out.to(x.dtype), "act_batch", "act_seq",
                     "embed"), aux


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


def _groups(p: DenseLM):
    """(cache key, blocks) per layer group in order: deepseek-v2's dense
    ``first_layers``, then ``layers``."""
    if hasattr(p, "first_layers"):
        yield "first_layers", p.first_layers
    yield "layers", p.layers


def _embed(p: DenseLM, tokens, cfg, prefix_embed):
    """Token embeddings with the optional continuous prefix before them;
    returns (x, prefix_len)."""
    x = embed_lookup(p.embed_table, tokens, cfg.cdtype, cfg.embed_scale)
    if prefix_embed is None:
        return x, 0
    return torch.cat([prefix_embed.to(x.dtype), x], 1), prefix_embed.shape[1]


def lm_hidden(p: DenseLM, tokens, cfg, *, prefix_embed=None):
    """Token ids (B, N) -> final hidden states (B, N, D) and the MoE aux
    loss summed over the layers (0 for the dense family).
    ``prefix_embed``: an optional (B, M, D) continuous prefix (a VLM's
    patches) before the tokens, attended under a prefix-LM mask."""
    x, prefix_len = _embed(p, tokens, cfg, prefix_embed)
    positions = torch.arange(x.shape[1], device=x.device)
    block = _remat(functools.partial(block_apply, prefix_len=prefix_len),
                   cfg)
    aux = torch.zeros((), device=x.device)
    for _, blocks in _groups(p):
        for lp in blocks:
            x, a = block(lp, x, cfg, positions)
            aux = aux + a
    x = apply_norm(p.final_norm, x)
    return x, aux


def lm_logits(p: DenseLM, tokens, cfg, **kw):
    h, aux = lm_hidden(p, tokens, cfg, **kw)
    return logits_from_hidden(lm_head_of(p), h, cfg.cdtype,
                              cfg.logit_softcap), aux


def block_prefill(p: Block, x, cfg, positions, max_len: int,
                  prefix_len: int = 0):
    # On a mesh the serving blocks place x as the training blocks do (the
    # embedding leaves a partial sum over the vocab's mesh dim; GSPMD
    # would propagate the batch layout from the inputs).
    x = constrain(x, "act_batch", "act_seq", "embed")
    h = apply_norm(p.ln1, x)
    if _use_mla(cfg):
        attn_out, cache = mla_mod.mla_prefill(p.attn, h, cfg, positions,
                                              max_len=max_len)
    else:
        attn_out, cache = serve_prefill(p.attn, h, cfg, positions,
                                        prefix_len=prefix_len,
                                        max_len=max_len)
    x = x + attn_out.to(x.dtype)
    h = apply_norm(p.ln2, x)
    return x + _ffn(p, h, cfg)[0].to(x.dtype), cache


def block_decode(p: Block, x, cache, cfg, position, *, row_mask=None,
                 commit_len=None):
    x = constrain(x, "act_batch", "act_seq", "embed")
    h = apply_norm(p.ln1, x)
    if _use_mla(cfg):
        if row_mask is not None or commit_len is not None:
            raise NotImplementedError(
                "row-masked / partial-commit decode is not wired for MLA")
        attn_out, cache = mla_mod.mla_decode(p.attn, h, cache, cfg, position)
    else:
        attn_out, cache = serve_decode(p.attn, h, cache, cfg, position,
                                       row_mask=row_mask,
                                       commit_len=commit_len)
    x = x + attn_out.to(x.dtype)
    h = apply_norm(p.ln2, x)
    return x + _ffn(p, h, cfg)[0].to(x.dtype), cache


def block_score(p: Block, x, cache, cfg, position, *, row_mask=None):
    """The speculative score pass over one block: a ``commit_len=0`` decode
    that leaves ``cache`` as it was and returns the attention layer's
    ``{"k", "v"}`` commit residuals beside the activations."""
    if _use_mla(cfg):
        raise NotImplementedError(
            "single-pass speculative verify is not wired for MLA")
    h = apply_norm(p.ln1, x)
    # On a mesh a replicated DTensor, placed with the rows by the decode.
    zeros = replicated_like(x, torch.zeros(x.shape[0], dtype=torch.int32,
                                           device=x.device))
    attn_out, _, resid = serve_decode(p.attn, h, cache, cfg, position,
                                      row_mask=row_mask, commit_len=zeros,
                                      return_residuals=True)
    x = x + attn_out.to(x.dtype)
    h = apply_norm(p.ln2, x)
    return x + _ffn(p, h, cfg)[0].to(x.dtype), resid


def lm_cache_init(p: DenseLM, cfg, batch: int, max_len: int,
                  per_row: bool = False, device=None) -> dict:
    """Per-layer decode states, ``{"layers": [AttentionState, ...]}`` and,
    with dense first layers, ``"first_layers"`` (softmax KV caches, or
    MLA's latent cache, of ``max_len`` positions).  The state is always per
    row ((B,) ``len``/``pos``, (B, H) alpha/beta; the static lockstep batch
    is the degenerate case), so ``per_row`` is accepted, as the
    reference's is, and changes nothing.  The caches go on ``device``,
    by default the parameters'."""
    del per_row
    if device is None:
        device = p.embed_table.device
    first, n_main, _ = _layer_groups(cfg)

    def one():
        if _use_mla(cfg):
            return mla_mod.mla_state_init(cfg, batch, max_len, device)
        return serve_state_init(cfg, batch, max_len, device)
    caches = {"layers": [one() for _ in range(n_main)]}
    if first:
        caches["first_layers"] = [one() for _ in range(first)]
    return caches


@torch.inference_mode()
def lm_prefill(p: DenseLM, tokens, cfg, max_len: int, prefix_embed=None):
    """Prompt forward.  Returns (last-position logits (B, 1, Vpad),
    caches); softmax KV caches hold ``max(max_len, N)`` positions.
    ``prefix_embed``: as :func:`lm_hidden` (the softmax prefill attends
    the prefix bidirectionally)."""
    x, prefix_len = _embed(p, tokens, cfg, prefix_embed)
    positions = torch.arange(x.shape[1], device=x.device)
    caches = {}
    for name, blocks in _groups(p):
        caches[name] = []
        for lp in blocks:
            x, cache = block_prefill(lp, x, cfg, positions, max_len,
                                     prefix_len)
            caches[name].append(cache)
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.head, x[:, -1:], cfg.cdtype,
                                cfg.logit_softcap)
    return logits, caches


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
    new = {}
    for name, blocks in _groups(p):
        new[name] = []
        for lp, cache in zip(blocks, caches[name]):
            x, cache = block_decode(lp, x, cache, cfg, position,
                                    row_mask=row_mask, commit_len=commit_len)
            new[name].append(cache)
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.head, x, cfg.cdtype, cfg.logit_softcap)
    return (logits[:, 0] if single else logits), new


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
    resids = {}
    for name, blocks in _groups(p):
        resids[name] = []
        for lp, cache in zip(blocks, caches[name]):
            x, resid = block_score(lp, x, cache, cfg, position,
                                   row_mask=row_mask)
            resids[name].append(resid)
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.head, x, cfg.cdtype, cfg.logit_softcap)
    return logits, resids


@torch.inference_mode()
def lm_commit(caches, residuals, cfg, commit_len, row_mask=None):
    """Fold the accepted prefix of a scored chunk into every layer's cache,
    with no parameters: the residuals carry the post-RoPE (k, v) of the
    score pass, so the commit is one O(T d^2) fold per layer
    (``AttentionEngine.commit``), the same caches bit for bit as
    :func:`lm_decode` with this ``commit_len``.  Returns the new caches."""
    if _use_mla(cfg):
        raise NotImplementedError(
            "single-pass speculative verify is not wired for MLA")
    return {name: [serve_commit(c, r, cfg, commit_len=commit_len,
                                row_mask=row_mask)
                   for c, r in zip(caches[name], residuals[name])]
            for name in caches}
