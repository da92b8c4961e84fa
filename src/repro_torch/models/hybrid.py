"""SSM language models: pure Mamba2 (mamba2-130m) and the Zamba2-style
hybrid (port of ``repro.models.hybrid``: the training forward and
serving).

Zamba2 (arXiv:2411.15242): a Mamba2 backbone with a single *shared*
transformer block (attention + MLP, one set of weights) applied every
``shared_attn_period`` layers; its input is the concatenation of the
residual stream with the initial embeddings, projected back to d_model.
``shared_attn_period = 0`` disables the shared block (the pure Mamba2 LM).
The paper's LLN attention applies to the shared block only.

The reference stacks the Mamba2 layers along a leading axis and scans
them; here they are a ``ModuleList`` and Python loops, each Mamba2 layer
and each application of the shared block under ``torch.utils.checkpoint``
when ``cfg.remat == "full"`` (per layer and per application, not per
group, as the reference).  Parameter names match the reference pytree
(``embed.table`` as ``embed_table``, ``final_norm``, ``layers[i].{ln,
ssm}``, ``shared.{in_proj, ln1, attn, ln2, mlp}``, ``lm_head`` unless the
embeddings are tied).

Serving (:func:`hybrid_cache_init`, :func:`hybrid_prefill`,
:func:`hybrid_decode`) keeps ``{"layers": [{"state", "conv"} per Mamba2
layer], "shared": [AttentionState per application of the shared block]}``;
the reference stacks each list along a leading axis
(``convert.hybrid_cache_from_numpy`` maps one to the other).  The Mamba2
layers run no kernel there, as in the reference; the shared block serves
through the attention engine, so with ``lln_diag`` its prefill and decode
reach the LLN serving kernels.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.sharding import constrain

from .attention_block import (Attention, attn_apply, serve_decode,
                              serve_prefill, serve_state_init)
from .layers import (MLP, Norm, _dense_param, apply_mlp, apply_norm, dense,
                     embed_lookup, logits_from_hidden, trunc_normal)
from .ssm import (SSMBlock, ssm_apply, ssm_cache_init, ssm_decode,
                  ssm_decode_chunk)
from .transformer import _remat


def _groups(cfg):
    """(groups, layers per group, tail layers): the shared block follows
    each group."""
    per = cfg.shared_attn_period
    if per <= 0:
        return 0, 0, cfg.n_layers
    g = cfg.n_layers // per
    return g, per, cfg.n_layers - g * per


class MambaLayer(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        self.ln = Norm(cfg.d_model, "rmsnorm", dtype, device)
        self.ssm = SSMBlock(cfg, dtype, device, generator)


class SharedBlock(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d = cfg.d_model
        self.in_proj = _dense_param(2 * d, d, dtype, device, generator)
        self.ln1 = Norm(d, "rmsnorm", dtype, device)
        self.attn = Attention(cfg, dtype, device, generator)
        self.ln2 = Norm(d, "rmsnorm", dtype, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.act, dtype, device, generator)


class HybridLM(nn.Module):
    """Parameters of a Mamba2 / hybrid LM (random init from
    ``generator``)."""

    def __init__(self, cfg, device, generator=None):
        super().__init__()
        dtype = cfg.pdtype
        self.embed_table = nn.Parameter(
            trunc_normal((cfg.padded_vocab, cfg.d_model), cfg.d_model ** -0.5,
                         dtype, device, generator))
        self.final_norm = Norm(cfg.d_model, "rmsnorm", dtype, device)
        self.layers = nn.ModuleList(
            MambaLayer(cfg, dtype, device, generator)
            for _ in range(cfg.n_layers))
        if _groups(cfg)[0]:
            self.shared = SharedBlock(cfg, dtype, device, generator)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                trunc_normal((cfg.d_model, cfg.padded_vocab),
                             cfg.d_model ** -0.5, dtype, device, generator))

    @property
    def head(self) -> torch.Tensor:
        return self.lm_head if hasattr(self, "lm_head") else self.embed_table.T


def hybrid_init(cfg, device, seed: int = 0) -> HybridLM:
    """Random parameters with the reference's shapes and names, drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    gen = None                 # seed None: an abstract init (FakeTensorMode)
    if seed is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    return HybridLM(cfg, device, gen)


def _split_layers(p: HybridLM, cfg):
    """([the layers of each group], the tail layers)."""
    g, per, _ = _groups(cfg)
    layers = list(p.layers)
    return ([layers[i * per:(i + 1) * per] for i in range(g)],
            layers[g * per:])


def _placed(x):
    """The residual stream by (batch, sequence, embed) on a mesh, as the
    transformer's blocks place it (its sums then meet their partial-sum
    addends in one layout); ``x`` itself without a mesh."""
    return constrain(x, "act_batch", "act_seq", "embed")


def _mamba_block(lp: MambaLayer, x, cfg):
    x = _placed(x)
    return x + ssm_apply(lp.ssm, apply_norm(lp.ln, x), cfg).to(x.dtype)


def _in_proj(sp: SharedBlock, x, x0, cfg):
    return _placed(dense(sp.in_proj, torch.cat([_placed(x), x0], -1),
                         cfg.cdtype))


def _shared_block(sp: SharedBlock, x, x0, cfg, positions):
    h = _in_proj(sp, x, x0, cfg)
    a = attn_apply(sp.attn, apply_norm(sp.ln1, h), cfg, positions,
                   causal=True)
    h = h + a.to(h.dtype)
    m = apply_mlp(sp.mlp, apply_norm(sp.ln2, h), cfg.cdtype)
    return x + (h + m.to(h.dtype)).to(x.dtype)


def hybrid_hidden(p: HybridLM, tokens, cfg):
    """Token ids (B, N) -> final hidden states (B, N, D) and a zero aux
    loss."""
    x = _placed(embed_lookup(p.embed_table, tokens, cfg.cdtype,
                             cfg.embed_scale))
    x0 = x
    positions = torch.arange(x.shape[1], device=x.device)
    groups, tail = _split_layers(p, cfg)
    mamba = _remat(_mamba_block, cfg)
    shared = _remat(_shared_block, cfg)
    for layers in groups:
        for lp in layers:
            x = mamba(lp, x, cfg)
        x = shared(p.shared, x, x0, cfg, positions)
    for lp in tail:
        x = mamba(lp, x, cfg)
    x = apply_norm(p.final_norm, x)
    return x, torch.zeros((), device=x.device)


def hybrid_logits(p: HybridLM, tokens, cfg):
    h, aux = hybrid_hidden(p, tokens, cfg)
    return logits_from_hidden(p.head, h, cfg.cdtype, cfg.logit_softcap), aux


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------

def hybrid_cache_init(p: HybridLM, cfg, batch: int, max_len: int,
                      per_row: bool = False, device=None) -> dict:
    """Zeroed decode caches: one ``{"state", "conv"}`` per Mamba2 layer and
    one :class:`~repro_torch.core.engine.AttentionState` per application
    of the shared block (a softmax KV cache of ``max_len`` positions).
    ``per_row`` is accepted for the pool's signature, as the reference's
    is: the SSM caches carry no position counters and the attention state
    is per row by construction, so the layout is the same either way.
    The caches go on ``device``, by default the parameters'."""
    del per_row
    if device is None:
        device = p.embed_table.device
    g, _, _ = _groups(cfg)
    caches = {"layers": [ssm_cache_init(cfg, batch, device)
                         for _ in range(cfg.n_layers)]}
    if g:
        caches["shared"] = [serve_state_init(cfg, batch, max_len, device)
                            for _ in range(g)]
    return caches


def _shared_serve(sp: SharedBlock, x, x0, cfg, attend):
    """The shared block around ``attend(attn params, normed input) ->
    (out, state)``; returns (x, state)."""
    h = _in_proj(sp, x, x0, cfg)
    a, state = attend(sp.attn, apply_norm(sp.ln1, h))
    h = h + a.to(h.dtype)
    m = apply_mlp(sp.mlp, apply_norm(sp.ln2, h), cfg.cdtype)
    return x + (h + m.to(h.dtype)).to(x.dtype), state


@torch.inference_mode()
def hybrid_prefill(p: HybridLM, tokens, cfg, max_len: int):
    """Prompt forward over the layers in order.  Returns (last-position
    logits (B, 1, Vpad), caches); the shared block's softmax KV caches
    hold ``max(max_len, N)`` positions."""
    x = _placed(embed_lookup(p.embed_table, tokens, cfg.cdtype,
                             cfg.embed_scale))
    x0 = x
    positions = torch.arange(x.shape[1], device=x.device)
    groups, tail = _split_layers(p, cfg)

    def mamba(lp, x):
        x = _placed(x)
        out, cache = ssm_apply(lp.ssm, apply_norm(lp.ln, x), cfg,
                               return_state=True)
        return x + out.to(x.dtype), cache

    def attend(ap, h):
        return serve_prefill(ap, h, cfg, positions, max_len=max_len)

    layer_caches, shared = [], []
    for layers in groups:
        for lp in layers:
            x, cache = mamba(lp, x)
            layer_caches.append(cache)
        x, state = _shared_serve(p.shared, x, x0, cfg, attend)
        shared.append(state)
    for lp in tail:
        x, cache = mamba(lp, x)
        layer_caches.append(cache)
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.head, x[:, -1:], cfg.cdtype,
                                cfg.logit_softcap)
    caches = {"layers": layer_caches}
    if groups:
        caches["shared"] = shared
    return logits, caches


@torch.inference_mode()
def hybrid_decode(p: HybridLM, caches, token, cfg, position, *,
                  row_mask=None, commit_len=None):
    """Decode step.  ``token`` (B,) is the one-token loop (``ssm_decode``);
    (B, T) the chunked path (``ssm_decode_chunk``).  ``position`` is the
    absolute index of the first new token, an int or a per-row (B,)
    tensor (the shared block's RoPE base; the Mamba2 layers are
    position-free).  ``row_mask`` / ``commit_len`` hold on every cache, as
    in ``AttentionEngine.decode``: masked rows advance neither the SSM
    states, the conv windows nor the shared block's attention state, and
    ``commit_len`` folds only the accepted prefix (both take the chunked
    SSM path, as the reference).  Returns (logits (B, Vpad) or (B, T,
    Vpad), the new caches)."""
    chunked = token.ndim == 2
    use_chunk = chunked or row_mask is not None or commit_len is not None
    tokens = token if chunked else token[:, None]
    x = _placed(embed_lookup(p.embed_table, tokens, cfg.cdtype,
                             cfg.embed_scale))
    x0 = x
    groups, tail = _split_layers(p, cfg)
    layer_caches = iter(caches["layers"])
    new_layers, new_shared = [], []

    def mamba(lp, x):
        x = _placed(x)
        xn, cache = apply_norm(lp.ln, x), next(layer_caches)
        if use_chunk:
            out, cache = ssm_decode_chunk(lp.ssm, xn, cache, cfg,
                                          row_mask=row_mask,
                                          commit_len=commit_len)
        else:
            out, cache = ssm_decode(lp.ssm, xn, cache, cfg)
        new_layers.append(cache)
        return x + out.to(x.dtype)

    for layers, state in zip(groups, caches.get("shared", ())):
        for lp in layers:
            x = mamba(lp, x)
        x, state = _shared_serve(
            p.shared, x, x0, cfg,
            lambda ap, h, state=state: serve_decode(
                ap, h, state, cfg, position, row_mask=row_mask,
                commit_len=commit_len))
        new_shared.append(state)
    for lp in tail:
        x = mamba(lp, x)
    x = apply_norm(p.final_norm, x)
    logits = logits_from_hidden(p.head, x, cfg.cdtype, cfg.logit_softcap)
    new = {"layers": new_layers}
    if groups:
        new["shared"] = new_shared
    return (logits if chunked else logits[:, 0]), new
