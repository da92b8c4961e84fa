"""Attention sub-block: projections + RoPE + unified attention.

Port of ``repro.models.attention_block``: the training forward
``attn_apply`` through ``core/attention.py:multi_head_attention`` (with a
key mask, a prefix-LM ``prefix_len``, or cross-attention over a memory
``kv``, always the online softmax),
the serving lifecycle ``serve_state_init`` / ``serve_prefill`` /
``serve_decode`` / ``serve_commit`` over
:class:`repro_torch.core.engine.AttentionEngine`, and the legacy
warn-once shims ``attn_cache_init`` / ``attn_prefill`` / ``attn_decode``.
GQA/MQA, qk-norm (``cfg.qk_norm``: an RMS norm over head_dim of q and k
before the RoPE, qwen3) and partial RoPE (``cfg.rotary_pct``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.attention import (AttnConfig, flash_softmax,
                                        multi_head_attention)
from repro_torch.core.engine import AttentionEngine
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import constrain, split_heads
from repro_torch.kernels.registry import deprecated_shim
from .layers import _dense_param, dense, rms_head_norm, rope


class Attention(nn.Module):
    """q/k/v/o projection weights in (d_in, d_out) layout, and with
    ``cfg.qk_norm`` the (head_dim,) scales ``q_norm_scale`` /
    ``k_norm_scale`` (ones at init)."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d, hd, h, g = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        self.q_w = _dense_param(d, h * hd, dtype, device, generator)
        self.k_w = _dense_param(d, g * hd, dtype, device, generator)
        self.v_w = _dense_param(d, g * hd, dtype, device, generator)
        self.o_w = _dense_param(h * hd, cfg.d_model, dtype, device, generator)
        if cfg.qk_norm:
            self.q_norm_scale = nn.Parameter(
                torch.ones(hd, dtype=dtype, device=device))
            self.k_norm_scale = nn.Parameter(
                torch.ones(hd, dtype=dtype, device=device))


def attn_cfg_of(cfg, causal: bool = True) -> AttnConfig:
    """The training ``AttnConfig`` an ``ArchConfig`` implies (with its
    ``attn_backend``, which selects kernel / plain / ref under
    ``use_kernel``)."""
    return AttnConfig(impl=cfg.attn_impl, causal=causal,
                      diag_block=cfg.diag_block, lln_chunk=cfg.lln_chunk,
                      softmax_chunk=cfg.softmax_chunk,
                      use_kernel=cfg.use_kernel, backend=cfg.attn_backend,
                      fixed_ab=cfg.lln_fixed_ab,
                      num_scales=cfg.lln_num_scales,
                      scale_decay=cfg.lln_scale_decay)


def attn_engine(cfg, causal: bool = True) -> AttentionEngine:
    """The serving engine an ``ArchConfig`` attention layer implies."""
    return AttentionEngine.from_cfg(cfg, causal=causal)


def _project_qkv(p: Attention, x, cfg, positions):
    b, n, _ = x.shape
    hd, h, g = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = split_heads(dense(p.q_w, x, cfg.cdtype), h, hd)
    k = split_heads(dense(p.k_w, x, cfg.cdtype), g, hd)
    v = split_heads(dense(p.v_w, x, cfg.cdtype), g, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p.q_norm_scale, q)
        k = rms_head_norm(p.k_norm_scale, k)
    q = rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    q = constrain(q, "act_batch", "attn_seq", "heads", None)
    k = constrain(k, "act_batch", None, "kv_heads", None)
    v = constrain(v, "act_batch", None, "kv_heads", None)
    return q, k, v


def attn_apply(p: Attention, x, cfg, positions, *, causal: bool = True,
               kv=None, mask=None, prefix_len: int = 0):
    """Full-sequence attention (training forward); x: (B, N, d).  ``kv``:
    a cross-attention memory (B, M, d), projected by ``k_w`` / ``v_w``
    without RoPE and attended by the online softmax whatever
    ``cfg.attn_impl`` (the seamless decoder); ``mask`` (B, N or M) key
    validity; ``prefix_len`` the prefix-LM mask of the self-attention."""
    b, n, _ = x.shape
    hd, h, g = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    if kv is None:
        q, k, v = _project_qkv(p, x, cfg, positions)
        out = multi_head_attention(q, k, v, attn_cfg_of(cfg, causal),
                                   mask=mask, prefix_len=prefix_len)
    else:
        m = kv.shape[1]
        q = split_heads(dense(p.q_w, x, cfg.cdtype), h, hd)
        k = split_heads(dense(p.k_w, kv, cfg.cdtype), g, hd)
        v = split_heads(dense(p.v_w, kv, cfg.cdtype), g, hd)
        q = constrain(q, "act_batch", "attn_seq", "heads", None)
        k = constrain(k, "act_batch", None, "kv_heads", None)
        v = constrain(v, "act_batch", None, "kv_heads", None)
        out = flash_softmax(q, k, v, causal=False,
                            chunk=min(cfg.softmax_chunk, m), mask=mask)
    out = constrain(out.reshape(b, n, h * hd), "act_batch", "attn_seq", None)
    return dense(p.o_w, out, cfg.cdtype)


def serve_state_init(cfg, batch: int, max_len: int, device):
    """Zeroed :class:`~repro_torch.core.engine.AttentionState` for one
    layer (per-row counters and calibration; a softmax KV cache of
    ``max_len`` positions)."""
    return attn_engine(cfg).init_state(batch, device, max_len)


def serve_prefill(p: Attention, x, cfg, positions, *, prefix_len: int = 0,
                  max_len: int = 0):
    """Forward over the prompt; returns ``(out, AttentionState)``.  The
    softmax KV cache holds ``max(max_len, n)`` positions, the padding for
    the tokens decode appends; LLN emits the O(d^2) state from the same
    pass.  ``prefix_len``: the softmax prefill's prefix-LM mask (a VLM's
    patches; the LLN impls take the prefix causally)."""
    b, n, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    out, state = attn_engine(cfg).prefill(q, k, v, max_len=max_len,
                                          prefix_len=prefix_len)
    return dense(p.o_w, out.reshape(b, n, cfg.n_heads * cfg.hd),
                 cfg.cdtype), state


def serve_decode(p: Attention, x, state, cfg, position, *, row_mask=None,
                 commit_len=None, return_residuals: bool = False):
    """Decode over T >= 1 new tokens; x: (B, T, d).  ``position``: the
    absolute index of the first new token, an int (every row at the same
    depth) or a per-row (B,) tensor.  ``row_mask`` (B,) bool: masked rows
    write nothing (their outputs are to be discarded); ``commit_len`` (B,)
    int in [0, T]: all T positions are scored, only the accepted prefix
    folds into the state (``AttentionEngine.decode``).
    ``return_residuals=True`` (with ``commit_len``) returns a third
    element, the layer's post-RoPE ``{"k", "v"}``, so that a
    ``commit_len=0`` score can be folded later by :func:`serve_commit`
    (``AttentionEngine.verify``)."""
    b, t, _ = x.shape
    steps = torch.arange(t, dtype=torch.int32, device=x.device)
    if torch.is_tensor(position) and position.ndim == 1:
        pos = position.to(device=x.device, dtype=torch.int32)[:, None] \
            + steps[None, :]
    else:
        pos = position + steps
    q, k, v = _project_qkv(p, x, cfg, pos)
    eng = attn_engine(cfg)
    if return_residuals:
        out, state, resid = eng.verify(state, q, k, v, row_mask=row_mask,
                                       commit_len=commit_len,
                                       return_residuals=True)
    else:
        out, state = eng.decode(state, q, k, v, row_mask=row_mask,
                                commit_len=commit_len)
    out = dense(p.o_w, out.reshape(b, t, cfg.n_heads * cfg.hd), cfg.cdtype)
    return (out, state, resid) if return_residuals else (out, state)


def serve_commit(state, residual, cfg, *, commit_len, row_mask=None):
    """Fold a scored chunk's accepted prefix into one layer's state, with
    no parameters: ``residual`` is the ``{"k", "v"}`` that
    :func:`serve_decode` returned under ``return_residuals=True``, and
    ``state`` the state that score ran against (``AttentionEngine.commit``,
    O(T d^2))."""
    return attn_engine(cfg).commit(state, residual, commit_len=commit_len,
                                   row_mask=row_mask)


# --- legacy entry points (deprecation shims over the engine) ---------------

@deprecated_shim("models.attention_block.attn_cache_init",
                 "attn_engine(cfg).init_state / serve_state_init")
def attn_cache_init(cfg, batch: int, max_len: int, per_row: bool = False,
                    device=None):
    """Legacy cache initializer.  The state is always per row, so
    ``per_row`` is accepted and ignored; ``device`` is the CUDA card
    unless the caller asks for another."""
    del per_row
    return serve_state_init(cfg, batch, max_len, resolve_device(device))


@deprecated_shim("models.attention_block.attn_prefill", "serve_prefill")
def attn_prefill(p, x, cfg, positions, *, prefix_len: int = 0,
                 max_len: int = 0):
    """Legacy prefill: delegates to :func:`serve_prefill`."""
    return serve_prefill(p, x, cfg, positions, prefix_len=prefix_len,
                         max_len=max_len)


@deprecated_shim("models.attention_block.attn_decode", "serve_decode")
def attn_decode(p, x, cache, cfg, position, *, row_mask=None):
    """Legacy decode: delegates to :func:`serve_decode`."""
    return serve_decode(p, x, cache, cfg, position, row_mask=row_mask)
