"""Attention sub-block: projections + RoPE + unified attention.

Port of ``repro.models.attention_block`` for self-attention: the training
forward ``attn_apply`` through ``core/attention.py:multi_head_attention``,
and the serving lifecycle ``serve_state_init`` / ``serve_prefill`` /
``serve_decode`` over :class:`repro_torch.core.engine.AttentionEngine`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.attention import AttnConfig, multi_head_attention
from repro_torch.core.engine import AttentionEngine
from .layers import _dense_param, dense, rope


class Attention(nn.Module):
    """q/k/v/o projection weights in (d_in, d_out) layout."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d, hd, h, g = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        self.q_w = _dense_param(d, h * hd, dtype, device, generator)
        self.k_w = _dense_param(d, g * hd, dtype, device, generator)
        self.v_w = _dense_param(d, g * hd, dtype, device, generator)
        self.o_w = _dense_param(h * hd, cfg.d_model, dtype, device, generator)


def attn_cfg_of(cfg, causal: bool = True) -> AttnConfig:
    """The training ``AttnConfig`` an ``ArchConfig`` implies (with its
    ``attn_backend``, which selects kernel / plain / ref under
    ``use_kernel``)."""
    return AttnConfig(impl=cfg.attn_impl, causal=causal,
                      diag_block=cfg.diag_block, lln_chunk=cfg.lln_chunk,
                      use_kernel=cfg.use_kernel, backend=cfg.attn_backend,
                      fixed_ab=cfg.lln_fixed_ab)


def attn_engine(cfg) -> AttentionEngine:
    """The serving engine an ``ArchConfig`` attention layer implies."""
    return AttentionEngine.from_cfg(cfg)


def _project_qkv(p: Attention, x, cfg, positions):
    b, n, _ = x.shape
    hd, h, g = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = dense(p.q_w, x, cfg.cdtype).reshape(b, n, h, hd)
    k = dense(p.k_w, x, cfg.cdtype).reshape(b, n, g, hd)
    v = dense(p.v_w, x, cfg.cdtype).reshape(b, n, g, hd)
    q = rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v


def attn_apply(p: Attention, x, cfg, positions, *, causal: bool = True):
    """Full-sequence self-attention (training forward); x: (B, N, d)."""
    b, n, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = multi_head_attention(q, k, v, attn_cfg_of(cfg, causal))
    return dense(p.o_w, out.reshape(b, n, cfg.n_heads * cfg.hd), cfg.cdtype)


def serve_state_init(cfg, batch: int, device):
    """Zeroed :class:`~repro_torch.core.engine.AttentionState` for one
    layer (per-row pos and calibration)."""
    return attn_engine(cfg).init_state(batch, device)


def serve_prefill(p: Attention, x, cfg, positions):
    """Forward over the prompt; returns ``(out, AttentionState)``."""
    b, n, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    out, state = attn_engine(cfg).prefill(q, k, v)
    return dense(p.o_w, out.reshape(b, n, cfg.n_heads * cfg.hd),
                 cfg.cdtype), state


def serve_decode(p: Attention, x, state, cfg, position: int):
    """Decode over T >= 1 new tokens; x: (B, T, d); ``position`` is the
    absolute index of the first new token (every row at the same depth)."""
    b, t, _ = x.shape
    pos = position + torch.arange(t, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, pos)
    out, state = attn_engine(cfg).decode(state, q, k, v)
    return dense(p.o_w, out.reshape(b, t, cfg.n_heads * cfg.hd),
                 cfg.cdtype), state
