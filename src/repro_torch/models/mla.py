"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434); port of
``repro.models.mla``.

Queries, keys and values go through low-rank latents:
  c_q  = RMSNorm(x W_dq)            (q_lora)
  q    = c_q W_uq                   -> per-head [nope | rope] parts
  c_kv = RMSNorm(x W_dkv)           (kv_lora)
  k_nope, v = c_kv W_uk, c_kv W_uv  (decompressed per head)
  k_rope = RoPE(x W_kr)             (one shared rope key per position)

The assembled per-head q/k (width nope + rope, G = H) and v (``v_head_dim``)
run through the same :class:`~repro_torch.core.engine.AttentionEngine` as
standard attention, so the LLN impls prefill and decode on the port's
kernels at D = nope + rope, Dv = v_head_dim.  The ``softmax`` decode is
the absorbed form over the latent ``(ckv, kr)`` cache (``W_uk`` folded
into q, ``W_uv`` applied after the latent context), in plain torch as in
the reference.  Parameter names are the reference's.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.attention import multi_head_attention
from repro_torch.core.engine import AttentionEngine, AttentionState
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (constrain, is_dtensor,
                                              pad_seq, split_heads)
from repro_torch.kernels.registry import deprecated_shim
from .attention_block import attn_cfg_of
from .layers import _dense_param, dense, rms_head_norm, rope


def _dims(cfg):
    return (cfg.q_lora, cfg.kv_lora, cfg.nope_head_dim, cfg.rope_head_dim,
            cfg.v_head_dim, cfg.n_heads)


class MLA(nn.Module):
    """The latent projections, their RMS-norm scales (ones at init) and the
    output projection, in (d_in, d_out) layout."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        ql, kvl, nd, rd, vd, h = _dims(cfg)
        d = cfg.d_model

        def dense_p(i, o):
            return _dense_param(i, o, dtype, device, generator)
        self.w_dkv = dense_p(d, kvl)
        self.kv_norm_scale = nn.Parameter(
            torch.ones(kvl, dtype=dtype, device=device))
        self.w_uk = dense_p(kvl, h * nd)
        self.w_uv = dense_p(kvl, h * vd)
        self.w_kr = dense_p(d, rd)
        self.o_w = dense_p(h * vd, d)
        if ql:
            self.w_dq = dense_p(d, ql)
            self.q_norm_scale = nn.Parameter(
                torch.ones(ql, dtype=dtype, device=device))
            self.w_uq = dense_p(ql, h * (nd + rd))
        else:
            self.w_q = dense_p(d, h * (nd + rd))


def mla_init(cfg, device, generator=None) -> MLA:
    return MLA(cfg, cfg.pdtype, device, generator)


def _q_proj(p: MLA, x, cfg, positions):
    ql, kvl, nd, rd, vd, h = _dims(cfg)
    b, n, _ = x.shape
    if ql:
        cq = rms_head_norm(p.q_norm_scale, dense(p.w_dq, x, cfg.cdtype))
        q = split_heads(dense(p.w_uq, cq, cfg.cdtype), h, nd + rd)
    else:
        q = split_heads(dense(p.w_q, x, cfg.cdtype), h, nd + rd)
    return q[..., :nd], rope(q[..., nd:], positions, cfg.rope_theta)


def _kv_latent(p: MLA, x, cfg, positions):
    ckv = rms_head_norm(p.kv_norm_scale, dense(p.w_dkv, x, cfg.cdtype))
    kr = dense(p.w_kr, x, cfg.cdtype)[:, :, None, :]          # (B,N,1,rd)
    return ckv, rope(kr, positions, cfg.rope_theta)


def _decompress(p: MLA, ckv, cfg):
    ql, kvl, nd, rd, vd, h = _dims(cfg)
    b, n, _ = ckv.shape
    k_nope = split_heads(dense(p.w_uk, ckv, cfg.cdtype), h, nd)
    v = split_heads(dense(p.w_uv, ckv, cfg.cdtype), h, vd)
    return k_nope, v


def _assemble(q_nope, q_rope, k_nope, kr):
    h = q_nope.shape[2]
    k_rope = kr.expand(kr.shape[:2] + (h, kr.shape[-1]))
    return (torch.cat([q_nope, q_rope], -1),
            torch.cat([k_nope, k_rope], -1))


def _placed(q, k, v):
    """q, k and v by (batch, attn_seq, heads), as the reference constrains
    them (G = H: k and v split with the query heads)."""
    return tuple(constrain(t, "act_batch", "attn_seq", "heads", None)
                 for t in (q, k, v))


def mla_apply(p: MLA, x, cfg, positions, *, causal: bool = True):
    """Full-sequence MLA (decompressed form), any attention impl."""
    b, n, _ = x.shape
    q_nope, q_rope = _q_proj(p, x, cfg, positions)
    ckv, kr = _kv_latent(p, x, cfg, positions)
    k_nope, v = _decompress(p, ckv, cfg)
    q, k = _assemble(q_nope, q_rope, k_nope, kr)
    q, k, v = _placed(q, k, v)
    out = multi_head_attention(q, k, v, attn_cfg_of(cfg, causal))
    return dense(p.o_w, out.reshape(b, n, -1), cfg.cdtype)


def mla_engine(cfg, causal: bool = True) -> AttentionEngine:
    """The engine for MLA's assembled q/k/v (full heads: G = H)."""
    ql, kvl, nd, rd, vd, h = _dims(cfg)
    return AttentionEngine.from_cfg(cfg, causal=causal, heads=h, kv_heads=h,
                                    head_dim=nd + rd, v_dim=vd)


def mla_state_init(cfg, batch: int, max_len: int,
                   device) -> AttentionState:
    """Zeroed MLA decode state on ``device``: the latent cache of
    ``max_len`` positions for ``softmax``, the engine's state otherwise."""
    ql, kvl, nd, rd, vd, h = _dims(cfg)
    if cfg.attn_impl == "softmax":
        return AttentionState(
            ckv=torch.zeros(batch, max_len, kvl, dtype=cfg.cdtype,
                            device=device),
            kr=torch.zeros(batch, max_len, rd, dtype=cfg.cdtype,
                           device=device),
            len=torch.zeros(batch, dtype=torch.int32, device=device))
    return mla_engine(cfg).init_state(batch, device, max_len)


def mla_prefill(p: MLA, x, cfg, positions, *, max_len: int = 0):
    """Forward over the prompt; returns ``(out, AttentionState)``: the
    latent cache (``softmax``, zero-padded to ``max(max_len, n)``
    positions) or the engine's LLN state."""
    b, n, _ = x.shape
    q_nope, q_rope = _q_proj(p, x, cfg, positions)
    ckv, kr = _kv_latent(p, x, cfg, positions)
    k_nope, v = _decompress(p, ckv, cfg)
    q, k = _assemble(q_nope, q_rope, k_nope, kr)
    q, k, v = _placed(q, k, v)
    if cfg.attn_impl == "softmax":
        out = multi_head_attention(q, k, v, attn_cfg_of(cfg, True))
        total = max(max_len, n)
        state = AttentionState(
            ckv=pad_seq(ckv.to(cfg.cdtype), total),
            kr=pad_seq(kr[:, :, 0].to(cfg.cdtype), total),
            len=torch.full((b,), n, dtype=torch.int32, device=x.device))
    else:
        out, state = mla_engine(cfg).prefill(q, k, v, max_len=max(max_len, n))
    return dense(p.o_w, out.reshape(b, n, -1), cfg.cdtype), state


def _write_rows(cache, new, start):
    """``cache`` (B, S, C) with ``new`` (B, T, C) written at each row's
    ``start`` (B,), clamped so the chunk fits, as
    ``lax.dynamic_update_slice`` does."""
    t = new.shape[1]
    start = torch.clamp(start.long(), 0, cache.shape[1] - t)
    idx = start[:, None] + torch.arange(t, device=cache.device)[None, :]
    out = cache.clone()
    out.scatter_(1, idx[:, :, None].expand(-1, -1, cache.shape[2]),
                 new.to(cache.dtype))
    return out


def _absorbed(w_uk, w_uv, cfg, state, q_nope, q_rope, ckv_new, kr_new,
              h0: int = 0):
    """Absorbed-form softmax decode over T >= 1 tokens for query heads
    [h0, h0 + H'), H' = ``q_nope.shape[2]`` (all H without a mesh): q is
    folded into the latent space (``W_uk``), so the whole cache is scored
    without decompressing it; query i sits at absolute position
    ``len + i`` and sees keys up to it.  ``w_uk`` / ``w_uv``: the whole
    (kv_lora, H nope) and (kv_lora, H v_head_dim) weights.  Returns (out
    (B, T, H', v_head_dim), the new ckv, kr and len)."""
    ql, kvl, nd, rd, vd, h = _dims(cfg)
    t, hl = q_nope.shape[1], q_nope.shape[2]
    ckv = _write_rows(state.ckv, ckv_new, state.len)
    krc = _write_rows(state.kr, kr_new[:, :, 0], state.len)
    w_uk = w_uk.reshape(kvl, h, nd)[:, h0:h0 + hl].float()
    q_lat = torch.einsum("bqhn,khn->bqhk", q_nope.float(), w_uk)
    s = torch.einsum("bqhk,bsk->bhqs", q_lat, ckv.float())
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), krc.float())
    s = s * (nd + rd) ** -0.5
    key_pos = torch.arange(ckv.shape[1], device=ckv.device)
    q_pos = state.len.long()[:, None] + torch.arange(t, device=ckv.device)
    allowed = key_pos[None, None, None, :] <= q_pos[:, None, :, None]
    s = torch.where(allowed, s, torch.tensor(-1e30, device=s.device))
    attn = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsk->bqhk", attn, ckv.float())
    w_uv = w_uv.reshape(kvl, h, vd)[:, h0:h0 + hl].float()
    out = torch.einsum("bqhk,khv->bqhv", ctx, w_uv)
    return out.to(cfg.cdtype), ckv, krc, state.len + t


def _mla_absorbed_decode(p: MLA, cfg, state, q_nope, q_rope, ckv_new,
                         kr_new):
    """:func:`_absorbed` over every head, or per rank on a mesh
    (``distributed/local_attention.py:mla_absorbed``: the latent cache
    gathered over its split latent dim before the contraction)."""
    if is_dtensor(q_nope):
        from repro_torch.distributed import local_attention
        out, ckv, krc, length = local_attention.mla_absorbed(
            _absorbed, p.w_uk, p.w_uv, cfg, state, q_nope, q_rope, ckv_new,
            kr_new)
    else:
        out, ckv, krc, length = _absorbed(p.w_uk, p.w_uv, cfg, state,
                                          q_nope, q_rope, ckv_new, kr_new)
    return out, state.replace(ckv=ckv, kr=krc, len=length)


def mla_decode(p: MLA, x, state, cfg, position):
    """MLA decode over T >= 1 tokens (x: (B, T, d)): the engine's chunked
    decode for the LLN impls, the absorbed form for ``softmax``.
    ``position``: the absolute index of the first new token, an int or a
    per-row (B,) tensor."""
    b, n, _ = x.shape
    steps = torch.arange(n, dtype=torch.int32, device=x.device)
    if torch.is_tensor(position) and position.ndim == 1:
        pos = position.to(device=x.device, dtype=torch.int32)[:, None] \
            + steps[None, :]
    else:
        pos = position + steps
    q_nope, q_rope = _q_proj(p, x, cfg, pos)
    ckv_new, kr_new = _kv_latent(p, x, cfg, pos)
    if cfg.attn_impl == "softmax":
        out, state = _mla_absorbed_decode(p, cfg, state, q_nope, q_rope,
                                          ckv_new, kr_new)
    else:
        k_nope, v = _decompress(p, ckv_new, cfg)
        q, k = _assemble(q_nope, q_rope, k_nope, kr_new)
        out, state = mla_engine(cfg).decode(state, *_placed(q, k, v))
    return dense(p.o_w, out.reshape(b, n, -1), cfg.cdtype), state


@deprecated_shim("models.mla.mla_cache_init", "mla_state_init")
def mla_cache_init(cfg, batch: int, max_len: int, device=None):
    """Legacy cache initializer: delegates to :func:`mla_state_init` on
    ``device`` (the CUDA card unless the caller asks for another)."""
    return mla_state_init(cfg, batch, max_len, resolve_device(device))
