"""Attention front-end: calibration, full-sequence attention and chunked
LLN(+Diag) decode.

Port of ``repro.core.attention`` for the ``lln``, ``lln_diag`` and
``log_linear`` impls: :func:`batch_alpha_beta` (eq. 10 on the current
batch's statistics), :class:`AttnConfig` and :func:`multi_head_attention`
(the training forward, causal for the decoder and bidirectional for the
encoder; ``log_linear`` is causal and, on the CUDA kernel, forward only),
:class:`LLNDecodeState` and :func:`decode_lln_chunk`, whose §4.2 diag part
is one masked softmax over [tail block ∪ chunk keys] in plain PyTorch (it
has no kernel in the reference either).

GQA: k/v carry G kv heads with G | H; all inputs are (batch, seq, heads,
head_dim).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from . import lln as lln_mod
from . import loglinear as loglin_mod
from .diag import block_diag_attn
from .lln import LLNState, lln_bidir, lln_causal_scan
from .moment_matching import constants_for_dim, solve_alpha_beta

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """The reference's ``AttnConfig``.  ``use_kernel`` routes through
    ``kernels/registry.py:attention`` (the CUDA kernels' autograd
    Functions); without it the core scan runs on repeated KV.  ``backend``:
    an explicit registry backend (None -> ``auto``).  ``num_scales`` /
    ``scale_decay``: the ``log_linear`` pyramid.  The reference's
    ``softmax_chunk`` and ``mm_a``/``mm_b`` come with the slices that port
    the code that reads them."""
    impl: str = "softmax"
    causal: bool = True
    diag_block: int = 256
    lln_chunk: int = 128
    use_kernel: bool = False
    backend: Optional[str] = None
    fixed_ab: float = 0.0
    num_scales: int = 4
    scale_decay: float = 0.5


# What each unported branch of multi_head_attention waits for.
_NOT_PORTED = {
    "softmax": "the softmax impl (ROADMAP.md queue 1, 'left out of the "
               "first slice', item 1)",
}


def _repeat_kv(t: torch.Tensor, h: int) -> torch.Tensor:
    """Expand (B, N, G, D) kv heads to H = G*R query heads."""
    g = t.shape[2]
    return t if g == h else torch.repeat_interleave(t, h // g, dim=2)


def batch_alpha_beta(q, k, cfg, n: int | None = None):
    """Moment-matched (alpha, beta) from the current batch's statistics.

    Statistics are pooled over the batch and per kv group (the r query heads
    sharing one kv head): alpha (H,), beta (G,).  ``cfg`` is any object with
    a ``fixed_ab`` attribute and optionally ``beta_n`` (an ``AttnSpec`` or
    ``AttnConfig``); (a, b) are the shipped constants for the head dim
    (length-aware when ``beta_n > 0``).  As in the reference, only
    ``solve_alpha_beta`` stops its inputs' gradient: alpha keeps its graph
    to q and k through the per-head statistics.
    """
    h, g = q.shape[2], k.shape[2]
    length_aware = getattr(cfg, "beta_n", 0.0) > 0.0 and n is not None
    if cfg.fixed_ab:
        return (torch.full((h,), cfg.fixed_ab, device=q.device),
                torch.full((g,), cfg.fixed_ab, device=q.device))
    a, b = constants_for_dim(q.shape[-1], n=n if length_aware else None)
    r = h // g
    dims = (0, 1, 3)
    sq = torch.sqrt(torch.mean(torch.square(q.float()), dim=dims))
    sq_g = torch.mean(sq.reshape(sq.shape[:-1] + (g, r)), dim=-1)    # (.., G)
    sk_g = torch.sqrt(torch.mean(torch.square(k.float()), dim=dims))  # (.., G)
    _, beta_g = solve_alpha_beta(sq_g, sk_g, a, b)
    # Per-query-head alpha re-solved against the group's sigma_tilde so each
    # q head is normalized by its own sigma_q (eq. 10).
    sigma_sm_sq = torch.square(sq_g) * torch.square(sk_g)
    st = torch.sqrt(torch.clamp((sigma_sm_sq - b) / a, min=1e-4))
    alpha = torch.repeat_interleave(st, r, dim=-1) / (
        math.sqrt(2.0) * torch.clamp(sq, min=1e-4))
    return alpha, beta_g


def multi_head_attention(q, k, v, cfg: AttnConfig, *, alpha=None,
                         beta=None) -> torch.Tensor:
    """Full-sequence attention (training / prefill), ``lln``, ``lln_diag``
    or ``log_linear``, causal or bidirectional (``cfg.causal``; log-linear
    is causal only).  q: (B,N,H,D); k/v: (B,N,G,D[v]).  alpha/beta default
    to :func:`batch_alpha_beta` of this batch; a per-head (H,) beta is
    pooled to the G groups.  ``log_linear`` under ``use_kernel`` on the
    ``kernel`` kind (the CUDA kernel, ``auto`` on a CUDA tensor) has no
    gradient (the reference has no backward kernel for it) and raises when
    one would be needed; its ``plain`` and ``ref`` kinds, and the core scan
    without ``use_kernel``, are plain PyTorch, which autograd
    differentiates, as the reference's scan twin and oracle are."""
    if cfg.impl not in ("lln", "lln_diag", "log_linear"):
        raise NotImplementedError(f"attn impl {cfg.impl!r} is not ported "
                                  f"yet: {_NOT_PORTED.get(cfg.impl, '')}")
    h, g = q.shape[2], k.shape[2]
    if alpha is None or beta is None:
        alpha, beta = batch_alpha_beta(q, k, cfg)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=q.device)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=q.device)
    if alpha.ndim == 0:
        alpha = alpha.expand(h)
    if beta.ndim == 0:
        beta = beta.expand(g)
    if beta.shape[-1] == h and g != h:
        beta = beta.reshape(beta.shape[:-1] + (g, h // g)).mean(dim=-1)

    if cfg.impl == "log_linear" and not cfg.causal:
        raise ValueError("log_linear attention is causal-only")
    if cfg.use_kernel:
        from repro_torch.kernels import registry as kreg
        backend = cfg.backend or "auto"
        if cfg.impl == "log_linear" and torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)) and kreg.resolve(
                    backend, q.device) == "kernel":
            raise NotImplementedError(
                "log_linear on the CUDA kernel is forward only (the "
                "reference has no backward kernel for it): run it under "
                "torch.no_grad(), or with backend 'plain' or 'ref', or "
                "use_kernel=False, for a gradient")
        spec = kreg.AttnSpec(impl=cfg.impl, causal=cfg.causal, r=h // g,
                             backend=backend,
                             lln_chunk=cfg.lln_chunk,
                             diag_block=cfg.diag_block,
                             fixed_ab=cfg.fixed_ab,
                             num_scales=cfg.num_scales,
                             scale_decay=cfg.scale_decay)
        return kreg.attention(spec, q, k, v, alpha, beta)

    kv_k, kv_v = _repeat_kv(k, h), _repeat_kv(v, h)
    beta_h = torch.repeat_interleave(beta, h // g, dim=-1) if g != h else beta
    if cfg.impl == "log_linear":
        out, _ = loglin_mod.prefill(q, kv_k, kv_v, alpha, beta_h,
                                    granule=cfg.lln_chunk,
                                    num_scales=cfg.num_scales,
                                    scale_decay=cfg.scale_decay)
        return out
    if cfg.causal:
        lln_out, _ = lln_causal_scan(q, kv_k, kv_v, alpha, beta_h,
                                     chunk=cfg.lln_chunk)
    else:
        lln_out = lln_bidir(q, kv_k, kv_v, alpha, beta_h)
    if cfg.impl == "lln":
        return lln_out
    diag_out = block_diag_attn(q, kv_k, kv_v, block=cfg.diag_block,
                               causal=cfg.causal)
    return (0.5 * (lln_out.float() + diag_out.float())).to(v.dtype)


@dataclasses.dataclass
class LLNDecodeState:
    """LLN decode state plus the rolling diag tail: the §4.2 diag part
    only ever needs the current block's history, so decode keeps a
    (B, BLK, G, D) tail instead of a KV cache."""
    lln: LLNState
    tail_k: torch.Tensor     # (B, BLK, G, D)
    tail_v: torch.Tensor     # (B, BLK, G, Dv)
    pos: torch.Tensor        # (B,) absolute next position


def decode_lln_chunk(state: LLNDecodeState, q, k_new, v_new, alpha, beta,
                     *, impl: str = "lln_diag", backend: str = "auto"):
    """LLN(+Diag) decode of T >= 1 tokens.  q: (B,T,H,D); k/v_new: (B,T,G,D[v]).

    The LLN state advance runs through ``kernels/ops.py:lln_decode_chunk``
    (``auto``/``kernel``/``plain``) or the core reference
    ``core/lln.py:decode_chunk`` (``ref``).  The diag part is one masked
    softmax over [tail ∪ chunk] keys with per-token block-diagonal
    visibility from absolute positions, so a chunk may straddle a block
    boundary.
    """
    b, t, h, d = q.shape
    if backend != "ref":
        from repro_torch.kernels import ops as kops
        lln_out, lln_state = kops.lln_decode_chunk(
            state.lln, q, k_new, v_new, alpha, beta, backend=backend)
    else:
        g = k_new.shape[2]
        beta_h = torch.as_tensor(beta, dtype=torch.float32)
        if beta_h.ndim and beta_h.shape[-1] == g and g != h:
            beta_h = torch.repeat_interleave(beta_h, h // g, dim=-1)
        lln_out, lln_state = lln_mod.decode_chunk(
            state.lln, q, _repeat_kv(k_new, h), _repeat_kv(v_new, h),
            alpha, beta_h)

    # Rolling tail update: for each slot i the last chunk token writing it
    # is j_i = j0 + block*((t-1-j0)//block), j0 = (i-pos) % block.
    block = state.tail_k.shape[1]
    dev = q.device
    posb = state.pos.to(torch.int64)                               # (B,)
    idx = torch.arange(block, device=dev)
    j0 = torch.remainder(idx[None, :] - posb[:, None], block)      # (B, BLK)
    j_last = torch.clamp(
        j0 + block * torch.div(t - 1 - j0, block, rounding_mode="floor"),
        0, t - 1)
    wrote = (j0 < t)[:, :, None, None]
    gather = j_last[:, :, None, None]
    tail_k = torch.where(
        wrote, torch.take_along_dim(k_new, gather, dim=1).to(state.tail_k.dtype),
        state.tail_k)
    tail_v = torch.where(
        wrote, torch.take_along_dim(v_new, gather, dim=1).to(state.tail_v.dtype),
        state.tail_v)
    new_state = LLNDecodeState(lln=lln_state, tail_k=tail_k, tail_v=tail_v,
                               pos=state.pos + t)
    if impl == "lln":
        return lln_out, new_state

    # Diag part: one softmax over [tail ∪ chunk] keys.  Tail slot i holds
    # absolute position cur_base + i (this block) or that minus block (the
    # previous block, masked); never-written slots get negative positions.
    cur_base = torch.div(posb, block, rounding_mode="floor") * block  # (B,)
    abs_idx = cur_base[:, None] + idx[None, :]                        # (B, BLK)
    tail_pos = torch.where(idx[None, :] < (posb - cur_base)[:, None],
                           abs_idx, abs_idx - block)
    q_pos = posb[:, None] + torch.arange(t, device=dev)[None, :]       # (B, T)
    q_base = torch.div(q_pos, block, rounding_mode="floor") * block
    m_tail = (tail_pos[:, None, :] >= q_base[:, :, None]) \
        & (tail_pos[:, None, :] >= 0)                                  # (B,T,BLK)
    ar = torch.arange(t, device=dev)
    m_chunk = (ar[None, None, :] <= ar[None, :, None]) \
        & (q_base[:, None, :] == q_base[:, :, None])                   # (B,T,T)
    allowed = torch.cat([m_tail, m_chunk], dim=2)

    keys = torch.cat([state.tail_k, k_new.to(state.tail_k.dtype)], dim=1)
    vals = torch.cat([state.tail_v, v_new.to(state.tail_v.dtype)], dim=1)
    kf = _repeat_kv(keys, h).float()
    vf = _repeat_kv(vals, h).float()
    s = torch.einsum("bihd,bjhd->bhij", q.float(), kf) * (d ** -0.5)
    s = torch.where(allowed[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    diag_out = torch.einsum("bhij,bjhv->bihv", p, vf)
    out = 0.5 * (lln_out.float() + diag_out)
    return out.to(v_new.dtype), new_state


def decode_lln(state: LLNDecodeState, q, k_new, v_new, alpha, beta,
               *, impl: str = "lln_diag"):
    """One-token LLN(+Diag) decode (T=1 :func:`decode_lln_chunk` on the
    core reference).

    .. deprecated:: use :meth:`repro_torch.core.engine.AttentionEngine.decode`
       (or :func:`decode_lln_chunk` directly): chunked decode subsumes the
       single-token case.
    """
    from repro_torch.kernels.registry import warn_deprecated
    warn_deprecated("repro_torch.core.attention.decode_lln",
                    "AttentionEngine.decode / decode_lln_chunk")
    return decode_lln_chunk(state, q, k_new, v_new, alpha, beta, impl=impl,
                            backend="ref")
