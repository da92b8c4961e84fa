"""LLN calibration and chunked LLN(+Diag) decode.

Port of the serving half of ``repro.core.attention``:
:func:`batch_alpha_beta` (eq. 10 on the current batch's statistics),
:class:`LLNDecodeState` and :func:`decode_lln_chunk`, whose §4.2 diag part
is one masked softmax over [tail block ∪ chunk keys] in plain PyTorch (it
has no kernel in the reference either).

GQA: k/v carry G kv heads with G | H; all inputs are (batch, seq, heads,
head_dim).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import lln as lln_mod
from .lln import LLNState
from .moment_matching import constants_for_dim, solve_alpha_beta

NEG_INF = -1e30


def _repeat_kv(t: torch.Tensor, h: int) -> torch.Tensor:
    """Expand (B, N, G, D) kv heads to H = G*R query heads."""
    g = t.shape[2]
    return t if g == h else torch.repeat_interleave(t, h // g, dim=2)


def batch_alpha_beta(q, k, cfg, n: int | None = None):
    """Moment-matched (alpha, beta) from the current batch's statistics.

    Statistics are pooled over the batch and per kv group (the r query heads
    sharing one kv head): alpha (H,), beta (G,).  ``cfg`` is any object with
    ``fixed_ab`` and
    ``beta_n`` attributes (an ``AttnSpec``); (a, b) are the shipped
    constants for the head dim (length-aware when ``beta_n > 0``).
    """
    h, g = q.shape[2], k.shape[2]
    length_aware = cfg.beta_n > 0.0 and n is not None
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
