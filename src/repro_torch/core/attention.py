"""Attention front-end: calibration, full-sequence attention and chunked
decode.

Port of ``repro.core.attention``: :func:`batch_alpha_beta` (eq. 10 on the
current batch's statistics), :class:`AttnConfig` and
:func:`multi_head_attention` (the training forward, causal for the decoder
and bidirectional for the encoder, for ``softmax``, ``lln``, ``lln_diag``
and ``log_linear``; ``log_linear`` is causal and, on the CUDA kernel,
forward only), the softmax half (:func:`flash_softmax`, an online softmax
chunked over keys; :func:`naive_softmax`, the quadratic oracle;
:class:`KVCache`, :func:`decode_softmax` and :func:`commit_softmax`), and
:class:`LLNDecodeState` and :func:`decode_lln_chunk`, whose §4.2 diag part
is one masked softmax over [tail block ∪ chunk keys], with its commit half
:func:`commit_lln_chunk` (the speculative verify's fold).  The softmax paths
are plain PyTorch: the reference has no kernel for them either.

GQA: k/v carry G kv heads with G | H; all inputs are (batch, seq, heads,
head_dim).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import is_dtensor
from . import lln as lln_mod
from . import loglinear as loglin_mod
from .diag import block_diag_attn
from .lln import LLNState, commit_lengths, lln_bidir, lln_causal_scan
from .moment_matching import constants_for_dim, solve_alpha_beta
from .numerics import einsum_f32

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """The reference's ``AttnConfig``.  ``use_kernel`` routes the LLN
    impls through ``kernels/registry.py:attention`` (the CUDA kernels'
    autograd Functions); without it the core scan runs on repeated KV.
    ``softmax`` runs :func:`flash_softmax` with key chunks of
    ``softmax_chunk`` either way.  ``backend``: an explicit registry
    backend (None -> ``auto``).  ``num_scales`` / ``scale_decay``: the
    ``log_linear`` pyramid.  The reference's ``mm_a``/``mm_b`` come with
    the slice that ports the code that reads them."""
    impl: str = "softmax"
    causal: bool = True
    diag_block: int = 256
    lln_chunk: int = 128
    softmax_chunk: int = 1024
    use_kernel: bool = False
    backend: Optional[str] = None
    fixed_ab: float = 0.0
    num_scales: int = 4
    scale_decay: float = 0.5


def _repeat_kv(t: torch.Tensor, h: int) -> torch.Tensor:
    """Expand (B, N, G, D) kv heads to H = G*R query heads."""
    g = t.shape[2]
    return t if g == h else torch.repeat_interleave(t, h // g, dim=2)


def batch_alpha_beta(q, k, cfg, per_row: bool = False,
                     n: int | None = None, *, pool=None):
    """Moment-matched (alpha, beta) from the current batch's statistics.

    Statistics are pooled over the batch and per kv group (the r query heads
    sharing one kv head): alpha (H,), beta (G,).  ``per_row=True`` measures
    each batch row alone (its sequence and feature dims only) and returns
    alpha (B, H) and beta (B, G): a batched prefill then gives each row the
    calibration it would get alone.  ``cfg`` is any object with a
    ``fixed_ab`` attribute and optionally ``beta_n`` (an ``AttnSpec`` or
    ``AttnConfig``); (a, b) are the shipped constants for the head dim
    (length-aware when ``beta_n > 0``).  As in the reference, only
    ``solve_alpha_beta`` stops its inputs' gradient: alpha keeps its graph
    to q and k through the per-head statistics.  ``pool``: on a mesh, a
    function of the local mean squares (q's per head, k's per group) that
    returns them pooled over the ranks, all H and G heads (the caller
    takes its own heads' slice of the result).
    """
    bsz, h, g = q.shape[0], q.shape[2], k.shape[2]
    length_aware = getattr(cfg, "beta_n", 0.0) > 0.0 and n is not None
    if cfg.fixed_ab:
        lead = (bsz,) if per_row else ()
        return (torch.full(lead + (h,), cfg.fixed_ab, device=q.device),
                torch.full(lead + (g,), cfg.fixed_ab, device=q.device))
    a, b = constants_for_dim(q.shape[-1], n=n if length_aware else None)
    r = h // g
    dims = (1, 3) if per_row else (0, 1, 3)      # row-local vs batch-pooled
    msq = torch.mean(torch.square(q.float()), dim=dims)
    msk = torch.mean(torch.square(k.float()), dim=dims)
    if pool is not None:
        msq, msk = pool(msq, msk)
        h, g = msq.shape[-1], msk.shape[-1]
        r = h // g
    sq = torch.sqrt(msq)
    sq_g = torch.mean(sq.reshape(sq.shape[:-1] + (g, r)), dim=-1)    # (.., G)
    sk_g = torch.sqrt(msk)                                            # (.., G)
    _, beta_g = solve_alpha_beta(sq_g, sk_g, a, b)
    # Per-query-head alpha re-solved against the group's sigma_tilde so each
    # q head is normalized by its own sigma_q (eq. 10).
    sigma_sm_sq = torch.square(sq_g) * torch.square(sk_g)
    st = torch.sqrt(torch.clamp((sigma_sm_sq - b) / a, min=1e-4))
    alpha = torch.repeat_interleave(st, r, dim=-1) / (
        math.sqrt(2.0) * torch.clamp(sq, min=1e-4))
    return alpha, beta_g


# ---------------------------------------------------------------------------
# Softmax attention: online softmax chunked over keys, its quadratic oracle,
# and decode against a KV cache.
# ---------------------------------------------------------------------------

def _flash_step(m, l, acc, qq, ck, cv, cm, allowed):
    """One key chunk of the online softmax.  qq (B,Cq,G,R,D) pre-scaled;
    ck/cv (B,C,G,D[v]); cm (B,C) key validity; allowed (B|1,Cq,C) or None.
    m/l (B,G,R,Cq) and acc (B,G,R,Cq,Dv) fp32."""
    s = einsum_f32("bqgrd,bjgd->bgrqj", qq, ck)
    bias = torch.where(cm, 0.0, NEG_INF)[:, None, None, None, :]
    if allowed is not None:
        bias = bias + torch.where(allowed, 0.0, NEG_INF)[:, None, None]
    s = s + bias
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + torch.sum(p, dim=-1)
    acc = acc * corr[..., None] + einsum_f32("bgrqj,bjgv->bgrqv",
                                             p.to(cv.dtype), cv)
    return m_new, l, acc


def flash_softmax(q, k, v, *, causal: bool = True, chunk: int = 1024,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None, prefix_len: int = 0,
                  q_start=None) -> torch.Tensor:
    """Online-softmax attention, chunked over keys (and queries).

    q: (B,Nq,H,D); k/v: (B,Nk,G,D[v]) with G | H (GQA: query head i reads
    kv head i // (H // G), without repeating k/v).  ``mask``: (B, Nk) key
    validity.  Returns (B, Nq, H, Dv) in ``v.dtype``.  The inputs stay in
    their dtype; each chunk's two products are taken on fp32 copies (torch's
    bf16 matmul would return bf16) and the statistics and accumulators are
    fp32.  q is scaled in its own dtype, as the reference does.  Padded
    keys are masked; scores of masked keys get ``NEG_INF``.

    When ``causal``, query i sees keys j <= i + (Nk - Nq) (the queries are
    the last Nq positions); ``q_start`` sets their absolute positions to
    ``q_start + i`` instead, as a scalar or per row (B,) (decode against a
    cache, each row at its own depth).  ``prefix_len``: keys below it are
    visible to every query (a prefix-LM).  With grad enabled each key
    chunk runs under ``torch.utils.checkpoint``, as the reference wraps
    its step in ``jax.checkpoint``: the backward recomputes the chunk's
    probabilities instead of keeping them.  On a mesh (DTensor q) it runs
    per rank under ``local_map``."""
    if is_dtensor(q):
        from repro_torch.distributed import local_attention
        return local_attention.flash_softmax(
            q, k, v, causal=causal, chunk=chunk, mask=mask, scale=scale,
            prefix_len=prefix_len, q_start=q_start)
    b, nq, h, d = q.shape
    nk, g = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    r = h // g
    dev = q.device
    scale = d ** -0.5 if scale is None else scale
    nkc = -(-nk // chunk)
    kpad = nkc * chunk - nk
    if mask is None:
        mask = torch.ones(b, nk, dtype=torch.bool, device=dev)
    if kpad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kpad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kpad))
        mask = torch.nn.functional.pad(mask, (0, kpad))
    qchunk = min(chunk, nq)
    nqc = -(-nq // qchunk)
    qpad = nqc * qchunk - nq
    if qpad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, qpad))
    qg = (q * torch.tensor(scale, dtype=q.dtype, device=dev)).reshape(
        b, nqc * qchunk, g, r, d)

    per_row = q_start is not None and torch.as_tensor(q_start).ndim == 1
    if q_start is None:
        q_off = torch.tensor(nk - nq, device=dev)
    else:
        q_off = torch.as_tensor(q_start, device=dev).to(torch.int64)
    step = _flash_step
    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, _flash_step, use_reentrant=False)
    outs = []
    for qi in range(nqc):
        qq = qg[:, qi * qchunk:(qi + 1) * qchunk]
        rel = qi * qchunk + torch.arange(qchunk, device=dev)
        q_pos = rel[None, :] + q_off[:, None] if per_row else rel + q_off
        m = torch.full((b, g, r, qchunk), NEG_INF, device=dev)
        l = torch.zeros(b, g, r, qchunk, device=dev)
        acc = torch.zeros(b, g, r, qchunk, dv, device=dev)
        for ki in range(nkc):
            sl = slice(ki * chunk, (ki + 1) * chunk)
            allowed = None
            if causal:
                key_pos = torch.arange(ki * chunk, (ki + 1) * chunk,
                                       device=dev)
                allowed = q_pos[..., :, None] >= key_pos
                if prefix_len:
                    allowed = allowed | (key_pos < prefix_len)
                if not per_row:
                    allowed = allowed[None]
            m, l, acc = step(m, l, acc, qq, k[:, sl], v[:, sl], mask[:, sl],
                             allowed)
        out = acc / torch.clamp(l[..., None], min=1e-20)     # (B,G,R,Cq,Dv)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qchunk, h, dv)
                    .to(v.dtype))
    return torch.cat(outs, 1)[:, :nq]


def naive_softmax(q, k, v, *, causal: bool = True,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None,
                  prefix_len: int = 0) -> torch.Tensor:
    """Quadratic reference (small N and tests): fp32 scores over repeated
    kv heads, one softmax, the output in ``v.dtype``."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bjhd->bhqj", q.float(), k.float()) * scale
    if mask is not None:
        s = s + torch.where(mask[:, None, None, :], 0.0, NEG_INF)
    if causal:
        kp = torch.arange(nk, device=q.device)
        qp = torch.arange(nq, device=q.device) + (nk - nq)
        allowed = qp[:, None] >= kp[None, :]
        if prefix_len:
            allowed = allowed | (kp[None, :] < prefix_len)
        s = s + torch.where(allowed, 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqj,bjhv->bqhv", p, v.float()).to(v.dtype)


@dataclasses.dataclass
class KVCache:
    """Softmax KV cache: k/v (B, S, G, D[v]) and the filled length, a
    scalar or per row (B,) int32."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def _append(buf: torch.Tensor, new: torch.Tensor,
            start: torch.Tensor) -> torch.Tensor:
    """``buf`` (B,S,...) with ``new`` (B,T,...) written at row offsets
    ``start`` (B,), out of place.  As the reference's
    ``dynamic_update_slice``, a start past S - T is clamped to S - T."""
    t, cap = new.shape[1], buf.shape[1]
    start = torch.clamp(start.to(torch.int64), 0, cap - t)
    idx = start[:, None] + torch.arange(t, device=buf.device)[None, :]
    idx = idx.reshape(idx.shape + (1,) * (new.ndim - 2)).expand(new.shape)
    return buf.scatter(1, idx, new.to(buf.dtype))


def decode_softmax(cache: KVCache, q, k_new, v_new, *,
                   scale: Optional[float] = None, chunk: int = 1024,
                   row_mask: Optional[torch.Tensor] = None,
                   commit_len: Optional[torch.Tensor] = None):
    """Softmax decode of T >= 1 tokens against a KV cache.

    q: (B,T,H,D); k/v_new: (B,T,G,D[v]).  The new keys are written at
    ``cache.length`` (a scalar, or per row (B,)) and the T queries score
    the cache with their absolute positions, so within-chunk causality
    holds.  ``row_mask`` (B,) bool: rows where it is False neither write
    the cache nor advance ``length`` (their outputs are to be discarded).
    ``commit_len`` (B,) int in [0, T], per-row ``length`` only: all T
    tokens are scored, ``length`` advances by ``commit_len`` and rows with
    ``commit_len = 0`` keep their buffers bitwise.  The cache passed in is
    not modified.  Returns (out (B,T,H,Dv), new cache)."""
    per_row = cache.length.ndim == 1
    if commit_len is not None and not per_row:
        raise ValueError("decode_softmax: commit_len requires a per-row "
                         "(B,) cache length")
    b, t = q.shape[:2]
    start = cache.length if per_row else cache.length.expand(b)
    kc = _append(cache.k, k_new, start)
    vc = _append(cache.v, v_new, start)
    ret_k = ret_v = None
    if commit_len is not None:
        cl = commit_lengths(commit_len, row_mask, t)
        keep = (cl > 0)[:, None, None, None]
        ret_k = torch.where(keep, kc, cache.k)
        ret_v = torch.where(keep, vc, cache.v)
        new_len = cache.length + cl
        score_len = cache.length + t
    elif row_mask is not None:
        keep = row_mask[:, None, None, None]
        kc = torch.where(keep, kc, cache.k)
        vc = torch.where(keep, vc, cache.v)
        new_len = cache.length + t * row_mask.to(torch.int32)
        score_len = new_len
    else:
        new_len = cache.length + t
        score_len = new_len
    lens = score_len if score_len.ndim == 1 else score_len.expand(b)
    valid = torch.arange(kc.shape[1], device=q.device)[None, :] \
        < lens[:, None]
    out = flash_softmax(q, kc, vc, causal=True, chunk=min(chunk, kc.shape[1]),
                        mask=valid, scale=scale, q_start=cache.length)
    if ret_k is None:
        ret_k, ret_v = kc, vc
    return out, KVCache(k=ret_k, v=ret_v, length=new_len.to(torch.int32))


def commit_softmax(cache: KVCache, k_new, v_new, *,
                   commit_len: torch.Tensor,
                   row_mask: Optional[torch.Tensor] = None) -> KVCache:
    """The commit half of :func:`decode_softmax`: append the accepted
    prefix of a chunk scored earlier, without scoring; the same cache as
    :func:`decode_softmax` with this ``commit_len``.  Per-row ``length``
    only."""
    if cache.length.ndim != 1:
        raise ValueError("commit_softmax requires a per-row (B,) cache "
                         "length")
    t = k_new.shape[1]
    kc = _append(cache.k, k_new, cache.length)
    vc = _append(cache.v, v_new, cache.length)
    cl = commit_lengths(commit_len, row_mask, t)
    keep = (cl > 0)[:, None, None, None]
    return KVCache(k=torch.where(keep, kc, cache.k),
                   v=torch.where(keep, vc, cache.v),
                   length=(cache.length + cl).to(torch.int32))


def multi_head_attention(q, k, v, cfg: AttnConfig, *, mask=None, alpha=None,
                         beta=None, prefix_len: int = 0) -> torch.Tensor:
    """Full-sequence attention (training / prefill), ``softmax``, ``lln``,
    ``lln_diag`` or ``log_linear``, causal or bidirectional
    (``cfg.causal``; log-linear is causal only).  q: (B,N,H,D); k/v:
    (B,N,G,D[v]).  ``softmax`` is :func:`flash_softmax` with key chunks of
    ``min(cfg.softmax_chunk, N)`` whatever ``use_kernel`` says, as in the
    reference.  alpha/beta default to :func:`batch_alpha_beta` of this
    batch; a per-head (H,) beta is pooled to the G groups.  ``log_linear``
    under ``use_kernel`` on the ``kernel`` kind (the CUDA kernel, ``auto``
    on a CUDA tensor) has no gradient (the reference has no backward
    kernel for it) and raises when one would be needed; its ``plain`` and
    ``ref`` kinds, and the core scan without ``use_kernel``, are plain
    PyTorch, which autograd differentiates, as the reference's scan twin
    and oracle are.  ``mask`` (B, N) key validity: the softmax, and the core
    path's bidirectional LLN and diag part (the kernels take none, as in
    the reference); ``prefix_len``: the softmax's prefix-LM mask (the LLN
    impls approximate a prefix causally, as the reference does)."""
    if is_dtensor(q):               # on a mesh: per rank, under local_map
        from repro_torch.distributed import local_attention
        return local_attention.multi_head_attention(
            q, k, v, cfg, mask=mask, alpha=alpha, beta=beta,
            prefix_len=prefix_len)
    if cfg.impl == "softmax":
        return flash_softmax(q, k, v, causal=cfg.causal,
                             chunk=min(cfg.softmax_chunk, k.shape[1]),
                             mask=mask, prefix_len=prefix_len)
    if cfg.impl not in ("lln", "lln_diag", "log_linear"):
        raise ValueError(f"unknown attention impl: {cfg.impl!r}")
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
        lln_out = lln_bidir(q, kv_k, kv_v, alpha, beta_h, mask=mask)
    if cfg.impl == "lln":
        return lln_out
    diag_out = block_diag_attn(q, kv_k, kv_v, block=cfg.diag_block,
                               causal=cfg.causal, mask=mask)
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
                     *, impl: str = "lln_diag", backend: str = "auto",
                     row_mask=None, commit_len=None, renorm=None):
    """LLN(+Diag) decode of T >= 1 tokens.  q: (B,T,H,D); k/v_new: (B,T,G,D[v]).

    The LLN state advance runs through ``kernels/ops.py:lln_decode_chunk``
    (``auto``/``kernel``/``plain``) or the core reference
    ``core/lln.py:decode_chunk`` (``ref``).  The diag part is one masked
    softmax over [tail ∪ chunk] keys with per-token block-diagonal
    visibility from absolute positions, so a chunk may straddle a block
    boundary.  ``alpha``/``beta`` may be per row ((B, H)/(B, G)).

    The serving contract: ``row_mask`` (B,) bool rows advance nothing (LLN
    state, tails and ``pos`` keep their values; their outputs are to be
    discarded); ``commit_len`` (B,) in [0, T] scores every position but
    folds only the accepted prefix into the LLN state, the tail and
    ``pos`` (0 is the masked row, T a plain decode); ``renorm`` is the
    drift-renorm threshold of ``core/lln.py:decode_chunk``, applied the
    same way by every backend.
    """
    b, t, h, d = q.shape
    if backend != "ref":
        from repro_torch.kernels import ops as kops
        lln_out, lln_state = kops.lln_decode_chunk(
            state.lln, q, k_new, v_new, alpha, beta, backend=backend,
            row_mask=row_mask, commit_len=commit_len, renorm=renorm)
    else:
        g = k_new.shape[2]
        beta_h = torch.as_tensor(beta, dtype=torch.float32)
        if beta_h.ndim and beta_h.shape[-1] == g and g != h:
            beta_h = torch.repeat_interleave(beta_h, h // g, dim=-1)
        lln_out, lln_state = lln_mod.decode_chunk(
            state.lln, q, _repeat_kv(k_new, h), _repeat_kv(v_new, h),
            alpha, beta_h, row_mask=row_mask, commit_len=commit_len,
            renorm=renorm)

    cl = commit_lengths(commit_len, row_mask, t)
    new_state = _roll_tail(state, lln_state, k_new, v_new, cl)
    if impl == "lln":
        return lln_out, new_state
    block = state.tail_k.shape[1]
    dev = q.device
    posb = state.pos.to(torch.int64)                               # (B,)
    idx = torch.arange(block, device=dev)

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


def _roll_tail(state: LLNDecodeState, lln_state, k_new, v_new, cl
               ) -> LLNDecodeState:
    """The decode state after a chunk whose rows commit ``cl`` tokens (the
    int T, or (B,)): the new LLN state, the rolling diag tails and ``pos``.
    For each tail slot i the last committed chunk token writing it is
    j_i = j0 + block*((c-1-j0)//block), j0 = (i-pos) % block, c the row's
    committed length."""
    t = k_new.shape[1]
    block = state.tail_k.shape[1]
    posb = state.pos.to(torch.int64)                               # (B,)
    c = cl[:, None] if torch.is_tensor(cl) else cl
    idx = torch.arange(block, device=k_new.device)
    j0 = torch.remainder(idx[None, :] - posb[:, None], block)      # (B, BLK)
    j_last = torch.clamp(
        j0 + block * torch.div(c - 1 - j0, block, rounding_mode="floor"),
        0, t - 1)
    wrote = (j0 < c)[:, :, None, None]
    gather = j_last[:, :, None, None]
    tail_k = torch.where(
        wrote, torch.take_along_dim(k_new, gather, dim=1).to(state.tail_k.dtype),
        state.tail_k)
    tail_v = torch.where(
        wrote, torch.take_along_dim(v_new, gather, dim=1).to(state.tail_v.dtype),
        state.tail_v)
    return LLNDecodeState(lln=lln_state, tail_k=tail_k, tail_v=tail_v,
                          pos=state.pos + cl)


def commit_lln_chunk(state: LLNDecodeState, k_new, v_new, beta, *,
                     impl: str = "lln_diag", commit_len,
                     row_mask=None, backend: str = "auto",
                     renorm=None) -> LLNDecodeState:
    """The commit half of :func:`decode_lln_chunk`: fold the accepted
    prefix of a chunk scored earlier into the LLN state, the diag tails and
    ``pos``, without scoring.  k/v_new: (B,T,G,D[v]), the post-RoPE keys
    and values the score pass returned.  The same state, bit for bit, as
    :func:`decode_lln_chunk` with this ``commit_len`` on the same backend
    (the two share the LLN fold per backend and :func:`_roll_tail`).
    ``impl`` is accepted for the reference's signature: the state update
    does not depend on it."""
    del impl
    t = k_new.shape[1]
    if backend != "ref":
        from repro_torch.kernels import ops as kops
        lln_state = kops.lln_commit_chunk(
            state.lln, k_new, v_new, beta, backend=backend,
            row_mask=row_mask, commit_len=commit_len, renorm=renorm)
    else:
        h = state.lln.s.shape[1]
        g = k_new.shape[2]
        beta_h = torch.as_tensor(beta, dtype=torch.float32)
        if beta_h.ndim and beta_h.shape[-1] == g and g != h:
            beta_h = torch.repeat_interleave(beta_h, h // g, dim=-1)
        lln_state = lln_mod.commit_chunk(
            state.lln, _repeat_kv(k_new, h), _repeat_kv(v_new, h), beta_h,
            row_mask=row_mask, commit_len=commit_len, renorm=renorm)
    return _roll_tail(state, lln_state, k_new, v_new,
                      commit_lengths(commit_len, row_mask, t))


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
