"""Linear Log-Normal (LLN) attention — the paper's core contribution (eq. 8-9).

Port of ``repro.core.lln``: the plain PyTorch reference of the feature
maps, the bidirectional (encoder) LLN forward, the causal LLN forward, the
state-emitting prefill, the analytic gradient and the one-token and
chunked decode.  These are the oracles the kernels' plain versions and the
``ref`` backend are held to.

Feature maps Phi_Q(q) = exp(alpha*q - c_q), Phi_K(k) = exp(beta*k - c_k)
with per-(batch, head) stop-gradient maxima c_q, c_k: the normalized form is
exactly invariant to them, so they only keep ``exp`` in range.  Decode
carries the key constant ``c_k`` with the state and rescales the state when
a new key raises it.

Layout: (batch, seq, heads, head_dim) for q/k, (batch, seq, heads, v_dim)
for v; k/v here carry the full H heads (the caller repeats GQA kv heads).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

EPS = 1e-6


def _stab_const(x: torch.Tensor) -> torch.Tensor:
    """Per-(batch, head) max over seq and feature, (B, 1, H, 1); 0 where
    the input is empty or non-finite."""
    c = torch.amax(x, dim=(1, 3), keepdim=True).detach()
    return torch.where(torch.isfinite(c), c, torch.zeros_like(c))


def feature_map_q(q, alpha) -> torch.Tensor:
    """Phi_Q(q) = exp(alpha*q - c_q);  q: (B, N, H, D), alpha scalar,
    (H,) or (B, H)."""
    aq = q * _bcast(alpha, q)
    return torch.exp(aq - _stab_const(aq))


def feature_map_k(k, beta) -> torch.Tensor:
    """Phi_K(k) = exp(beta*k - c_k);  k: (B, N, H, D), beta scalar, (H,)
    or (B, H)."""
    bk = k * _bcast(beta, k)
    return torch.exp(bk - _stab_const(bk))


def _bcast(p, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar, per-head (H,) or per-row (B, H) parameter over
    (B, N, H, D)."""
    p = torch.as_tensor(p, dtype=like.dtype, device=like.device)
    if p.ndim == 0:
        return p
    if p.ndim == 2:
        return p[:, None, :, None]
    return p.reshape(1, 1, -1, 1)


@dataclasses.dataclass
class LLNState:
    """Running LLN decode state for one layer.

    s: (B, H, D, Dv) fp32 accumulated Phi(k)^T v; z: (B, H, D) fp32
    accumulated Phi(k); c_k: (B, 1, H, 1) fp32 reference constant the state
    was built with; log_scale: (B, H) accumulated drift-renorm shift.
    """
    s: torch.Tensor
    z: torch.Tensor
    c_k: torch.Tensor
    log_scale: Optional[torch.Tensor] = None


def lln_bidir(q, k, v, alpha, beta, *, mask=None) -> torch.Tensor:
    """Non-causal LLN attention, O(N d^2) time, O(d^2) state.

    out_i = Phi(q_i) S / (Phi(q_i) . z + EPS) with S = sum_j Phi(k_j) v_j^T
    and z = sum_j Phi(k_j) over the whole sequence.  As in the reference,
    the feature maps are rounded to q's / k's dtype and the summaries to
    Phi(q)'s dtype before the fp32 products.  ``mask``: optional (B, N)
    1/0 key validity (masked keys get Phi(k) = 0).
    """
    aq = q * _bcast(alpha, q)
    bk = k * _bcast(beta, k)
    fq = torch.exp(aq - _stab_const(aq)).to(q.dtype)
    fk = torch.exp(bk - _stab_const(bk)).to(k.dtype)
    if mask is not None:
        fk = fk * mask[:, :, None, None].to(fk.dtype)
    fk = fk.float()
    s = torch.einsum("bnhd,bnhv->bhdv", fk, v.float())
    z = fk.sum(1)
    num = torch.einsum("bnhd,bhdv->bnhv", fq.float(), s.to(fq.dtype).float())
    den = torch.einsum("bnhd,bhd->bnh", fq.float(), z.to(fq.dtype).float())
    return (num / (den[..., None] + EPS)).to(v.dtype)


def lln_causal(q, k, v, alpha, beta, *, chunk: int = 128) -> torch.Tensor:
    """Causal LLN via the chunked scan: intra-chunk masked quadratic plus
    the inter-chunk state pass.  O(N * (chunk*d + d^2)) compute."""
    return lln_causal_scan(q, k, v, alpha, beta, chunk=chunk)[0]


def lln_causal_scan(q, k, v, alpha, beta, *, chunk: int = 128):
    """Causal LLN via a chunked scan, returning ``(out, LLNState)``.

    Per chunk: the masked intra-chunk quadratic term plus the carried
    ``(s, z)``.  Ragged lengths pad the feature-mapped keys with zeros so
    padded positions never reach the carry.
    """
    b, n, h, d = q.shape
    dv = v.shape[-1]
    aq = q * _bcast(alpha, q)
    bk = k * _bcast(beta, k)
    c_k = _stab_const(bk)
    fq = torch.exp(aq - _stab_const(aq)).to(q.dtype).float()
    fk = torch.exp(bk - c_k).to(k.dtype).float()
    vf = v.float()
    pad = (-n) % chunk
    if pad:
        fq = torch.nn.functional.pad(fq, (0, 0, 0, 0, 0, pad))
        fk = torch.nn.functional.pad(fk, (0, 0, 0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
    nc = fq.shape[1] // chunk
    causal = torch.tril(torch.ones(chunk, chunk, device=q.device))
    s = torch.zeros(b, h, d, dv, device=q.device)
    z = torch.zeros(b, h, d, device=q.device)
    outs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        cq, ck, cv = fq[:, sl], fk[:, sl], vf[:, sl]
        scores = torch.einsum("bihd,bjhd->bhij", cq, ck) * causal
        intra = torch.einsum("bhij,bjhv->bihv", scores, cv)
        intra_z = scores.sum(-1).transpose(1, 2)               # (B, C, H)
        inter = torch.einsum("bihd,bhdv->bihv", cq, s)
        inter_z = torch.einsum("bihd,bhd->bih", cq, z)
        outs.append((intra + inter) / (intra_z + inter_z + EPS)[..., None])
        s = s + torch.einsum("bjhd,bjhv->bhdv", ck, cv)
        z = z + ck.sum(1)
    out = torch.cat(outs, 1)[:, :n].to(v.dtype)
    return out, LLNState(s=s, z=z, c_k=c_k.float())


def lln_grads(q, k, v, alpha, beta, g, *, causal: bool = True):
    """Analytic ``(dq, dk, dv)`` of LLN attention for the cotangent ``g``.

    The quotient rule through out = num/den, den = Phi(q).z + EPS: with
    u_i = g_i/den_i and w_i = (g_i . out_i)/den_i,

        dPhi(q)_i = sum_j M_ij (u_i . v_j - w_i) Phi(k)_j
        dPhi(k)_j = sum_i M_ij (u_i . v_j - w_i) Phi(q)_i
        dv_j      = sum_i M_ij (Phi(q)_i . Phi(k)_j) u_i

    (M the causal mask), then dq = alpha * Phi(q) * dPhi(q) elementwise
    (the stop-gradient constants drop out), and likewise for k.  O(N^2)
    memory: a test oracle, not a training path.  All heads are full
    (repeat KV before calling for GQA).
    """
    fq = feature_map_q(q.float(), alpha)
    fk = feature_map_k(k.float(), beta)
    vf, gf = v.float(), g.float()
    scores = torch.einsum("bihd,bjhd->bhij", fq, fk)
    n = q.shape[1]
    tril = torch.tril(torch.ones(n, n, device=q.device))
    if causal:
        scores = scores * tril
    den = scores.sum(-1) + EPS                                 # (B, H, N)
    den_t = den.transpose(1, 2)[..., None]                     # (B, N, H, 1)
    out = torch.einsum("bhij,bjhv->bihv", scores, vf) / den_t
    u = gf / den_t
    w = (gf * out).sum(-1) / den_t[..., 0]                     # (B, N, H)
    gmat = torch.einsum("bihv,bjhv->bhij", u, vf) \
        - w.transpose(1, 2)[..., None]
    if causal:
        gmat = gmat * tril
    dq = _bcast(torch.as_tensor(alpha, dtype=torch.float32), fq) * fq \
        * torch.einsum("bhij,bjhd->bihd", gmat, fk)
    dk = _bcast(torch.as_tensor(beta, dtype=torch.float32), fk) * fk \
        * torch.einsum("bhij,bihd->bjhd", gmat, fq)
    dv = torch.einsum("bhij,bihv->bjhv", scores, u)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def prefill(q, k, v, alpha, beta, *, chunk: int = 128):
    """Causal forward over a prompt, returning outputs and the decode state
    (the scan's final carry)."""
    return lln_causal_scan(q, k, v, alpha, beta, chunk=chunk)


def commit_lengths(commit_len: Optional[torch.Tensor],
                   row_mask: Optional[torch.Tensor], t: int):
    """The tokens each row folds this call: ``commit_len`` clipped to
    [0, T], or all T when it is None, and 0 on masked rows (the one
    definition of the contract's edge handling).  (B,) int32, or the int T
    when neither argument is given (a plain decode builds nothing)."""
    if commit_len is None:
        return t if row_mask is None else t * row_mask.to(torch.int32)
    cl = torch.clamp(commit_len.to(torch.int32), 0, t)
    if row_mask is not None:
        cl = torch.where(row_mask, cl, torch.zeros_like(cl))
    return cl


def decode_step(state: LLNState, q, k, v, alpha, beta):
    """One decode step.  q/k/v: (B, 1, H, D[v]).  Returns (out, new_state).

    If the new key raises the stabilization constant, the state is rescaled
    by exp(c_old - c_new) so history and update share one constant.
    """
    bk = k * _bcast(beta, k)
    c_new = torch.maximum(state.c_k,
                          torch.amax(bk, dim=(1, 3), keepdim=True).detach())
    r = torch.exp(state.c_k - c_new)[:, 0, :, 0][..., None]     # (B, H, 1)
    fk = torch.exp(bk - c_new).float()[:, 0]                   # (B, H, D)
    vt = v.float().transpose(1, 2)[:, :, 0]                    # (B, H, Dv)
    s = state.s * r[..., None] + fk[..., None] * vt[:, :, None, :]
    z = state.z * r + fk
    aq = q * _bcast(alpha, q)
    fq = torch.exp(aq - _stab_const(aq)).float()[:, 0]         # (B, H, D)
    num = torch.einsum("bhd,bhdv->bhv", fq, s)
    den = torch.einsum("bhd,bhd->bh", fq, z)
    out = (num / (den[..., None] + EPS)).to(v.dtype)[:, None]  # (B,1,H,Dv)
    return out, LLNState(s=s, z=z, c_k=c_new, log_scale=state.log_scale)


def _renorm(s, z, c_k, log_scale, folded, renorm: float):
    """The drift renorm: where ``max_d z`` exceeds ``renorm`` in a row of
    ``folded`` ((B, 1) bool; None: every row), raise the reference constant
    by delta = ln(max_d z) and scale (s, z) by exp(-delta).  The normalized
    output is invariant to the reference constant, so only the carried
    magnitudes change (``max_d z`` returns to about 1); the shift
    accumulates into ``log_scale``."""
    zmax = torch.amax(z, dim=-1).detach()                      # (B, H)
    fire = zmax > renorm if folded is None else folded & (zmax > renorm)
    delta = torch.where(fire, torch.log(torch.clamp(zmax, min=EPS)),
                        torch.zeros_like(zmax))
    scale = torch.exp(-delta)
    s = s * scale[..., None, None]
    z = z * scale[..., None]
    c_k = c_k + delta[:, None, :, None]
    if log_scale is not None:
        log_scale = log_scale + delta
    return s, z, c_k, log_scale


def folded_rows(row_mask=None, cl=None) -> Optional[torch.Tensor]:
    """(B, 1) bool: the rows that fold at least one token this call (the
    rows the drift renorm may touch); None when every row does.  ``cl`` is
    :func:`commit_lengths`' result, or None."""
    if torch.is_tensor(cl):
        return (cl > 0)[:, None]
    return None if row_mask is None else row_mask[:, None]


def keep_rows(row_mask, new: LLNState, old: LLNState) -> LLNState:
    """Masked rows (``row_mask`` False) keep every leaf of ``old``
    bitwise."""
    if row_mask is None:
        return new
    keep = row_mask
    log_scale = new.log_scale
    if log_scale is not None:
        log_scale = torch.where(keep[:, None], log_scale, old.log_scale)
    return LLNState(
        s=torch.where(keep[:, None, None, None], new.s, old.s),
        z=torch.where(keep[:, None, None], new.z, old.z),
        c_k=torch.where(keep[:, None, None, None], new.c_k, old.c_k),
        log_scale=log_scale)


def decode_chunk(state: LLNState, q, k, v, alpha, beta, row_mask=None,
                 commit_len=None, renorm: Optional[float] = None):
    """Advance the state over T new tokens at once.  q/k/v: (B, T, H, D[v]).

    One max-rescale of the carried state against the chunk's keys, an
    intra-chunk causal quadratic for the new tokens and a per-row
    normalizer: equal to T sequential single-token steps.  ``alpha`` /
    ``beta``: scalar, (H,) or per row (B, H).

    The serving contract, as the reference's:
    ``row_mask`` (B,) bool: rows where it is False keep ``(s, z, c_k,
    log_scale)`` bitwise (their outputs are to be discarded).
    ``commit_len`` (B,) int in [0, T]: every position is scored, but only
    tokens ``j < commit_len[b]`` fold into the state, the reference
    constant advancing over the committed keys only; 0 is the masked row,
    T a plain decode.
    ``renorm``: the drift-renorm threshold on ``max_d z`` (:func:`_renorm`),
    applied after the fold to the rows that folded at least one token.
    """
    t = q.shape[1]
    bk = k * _bcast(beta, k)
    cl = None
    if commit_len is not None:
        cl = commit_lengths(commit_len, row_mask, t)
        # The committed prefix's constant (an empty commit keeps c_k); the
        # scores need one covering every chunk key.
        _, c_new = _committed(state, bk, cl)
        c_out = torch.maximum(
            c_new, torch.amax(bk, dim=(1, 3), keepdim=True).detach())
    else:
        c_new = torch.maximum(
            state.c_k, torch.amax(bk, dim=(1, 3), keepdim=True).detach())
        c_out = c_new
    r_out = torch.exp(state.c_k - c_out)[:, 0, :, 0]           # (B, H) <= 1
    fk = torch.exp(bk - c_out).float()
    vf = v.float()
    aq = q * _bcast(alpha, q)
    fq = torch.exp(aq - _stab_const(aq)).float()
    s0 = state.s * r_out[..., None, None]
    z0 = state.z * r_out[..., None]
    causal = torch.tril(torch.ones(t, t, device=q.device))
    scores = torch.einsum("bihd,bjhd->bhij", fq, fk) * causal
    intra = torch.einsum("bhij,bjhv->bihv", scores, vf)
    intra_z = scores.sum(-1).transpose(1, 2)
    inter = torch.einsum("bihd,bhdv->bihv", fq, s0)
    inter_z = torch.einsum("bihd,bhd->bih", fq, z0)
    out = (intra + inter) / (intra_z + inter_z + EPS)[..., None]
    if cl is not None:
        return out.to(v.dtype), _fold_committed(state, bk, vf, cl, row_mask,
                                                renorm)
    s = s0 + torch.einsum("bjhd,bjhv->bhdv", fk, vf)
    z = z0 + fk.sum(1)
    log_scale = state.log_scale
    if renorm is not None and renorm > 0.0:
        s, z, c_new, log_scale = _renorm(
            s, z, c_new, log_scale, folded_rows(row_mask, cl), renorm)
    new = LLNState(s=s, z=z, c_k=c_new, log_scale=log_scale)
    return out.to(v.dtype), keep_rows(row_mask, new, state)


def _committed(state: LLNState, bk, cl):
    """``(bk_c, c_new)``: beta*k with the keys past each row's commit
    length at -inf, and the reference constant advanced over the committed
    keys only (an empty commit keeps c_k)."""
    t = bk.shape[1]
    cmask = torch.arange(t, device=bk.device)[None, :] < cl[:, None]
    bk_c = torch.where(cmask[:, :, None, None], bk, -torch.inf)
    c_new = torch.maximum(
        state.c_k, torch.amax(bk_c, dim=(1, 3), keepdim=True).detach())
    return bk_c, c_new


def _fold_committed(state: LLNState, bk, vf, cl, row_mask, renorm):
    """Fold each row's first ``cl`` keys (beta*k ``bk``, fp32 values
    ``vf``) into the state, with the drift renorm and the row mask: the
    state half of :func:`decode_chunk` under ``commit_len``, and all of
    :func:`commit_chunk`, so the two agree bit for bit."""
    bk_c, c_new = _committed(state, bk, cl)
    r_c = torch.exp(state.c_k - c_new)[:, 0, :, 0]
    fk_c = torch.exp(bk_c - c_new).float()                  # 0 past commit
    s = state.s * r_c[..., None, None] \
        + torch.einsum("bjhd,bjhv->bhdv", fk_c, vf)
    z = state.z * r_c[..., None] + fk_c.sum(1)
    log_scale = state.log_scale
    if renorm is not None and renorm > 0.0:
        s, z, c_new, log_scale = _renorm(
            s, z, c_new, log_scale, folded_rows(row_mask, cl), renorm)
    new = LLNState(s=s, z=z, c_k=c_new, log_scale=log_scale)
    return keep_rows(row_mask, new, state)


def full_commit(t: int, like: torch.Tensor) -> torch.Tensor:
    """A (B,) commit length of ``t`` for every row of ``like`` (B, ...)."""
    return torch.full((like.shape[0],), t, dtype=torch.int32,
                      device=like.device)


def commit_chunk(state: LLNState, k, v, beta, row_mask=None,
                 commit_len=None, renorm: Optional[float] = None) -> LLNState:
    """Fold a chunk's accepted prefix into the state without scoring.

    The state half of :func:`decode_chunk`: the same (k, v, beta), the
    same :func:`commit_lengths` contract (None commits all T), the same
    drift renorm and ``row_mask``, no queries.  A speculative verify scores
    its chunk with ``commit_len=0`` (the state untouched); once the accept
    counts are known this O(T d^2) fold commits the accepted prefix, equal
    bit for bit to :func:`decode_chunk` with that ``commit_len``.
    k/v: (B, T, H, D[v]).
    """
    t = k.shape[1]
    cl = commit_lengths(commit_len if commit_len is not None
                        else full_commit(t, k), row_mask, t)
    return _fold_committed(state, k * _bcast(beta, k), v.float(), cl,
                           row_mask, renorm)
