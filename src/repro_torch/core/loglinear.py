"""Log-linear multi-scale LLN state: a Fenwick-tree pyramid of buckets.

Port of ``repro.core.loglinear``.  One LLN ``(s, z)`` running sum
compresses the whole context into a single O(d^2) state; this module keeps
O(log N) dyadic buckets arranged as a binary counter instead.  Closing one
``granule``-sized chunk of keys inserts a level-0 bucket; two level-l
buckets merge into one level-(l+1) bucket like a carry in a binary
increment.  After ``n`` closed granules the occupied levels are the set
bits of ``n`` (the top level saturates, see :func:`occupancy`).

Scoring mixes the buckets with per-scale weights ``w_l = scale_decay**l``
under one shared normalizer:

    out_i = (sum_l w_l Phi(q_i) . S_l  +  Phi(q_i) . S_open  +  intra_i)
            / (same with z  +  EPS)

The open (partially filled) granule and the intra-chunk keys score at
weight 1.  ``scale_decay = 1`` or ``num_scales = 1`` give plain causal LLN.

Numerics follow ``core/lln.py``: every bucket carries its own reference
constant (``cl`` per level, ``c_k`` for the open bucket); merges rescale
both operands to the larger reference.  Decode honours the serving
contract of ``core/lln.py:decode_chunk`` (``row_mask``, ``commit_len`` and
the drift renorm, per bucket), and :func:`commit_chunk` folds a scored
chunk's accepted prefix (the speculative verify's commit).

Layout: (batch, seq, heads, head_dim); k/v carry the full H heads (the
caller repeats GQA kv heads).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .lln import (EPS, _bcast, _renorm, _stab_const, commit_lengths,
                  folded_rows)


@dataclasses.dataclass
class LogLinState:
    """Multi-scale decode state for one layer (full H query heads).

    s / z / c_k / log_scale: the open bucket, exactly an ``LLNState``: s
    (B,H,D,Dv), z (B,H,D), c_k (B,1,H,1), log_scale (B,H), all fp32.
    sl (B,L,H,D,Dv), zl (B,L,H,D), cl (B,L,H) fp32: the closed-bucket
    pyramid, level l at index l, with per-bucket reference constants.
    Unoccupied levels hold zeros; occupancy comes from the row position.
    """
    s: torch.Tensor
    z: torch.Tensor
    c_k: torch.Tensor
    sl: torch.Tensor
    zl: torch.Tensor
    cl: torch.Tensor
    log_scale: Optional[torch.Tensor] = None

    @staticmethod
    def init(batch: int, heads: int, d: int, dv: int, num_scales: int,
             device=None) -> "LogLinState":
        f32 = dict(dtype=torch.float32, device=device)
        return LogLinState(
            s=torch.zeros(batch, heads, d, dv, **f32),
            z=torch.zeros(batch, heads, d, **f32),
            c_k=torch.zeros(batch, 1, heads, 1, **f32),
            sl=torch.zeros(batch, num_scales, heads, d, dv, **f32),
            zl=torch.zeros(batch, num_scales, heads, d, **f32),
            cl=torch.zeros(batch, num_scales, heads, **f32),
            log_scale=torch.zeros(batch, heads, **f32))


def level_weights(num_scales: int, scale_decay: float,
                  device=None) -> torch.Tensor:
    """Per-scale mix weights ``w_l = scale_decay**l``, (L,) fp32."""
    return torch.tensor([float(scale_decay) ** l for l in range(num_scales)],
                        dtype=torch.float32, device=device)


def occupancy(n, num_scales: int) -> torch.Tensor:
    """Which pyramid levels hold a bucket after ``n`` closed granules.

    Level ``l < L-1`` is occupied iff bit ``l`` of ``n`` is set; the top
    level saturates (``n >= 2^(L-1)``): carries past it merge into it.
    ``n``: an int or an int tensor; returns (..., L) float32 in {0, 1}.
    """
    n = torch.as_tensor(n, dtype=torch.int32)
    if num_scales == 1:
        return (n[..., None] >= 1).float()
    ls = torch.arange(num_scales - 1, dtype=torch.int32, device=n.device)
    low = ((n[..., None] >> ls) & 1).float()
    top = (n >= 2 ** (num_scales - 1)).float()
    return torch.cat([low, top[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Quadratic oracle (the test reference; never a serving path).
# ---------------------------------------------------------------------------

def level_matrix(n: int, *, granule: int, num_scales: int,
                 device=None) -> torch.Tensor:
    """(N, N) int32: pyramid level of key j as seen by query t.  Keys of
    the query's own granule are level 0; entries above the diagonal are
    level 0 too (callers mask causally)."""
    pos = torch.arange(n, dtype=torch.int32, device=device)
    nq = (pos // granule)[:, None]          # query's granule == closed count
    gj = (pos // granule)[None, :]          # key's granule
    ls = num_scales
    top_count = nq - (nq & ((1 << (ls - 1)) - 1))    # low L-1 bits cleared
    zero = torch.zeros((), dtype=torch.int32, device=device)
    lev = torch.where(gj < top_count, zero + (ls - 1), zero)
    for l in range(ls - 1):
        hi = (nq >> (l + 1)) << (l + 1)
        in_l = (((nq >> l) & 1) == 1) & (gj >= hi) & (gj < hi + (1 << l)) \
            & (gj >= top_count)
        lev = torch.where(in_l, zero + l, lev)
    return torch.where(gj == nq, zero, lev)


def _feature_maps(q, k, v, alpha, beta):
    """fp32 ``(fq, fk, vf, c_k)`` with per-(batch, head) constants."""
    aq = q * _bcast(alpha, q)
    bk = k * _bcast(beta, k)
    c_k = _stab_const(bk)
    fq = torch.exp(aq - _stab_const(aq)).float()
    fk = torch.exp(bk - c_k).float()
    return fq, fk, v.float(), c_k


def loglin_attention_ref(q, k, v, alpha, beta, *, granule: int,
                         num_scales: int, scale_decay: float) -> torch.Tensor:
    """Causal multi-scale LLN attention in quadratic form (full H heads):
    key j weighs ``scale_decay**level(t, j)`` for query t."""
    n = q.shape[1]
    fq, fk, vf, _ = _feature_maps(q, k, v, alpha, beta)
    lev = level_matrix(n, granule=granule, num_scales=num_scales,
                       device=q.device)
    w = torch.tensor(float(scale_decay), device=q.device) ** lev.float() \
        * torch.tril(torch.ones(n, n, device=q.device))
    scores = torch.einsum("bihd,bjhd->bhij", fq, fk) * w
    num = torch.einsum("bhij,bjhv->bihv", scores, vf)
    den = scores.sum(-1).transpose(1, 2)                         # (B,N,H)
    return (num / (den[..., None] + EPS)).to(v.dtype)


# ---------------------------------------------------------------------------
# Prefill: a scan over granules carrying the pyramid.  One stabilization
# constant per (batch, head): every bucket shares it, so merges are adds.
# ---------------------------------------------------------------------------

def _cascade_same_ref(sl, zl, g_s, g_z, i: int, num_scales: int):
    """Insert a closed granule ``(g_s, g_z)`` into a pyramid whose buckets
    share one reference; ``i`` is the closed count before the insert.
    Binary-increment carry; the top level saturates."""
    inc_s, inc_z = g_s, g_z
    carry = True
    new_s, new_z = [], []
    for l in range(num_scales - 1):
        occ = (i >> l) & 1 == 1
        mrg, take = carry and occ, carry and not occ
        new_s.append(inc_s if take else (torch.zeros_like(inc_s) if mrg
                                         else sl[:, l]))
        new_z.append(inc_z if take else (torch.zeros_like(inc_z) if mrg
                                         else zl[:, l]))
        if mrg:
            inc_s, inc_z = sl[:, l] + inc_s, zl[:, l] + inc_z
        carry = mrg
    top = num_scales - 1
    new_s.append(sl[:, top] + inc_s if carry else sl[:, top])
    new_z.append(zl[:, top] + inc_z if carry else zl[:, top])
    return torch.stack(new_s, 1), torch.stack(new_z, 1)


def _mix(w, occ, sl, zl):
    """``sum_l w_l occ_l (S_l, z_l)`` over (B, L, H, ...) pyramids."""
    wv = w * occ
    return (torch.einsum("l,blhdv->bhdv", wv, sl),
            torch.einsum("l,blhd->bhd", wv, zl))


def _granule_out(cq, ck, cv, s_eff, z_eff):
    """Outputs of one granule: causal intra term plus the pyramid mix."""
    t = cq.shape[1]
    tri = torch.tril(torch.ones(t, t, device=cq.device))
    scores = torch.einsum("bihd,bjhd->bhij", cq, ck) * tri
    intra = torch.einsum("bhij,bjhv->bihv", scores, cv)
    intra_z = scores.sum(-1).transpose(1, 2)
    inter = torch.einsum("bihd,bhdv->bihv", cq, s_eff)
    inter_z = torch.einsum("bihd,bhd->bih", cq, z_eff)
    return (intra + inter) / (intra_z + inter_z + EPS)[..., None]


def prefill(q, k, v, alpha, beta, *, granule: int, num_scales: int,
            scale_decay: float):
    """Causal multi-scale forward over a prompt; returns ``(out,
    LogLinState)``.  The trailing ``N % granule`` keys land in the open
    bucket.  q: (B,N,H,D); k/v: (B,N,H,D[v]) (full heads)."""
    b, n, h, d = q.shape
    dv = v.shape[-1]
    ls = num_scales
    dev = q.device
    fq, fk, vf, c_k = _feature_maps(q, k, v, alpha, beta)
    w = level_weights(ls, scale_decay, dev)
    nf = n // granule
    sl = torch.zeros(b, ls, h, d, dv, device=dev)
    zl = torch.zeros(b, ls, h, d, device=dev)
    pieces = []
    for i in range(nf):
        cut = slice(i * granule, (i + 1) * granule)
        cq, ck, cv = fq[:, cut], fk[:, cut], vf[:, cut]
        s_eff, z_eff = _mix(w, occupancy(i, ls).to(dev), sl, zl)
        pieces.append(_granule_out(cq, ck, cv, s_eff, z_eff))
        g_s = torch.einsum("bjhd,bjhv->bhdv", ck, cv)
        sl, zl = _cascade_same_ref(sl, zl, g_s, ck.sum(1), i, ls)
    if n > nf * granule:
        cut = slice(nf * granule, n)
        tq, tk, tv = fq[:, cut], fk[:, cut], vf[:, cut]
        s_eff, z_eff = _mix(w, occupancy(nf, ls).to(dev), sl, zl)
        pieces.append(_granule_out(tq, tk, tv, s_eff, z_eff))
        s_open = torch.einsum("bjhd,bjhv->bhdv", tk, tv)
        z_open = tk.sum(1)
    else:
        s_open = torch.zeros(b, h, d, dv, device=dev)
        z_open = torch.zeros(b, h, d, device=dev)
    out = torch.cat(pieces, 1)
    c_k = c_k.float()
    state = LogLinState(
        s=s_open, z=z_open, c_k=c_k, sl=sl, zl=zl,
        cl=c_k[:, 0, :, 0][:, None, :].expand(b, ls, h).clone(),
        log_scale=torch.zeros(b, h, device=dev))
    return out.to(v.dtype), state


# ---------------------------------------------------------------------------
# Decode: a chunked multi-token advance crossing at most one boundary.
# ---------------------------------------------------------------------------

def _sel(mask, a, b):
    """Per-row select: broadcast a (B,) bool over a's trailing dims."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def _masked_max(bk, mask, floor):
    """``max(floor, max over the masked keys of bk)`` per (batch, head),
    (B,1,H,1), and bk with the other keys at -inf."""
    bk_m = torch.where(mask[:, :, None, None], bk, -torch.inf)
    return torch.maximum(floor, torch.amax(bk_m, dim=(1, 3),
                                           keepdim=True)), bk_m


def _fold(fk, vf):
    return torch.einsum("bjhd,bjhv->bhdv", fk, vf), fk.sum(1)


def _advance(state: LogLinState, bk, vf, *, pos, granule: int,
             num_scales: int, t: int, row_mask=None, commit_len=None,
             renorm=None):
    """The state advance of :func:`decode_chunk`.

    ``bk`` = beta*k (B,T,H,D) fp32; ``vf`` (B,T,H,Dv) fp32; ``pos`` (B,)
    int32 tokens already folded.  Returns ``(new_state, aux)``; ``aux`` =
    ``(split, crossed, occ, occ2, sl2, zl2, cl2)`` is what scoring needs:
    the pre-boundary count ``split``, whether the commit closes the open
    granule, the occupancies before and after the close, and the cascaded
    pyramid (which absorbed every pre-boundary chunk key: what a sequential
    decode would see).  The committed state folds only ``j <
    commit_len``; a commit that crosses the boundary has committed every
    pre-boundary key, so there the two folds coincide.  ``row_mask`` rows
    keep every leaf bitwise; ``renorm`` renormalizes the open bucket of the
    rows that folded a token and the closed buckets of those that crossed,
    each into its own reference.
    """
    b = bk.shape[0]
    ls = num_scales
    dev = bk.device
    cl_c = commit_lengths(commit_len, row_mask, t)   # (B,) or the int T
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    n = pos // granule
    split = granule - (pos - n * granule)            # (B,) in [1, granule]
    crossed = cl_c >= split                          # the close fires
    j = torch.arange(t, device=dev)
    # Close the open granule with every pre-boundary key (the scoring view;
    # the committed one too whenever ``crossed``).
    c_cas, bk_a = _masked_max(bk, j[None, :] < split[:, None], state.c_k)
    r_a = torch.exp(state.c_k - c_cas)[:, 0, :, 0]              # (B,H)
    add_s, add_z = _fold(torch.exp(bk_a - c_cas), vf)
    closed_s = state.s * r_a[..., None, None] + add_s
    closed_z = state.z * r_a[..., None] + add_z
    inc_s, inc_z, inc_c = closed_s, closed_z, c_cas[:, 0, :, 0]
    # Fenwick carry-merge: insert at level 0, merge upward while occupied;
    # the top level saturates.
    occ = occupancy(n, ls)                                      # (B,L)
    carry = torch.ones(b, dtype=torch.bool, device=dev)
    new_sl, new_zl, new_cl = [], [], []
    for l in range(ls):
        o_l = occ[:, l] > 0.5
        mrg, take = carry & o_l, carry & ~o_l
        old_s, old_z, old_c = state.sl[:, l], state.zl[:, l], state.cl[:, l]
        cm = torch.maximum(old_c, inc_c)
        e_old, e_inc = torch.exp(old_c - cm), torch.exp(inc_c - cm)
        sm = old_s * e_old[..., None, None] + inc_s * e_inc[..., None, None]
        zm = old_z * e_old[..., None] + inc_z * e_inc[..., None]
        if l < ls - 1:        # a merged level empties; the carry moves up
            keep_s, keep_z = torch.zeros_like(inc_s), torch.zeros_like(inc_z)
            keep_c = torch.zeros_like(inc_c)
        else:                 # the saturated top keeps the merge
            keep_s, keep_z, keep_c = sm, zm, cm
        new_sl.append(_sel(take, inc_s, _sel(mrg, keep_s, old_s)))
        new_zl.append(_sel(take, inc_z, _sel(mrg, keep_z, old_z)))
        new_cl.append(_sel(take, inc_c, _sel(mrg, keep_c, old_c)))
        inc_s, inc_z, inc_c = (_sel(mrg, sm, inc_s), _sel(mrg, zm, inc_z),
                               _sel(mrg, cm, inc_c))
        carry = mrg
    sl2 = torch.stack(new_sl, 1)
    zl2 = torch.stack(new_zl, 1)
    cl2 = torch.stack(new_cl, 1)
    occ2 = occupancy(n + 1, ls)
    # The committed pyramid takes the cascade only when the commit crossed.
    sl_new = _sel(crossed, sl2, state.sl)
    zl_new = _sel(crossed, zl2, state.zl)
    cl_new = _sel(crossed, cl2, state.cl)
    # Not crossed: the open bucket folds the committed keys j < commit.  A
    # full commit that does not cross commits every key, j < T < split:
    # that is the cascade's fold.
    s_nc, z_nc, c_nc = closed_s, closed_z, c_cas
    if commit_len is not None:
        c_nc, bk_nc = _masked_max(
            bk, j[None, :] < torch.minimum(cl_c, split)[:, None], state.c_k)
        r_nc = torch.exp(state.c_k - c_nc)[:, 0, :, 0]
        add_s, add_z = _fold(torch.exp(bk_nc - c_nc), vf)
        s_nc = state.s * r_nc[..., None, None] + add_s
        z_nc = state.z * r_nc[..., None] + add_z
    # Crossed: a new open bucket from the committed post-boundary keys, its
    # reference from zero as a fresh row's first fold.
    post = j[None, :] >= split[:, None]
    if torch.is_tensor(cl_c):
        post = post & (j[None, :] < cl_c[:, None])
    c_b, bk_b = _masked_max(bk, post, torch.zeros_like(state.c_k))
    s_b, z_b = _fold(torch.exp(bk_b - c_b), vf)
    s_new = _sel(crossed, s_b, s_nc)
    z_new = _sel(crossed, z_b, z_nc)
    c_new = _sel(crossed, c_b, c_nc)
    log_scale = state.log_scale
    if renorm is not None and renorm > 0.0:
        # The open bucket: the drift renorm of core/lln.py (the shift folds
        # into c_k, which the mix weight exp(c_k - c_out) repays exactly).
        s_new, z_new, c_new, log_scale = _renorm(
            s_new, z_new, c_new, log_scale, folded_rows(row_mask, cl_c),
            renorm)
        # The closed buckets renormalize into their own cl at the merge.
        zlmax = torch.amax(zl_new, dim=-1)                      # (B,L,H)
        dl = torch.where(crossed[:, None, None] & (zlmax > renorm),
                         torch.log(torch.clamp(zlmax, min=EPS)),
                         torch.zeros_like(zlmax))
        sc = torch.exp(-dl)
        sl_new = sl_new * sc[..., None, None]
        zl_new = zl_new * sc[..., None]
        cl_new = cl_new + dl
    if row_mask is not None:
        keep = row_mask
        s_new, z_new, c_new = (_sel(keep, s_new, state.s),
                               _sel(keep, z_new, state.z),
                               _sel(keep, c_new, state.c_k))
        sl_new, zl_new, cl_new = (_sel(keep, sl_new, state.sl),
                                  _sel(keep, zl_new, state.zl),
                                  _sel(keep, cl_new, state.cl))
        if log_scale is not None:
            log_scale = _sel(keep, log_scale, state.log_scale)
    new = LogLinState(s=s_new, z=z_new, c_k=c_new, sl=sl_new, zl=zl_new,
                      cl=cl_new, log_scale=log_scale)
    return new, (split, crossed, occ, occ2, sl2, zl2, cl2)


def _aggregate(sl, zl, cl, occ, w, c_out):
    """Weighted pyramid aggregate at reference ``c_out`` (B,1,H,1):
    ``sum_l occ_l w_l exp(cl_l - c_out) (sl_l, zl_l)``.  Unoccupied levels
    are masked to -inf before the exp (a stale ``cl`` must not
    overflow)."""
    c_o = c_out[:, 0, :, 0]                                     # (B,H)
    cl_occ = torch.where(occ[..., None] > 0.5, cl, -torch.inf)  # (B,L,H)
    wl = occ[..., None] * w[None, :, None] * torch.exp(cl_occ - c_o[:, None])
    return (torch.einsum("blh,blhdv->bhdv", wl, sl),
            torch.einsum("blh,blhd->bhd", wl, zl))


def inter_views(state: LogLinState, aux, w, c_out):
    """``((s_a, z_a), (s_b, z_b))`` at the reference ``c_out``: the
    pre-boundary view pyramid(n) + open bucket, and the post-boundary view
    pyramid(n+1)."""
    _, _, occ, occ2, sl2, zl2, cl2 = aux
    s_a, z_a = _aggregate(state.sl, state.zl, state.cl, occ, w, c_out)
    r_open = torch.exp(state.c_k - c_out)[:, 0, :, 0]            # (B,H)
    s_a = s_a + state.s * r_open[..., None, None]
    z_a = z_a + state.z * r_open[..., None]
    return (s_a, z_a), _aggregate(sl2, zl2, cl2, occ2, w, c_out)


def state_reference(state: LogLinState, aux, bk) -> torch.Tensor:
    """The scoring reference (B,1,H,1) covering every occupied bucket and
    every chunk key."""
    occ = aux[2]
    cl_occ = torch.where(occ[..., None] > 0.5, state.cl, -torch.inf)
    c_state = torch.amax(cl_occ, dim=1)[:, None, :, None]
    return torch.maximum(torch.maximum(state.c_k, c_state),
                         torch.amax(bk, dim=(1, 3), keepdim=True))


def decode_chunk(state: LogLinState, q, k, v, alpha, beta, *, pos,
                 granule: int, num_scales: int, scale_decay: float,
                 row_mask=None, commit_len=None, renorm=None):
    """Advance the multi-scale state over T new tokens.

    q/k/v: (B,T,H,D[v]) full heads; ``pos``: (B,) int32 tokens already in
    the state (per row: rows at different depths see different bucket
    layouts).  Each position scores what a sequential decode would see:
    pre-boundary queries mix pyramid(n) + open + intra, post-boundary ones
    pyramid(n+1) (which absorbed the closed granule and every pre-boundary
    chunk key) + intra over post-boundary keys.  The serving contract of
    ``core/lln.py:decode_chunk``: ``row_mask`` rows keep every leaf
    bitwise, ``commit_len`` scores all T positions but folds only the
    accepted prefix, ``renorm`` bounds the carried magnitudes per bucket
    (:func:`_advance`).  ``T > granule`` runs in granule-sized sub-chunks
    (full commit only: a speculative draft is never longer than a
    granule).  Returns ``(out, new LogLinState)``.
    """
    b, t, h, _ = q.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    if t > granule:
        if commit_len is not None:
            raise ValueError(
                "log_linear decode_chunk supports commit_len only for "
                f"T <= granule (T={t}, granule={granule})")
        outs = []
        done = torch.zeros_like(pos)
        for i0 in range(0, t, granule):
            cut = slice(i0, min(i0 + granule, t))
            o, state = decode_chunk(
                state, q[:, cut], k[:, cut], v[:, cut], alpha, beta,
                pos=pos + done, granule=granule, num_scales=num_scales,
                scale_decay=scale_decay, row_mask=row_mask, renorm=renorm)
            step = cut.stop - cut.start
            done = done + commit_lengths(None, row_mask, step)
            outs.append(o)
        return torch.cat(outs, 1), state
    bk = (k * _bcast(beta, k)).float()
    aq = q * _bcast(alpha, q)
    fq = torch.exp(aq - _stab_const(aq)).float()
    vf = v.float()
    w = level_weights(num_scales, scale_decay, q.device)
    new_state, aux = _advance(state, bk, vf, pos=pos, granule=granule,
                              num_scales=num_scales, t=t, row_mask=row_mask,
                              commit_len=commit_len, renorm=renorm)
    split = aux[0]
    c_out = state_reference(state, aux, bk)
    fk = torch.exp(bk - c_out).float()
    (s_a, z_a), (s_b, z_b) = inter_views(state, aux, w, c_out)
    # Intra: causal and on the same side of the boundary (post-boundary
    # queries see pre-boundary chunk keys through pyramid(n+1)).
    j = torch.arange(t, device=q.device)
    tri = j[:, None] >= j[None, :]
    pre = j[None, :] < split[:, None]                           # (B,T)
    mask = (tri[None] & (pre[:, :, None] | ~pre[:, None, :])).float()
    scores = torch.einsum("bihd,bjhd->bhij", fq, fk) * mask[:, None]
    intra = torch.einsum("bhij,bjhv->bihv", scores, vf)
    intra_z = scores.sum(-1).transpose(1, 2)                    # (B,T,H)
    inter = torch.where(pre[..., None, None],
                        torch.einsum("bihd,bhdv->bihv", fq, s_a),
                        torch.einsum("bihd,bhdv->bihv", fq, s_b))
    inter_z = torch.where(pre[..., None],
                          torch.einsum("bihd,bhd->bih", fq, z_a),
                          torch.einsum("bihd,bhd->bih", fq, z_b))
    out = (intra + inter) / (intra_z + inter_z + EPS)[..., None]
    return out.to(v.dtype), new_state


def commit_chunk(state: LogLinState, k, v, beta, *, pos, granule: int,
                 num_scales: int, row_mask=None, commit_len=None,
                 renorm=None) -> LogLinState:
    """Fold a scored chunk's accepted prefix without scoring: the
    speculative verify's commit.  It runs the ``_advance`` that
    :func:`decode_chunk` runs, so it equals that decode with the final
    ``commit_len`` bit for bit.  k/v: (B,T,H,D[v]), T <= granule."""
    t = k.shape[1]
    if t > granule:
        raise ValueError(f"log_linear commit_chunk requires T <= granule "
                         f"(T={t}, granule={granule})")
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k.device)
    new_state, _ = _advance(state, (k * _bcast(beta, k)).float(), v.float(),
                            pos=pos, granule=granule, num_scales=num_scales,
                            t=t, row_mask=row_mask, commit_len=commit_len,
                            renorm=renorm)
    return new_state
