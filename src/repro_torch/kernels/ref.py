"""Quadratic-form oracles for the port's kernels (kernel layout), in plain
PyTorch (port of ``repro.kernels.ref``, same names and signatures).

q/k (BH, N, D) (already alpha/beta-scaled and stabilized for LLN), v
(BG, N, Dv); GQA is ``r = H // G``: query row ``bh`` reads kv row
``bh // r``.  The backward oracles return the kv gradients summed over the
r query heads that share each kv row.
"""
from __future__ import annotations

import torch

EPS = 1e-6
NEG_INF = -1e30


def _expand_kv(t: torch.Tensor, r: int) -> torch.Tensor:
    return t if r == 1 else torch.repeat_interleave(t, r, dim=0)


def _tril(n: int, device) -> torch.Tensor:
    return torch.tril(torch.ones(n, n, device=device))


def lln_bidir_ref(qs, ks, v, r: int = 1) -> torch.Tensor:
    """Bidirectional LLN: out_i = e^{qs_i} S / (e^{qs_i} . z)."""
    fq = torch.exp(qs.float())
    fk = torch.exp(ks.float())
    s = _expand_kv(torch.einsum("gnd,gnv->gdv", fk, v.float()), r)
    z = _expand_kv(fk.sum(1), r)
    num = torch.einsum("hnd,hdv->hnv", fq, s)
    den = torch.einsum("hnd,hd->hn", fq, z)
    return (num / (den[..., None] + EPS)).to(v.dtype)


def lln_causal_ref(qs, ks, v, r: int = 1) -> torch.Tensor:
    """Causal LLN: P = tril(e^{qs} e^{ks}^T), row-normalized."""
    fq = torch.exp(qs.float())
    fk = torch.exp(_expand_kv(ks, r).float())
    vf = _expand_kv(v, r).float()
    n = qs.shape[1]
    scores = torch.einsum("hid,hjd->hij", fq, fk) * _tril(n, qs.device)
    out = torch.einsum("hij,hjv->hiv", scores, vf)
    return (out / (scores.sum(-1)[..., None] + EPS)).to(v.dtype)


def block_diag_ref(q, k, v, *, block: int, causal: bool, r: int = 1,
                   scale: float | None = None) -> torch.Tensor:
    """Block-diagonal softmax attention (N divisible by ``block``)."""
    k = _expand_kv(k, r)
    v = _expand_kv(v, r)
    bh, n, d = q.shape
    dv = v.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    nb = n // block
    qb = q.reshape(bh, nb, block, d).float() * scale
    kb = k.reshape(bh, nb, block, d).float()
    vb = v.reshape(bh, nb, block, dv).float()
    s = torch.einsum("hgid,hgjd->hgij", qb, kb)
    if causal:
        tri = torch.tril(torch.ones(block, block, dtype=torch.bool,
                                    device=q.device))
        s = torch.where(tri, s, NEG_INF)
    out = torch.einsum("hgij,hgjv->hgiv", torch.softmax(s, dim=-1), vb)
    return out.reshape(bh, n, dv).to(v.dtype)


def lln_prefill_state_ref(qs, ks, v, r: int = 1):
    """(out, s, z) of the state-emitting causal kernel: s = sum_j
    Phi(k_j) v_j^T (BH, D, Dv), z = sum_j Phi(k_j) (BH, 1, D), per
    query-head row."""
    fk = torch.exp(_expand_kv(ks, r).float())
    vf = _expand_kv(v, r).float()
    return (lln_causal_ref(qs, ks, v, r),
            torch.einsum("hnd,hnv->hdv", fk, vf), fk.sum(1, keepdim=True))


def _segsum_kv(t: torch.Tensor, r: int) -> torch.Tensor:
    """A per-query-head gradient summed over the r heads of each kv row."""
    if r == 1:
        return t
    return t.reshape(t.shape[0] // r, r, *t.shape[1:]).sum(1)


def _mask(n: int, causal: bool, device) -> torch.Tensor:
    return _tril(n, device) if causal else torch.ones(n, n, device=device)


def lln_fwd_res_ref(qs, ks, v, causal: bool, r: int = 1):
    """The forward with its fp32 residuals: ``(out, den)``."""
    fq = torch.exp(qs.float())
    fk = torch.exp(_expand_kv(ks, r).float())
    vf = _expand_kv(v, r).float()
    scores = torch.einsum("hid,hjd->hij", fq, fk) \
        * _mask(qs.shape[1], causal, qs.device)
    den = scores.sum(-1) + EPS
    return torch.einsum("hij,hjv->hiv", scores, vf) / den[..., None], den


def lln_bwd_ref(qs, ks, v, g, o, den, causal: bool, r: int = 1):
    """Analytic LLN backward (quadratic form): u = g/den, w = (g.o)/den,
    G_ij = (u_i.v_j - w_i) * mask; dqs = fq * (G @ fk), dks = fk * (G^T @
    fq), dv = scores^T @ u."""
    fq = torch.exp(qs.float())
    fk = torch.exp(_expand_kv(ks, r).float())
    vf = _expand_kv(v, r).float()
    gf = g.float()
    u = gf / den[..., None]
    w = (gf * o.float()).sum(-1) / den
    mask = _mask(qs.shape[1], causal, qs.device)
    scores = torch.einsum("hid,hjd->hij", fq, fk) * mask
    gmat = (torch.einsum("hiv,hjv->hij", u, vf) - w[..., None]) * mask
    dqs = fq * torch.einsum("hij,hjd->hid", gmat, fk)
    dks = fk * torch.einsum("hij,hid->hjd", gmat, fq)
    dv = torch.einsum("hij,hiv->hjv", scores, u)
    return dqs, _segsum_kv(dks, r), _segsum_kv(dv, r)


def block_diag_bwd_ref(q, k, v, g, *, block: int, causal: bool, r: int = 1,
                       scale: float | None = None):
    """Block-diagonal softmax backward, by autograd through
    :func:`block_diag_ref` in fp32."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_()
                      for t in (q, _expand_kv(k, r), _expand_kv(v, r)))
        out = block_diag_ref(qf, kf, vf, block=block, causal=causal,
                             scale=scale)
        dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), g.float())
    return dq, _segsum_kv(dk, r), _segsum_kv(dv, r)


def lln_diag_fused_bwd_ref(qs, ks, q, k, v, g, o, den, *, block: int,
                           r: int = 1, scale: float | None = None):
    """Backward of the fused causal LLN + diag: the LLN part's output is
    reconstructed as the kernel does, 2 o - diag_out.  Returns ``(dqs,
    dq, dks, dk, dv)``."""
    diag_out = block_diag_ref(q.float(), k.float(), v.float(), block=block,
                              causal=True, r=r, scale=scale)
    lln_out = 2.0 * o.float() - diag_out
    gh = 0.5 * g.float()
    dqs, dks, dv_lln = lln_bwd_ref(qs, ks, v, gh, lln_out, den,
                                   causal=True, r=r)
    dqd, dkd, dv_diag = block_diag_bwd_ref(q, k, v, gh, block=block,
                                           causal=True, r=r, scale=scale)
    return dqs, dqd, dks, dkd, dv_lln + dv_diag


def lln_diag_fused_ref(qs, ks, q, k, v, *, block: int, causal: bool,
                       r: int = 1, scale: float | None = None
                       ) -> torch.Tensor:
    """The fused LLN + diag: 0.5 (LLN + block-diag softmax); qs/ks the
    stabilized LLN-scaled tensors, q/k the raw ones."""
    lln = (lln_causal_ref(qs, ks, v, r) if causal
           else lln_bidir_ref(qs, ks, v, r))
    diag = block_diag_ref(q, k, v, block=block, causal=causal, r=r,
                          scale=scale)
    return (0.5 * (lln.float() + diag.float())).to(v.dtype)
