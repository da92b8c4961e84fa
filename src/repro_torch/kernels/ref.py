"""Quadratic-form oracles for the port's kernels (kernel layout).

Port of the serving oracles of ``repro.kernels.ref``: q/k (BH, N, D)
(already alpha/beta-scaled and stabilized for LLN), v (BG, N, Dv); query
row ``bh`` reads kv row ``bh // r``.
"""
from __future__ import annotations

import torch

EPS = 1e-6


def _expand_kv(t: torch.Tensor, r: int) -> torch.Tensor:
    return t if r == 1 else torch.repeat_interleave(t, r, dim=0)


def lln_causal_ref(qs, ks, v, r: int = 1) -> torch.Tensor:
    """Causal LLN: P = tril(e^{qs} e^{ks}^T), row-normalized."""
    fq = torch.exp(qs.float())
    fk = torch.exp(_expand_kv(ks, r).float())
    vf = _expand_kv(v, r).float()
    n = qs.shape[1]
    scores = torch.einsum("hid,hjd->hij", fq, fk) \
        * torch.tril(torch.ones(n, n, device=qs.device))
    out = torch.einsum("hij,hjv->hiv", scores, vf)
    return (out / (scores.sum(-1)[..., None] + EPS)).to(v.dtype)


def lln_prefill_state_ref(qs, ks, v, r: int = 1):
    """(out, s, z) of the state-emitting causal kernel: s = sum_j
    Phi(k_j) v_j^T (BH, D, Dv), z = sum_j Phi(k_j) (BH, 1, D)."""
    fk = torch.exp(_expand_kv(ks, r).float())
    vf = _expand_kv(v, r).float()
    return (lln_causal_ref(qs, ks, v, r),
            torch.einsum("hnd,hnv->hdv", fk, vf), fk.sum(1, keepdim=True))
