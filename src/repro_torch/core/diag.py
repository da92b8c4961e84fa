"""Block-diagonal softmax attention (paper §4.2, after Qin et al. 2022b).

Port of ``repro.core.diag``: softmax applied inside non-overlapping blocks
along the sequence only, O(N * block) time and memory.  Averaged with LLN
attention it restores the short-range interactions linear attention
dilutes.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def block_diag_attn(q, k, v, *, block: int = 256, causal: bool = False,
                    mask=None) -> torch.Tensor:
    """q,k: (B, N, H, D); v: (B, N, H, Dv); mask: optional (B, N) key
    validity.

    Sequences are zero-padded to a block multiple; padded keys are masked.
    """
    b, n, h, d = q.shape
    dv = v.shape[-1]
    scale = d ** -0.5
    nb = -(-n // block)
    pad = nb * block - n
    if mask is None:
        mask = torch.ones(b, n, dtype=torch.bool, device=q.device)
    mask = mask.to(torch.bool)
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    qb = q.reshape(b, nb, block, h, d)
    kb = k.reshape(b, nb, block, h, d)
    vb = v.reshape(b, nb, block, h, dv)
    mb = mask.reshape(b, nb, block)
    scores = torch.einsum("bgihd,bgjhd->bghij", qb.float(), kb.float()) * scale
    bias = torch.where(mb[:, :, None, None, :], 0.0, NEG_INF)
    if causal:
        tri = torch.tril(torch.ones(block, block, dtype=torch.bool,
                                    device=q.device))
        bias = bias + torch.where(tri, 0.0, NEG_INF)
    p = torch.softmax(scores + bias, dim=-1)
    out = torch.einsum("bghij,bgjhv->bgihv", p.to(v.dtype).float(), vb.float())
    return out.to(v.dtype).reshape(b, nb * block, h, dv)[:, :n]
