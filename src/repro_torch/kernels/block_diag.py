"""Block-diagonal softmax attention (paper §4.2): CUDA kernel and plain version.

Kernel layout: q (BH, N, D), k/v (BG, N, D[v]) in the compute dtype; query
row ``bh`` reads kv row ``bh // r``.  Each ``blk``-sized block attends only
within itself (causal optional); the ragged last block holds ``N - (nb-1) *
blk`` keys and masks the rest.  fp32 math, output in ``v.dtype``.

``block_diag`` (``csrc/block_diag.cu``) replaces
``src/repro/kernels/block_diag.py:block_diag_pallas``.  One CTA per (query
head, block, 32-row query tile) stages the scaled query tile, the row
scores against the block's keys (only the keys a causal tile can see) and
its fp32 output rows in shared memory; keys and values stream through in
64-row tiles.  The softmax is the reference's exact form: subtract the row
max, exponentiate, divide by the row sum, then multiply by V.  Bound on the
H100 at the serve shapes (B=4, H=32, G=4, N=512, blk=256, D=Dv=128): the
causal blocks need about 4.3 GFLOP of fp32 work against 21 MB of traffic,
so fp32 operations bound it (67 TFLOP/s without tensor cores).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

NEG_INF = -1e30
QUERY_TILE = 32
_DCODES = {torch.float32: 0, torch.bfloat16: 1}


def block_diag_plain(q, k, v, *, r: int = 1, blk: int = 256,
                     causal: bool = False):
    """Plain PyTorch block-diagonal softmax, any N (GQA via a (BG, R) head
    split; keys past N in the ragged last block are masked)."""
    bh, n, d = q.shape
    bg, dv = k.shape[0], v.shape[-1]
    scale = d ** -0.5
    nb = -(-n // blk)
    pad = nb * blk - n
    qf = F.pad(q.float(), (0, 0, 0, pad)).reshape(bg, r, nb, blk, d) * scale
    kf = F.pad(k.float(), (0, 0, 0, pad)).reshape(bg, nb, blk, d)
    vf = F.pad(v.float(), (0, 0, 0, pad)).reshape(bg, nb, blk, dv)
    s = torch.einsum("grnid,gnjd->grnij", qf, kf)
    allowed = (torch.arange(nb * blk, device=q.device) < n).reshape(nb, 1, blk)
    if causal:
        allowed = allowed & torch.tril(torch.ones(blk, blk, dtype=torch.bool,
                                                  device=q.device))
    s = torch.where(allowed, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("grnij,gnjv->grniv", p, vf)
    return out.reshape(bh, nb * blk, dv)[:, :n].to(v.dtype)


def block_diag(q, k, v, *, r: int = 1, blk: int = 256, causal: bool = False):
    """Block-diagonal softmax (scores scaled by D^-1/2); see the module
    docstring."""
    if q.device.type == "cpu":
        return block_diag_plain(q, k, v, r=r, blk=blk, causal=causal)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on the same CUDA device")
    if q.dtype not in _DCODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("q, k and v must be 3-D (rows, seq, dim)")
    bh, n, d = q.shape
    bg, dv = k.shape[0], v.shape[-1]
    if bg * r != bh or k.shape[1:] != (n, d) or v.shape[:2] != (bg, n):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, r={r}")
    if n < 1 or blk < 1:
        raise ValueError("empty sequence or block")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(bh, n, dv, dtype=v.dtype, device=q.device)
    lib = build.library("block_diag")
    with torch.cuda.device(q.device):
        err = lib.block_diag_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, bg, n, d, dv, blk, int(causal), _DCODES[q.dtype], QUERY_TILE,
            d ** -0.5, torch.cuda.current_stream().cuda_stream)
    build.check(err, "block_diag")
    block_diag.launches += 1
    return out


block_diag.launches = 0
