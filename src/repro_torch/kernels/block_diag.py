"""Block-diagonal softmax attention (paper §4.2): CUDA kernel and plain version.

Kernel layout: q (BH, N, D), k/v (BG, N, D[v]) in the compute dtype; query
row ``bh`` reads kv row ``bh // r``.  Each ``blk``-sized block attends only
within itself (causal optional); the ragged last block holds ``N - (nb-1) *
blk`` keys and masks the rest.  fp32 math, output in ``v.dtype``.

``block_diag`` (``csrc/block_diag.cu``) replaces
``src/repro/kernels/block_diag.py:block_diag_pallas``; ``block_diag_bwd``
(``csrc/block_diag_bwd.cu``) replaces ``block_diag_bwd_pallas``: fp32 dq
per query head and dk/dv summed over the r query heads of a kv head, with
the block softmax recomputed (no saved probabilities) and no atomics, so
two runs are bitwise equal.  The causal form serves the decoder, the
non-causal one the encoder.

The input type picks the kernel.  bf16, which every model path on the card
runs: the tensor cores (``mma.sync`` on bf16 fragments from ``ldmatrix``,
tiles staged by ``cp.async``; helpers in ``csrc/mma.cuh``), the forward at
D, Dv <= 256 (above 128, MLA's D = 192 and paligemma's 256, a CTA per
128-column chunk of the output, each recomputing its tile's scores), the
backward at D, Dv <= 128.
q k^T and g v^T take the raw bf16 operands; the fp32 p and dsm enter their
products as hi + lo bf16, about 2^-17 relative, so the results keep the
fp32 softmax of the reference.  The forward gives each CTA a 64-row query
tile and streams the block's key/value tiles with an online softmax; the
backward's dq kernel (per 64-row query tile: max, sum and delta in one
pass, then dsm k) saves each row's (m, l, delta) for the dk/dv kernel (per 64-key
tile, over the r heads and the query tiles in a fixed order).  Bound on
the H100: bytes (the products at the tensor cores' rate take less).
fp32, and bf16 above those widths (the backward above D or Dv = 128): IEEE
fp32 on the CUDA cores, the reference's exact softmax form (max,
exponentiate, divide, then multiply by V), in 32-row tiles; the shared
memory grows with D (at D = Dv = 256 and blk 256: 164 KB forward, with 32
query rows and the whole block's scores; 197 KB and 206 KB in the
backward's two kernels).

Each wrapper runs its plain version for a CPU tensor; for a CUDA tensor
it calls its custom op (``repro_torch::block_diag``,
``repro_torch::block_diag_bwd``), which launches the kernel and counts it
in ``<wrapper>.launches``; the ops' fake implementations give the
outputs' shapes to ``FakeTensorMode`` and launch and count nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

NEG_INF = -1e30
QUERY_TILE = 32
_DCODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_qkv(q, k, v, r, blk):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on the same CUDA device")
    if q.dtype not in _DCODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("q, k and v must be 3-D (rows, seq, dim)")
    bh, n, d = q.shape
    bg = k.shape[0]
    if bg * r != bh or k.shape[1:] != (n, d) or v.shape[:2] != (bg, n):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, r={r}")
    if n < 1 or blk < 1:
        raise ValueError("empty sequence or block")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _blocks(q, k, v, r: int, blk: int, causal: bool, g=None):
    """fp32 block views (zero-padded to whole blocks) and the block softmax
    probabilities: ``(qq = q D^-1/2 (BG,R,nb,blk,D), kk, vv, p
    (BG,R,nb,blk,blk), gg or None)``; keys past N are masked."""
    bh, n, d = q.shape
    bg, dv = k.shape[0], v.shape[-1]
    nb = -(-n // blk)
    pad = nb * blk - n
    qq = F.pad(q.float(), (0, 0, 0, pad)).reshape(bg, r, nb, blk, d) \
        * d ** -0.5
    kk = F.pad(k.float(), (0, 0, 0, pad)).reshape(bg, nb, blk, d)
    vv = F.pad(v.float(), (0, 0, 0, pad)).reshape(bg, nb, blk, dv)
    gg = None if g is None else \
        F.pad(g.float(), (0, 0, 0, pad)).reshape(bg, r, nb, blk, dv)
    s = torch.einsum("grnid,gnjd->grnij", qq, kk)
    allowed = (torch.arange(nb * blk, device=q.device) < n).reshape(nb, 1, blk)
    if causal:
        allowed = allowed & torch.tril(torch.ones(blk, blk, dtype=torch.bool,
                                                  device=q.device))
    p = torch.softmax(torch.where(allowed, s, NEG_INF), dim=-1)
    return qq, kk, vv, p, gg


def block_diag_plain(q, k, v, *, r: int = 1, blk: int = 256,
                     causal: bool = False):
    """Plain PyTorch block-diagonal softmax, any N (GQA via a (BG, R) head
    split; keys past N in the ragged last block are masked)."""
    bh, n, _ = q.shape
    _, _, vv, p, _ = _blocks(q, k, v, r, blk, causal)
    out = torch.einsum("grnij,gnjv->grniv", p, vv)
    return out.reshape(bh, -1, v.shape[-1])[:, :n].to(v.dtype)


def block_diag(q, k, v, *, r: int = 1, blk: int = 256, causal: bool = False):
    """Block-diagonal softmax (scores scaled by D^-1/2); see the module
    docstring."""
    if q.device.type == "cpu":
        return block_diag_plain(q, k, v, r=r, blk=blk, causal=causal)
    _check_qkv(q, k, v, r, blk)
    return _block_diag_op(q, k, v, r, blk, causal)


@torch.library.custom_op(
    "repro_torch::block_diag", mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, int r, int blk, bool causal) "
           "-> Tensor")
def _block_diag_op(q, k, v, r, blk, causal):
    bh, n, d = q.shape
    bg, dv = k.shape[0], v.shape[-1]
    out = torch.empty(bh, n, dv, dtype=v.dtype, device=q.device)
    lib = build.library("block_diag")
    with torch.cuda.device(q.device):
        err = lib.block_diag_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, bg, n, d, dv, blk, int(causal), _DCODES[q.dtype], QUERY_TILE,
            d ** -0.5, torch.cuda.current_stream().cuda_stream)
    build.check(err, "block_diag")
    block_diag.launches += 1
    block_diag.noncausal_launches += not causal
    return out


@_block_diag_op.register_fake
def _(q, k, v, r, blk, causal):
    return torch.empty(q.shape[0], q.shape[1], v.shape[-1], dtype=v.dtype,
                       device=q.device)


block_diag.launches = 0
block_diag.noncausal_launches = 0     # the non-causal ones among ``launches``


def block_diag_bwd_plain(q, k, v, g, *, r: int = 1, blk: int = 256,
                         causal: bool = False):
    """Plain PyTorch twin of ``block_diag_bwd_scan``, any N (the ragged
    last block's pad keys are masked and its pad rows get a zero
    cotangent).  Returns fp32 ``(dq (BH,N,D), dk (BG,N,D), dv
    (BG,N,Dv))``, dk/dv summed over the r query heads of a kv head."""
    bh, n, d = q.shape
    bg, dv = k.shape[0], v.shape[-1]
    qq, kk, vv, p, gg = _blocks(q, k, v, r, blk, causal, g)
    dp = torch.einsum("grnie,gnje->grnij", gg, vv)
    dsm = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("grnij,gnjd->grnid", dsm, kk) * d ** -0.5
    dk = torch.einsum("grnij,grnid->gnjd", dsm, qq)
    dvv = torch.einsum("grnij,grnie->gnje", p, gg)
    return (dq.reshape(bh, -1, d)[:, :n], dk.reshape(bg, -1, d)[:, :n],
            dvv.reshape(bg, -1, dv)[:, :n])


def block_diag_bwd(q, k, v, g, *, r: int = 1, blk: int = 256,
                   causal: bool = False):
    """Backward of :func:`block_diag` from its inputs and the cotangent
    ``g`` (BH,N,Dv) in their dtype; see the module docstring."""
    if q.device.type == "cpu":
        return block_diag_bwd_plain(q, k, v, g, r=r, blk=blk, causal=causal)
    _check_qkv(q, k, v, r, blk)
    bh, n, _ = q.shape
    dv = v.shape[-1]
    if g.dtype != v.dtype or g.shape != (bh, n, dv) \
            or g.device != q.device or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous {v.dtype} {(bh, n, dv)} "
                         f"tensor on {q.device}")
    return _block_diag_bwd_op(q, k, v, g, r, blk, causal)


def _bwd_outputs(q, k, v):
    bh, n, d = q.shape
    bg, dv = k.shape[0], v.shape[-1]
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty(bh, n, d, **f32), torch.empty(bg, n, d, **f32),
            torch.empty(bg, n, dv, **f32))


@torch.library.custom_op(
    "repro_torch::block_diag_bwd", mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, Tensor g, int r, int blk, "
           "bool causal) -> (Tensor, Tensor, Tensor)")
def _block_diag_bwd_op(q, k, v, g, r, blk, causal):
    bh, n, d = q.shape
    bg, dv = k.shape[0], v.shape[-1]
    dq, dk, dvo = _bwd_outputs(q, k, v)
    stats = torch.empty(3, bh, n, dtype=torch.float32, device=q.device)
    lib = build.library("block_diag_bwd")
    with torch.cuda.device(q.device):
        err = lib.block_diag_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dvo.data_ptr(), stats.data_ptr(),
            bh, bg, n, d, dv, blk, int(causal), _DCODES[q.dtype], d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "block_diag_bwd")
    block_diag_bwd.launches += 1
    return dq, dk, dvo


@_block_diag_bwd_op.register_fake
def _(q, k, v, g, r, blk, causal):
    return _bwd_outputs(q, k, v)


block_diag_bwd.launches = 0
