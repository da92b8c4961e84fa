"""Causal LLN prefill and chunked LLN decode: CUDA kernels and plain versions.

Kernel layout: ``qs`` (BH, N, D) and ``ks`` (BG, N, D) fp32, pre-scaled
and stabilized by ``kernels/ops.py`` (qs = alpha*q - c_q <= 0, likewise
ks), ``v`` (BG, N, Dv) in the compute dtype (fp32 or bf16).  Query row
``bh`` reads kv row ``bh // r`` with ``r = BH // BG``, so repeated KV is
never materialized.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its CUDA kernel for a CUDA tensor; it counts its launches in
``<wrapper>.launches``.

``lln_causal`` (``csrc/lln_causal.cu``) replaces
``src/repro/kernels/lln_attention.py:lln_causal_pallas`` (prefill with
``return_state=True``).  On the TPU the grid's minor axis ran in order and
kept ``(S, z)`` in VMEM; here one CTA per (query head, 32 value columns)
walks the sequence in 64-row tiles and keeps its slice of ``S`` and all of
``z`` in shared memory, so the scan order is a loop inside the CTA.  Any N
is taken: the ragged last tile's pad keys get Phi(k) = 0 and its pad rows
are not written.  Bound on the H100: at the serve shapes (B=4, H=32, G=4,
N=512, D=Dv=128) the fp32 work (Phi(q)S per query, Phi(k)v^T per key,
about 4.3 GFLOP) outweighs the 65 MB it moves, so it is bound by fp32
operations (67 TFLOP/s, no tensor cores in this first version).  The
column split gives 4x more CTAs than heads (512 at the serve shapes) at
the cost of recomputing the tile's scores once per column group.

``lln_decode`` (``csrc/lln_decode.cu``) replaces
``src/repro/kernels/lln_attention.py:lln_decode_pallas``.  One CTA per
(query head, 32 value columns) reads its slice of the carried ``s0`` once,
uses it for Phi(q)·S of every chunk token and writes ``s1 = s0 +
Phi(k)^T v`` in the same pass.  T is looped inside the CTA, with no
padding.  Bound: the state's bytes (read s0, write s1: 16.8 MB per layer
at B=4, H=32, D=Dv=128, about 5 us at 3.35 TB/s).  The rescale of the
carried state before the launch is a third pass over it, still in PyTorch
(``ops.lln_decode_chunk``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

EPS = 1e-6
# CUDA tile shapes: prefill rows per tile, value columns per CTA (both
# kernels), and the most chunk tokens one decode launch takes.
PREFILL_TILE = 64
COLS = 32
MAX_DECODE_T = 64
_VCODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_lln_inputs(qs, ks, v, r):
    if not (qs.is_cuda and ks.device == qs.device and v.device == qs.device):
        raise ValueError("qs, ks and v must be on the same CUDA device")
    if qs.dtype != torch.float32 or ks.dtype != torch.float32:
        raise TypeError(f"qs/ks must be float32, got {qs.dtype}/{ks.dtype}")
    if v.dtype not in _VCODES:
        raise TypeError(f"v must be float32 or bfloat16, got {v.dtype}")
    if qs.ndim != 3 or ks.ndim != 3 or v.ndim != 3:
        raise ValueError("qs, ks and v must be 3-D (rows, seq, dim)")
    bh, n, d = qs.shape
    bg = ks.shape[0]
    if bg * r != bh or ks.shape[1:] != (n, d) or v.shape[:2] != (bg, n):
        raise ValueError(f"shape mismatch: qs {tuple(qs.shape)}, ks "
                         f"{tuple(ks.shape)}, v {tuple(v.shape)}, r={r}")
    if n < 1:
        raise ValueError("empty sequence")
    for name, t in (("qs", qs), ("ks", ks), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# Causal LLN prefill: outputs plus the final (s, z) in one pass.
# ---------------------------------------------------------------------------

def lln_causal_plain(qs, ks, v, *, r: int = 1, blk: int = 256):
    """Plain PyTorch causal LLN (chunked scan, GQA via a (BG, R) head
    split).  Returns ``(out (BH,N,Dv) in v.dtype, s (BH,D,Dv), z (BH,1,D))``
    with the final state repeated to each query-head row."""
    bh, n, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    pad = (-n) % blk
    nc = (n + pad) // blk
    fq = F.pad(torch.exp(qs.float()), (0, 0, 0, pad))
    fk = F.pad(torch.exp(ks.float()), (0, 0, 0, pad))     # pad keys: Phi = 0
    vf = F.pad(v.float(), (0, 0, 0, pad))
    fq = fq.reshape(bg, r, nc, blk, d)
    fk = fk.reshape(bg, nc, blk, d)
    vf = vf.reshape(bg, nc, blk, dv)
    causal = torch.tril(torch.ones(blk, blk, device=qs.device))
    s = torch.zeros(bg, d, dv, device=qs.device)
    z = torch.zeros(bg, d, device=qs.device)
    outs = []
    for c in range(nc):
        cq, ck, cv = fq[:, :, c], fk[:, c], vf[:, c]
        scores = torch.einsum("grid,gjd->grij", cq, ck) * causal
        intra = torch.einsum("grij,gjv->griv", scores, cv)
        intra_z = scores.sum(-1)
        inter = torch.einsum("grid,gdv->griv", cq, s)
        inter_z = torch.einsum("grid,gd->gri", cq, z)
        outs.append((intra + inter) / (intra_z + inter_z + EPS)[..., None])
        s = s + torch.einsum("gjd,gjv->gdv", ck, cv)
        z = z + ck.sum(1)
    out = torch.stack(outs, 2).reshape(bh, nc * blk, dv)[:, :n].to(v.dtype)
    s = torch.repeat_interleave(s, r, dim=0)
    z = torch.repeat_interleave(z, r, dim=0)[:, None, :]
    return out, s, z


def lln_causal(qs, ks, v, *, r: int = 1, blk: int = 256):
    """Causal LLN prefill with the final state; see the module docstring.

    ``blk`` is the plain version's chunk; the CUDA kernel tiles by
    :data:`PREFILL_TILE` (the split does not change the math)."""
    if qs.device.type == "cpu":
        return lln_causal_plain(qs, ks, v, r=r, blk=blk)
    _check_lln_inputs(qs, ks, v, r)
    bh, n, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    out = torch.empty(bh, n, dv, dtype=v.dtype, device=qs.device)
    s = torch.empty(bh, d, dv, dtype=torch.float32, device=qs.device)
    z = torch.empty(bh, 1, d, dtype=torch.float32, device=qs.device)
    lib = build.library("lln_causal")
    with torch.cuda.device(qs.device):
        err = lib.lln_causal_launch(
            qs.data_ptr(), ks.data_ptr(), v.data_ptr(), out.data_ptr(),
            s.data_ptr(), z.data_ptr(), bh, bg, n, d, dv, _VCODES[v.dtype],
            PREFILL_TILE, COLS, torch.cuda.current_stream().cuda_stream)
    build.check(err, "lln_causal")
    lln_causal.launches += 1
    return out, s, z


lln_causal.launches = 0


# ---------------------------------------------------------------------------
# Chunked decode against a pre-rescaled carried state.
# ---------------------------------------------------------------------------

def lln_decode_plain(qs, ks, v, s0, z0, *, r: int = 1):
    """Plain PyTorch T-token decode.  qs (BH,T,D); ks/v (BG,T,D[v]); s0
    (BH,D,Dv) and z0 (BH,1,D) fp32, already rescaled to the chunk's key
    constant.  Returns ``(out (BH,T,Dv) in v.dtype, s1, z1)``."""
    t = qs.shape[1]
    fq = torch.exp(qs.float())
    fk = torch.repeat_interleave(torch.exp(ks.float()), r, dim=0)
    vf = torch.repeat_interleave(v.float(), r, dim=0)
    causal = torch.tril(torch.ones(t, t, device=qs.device))
    scores = torch.einsum("hid,hjd->hij", fq, fk) * causal
    intra = torch.einsum("hij,hjv->hiv", scores, vf)
    inter = torch.einsum("hid,hdv->hiv", fq, s0)
    den = scores.sum(-1) + torch.einsum("hid,hd->hi", fq, z0[:, 0]) + EPS
    out = ((intra + inter) / den[..., None]).to(v.dtype)
    s1 = s0 + torch.einsum("hjd,hjv->hdv", fk, vf)
    z1 = z0 + fk.sum(1, keepdim=True)
    return out, s1, z1


def lln_decode(qs, ks, v, s0, z0, *, r: int = 1):
    """Chunked LLN decode; see the module docstring."""
    if qs.device.type == "cpu":
        return lln_decode_plain(qs, ks, v, s0, z0, r=r)
    _check_lln_inputs(qs, ks, v, r)
    bh, t, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    if t > MAX_DECODE_T:
        raise ValueError(f"lln_decode takes at most {MAX_DECODE_T} tokens "
                         f"per call, got {t}")
    for name, st, shape in (("s0", s0, (bh, d, dv)), ("z0", z0, (bh, 1, d))):
        if st.dtype != torch.float32 or tuple(st.shape) != shape \
                or st.device != qs.device or not st.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {qs.device}")
    out = torch.empty(bh, t, dv, dtype=v.dtype, device=qs.device)
    s1 = torch.empty_like(s0)
    z1 = torch.empty_like(z0)
    lib = build.library("lln_decode")
    with torch.cuda.device(qs.device):
        err = lib.lln_decode_launch(
            qs.data_ptr(), ks.data_ptr(), v.data_ptr(), s0.data_ptr(),
            z0.data_ptr(), out.data_ptr(), s1.data_ptr(), z1.data_ptr(),
            bh, bg, t, d, dv, _VCODES[v.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "lln_decode")
    lln_decode.launches += 1
    return out, s1, z1


lln_decode.launches = 0
