"""Causal LLN forward, the fused LLN + diag forward and chunked LLN decode:
CUDA kernels and plain versions.

Kernel layout: ``qs`` (BH, N, D) and ``ks`` (BG, N, D) fp32, pre-scaled
and stabilized by ``kernels/ops.py`` (qs = alpha*q - c_q <= 0, likewise
ks), ``v`` (BG, N, Dv) in the compute dtype (fp32 or bf16).  Query row
``bh`` reads kv row ``bh // r`` with ``r = BH // BG``, so repeated KV is
never materialized.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its CUDA kernel for a CUDA tensor; it counts its launches in
``<wrapper>.launches``.

``lln_causal`` (``csrc/lln_causal.cu``) replaces
``src/repro/kernels/lln_attention.py:lln_causal_pallas``: the prefill with
the final state (``return_state``) and the training forward with the row
normalizer ``den`` (``return_res``).  On the TPU the grid's minor axis ran
in order and kept ``(S, z)`` in VMEM.  Two paths (:func:`_tc_path`):

- bf16 v with D and Dv at most 128 (every model path on the card): the
  tensor-core path, chunk-parallel over blocks of :data:`TC_BLOCK` rows
  (the kernels' own block: of 64, 128 and 256, ``lln_causal_bwd`` is
  fastest at 64 on the card and this forward about flat; ``blk`` is the
  plain scan's chunk and does not enter the math).  Phi(k) is split into
  bf16 hi + lo; a state kernel writes each kv group's exclusive block
  states ``(S_c, z_c)`` once per group (not per query head) and, with
  ``return_state``, the final state in fp32 (Phi(k) in three planes
  there: it is held to 1e-5); one CTA per (query head, block, 64-row
  tile) computes the masked intra-block scores, their row sums, scores V,
  ``Phi(q) S_c`` and ``Phi(q) . z_c``, then ``den`` and the output,
  rounded once (the output kernel of ``loglin_causal``,
  ``csrc/causal_out.cuh``).  Any N: the short last block's pad keys are
  staged as Phi(k) = 0 (the final state is not masked, so ``ks`` is never
  zero-padded) and its pad rows are not written.  Scratch
  (:func:`_tc_scratch`): Phi(k) and ``S_c`` as two bf16 planes, ``z_c``
  fp32.  Bound on the H100 (``chip_smoke.py:_lln_counts``): the bytes
  (qs, ks, v, out), about twice the products at the bf16 rate, at the
  serve (B=4, H=32, G=4, N=512, D=Dv=128) and training (N=1024) shapes.
- fp32 v, or a wider head: the CUDA-core kernel, one CTA per (query head,
  32 value columns) walking the sequence in 64-row tiles with its slice of
  ``S`` and all of ``z`` in shared memory, IEEE fp32 (any N, as above).
  Bound: fp32 operations; each column group recomputes the tile's scores
  and each query head its group's state.

``lln_diag_fused`` (``csrc/lln_diag_fused.cu``) replaces
``src/repro/kernels/lln_attention.py:lln_diag_fused_pallas`` (causal,
``return_res``): the §4.2 hybrid ``0.5 * (lln + diag)`` in one pass, with
``blk`` both the LLN chunk of the reference and the diag block, N % blk ==
0.  Two paths, chosen here by type and width (:func:`_tc_path`):

- bf16 with D and Dv at most 128 (every model path on the card): the
  tensor-core path, chunk-parallel over the ``blk`` blocks.  Phi(q) and
  Phi(k) are split into bf16 hi + lo, a state kernel writes each kv
  group's exclusive block states ``(S_c, z_c)`` once per group in a fixed
  order, and one CTA per (query head, block, 64-row tile) walks the
  block's keys up to its diagonal once, computing on the same shared tiles
  the diag softmax (online, ``mma.sync``) and the LLN intra-block scores,
  then ``Phi(q) S_c``, ``den`` and the average, rounded once.  Products:
  bf16 x bf16 one MMA; an fp32 operand goes in as two bf16 planes (hi +
  lo), two MMAs against bf16, three against another fp32 operand.  The
  wrapper allocates the scratch (:func:`_tc_scratch`): Phi(q), Phi(k)
  and the states, about the bytes of qs, ks and one fp32 state per block
  and kv group.
- fp32, or a wider head: the CUDA-core kernel, one CTA per (query head,
  32 value columns) walking the sequence in 64-row tiles with the LLN
  state in shared memory, IEEE fp32 throughout.

Bound on the H100 (``chip_smoke.py:_fused_counts``): the products at the
bf16 tensor-core rate, an fp32 operand counted once per MMA it takes (2 D
per visible pair for q k^T, 2 Dv twice for p V and scores V, 2 D three
times for Phi(q) Phi(k)^T, and the block states), with the softmax steps
and the exps as fp32 work; at the training shape (B=4, H=32, G=4,
N=1024, blk=256, D=128) the operations and the bytes are about equal.

``lln_decode`` (``csrc/lln_decode.cu``) replaces
``src/repro/kernels/lln_attention.py:lln_decode_pallas``.  One CTA per
(query head, 32 value columns) reads its slice of the carried ``s0`` once,
uses it for Phi(q)·S of every chunk token and writes ``s1 = s0 +
Phi(k)^T v`` in the same pass.  T is looped inside the CTA, with no
padding.  Bound: the state's bytes (read s0, write s1: 16.8 MB per layer
at B=4, H=32, D=Dv=128, about 5 us at 3.35 TB/s).  The rescale of the
carried state before the launch is a third pass over it, still in PyTorch
(``ops.lln_decode_chunk``).

``lln_bidir`` (``csrc/lln_bidir.cu``) replaces
``src/repro/kernels/lln_attention.py:lln_bidir_pallas``: the encoder's
bidirectional LLN, ``Phi(q) S / (Phi(q) . z + EPS)`` with the whole
sequence's ``S = sum Phi(k) v^T`` and ``z = sum Phi(k)`` per kv head, as
the reference's reduce and apply.  Two paths (:func:`_tc_path`):

- bf16 v with D and Dv at most 128 (the encoder on the card): the
  tensor-core path, two launches and no scratch.  The causal pair's state
  kernel (``csrc/fused_state.cuh``) with one block of all N rows sums
  ``(S, z)`` once per kv group in fp32 (Phi(k) in three bf16 planes
  against bf16 v, each 64-row step added in fp32, a fixed order, no
  atomics; no block state stored); one CTA per (query head, 64-row tile)
  splits Phi(q) and the fp32 ``S`` into bf16 hi + lo as it stages them,
  takes ``Phi(q) S`` in three MMAs and ``Phi(q) . z`` in fp32 with the
  exact Phi(q), and rounds the output once.  Any N: pad keys and rows are
  staged as zero Phi rows, never by zero-padding ``qs`` or ``ks``.
  Bound on the H100 (``chip_smoke.py:_bidir_counts``): the bytes, mostly
  the fp32 qs and ks, at the encoder shape (B=32, H=G=12, N=512,
  D=Dv=64).
- fp32 v, or a wider head: the CUDA-core kernels.  The reduce gives each
  CTA a (kv head, 32 value columns) slice of ``S`` and loops over the
  sequence in order inside the CTA (the TPU's ordered grid axis), so the
  sums have a fixed order and no atomics; the apply gives each CTA a
  (query head, 64-row tile) and the whole of its kv head's ``S`` and
  ``z`` in shared memory.  Any N.  Bound: fp32 operations.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

EPS = 1e-6
NEG_INF = -1e30
# CUDA tile shapes: prefill rows per tile, value columns per CTA (both
# kernels), and the most chunk tokens one decode launch takes.
PREFILL_TILE = 64
COLS = 32
MAX_DECODE_T = 64
_VCODES = {torch.float32: 0, torch.bfloat16: 1}
# The widest head the tensor-core paths take (D and Dv).
TC_MAX_WIDTH = 128
# Rows per block of lln_causal's and lln_causal_bwd's tensor-core paths:
# the kernels' own chunk, whatever the caller's ``blk`` (chip_smoke.py
# times 128 and 256 beside it).
TC_BLOCK = 64


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


def _check_same(device, **tensors):
    """Raise unless every tensor is a contiguous tensor on ``device``."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_raw_qk(qs, ks, q, k, v):
    """The fused kernels' raw q/k: beside qs/ks, in v's dtype."""
    _check_same(qs.device, q=q, k=k)
    if q.dtype != v.dtype or k.dtype != v.dtype:
        raise TypeError(f"q, k and v must share a dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape != qs.shape or k.shape != ks.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} vs qs "
                         f"{tuple(qs.shape)}, k {tuple(k.shape)} vs ks "
                         f"{tuple(ks.shape)}")


# ---------------------------------------------------------------------------
# Causal LLN forward: outputs plus the optional den and final (s, z).
# ---------------------------------------------------------------------------

def _lln_causal_f32(qs, ks, v, r: int, blk: int):
    """The chunked causal LLN scan in fp32: ``(out (BH,N,Dv), den (BH,N),
    s (BG,D,Dv), z (BG,D))`` with the final state per kv group."""
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
    outs, dens = [], []
    for c in range(nc):
        cq, ck, cv = fq[:, :, c], fk[:, c], vf[:, c]
        scores = torch.einsum("grid,gjd->grij", cq, ck) * causal
        intra = torch.einsum("grij,gjv->griv", scores, cv)
        intra_z = scores.sum(-1)
        inter = torch.einsum("grid,gdv->griv", cq, s)
        inter_z = torch.einsum("grid,gd->gri", cq, z)
        den = intra_z + inter_z + EPS
        outs.append((intra + inter) / den[..., None])
        dens.append(den)
        s = s + torch.einsum("gjd,gjv->gdv", ck, cv)
        z = z + ck.sum(1)
    out = torch.stack(outs, 2).reshape(bh, nc * blk, dv)[:, :n]
    den = torch.stack(dens, 2).reshape(bh, nc * blk)[:, :n]
    return out, den, s, z


def _lln_outputs(out, den, s, z, return_res, return_state):
    res = (out,)
    if return_res:
        res += (den,)
    if return_state:
        res += (s, z)
    return res if len(res) > 1 else out


def lln_causal_plain(qs, ks, v, *, r: int = 1, blk: int = 256,
                     return_res: bool = False, return_state: bool = True):
    """Plain PyTorch causal LLN (chunked scan, GQA via a (BG, R) head
    split).  Returns ``out`` (BH,N,Dv) in v.dtype, then ``den`` (BH,N) fp32
    with ``return_res``, then ``s`` (BH,D,Dv) and ``z`` (BH,1,D) with
    ``return_state``, the final state repeated to each query-head row."""
    out, den, s, z = _lln_causal_f32(qs, ks, v, r, blk)
    s = torch.repeat_interleave(s, r, dim=0)
    z = torch.repeat_interleave(z, r, dim=0)[:, None, :]
    return _lln_outputs(out.to(v.dtype), den, s, z, return_res,
                        return_state)


def lln_causal(qs, ks, v, *, r: int = 1, blk: int = 256,
               return_res: bool = False, return_state: bool = True):
    """Causal LLN forward with its optional outputs (order and meaning as
    :func:`lln_causal_plain`); see the module docstring.

    ``blk`` is the plain version's chunk; it does not enter the math, and
    the CUDA kernels take their own (:data:`TC_BLOCK` rows per block on
    the tensor cores, :data:`PREFILL_TILE`-row tiles on the CUDA
    cores)."""
    if qs.device.type == "cpu":
        return lln_causal_plain(qs, ks, v, r=r, blk=blk, return_res=return_res,
                                return_state=return_state)
    _check_lln_inputs(qs, ks, v, r)
    bh, n, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    f32 = dict(dtype=torch.float32, device=qs.device)
    out = torch.empty(bh, n, dv, dtype=v.dtype, device=qs.device)
    den = torch.empty(bh, n, **f32) if return_res else None
    s = torch.empty(bh, d, dv, **f32) if return_state else None
    z = torch.empty(bh, 1, d, **f32) if return_state else None
    lib = build.library("lln_causal")
    ptrs = (qs.data_ptr(), ks.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (den, s, z)))
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if _tc_path(v, d, dv):
            _, *scratch = _tc_scratch(bh, bg, n, d, dv, TC_BLOCK, qs.device,
                                      phi_q=False)
            err = lib.lln_causal_tc_launch(
                *ptrs, *(t.data_ptr() for t in scratch), bh, bg, n, d, dv,
                TC_BLOCK, stream)
        else:
            err = lib.lln_causal_launch(
                *ptrs, bh, bg, n, d, dv, _VCODES[v.dtype], PREFILL_TILE, COLS,
                stream)
    build.check(err, "lln_causal")
    lln_causal.launches += 1
    return _lln_outputs(out, den, s, z, return_res, return_state)


lln_causal.launches = 0


# ---------------------------------------------------------------------------
# Fused causal LLN + block-diagonal softmax (the §4.2 hybrid).
# ---------------------------------------------------------------------------

def _diag_probs(q, k, r: int, blk: int, scale: float):
    """Causal block softmax probabilities, (BG, R, nb, blk, blk) fp32."""
    bh, n, d = q.shape
    bg, nb = k.shape[0], n // blk
    qq = q.float().reshape(bg, r, nb, blk, d) * scale
    kk = k.float().reshape(bg, nb, blk, d)
    s = torch.einsum("grcid,gcjd->grcij", qq, kk)
    tril = torch.tril(torch.ones(blk, blk, dtype=torch.bool, device=q.device))
    return torch.softmax(torch.where(tril, s, NEG_INF), dim=-1)


def _check_blocks(n: int, blk: int):
    if blk < 1 or n % blk:
        raise ValueError(f"the sequence length ({n}) must be a multiple of "
                         f"blk ({blk})")


def lln_diag_fused_plain(qs, ks, q, k, v, *, r: int = 1, blk: int = 256,
                         scale: float | None = None,
                         return_res: bool = False):
    """Plain PyTorch fused hybrid: ``0.5 * (lln + diag)`` in v.dtype, with
    the LLN scan chunked by ``blk`` and the diag softmax causal within
    each ``blk`` block (N % blk == 0); with ``return_res`` also the LLN
    ``den`` (BH,N) fp32."""
    bh, n, d = qs.shape
    _check_blocks(n, blk)
    scale = d ** -0.5 if scale is None else scale
    lln, den, _, _ = _lln_causal_f32(qs, ks, v, r, blk)
    p = _diag_probs(q, k, r, blk, scale)
    vf = v.float().reshape(ks.shape[0], n // blk, blk, v.shape[-1])
    diag = torch.einsum("grcij,gcje->grcie", p, vf).reshape(lln.shape)
    out = (0.5 * (lln + diag)).to(v.dtype)
    return (out, den) if return_res else out


def _tc_path(v, d: int, dv: int) -> bool:
    """Whether ``lln_causal``, the fused pair, ``lln_bidir`` and their
    backwards run their tensor-core paths: bf16 inputs and D, Dv <=
    :data:`TC_MAX_WIDTH`; otherwise their CUDA-core kernels."""
    return v.dtype == torch.bfloat16 and max(d, dv) <= TC_MAX_WIDTH


def _tc_scratch(bh, bg, n, d, dv, blk, device, planes: int = 2,
                phi_q: bool = True):
    """Scratch of the LLN tensor-core paths: Phi(q) (P,BH,N,D) (None
    without ``phi_q``) and Phi(k) (P,BG,N,D) as ``planes`` bf16 planes, the
    exclusive block states S (P,BG,nb,D,Dv) as bf16 planes and z
    (BG,nb,D) fp32, with nb = ceil(N / blk) blocks, a short last one
    included."""
    nb = -(-n // blk)
    bf = dict(dtype=torch.bfloat16, device=device)
    return (torch.empty(planes, bh, n, d, **bf) if phi_q else None,
            torch.empty(planes, bg, n, d, **bf),
            torch.empty(planes, bg, nb, d, dv, **bf),
            torch.empty(bg, nb, d, dtype=torch.float32, device=device))


def lln_diag_fused(qs, ks, q, k, v, *, r: int = 1, blk: int = 256,
                   scale: float | None = None, return_res: bool = False):
    """Fused causal LLN + block-diag softmax; see the module docstring."""
    if qs.device.type == "cpu":
        return lln_diag_fused_plain(qs, ks, q, k, v, r=r, blk=blk,
                                    scale=scale, return_res=return_res)
    _check_lln_inputs(qs, ks, v, r)
    _check_raw_qk(qs, ks, q, k, v)
    bh, n, d = qs.shape
    _check_blocks(n, blk)
    bg, dv = ks.shape[0], v.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty(bh, n, dv, dtype=v.dtype, device=qs.device)
    den = torch.empty(bh, n, dtype=torch.float32, device=qs.device) \
        if return_res else None
    lib = build.library("lln_diag_fused")
    ptrs = (qs.data_ptr(), ks.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            den.data_ptr() if den is not None else None)
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if _tc_path(v, d, dv):
            scratch = _tc_scratch(bh, bg, n, d, dv, blk, qs.device)
            err = lib.lln_diag_fused_tc_launch(
                *ptrs, *(t.data_ptr() for t in scratch), bh, bg, n, d, dv,
                blk, scale, stream)
        else:
            err = lib.lln_diag_fused_launch(
                *ptrs, bh, bg, n, d, dv, blk, _VCODES[v.dtype], COLS, scale,
                stream)
    build.check(err, "lln_diag_fused")
    lln_diag_fused.launches += 1
    return (out, den) if return_res else out


lln_diag_fused.launches = 0


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


# ---------------------------------------------------------------------------
# Bidirectional LLN (the encoder): reduce (S, z), then apply.
# ---------------------------------------------------------------------------

def lln_bidir_plain(qs, ks, v, *, r: int = 1, return_res: bool = False):
    """Plain PyTorch bidirectional LLN (the reference's reduce and apply,
    GQA via a (BG, R) head split), any N.  Returns ``out`` (BH,N,Dv) in
    v.dtype; with ``return_res`` ``(out, s (BG,D,Dv), z (BG,1,D), den
    (BH,N))``, the fp32 summaries and normalizer the backward reads."""
    bh, n, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    fk = torch.exp(ks.float())
    s = torch.einsum("gnd,gnv->gdv", fk, v.float())
    z = fk.sum(1)
    fq = torch.exp(qs.float()).reshape(bg, r, n, d)
    num = torch.einsum("grnd,gdv->grnv", fq, s)
    den = torch.einsum("grnd,gd->grn", fq, z) + EPS
    out = (num / den[..., None]).reshape(bh, n, dv).to(v.dtype)
    if return_res:
        return out, s, z[:, None, :], den.reshape(bh, n)
    return out


def lln_bidir(qs, ks, v, *, r: int = 1, return_res: bool = False):
    """Bidirectional LLN forward, outputs as :func:`lln_bidir_plain`; see
    the module docstring."""
    if qs.device.type == "cpu":
        return lln_bidir_plain(qs, ks, v, r=r, return_res=return_res)
    _check_lln_inputs(qs, ks, v, r)
    bh, n, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    f32 = dict(dtype=torch.float32, device=qs.device)
    out = torch.empty(bh, n, dv, dtype=v.dtype, device=qs.device)
    s = torch.empty(bg, d, dv, **f32)
    z = torch.empty(bg, 1, d, **f32)
    den = torch.empty(bh, n, **f32) if return_res else None
    lib = build.library("lln_bidir")
    ptrs = (qs.data_ptr(), ks.data_ptr(), v.data_ptr(), out.data_ptr(),
            den.data_ptr() if den is not None else None, s.data_ptr(),
            z.data_ptr())
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if _tc_path(v, d, dv):
            err = lib.lln_bidir_tc_launch(*ptrs, bh, bg, n, d, dv, stream)
        else:
            err = lib.lln_bidir_launch(*ptrs, bh, bg, n, d, dv,
                                       _VCODES[v.dtype], stream)
    build.check(err, "lln_bidir")
    lln_bidir.launches += 1
    return (out, s, z, den) if return_res else out


lln_bidir.launches = 0
