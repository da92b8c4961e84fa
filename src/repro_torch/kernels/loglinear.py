"""Log-linear (Fenwick multi-scale) causal LLN forward: the CUDA kernel and
its plain version.

``loglin_causal`` (``csrc/loglin_causal.cu``) replaces
``src/repro/kernels/loglinear.py:loglin_causal_pallas``: the ``log_linear``
prefill (``return_state``) and full-sequence forward.  Kernel layout as
``kernels/lln_attention.py``: ``qs`` (BH, N, D) and ``ks`` (BG, N, D) fp32,
pre-scaled and stabilized with one constant per (batch, kv group), ``v``
(BG, N, Dv) fp32 or bf16; query row ``bh`` reads kv row ``bh // r``.

Per ``blk``-sized granule j, a query mixes a causal intra-granule term at
weight 1 with the pyramid of j closed granules, level l at weight
``scale_decay**l``; when the granule closes it enters the pyramid by a
binary increment (pure adds, since every bucket shares the one reference;
merged levels are zeroed; the top level saturates).  Any N: the keys after
the last closed granule are the open bucket, returned as ``(s, z)`` with
the state (zeros for N % blk == 0); that is what
``core/loglinear.py:prefill`` returns for a ragged prompt.

On the TPU the grid's ordered minor axis walked the granules with the
pyramid in VMEM.  Here the walk splits in two, since granule j's queries
read a weighted sum of closed granule states only, ``A_j = sum_{i<j}
w(i, j) G_i`` with ``G_i = Phi(k_i)^T v_i`` and ``w(i, j) =
scale_decay**level(i, j)`` fixed by (i, j) alone.  Two paths
(:func:`_tc_path`):

- bf16 ``v`` with D, Dv <= 128 and at most :data:`TC_MAX_LEVELS` levels
  (the yi-9b serve): the tensor-core path, three launches.  Phi(k) is split
  into bf16 hi + lo once; one CTA per (kv group, 32 x 64 state slice) walks
  the granules in order, once per group, keeps its slice of the pyramid
  (Phi(k)^T v with Phi(k) in three bf16 planes, each 64-row step added in
  fp32) and writes ``A_j`` and ``zA_j`` for every granule, then the final
  state r times; one CTA per (query head, granule, 64-row tile), 4096 at
  the serve shape, adds the masked intra-granule term on the tensor cores
  to ``Phi(q) A_j`` and divides by ``den``.  Scratch (:func:`_tc_scratch`):
  Phi(k) and ``A_j`` as bf16 planes, ``zA_j`` fp32.  Bound on the H100 at
  the serve shape (B=4, H=32, G=4, N=2048, D=Dv=128, state): about 269 MB
  against about 69 GFLOP of tensor-core products, bytes by a little.
- fp32 ``v``, a wider head or a deeper pyramid: the CUDA-core kernel, one
  CTA per (query head, 32 value columns) that walks the sequence in 64-row
  tiles with its columns of every level, of the open granule and of the
  weighted read in shared memory; each query head rebuilds its group's
  pyramid.  Bound: fp32 operations.

The wrapper runs its plain version for a CPU tensor and launches its CUDA
kernels for a CUDA tensor; ``loglin_causal.launches`` counts its launching
calls (one call runs one path's kernels).  The CUDA branch is the custom
op ``repro_torch::loglin_causal``, whose fake implementation gives the
outputs' shapes to ``FakeTensorMode`` and launches and counts nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.loglinear import _cascade_same_ref
from . import build, lln_attention
from .lln_attention import (_VCODES, COLS, EPS, PREFILL_TILE,
                            _check_lln_inputs)

# The deepest pyramid the tensor-core path takes (csrc kMaxLevels).
TC_MAX_LEVELS = 8


def _check_scales(blk: int, num_scales: int, scale_decay: float):
    if blk < 1 or num_scales < 1 or not scale_decay > 0:
        raise ValueError(f"need blk >= 1, num_scales >= 1 and scale_decay > "
                         f"0, got {blk}, {num_scales}, {scale_decay}")


def _tc_path(v, d: int, dv: int, num_scales: int) -> bool:
    """Whether ``loglin_causal`` runs its tensor-core path: bf16 ``v``, D
    and Dv within its ``lln_attention.TC_WIDTH``, at most
    :data:`TC_MAX_LEVELS` levels; otherwise its CUDA-core kernel."""
    return (lln_attention._tc_path(v, d, dv, "loglin_causal")
            and num_scales <= TC_MAX_LEVELS)


def _tc_scratch(bg, n, d, dv, blk, device):
    """Scratch of the tensor-core path: Phi(k) (2,BG,N,D) and the granule
    reads A_j (2,BG,nc,D,Dv) as bf16 hi + lo, zA_j (BG,nc,D) fp32, with
    nc = ceil(N / blk) granules."""
    nc = -(-n // blk)
    bf = dict(dtype=torch.bfloat16, device=device)
    return (torch.empty(2, bg, n, d, **bf),
            torch.empty(2, bg, nc, d, dv, **bf),
            torch.empty(bg, nc, d, dtype=torch.float32, device=device))


def loglin_causal_plain(qs, ks, v, *, r: int = 1, blk: int = 256,
                        num_scales: int = 4, scale_decay: float = 0.5,
                        return_state: bool = False):
    """Plain PyTorch log-linear causal LLN (a scan over granules, GQA via a
    (BG, R) head split, no repeated KV).  Returns ``out`` (BH,N,Dv) in
    v.dtype; with ``return_state`` ``(out, sl (BH,L,D,Dv), zl (BH,L,1,D),
    s (BH,D,Dv), z (BH,1,D))``, fp32, the group state repeated to each
    query-head row: the pyramid and the open bucket."""
    _check_scales(blk, num_scales, scale_decay)
    bh, n, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    ls = num_scales
    nf = n // blk                                   # closed granules
    pad = (-n) % blk
    nc = (n + pad) // blk
    wv = torch.tensor([float(scale_decay) ** l for l in range(ls)],
                      dtype=torch.float32, device=qs.device)
    fq = F.pad(torch.exp(qs.float()), (0, 0, 0, pad)).reshape(bg, r, nc, blk,
                                                              d)
    fk = F.pad(torch.exp(ks.float()), (0, 0, 0, pad)).reshape(bg, nc, blk, d)
    vf = F.pad(v.float(), (0, 0, 0, pad)).reshape(bg, nc, blk, dv)
    causal = torch.tril(torch.ones(blk, blk, device=qs.device))
    sl = torch.zeros(bg, ls, d, dv, device=qs.device)
    zl = torch.zeros(bg, ls, d, device=qs.device)
    s = torch.zeros(bg, d, dv, device=qs.device)
    z = torch.zeros(bg, d, device=qs.device)
    outs = []
    for i in range(nc):
        cq, ck, cv = fq[:, :, i], fk[:, i], vf[:, i]
        s_eff = torch.einsum("l,gldv->gdv", wv, sl)
        z_eff = torch.einsum("l,gld->gd", wv, zl)
        scores = torch.einsum("grid,gjd->grij", cq, ck) * causal
        intra = torch.einsum("grij,gjv->griv", scores, cv)
        inter = torch.einsum("grid,gdv->griv", cq, s_eff)
        den = scores.sum(-1) + torch.einsum("grid,gd->gri", cq, z_eff) + EPS
        outs.append((intra + inter) / den[..., None])
        c_s = torch.einsum("gjd,gjv->gdv", ck, cv)
        if i < nf:
            sl, zl = _cascade_same_ref(sl, zl, c_s, ck.sum(1), i, ls)
        else:                                       # the open bucket
            s, z = c_s, ck.sum(1)
    out = torch.stack(outs, 2).reshape(bh, nc * blk, dv)[:, :n].to(v.dtype)
    if not return_state:
        return out
    rep = lambda t: torch.repeat_interleave(t, r, dim=0)  # noqa: E731
    return (out, rep(sl), rep(zl)[:, :, None, :], rep(s),
            rep(z)[:, None, :])


def loglin_causal(qs, ks, v, *, r: int = 1, blk: int = 256,
                  num_scales: int = 4, scale_decay: float = 0.5,
                  return_state: bool = False):
    """Log-linear causal LLN forward, outputs as
    :func:`loglin_causal_plain`; see the module docstring."""
    if qs.device.type == "cpu":
        return loglin_causal_plain(qs, ks, v, r=r, blk=blk,
                                   num_scales=num_scales,
                                   scale_decay=scale_decay,
                                   return_state=return_state)
    _check_lln_inputs(qs, ks, v, r)
    _check_scales(blk, num_scales, scale_decay)
    out, *state = _loglin_causal_op(qs, ks, v, r, blk, num_scales,
                                    float(scale_decay), return_state)
    return (out, *state) if return_state else out


def _loglin_outputs(qs, v, num_scales, return_state):
    """The output and, with ``return_state``, the pyramid and the open
    bucket (empty otherwise)."""
    bh, n, d = qs.shape
    dv = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=qs.device)
    out = torch.empty(bh, n, dv, dtype=v.dtype, device=qs.device)
    if not return_state:
        return (out,) + tuple(torch.empty(0, **f32) for _ in range(4))
    return (out, torch.empty(bh, num_scales, d, dv, **f32),
            torch.empty(bh, num_scales, 1, d, **f32),
            torch.empty(bh, d, dv, **f32), torch.empty(bh, 1, d, **f32))


@torch.library.custom_op(
    "repro_torch::loglin_causal", mutates_args=(), device_types="cuda",
    schema="(Tensor qs, Tensor ks, Tensor v, int r, int blk, "
           "int num_scales, float scale_decay, bool return_state) -> "
           "(Tensor, Tensor, Tensor, Tensor, Tensor)")
def _loglin_causal_op(qs, ks, v, r, blk, num_scales, scale_decay,
                      return_state):
    bh, n, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    ls = num_scales
    out, *state = _loglin_outputs(qs, v, ls, return_state)
    ptrs = [t.data_ptr() if return_state else None for t in state]
    lib = build.library("loglin_causal")
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if _tc_path(v, d, dv, ls):
            scratch = _tc_scratch(bg, n, d, dv, blk, qs.device)
            err = lib.loglin_causal_tc_launch(
                qs.data_ptr(), ks.data_ptr(), v.data_ptr(), out.data_ptr(),
                *ptrs, *(t.data_ptr() for t in scratch), bh, bg, n, d, dv,
                blk, ls, scale_decay, stream)
        else:
            err = lib.loglin_causal_launch(
                qs.data_ptr(), ks.data_ptr(), v.data_ptr(), out.data_ptr(),
                *ptrs, bh, bg, n, d, dv, _VCODES[v.dtype], blk, ls,
                PREFILL_TILE, COLS, scale_decay, stream)
    build.check(err, "loglin_causal")
    loglin_causal.launches += 1
    return (out, *state)


@_loglin_causal_op.register_fake
def _(qs, ks, v, r, blk, num_scales, scale_decay, return_state):
    return _loglin_outputs(qs, v, num_scales, return_state)


loglin_causal.launches = 0
