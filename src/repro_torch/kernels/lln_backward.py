"""Backward of the causal LLN and fused LLN + diag forwards: CUDA kernels
and plain versions.

Port of ``repro.kernels.lln_backward``.  With the cotangent ``g``, the
saved output ``o`` and normalizer ``den``, ``u = g / den`` and
``w = (g . o) / den``, the input gradients factor through the forward's
running state ``(S, z)`` and a reverse state ``dS = sum Phi(q) u^T``,
``dz = sum w Phi(q)`` (see that module's docstring).  All gradients are
fp32; ``kernels/ops.py`` applies the alpha/beta chain rule.  dk and dv are
summed over the ``r`` query heads that share a kv head.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its CUDA kernels for a CUDA tensor; it counts its launches (one per call of
its C entry, which runs several kernels) in ``<wrapper>.launches``. The CUDA branch is one ``torch.library`` custom op per
wrapper (``repro_torch::<wrapper>``): the device guard, the stream, the
scratch, the launch, its error check and the counter.  Its fake
implementation gives the outputs' shapes and dtypes to ``FakeTensorMode``
(``launch/dryrun.py``) and launches and counts nothing.

``lln_causal_bwd`` (``csrc/lln_causal_bwd.cu``) replaces
``src/repro/kernels/lln_backward.py:lln_causal_bwd_pallas``.  Two paths,
chosen by ``lln_attention._tc_path`` (its width 256, wider than the
forward's 128):

- bf16 with D, Dv <= 256 (every model path on the card): the tensor-core
  path, ``lln_diag_fused_bwd``'s without the softmax, chunk-parallel over
  blocks of ``lln_attention.TC_BLOCK`` rows (the kernels' own block; any
  N).  The forward's block states recomputed once per kv group; a dq
  kernel per (query head, block, 64-row tile) writes each row's ``w`` and
  ``dqs = Phi(q) (gmat Phi(k) + u S_c^T - w z_c)`` with ``gmat = tril(u
  v^T - w)``; the reverse block states ``(dS_c, dz_c)`` over the later
  blocks and the r heads in a fixed order; two CTAs per (kv group, block,
  64-key tile), one for ``dks`` and one for ``dv``, that walk the r heads
  and the block's query tiles in a fixed order: no atomics, two runs equal
  bit for bit.  Every fp32 operand as three bf16 planes (the gradients are
  held to 1e-5), each query tile's products added to the totals in fp32.
  Scratch: :func:`lln_attention._tc_scratch` with three planes, twice the
  states.  Above D or Dv = 128 (MLA's D = 192, paligemma's D = Dv = 256)
  each CTA writes 128 columns of its output, so dq and both dk/dv roles
  gain a CTA per 128-column chunk, each recomputing its tile's scores.
  Bound (``chip_smoke.py:_lln_counts``): the bytes, a little above the
  products at the bf16 rate with the three-plane count, at the training
  shapes (B=4, H=32, G=4, N=1024, D=Dv=128).
- fp32, or a head wider than 256: the CUDA-core kernels.  A dq kernel
  rebuilds ``(S, z)`` in forward order with one CTA per (query head, 32 rows
  of D) -- its products contract over Dv, so the forward's column split does
  not serve -- and a dk/dv kernel runs the reverse scan with dk CTAs over
  rows and dv CTAs over columns of ``dS``, each keeping the sum of ``(dS,
  dz)`` over the r heads and looping over the heads in order for the
  intra-tile terms: no atomics.  Bound: fp32 operations, about twice the
  forward's.

``lln_diag_fused_bwd`` (``csrc/lln_diag_fused_bwd.cu``) replaces
``src/repro/kernels/lln_backward.py:lln_diag_fused_bwd_pallas``: the LLN
gradient on ``g / 2`` with the LLN output rebuilt from the saved ``o`` as
``2 o - diag``, plus the block softmax gradient, recomputed in the kernels
(the dq kernel saves each row's softmax max, sum and delta, and ``w``,
for the dk/dv kernel instead of the probabilities).  Two paths, chosen by
``lln_attention._tc_path`` (bf16 with D, Dv <= 256 on the tensor cores,
else the CUDA-core kernels).  The tensor-core path
is chunk-parallel over the ``blk`` blocks: the forward's block states
recomputed once per kv group, a dq kernel per (query head, block, 64-row
tile) with one online softmax pass and one gradient pass, the reverse
block states ``(dS_c, dz_c)`` summed over the later blocks and the r heads
in a fixed order, and three CTAs per (kv group, block, 64-key tile), one
each for dkd, dks and dv, that walk the r heads and the block's query
tiles in a fixed order: no atomics, two runs equal bit for bit.
Every fp32 operand goes in as three bf16 planes (2^-24 relative; two
planes left dks and dqs outside the 1e-5 tolerance), and each query
tile's products are added to the dk/dv totals in fp32.  Above D or Dv =
128 (MLA's D = 192, paligemma's D = Dv = 256) each CTA writes 128 columns
of its output, so dq and every dk/dv role gain a CTA per 128-column
chunk, each recomputing its tile's scores.  The scratch is
:func:`lln_attention._tc_scratch` with three planes, twice the states.
Bound (``chip_smoke.py:_fused_counts``): the products at the bf16
tensor-core rate, an fp32 operand once per MMA the two-plane split takes;
at the training shape the bytes bound it.

``lln_bidir_bwd`` (``csrc/lln_bidir_bwd.cu``) replaces
``src/repro/kernels/lln_backward.py:lln_bidir_bwd_pallas``: the encoder's
backward from the saved ``(S, z, den, o)``, three kernels as the
reference's: dq applies ``(S, z)`` per (query head, 64-row tile) and
writes each row's ``w`` for the next; the reduce sums the whole sequence's
``(dS, dz)`` over N and over the r query heads of a kv head, in that fixed
order (the TPU revisited one output block in grid order; GPU programs run
concurrently, and atomics would make the sums' order vary); dk/dv apply
``(dS, dz)`` per (kv head, 64-row tile).  Any N.  Scratch
(:func:`_bidir_scratch`): ``w``, ``dS`` and ``dz`` in fp32.  Two paths,
chosen as the forward's (``lln_attention._tc_path``):

- bf16 with D, Dv <= 128 (the encoder on the card): the tensor-core path.
  dq takes ``g s^T`` with bf16 g against the fp32 ``s`` split into three
  bf16 planes as it is staged, then ``Phi(q) (g s^T / den - w z)`` in
  fp32; the reduce is the causal pair's reverse state kernel with one
  block of all N rows and the final total (Phi(q) / den in three planes
  against bf16 g, each 64-row step added in fp32, heads then rows); two
  CTAs per (kv group, 64-key tile) give ``dks = Phi(k) (V dS^T - dz)``
  (bf16 V, three MMAs) and ``dv = Phi(k) dS`` (both in three planes, six
  MMAs).  No atomics: two runs equal bit for bit.  Bound
  (``chip_smoke.py:_bidir_counts``): the bytes at the encoder shape (B=32,
  H=G=12, N=512, D=Dv=64).
- fp32, or a wider head: the CUDA-core kernels, one CTA per (kv head, 32
  columns) for the reduce.  Bound: fp32 operations.
"""
from __future__ import annotations

import torch

from . import build, lln_attention
# NEG_INF: the reference module's public constant, the same value here.
from .lln_attention import (NEG_INF, _VCODES, _check_blocks,  # noqa: F401
                            _check_lln_inputs, _check_raw_qk, _check_same,
                            _diag_probs, _tc_path, _tc_scratch)

# D rows of a dq/dk CTA, Dv columns of a dv CTA.
ROWS = 32
COLS = 32


def _check_grad_inputs(qs, ks, v, g, o, den, r):
    _check_lln_inputs(qs, ks, v, r)
    _check_same(qs.device, g=g, o=o, den=den)
    if g.dtype != v.dtype or o.dtype != v.dtype:
        raise TypeError(f"g and o must have v's dtype {v.dtype}, got "
                        f"{g.dtype}/{o.dtype}")
    if den.dtype != torch.float32:
        raise TypeError(f"den must be float32, got {den.dtype}")
    bh, n, _ = qs.shape
    shape = (bh, n, v.shape[-1])
    if g.shape != shape or o.shape != shape or den.shape != (bh, n):
        raise ValueError(f"shape mismatch: g {tuple(g.shape)}, o "
                         f"{tuple(o.shape)}, den {tuple(den.shape)} for qs "
                         f"{tuple(qs.shape)}")


def _uw(g, o, den):
    gf = g.float()
    return gf / den[..., None], (gf * o.float()).sum(-1) / den


# ---------------------------------------------------------------------------
# Causal LLN backward.
# ---------------------------------------------------------------------------

def lln_causal_bwd_plain(qs, ks, v, g, o, den, *, r: int = 1, blk: int = 256):
    """Plain PyTorch twin of ``lln_causal_bwd_scan``: a forward-order chunk
    scan for dqs and a reverse one for dks/dv, GQA by a (BG, R) head split.
    Returns fp32 ``(dqs (BH,N,D), dks (BG,N,D), dv (BG,N,Dv))``."""
    bh, n, d = qs.shape
    _check_blocks(n, blk)
    bg, dv = ks.shape[0], v.shape[-1]
    nc = n // blk
    dev = qs.device
    fq = torch.exp(qs.float()).reshape(bg, r, nc, blk, d)
    fk = torch.exp(ks.float()).reshape(bg, nc, blk, d)
    vf = v.float().reshape(bg, nc, blk, dv)
    u, w = _uw(g, o, den)
    u = u.reshape(bg, r, nc, blk, dv)
    w = w.reshape(bg, r, nc, blk)
    mask = torch.tril(torch.ones(blk, blk, device=dev))

    def gmat(c):
        return (torch.einsum("brie,bje->brij", u[:, :, c], vf[:, c])
                - w[:, :, c, :, None]) * mask

    s = torch.zeros(bg, d, dv, device=dev)
    z = torch.zeros(bg, d, device=dev)
    dqs = []
    for c in range(nc):
        dfq = torch.einsum("brij,bjd->brid", gmat(c), fk[:, c])
        dfq = dfq + torch.einsum("brie,bde->brid", u[:, :, c], s)
        dfq = dfq - w[:, :, c, :, None] * z[:, None, None, :]
        dqs.append(fq[:, :, c] * dfq)
        s = s + torch.einsum("bjd,bje->bde", fk[:, c], vf[:, c])
        z = z + fk[:, c].sum(1)

    ds = torch.zeros(bg, d, dv, device=dev)
    dz = torch.zeros(bg, d, device=dev)
    dks, dvs = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        fq_c, fk_c, v_c, u_c = fq[:, :, c], fk[:, c], vf[:, c], u[:, :, c]
        scores = torch.einsum("brid,bjd->brij", fq_c, fk_c) * mask
        dv_c = torch.einsum("brij,brie->bje", scores, u_c)
        dv_c = dv_c + torch.einsum("bjd,bde->bje", fk_c, ds)
        dfk = torch.einsum("brij,brid->bjd", gmat(c), fq_c)
        dfk = dfk + torch.einsum("bje,bde->bjd", v_c, ds) - dz[:, None, :]
        ds = ds + torch.einsum("brid,brie->bde", fq_c, u_c)
        dz = dz + (fq_c * w[:, :, c, :, None]).sum((1, 2))
        dks[c], dvs[c] = fk_c * dfk, dv_c
    return (torch.stack(dqs, 2).reshape(bh, n, d),
            torch.stack(dks, 1).reshape(bg, n, d),
            torch.stack(dvs, 1).reshape(bg, n, dv))


def lln_causal_bwd(qs, ks, v, g, o, den, *, r: int = 1, blk: int = 256):
    """Backward of the causal LLN forward from its residuals; see the
    module docstring.  qs/g/o/den are query-side (BH, ...), ks/v kv-side
    (BG, ...); g and o in v's dtype, den fp32; N % blk == 0."""
    if qs.device.type == "cpu":
        return lln_causal_bwd_plain(qs, ks, v, g, o, den, r=r, blk=blk)
    _check_grad_inputs(qs, ks, v, g, o, den, r)
    _check_blocks(qs.shape[1], blk)
    return _lln_causal_bwd_op(qs, ks, v, g, o, den, r, blk)


def _grads(qs, ks, v, raw: bool = False):
    """fp32 (dqs (BH,N,D), dks (BG,N,D), dv (BG,N,Dv)); ``raw``: also the
    diag part's dq and dk, as ``(dqs, dqd, dks, dkd, dv)``."""
    bh, n, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    f32 = dict(dtype=torch.float32, device=qs.device)
    if raw:
        return (torch.empty(bh, n, d, **f32), torch.empty(bh, n, d, **f32),
                torch.empty(bg, n, d, **f32), torch.empty(bg, n, d, **f32),
                torch.empty(bg, n, dv, **f32))
    return (torch.empty(bh, n, d, **f32), torch.empty(bg, n, d, **f32),
            torch.empty(bg, n, dv, **f32))


@torch.library.custom_op(
    "repro_torch::lln_causal_bwd", mutates_args=(), device_types="cuda",
    schema="(Tensor qs, Tensor ks, Tensor v, Tensor g, Tensor o, "
           "Tensor den, int r, int blk) -> (Tensor, Tensor, Tensor)")
def _lln_causal_bwd_op(qs, ks, v, g, o, den, r, blk):
    bh, n, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    dqs, dks, dvo = _grads(qs, ks, v)
    w = torch.empty(bh, n, dtype=torch.float32, device=qs.device)
    lib = build.library("lln_causal_bwd")
    ptrs = (qs.data_ptr(), ks.data_ptr(), v.data_ptr(), g.data_ptr(),
            o.data_ptr(), den.data_ptr(), dqs.data_ptr(), dks.data_ptr(),
            dvo.data_ptr(), w.data_ptr())
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if _tc_path(v, d, dv, "lln_causal_bwd"):
            tc_blk = lln_attention.TC_BLOCK
            phq, phk, sst, zst = _tc_scratch(bh, bg, n, d, dv, tc_blk,
                                             qs.device, planes=3)
            dsst, dzst = torch.empty_like(sst), torch.empty_like(zst)
            err = lib.lln_causal_bwd_tc_launch(
                *ptrs, *(t.data_ptr() for t in (phq, phk, sst, zst, dsst,
                                                dzst)),
                bh, bg, n, d, dv, tc_blk, stream)
        else:
            err = lib.lln_causal_bwd_launch(
                *ptrs, bh, bg, n, d, dv, blk, _VCODES[v.dtype], ROWS, COLS,
                stream)
    build.check(err, "lln_causal_bwd")
    lln_causal_bwd.launches += 1
    return dqs, dks, dvo


@_lln_causal_bwd_op.register_fake
def _(qs, ks, v, g, o, den, r, blk):
    return _grads(qs, ks, v)


lln_causal_bwd.launches = 0


# ---------------------------------------------------------------------------
# Fused LLN + block-diagonal softmax backward.
# ---------------------------------------------------------------------------

def lln_diag_fused_bwd_plain(qs, ks, q, k, v, g, o, den, *, r: int = 1,
                             blk: int = 256, scale: float | None = None):
    """Plain PyTorch twin of ``lln_diag_fused_bwd_scan``: the LLN scan
    backward on g/2 with the LLN output rebuilt as ``2 o - diag``, plus the
    block softmax backward.  Returns fp32 ``(dqs, dqd, dks, dkd, dv)``."""
    bh, n, d = qs.shape
    _check_blocks(n, blk)
    bg, dv = ks.shape[0], v.shape[-1]
    nb = n // blk
    scale = d ** -0.5 if scale is None else scale
    p = _diag_probs(q, k, r, blk, scale)
    qq = q.float().reshape(bg, r, nb, blk, d) * scale
    kk = k.float().reshape(bg, nb, blk, d)
    vf = v.float().reshape(bg, nb, blk, dv)
    diag = torch.einsum("brcij,bcje->brcie", p, vf).reshape(bh, n, dv)
    gh = 0.5 * g.float()
    lln = 2.0 * o.float() - diag
    dqs, dks, dv_lln = lln_causal_bwd_plain(qs, ks, v, gh, lln, den, r=r,
                                            blk=blk)
    ghb = gh.reshape(bg, r, nb, blk, dv)
    dp = torch.einsum("brcie,bcje->brcij", ghb, vf)
    dsm = p * (dp - (dp * p).sum(-1, keepdim=True))
    dqd = (torch.einsum("brcij,bcjd->brcid", dsm, kk) * scale).reshape(bh, n, d)
    dkd = torch.einsum("brcij,brcid->bcjd", dsm, qq).reshape(bg, n, d)
    dv_diag = torch.einsum("brcij,brcie->bcje", p, ghb).reshape(bg, n, dv)
    return dqs, dqd, dks, dkd, dv_lln + dv_diag


def lln_diag_fused_bwd(qs, ks, q, k, v, g, o, den, *, r: int = 1,
                       blk: int = 256, scale: float | None = None):
    """Backward of the fused hybrid; see the module docstring.  q/k/v/g/o
    share one dtype; qs/ks/den fp32; N % blk == 0."""
    if qs.device.type == "cpu":
        return lln_diag_fused_bwd_plain(qs, ks, q, k, v, g, o, den, r=r,
                                        blk=blk, scale=scale)
    _check_grad_inputs(qs, ks, v, g, o, den, r)
    _check_raw_qk(qs, ks, q, k, v)
    _check_blocks(qs.shape[1], blk)
    scale = qs.shape[-1] ** -0.5 if scale is None else scale
    return _lln_diag_fused_bwd_op(qs, ks, q, k, v, g, o, den, r, blk, scale)


@torch.library.custom_op(
    "repro_torch::lln_diag_fused_bwd", mutates_args=(), device_types="cuda",
    schema="(Tensor qs, Tensor ks, Tensor q, Tensor k, Tensor v, Tensor g, "
           "Tensor o, Tensor den, int r, int blk, float scale) -> "
           "(Tensor, Tensor, Tensor, Tensor, Tensor)")
def _lln_diag_fused_bwd_op(qs, ks, q, k, v, g, o, den, r, blk, scale):
    bh, n, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    dqs, dqd, dks, dkd, dvo = _grads(qs, ks, v, raw=True)
    stats = torch.empty(4, bh, n, dtype=torch.float32, device=qs.device)
    lib = build.library("lln_diag_fused_bwd")
    ptrs = (qs.data_ptr(), ks.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), g.data_ptr(), o.data_ptr(), den.data_ptr(),
            dqs.data_ptr(), dqd.data_ptr(), dks.data_ptr(), dkd.data_ptr(),
            dvo.data_ptr(), stats.data_ptr())
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if _tc_path(v, d, dv, "lln_diag_fused_bwd"):
            phq, phk, sst, zst = _tc_scratch(bh, bg, n, d, dv, blk,
                                             qs.device, planes=3)
            dsst, dzst = torch.empty_like(sst), torch.empty_like(zst)
            err = lib.lln_diag_fused_bwd_tc_launch(
                *ptrs, *(t.data_ptr() for t in (phq, phk, sst, zst, dsst,
                                                dzst)),
                bh, bg, n, d, dv, blk, scale, stream)
        else:
            err = lib.lln_diag_fused_bwd_launch(
                *ptrs, bh, bg, n, d, dv, blk, _VCODES[v.dtype], ROWS, COLS,
                scale, stream)
    build.check(err, "lln_diag_fused_bwd")
    lln_diag_fused_bwd.launches += 1
    return dqs, dqd, dks, dkd, dvo


@_lln_diag_fused_bwd_op.register_fake
def _(qs, ks, q, k, v, g, o, den, r, blk, scale):
    return _grads(qs, ks, v, raw=True)


lln_diag_fused_bwd.launches = 0


# ---------------------------------------------------------------------------
# Bidirectional LLN backward.
# ---------------------------------------------------------------------------

def _check_state(s, z, bg, d, dv, device):
    for name, t, shape in (("s", s, (bg, d, dv)), ("z", z, (bg, 1, d))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {device}")


def lln_bidir_bwd_plain(qs, ks, v, g, o, den, s, z, *, r: int = 1):
    """Plain PyTorch twin of ``lln_bidir_bwd_scan`` (full-sequence
    einsums, GQA by a (BG, R) head split), any N: u = g / den,
    w = (g . o) / den against the forward's ``s`` (BG,D,Dv) and
    ``z`` (BG,1,D).  Returns fp32 ``(dqs (BH,N,D), dks (BG,N,D),
    dv (BG,N,Dv))``."""
    bh, n, d = qs.shape
    bg = ks.shape[0]
    fq = torch.exp(qs.float()).reshape(bg, r, n, d)
    fk = torch.exp(ks.float())
    u, w = _uw(g, o, den)
    u = u.reshape(bg, r, n, -1)
    w = w.reshape(bg, r, n)
    dfq = torch.einsum("brne,bde->brnd", u, s) \
        - w[..., None] * z[:, 0][:, None, None, :]
    dqs = (fq * dfq).reshape(bh, n, d)
    ds = torch.einsum("brnd,brne->bde", fq, u)
    dz = (fq * w[..., None]).sum((1, 2))
    dvv = torch.einsum("bnd,bde->bne", fk, ds)
    dks = fk * (torch.einsum("bne,bde->bnd", v.float(), ds) - dz[:, None, :])
    return dqs, dks, dvv


def _bidir_scratch(bh, bg, n, d, dv, device):
    """Scratch of both ``lln_bidir_bwd`` paths, fp32: each query row's
    ``w`` (BH,N) and the reverse totals ``dS`` (BG,D,Dv) and ``dz``
    (BG,D)."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(bh, n, **f32), torch.empty(bg, d, dv, **f32),
            torch.empty(bg, d, **f32))


def lln_bidir_bwd(qs, ks, v, g, o, den, s, z, *, r: int = 1):
    """Backward of the bidirectional LLN forward from its residuals; see
    the module docstring.  qs/g/o/den are query-side (BH, ...), ks/v and
    the saved s/z kv-side (BG, ...); g and o in v's dtype; any N."""
    if qs.device.type == "cpu":
        return lln_bidir_bwd_plain(qs, ks, v, g, o, den, s, z, r=r)
    _check_grad_inputs(qs, ks, v, g, o, den, r)
    _check_state(s, z, ks.shape[0], qs.shape[-1], v.shape[-1], qs.device)
    return _lln_bidir_bwd_op(qs, ks, v, g, o, den, s, z, r)


@torch.library.custom_op(
    "repro_torch::lln_bidir_bwd", mutates_args=(), device_types="cuda",
    schema="(Tensor qs, Tensor ks, Tensor v, Tensor g, Tensor o, "
           "Tensor den, Tensor s, Tensor z, int r) -> "
           "(Tensor, Tensor, Tensor)")
def _lln_bidir_bwd_op(qs, ks, v, g, o, den, s, z, r):
    bh, n, d = qs.shape
    bg, dv = ks.shape[0], v.shape[-1]
    dqs, dks, dvo = _grads(qs, ks, v)
    scratch = _bidir_scratch(bh, bg, n, d, dv, qs.device)
    lib = build.library("lln_bidir_bwd")
    ptrs = (qs.data_ptr(), ks.data_ptr(), v.data_ptr(), g.data_ptr(),
            o.data_ptr(), den.data_ptr(), s.data_ptr(), z.data_ptr(),
            dqs.data_ptr(), dks.data_ptr(), dvo.data_ptr(),
            *(t.data_ptr() for t in scratch))
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if _tc_path(v, d, dv, "lln_bidir_bwd"):
            err = lib.lln_bidir_bwd_tc_launch(*ptrs, bh, bg, n, d, dv, stream)
        else:
            err = lib.lln_bidir_bwd_launch(*ptrs, bh, bg, n, d, dv,
                                           _VCODES[v.dtype], stream)
    build.check(err, "lln_bidir_bwd")
    lln_bidir_bwd.launches += 1
    return dqs, dks, dvo


@_lln_bidir_bwd_op.register_fake
def _(qs, ks, v, g, o, den, s, z, r):
    return _grads(qs, ks, v)


lln_bidir_bwd.launches = 0
