"""Mamba2 SSD chunked scan (arXiv:2405.21060): the CUDA kernel and its plain
version.

``ssd`` (``csrc/ssd.cu``) replaces ``src/repro/kernels/ssd.py:ssd_pallas``,
the training forward of ``models/ssm.py:ssm_apply``.  Kernel layout:
``log_a`` (BH, N) fp32 per-step log decay (<= 0), ``xbar`` (BH, N, P) fp32
dt-scaled inputs, ``b_in``/``c_in`` (BG, N, S) in the compute dtype (fp32
or bf16); head ``bh`` reads group row ``bh // r``, so B/C are never
repeated over the r heads of a group.  Per chunk of ``blk`` steps (N % blk
== 0):

    lcum_i = cumsum(log a)_i                       (within the chunk)
    y_i    = sum_{j<=i} (C_i.B_j) e(lcum_i - lcum_j) xbar_j + e(lcum_i) C_i.state
    state <- e(lcum_last) state + sum_j e(lcum_last - lcum_j) B_j xbar_j^T

with ``e(x) = exp(clip(x, -60, 0))`` and an fp32 (S, P) state carried from
chunk to chunk.  Returns y (BH, N, P) in xbar's dtype.

On the TPU the grid's ordered minor axis walked the chunks with the state
in VMEM.  Here two paths (:func:`_tc_path`):

- bf16 B/C with P at most 128 (mamba2-130m and zamba2-7b training):
  Mamba2's own chunked algorithm on the tensor cores, four launches.
  ``lcum`` of every (head, chunk) once, in one fixed order; each chunk's
  own state sum ``G_c = B^T (e(l_last - lcum) xbar)`` by one CTA per (head,
  chunk, 32 x 64 state slice), all in parallel (B exact, the decayed xbar
  as three bf16 planes, every 64-row step added in fp32); the states
  ``state_c`` by one fp32 pass over the chunks in order; the outputs by
  one CTA per (head, chunk, 64-row tile), 6144 at mamba2's shape:
  ``e(lcum_i) C_i state_c`` plus the masked decayed ``C B^T`` against
  xbar, each head recomputing its group's ``C B^T`` on the tensor cores.
  Scratch (:func:`_tc_scratch`): ``lcum`` and ``G_c`` fp32, ``state_c`` as
  bf16 hi + lo.  Bound on the H100 at mamba2's shape (B=8, H=24, N=2048,
  P=64, S=128): the 211 MB of xbar, y and B/C against about 61 GFLOP of
  tensor-core products, bytes by a little.
- fp32 B/C, or P above 128: one CTA per (head, 64 columns of P) loops
  over the chunks and owns its columns of the state in shared memory, 4 x
  4 register blocks of fp32 FMAs per thread; a CTA recomputes its group's
  C B^T for each of the r heads.  Bound: fp32 operations.

``ssd.launches`` counts the wrapper's launching calls (one call runs one
path's kernels).  The wrapper runs the plain version for a CPU tensor and
launches the kernels for a CUDA tensor, through the custom op
``repro_torch::ssd``, whose fake implementation gives the output's shape
to ``FakeTensorMode`` and launches and counts nothing.
"""
from __future__ import annotations

import torch

from . import build

# The most state rows the CUDA kernels hold (8 per row of 16 threads), and
# the widest P the tensor-core path takes.
MAX_STATE = 128
TC_MAX_P = 128
_BCODES = {torch.float32: 0, torch.bfloat16: 1}


def _clip_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def _check_shapes(log_a, xbar, b_in, c_in, r: int, blk: int):
    bh, n, _ = xbar.shape
    bg, _, s = b_in.shape
    if (log_a.shape != (bh, n) or c_in.shape != b_in.shape
            or b_in.shape[1] != n or bg * r != bh):
        raise ValueError(f"shape mismatch: log_a {tuple(log_a.shape)}, xbar "
                         f"{tuple(xbar.shape)}, b_in {tuple(b_in.shape)}, "
                         f"c_in {tuple(c_in.shape)}, r={r}")
    if blk < 1 or n % blk:
        raise ValueError(f"the sequence length ({n}) must be a multiple of "
                         f"the chunk ({blk})")


def _tc_path(b_in, p: int) -> bool:
    """Whether ``ssd`` runs its tensor-core path: bf16 B/C and P <=
    :data:`TC_MAX_P` (S <= :data:`MAX_STATE` holds for both paths)."""
    return b_in.dtype == torch.bfloat16 and p <= TC_MAX_P


def _tc_scratch(bh, n, p, s, blk, device):
    """Scratch of the tensor-core path: ``lcum`` (BH, N) fp32, each chunk's
    own state sum ``G_c`` (BH, N/blk - 1, S, P) fp32, and the chunk states
    ``state_c`` (2, BH, N/blk, S, P) as bf16 hi + lo."""
    nc = n // blk
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(bh, n, **f32),
            torch.empty(bh, max(nc - 1, 1), s, p, **f32),
            torch.empty(2, bh, nc, s, p, dtype=torch.bfloat16,
                        device=device))


def ssd_plain(log_a, xbar, b_in, c_in, *, r: int = 1, blk: int = 256):
    """Plain PyTorch SSD scan on the kernel layout (see the module
    docstring): a loop over chunks with an fp32 (BH, S, P) state, B/C read
    per group through a (BG, R) head split.  Returns y (BH, N, P) in
    xbar.dtype."""
    _check_shapes(log_a, xbar, b_in, c_in, r, blk)
    bh, n, p = xbar.shape
    bg, _, s = b_in.shape
    la = log_a.float().reshape(bg, r, n)
    xb = xbar.float().reshape(bg, r, n, p)
    bb, cc = b_in.float(), c_in.float()
    tril = torch.tril(torch.ones(blk, blk, device=xbar.device))
    state = torch.zeros(bg, r, s, p, device=xbar.device)
    ys = []
    for c0 in range(0, n, blk):
        cut = slice(c0, c0 + blk)
        lcum = torch.cumsum(la[:, :, cut], -1)                # (BG, R, blk)
        dot = cc[:, cut] @ bb[:, cut].transpose(1, 2)         # (BG, blk, blk)
        dec = _clip_exp(lcum[..., :, None] - lcum[..., None, :])
        scores = dot[:, None] * dec * tril
        y_intra = scores @ xb[:, :, cut]
        ein = _clip_exp(lcum)[..., None]
        y_inter = (cc[:, None, cut] * ein) @ state
        ys.append(y_intra + y_inter)
        l_last = lcum[..., -1:]
        carry = _clip_exp(l_last - lcum)[..., None]
        state = state * _clip_exp(l_last)[..., None] + \
            (bb[:, None, cut] * carry).transpose(-1, -2) @ xb[:, :, cut]
    return torch.cat(ys, 2).reshape(bh, n, p).to(xbar.dtype)


def ssd(log_a, xbar, b_in, c_in, *, r: int = 1, blk: int = 256):
    """SSD chunked scan, outputs as :func:`ssd_plain`; see the module
    docstring."""
    if xbar.device.type == "cpu":
        return ssd_plain(log_a, xbar, b_in, c_in, r=r, blk=blk)
    _check_shapes(log_a, xbar, b_in, c_in, r, blk)
    for name, t in (("log_a", log_a), ("xbar", xbar), ("b_in", b_in),
                    ("c_in", c_in)):
        if t.device != xbar.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{xbar.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if log_a.dtype != torch.float32 or xbar.dtype != torch.float32:
        raise TypeError(f"log_a and xbar must be float32, got "
                        f"{log_a.dtype}/{xbar.dtype}")
    if b_in.dtype not in _BCODES or c_in.dtype != b_in.dtype:
        raise TypeError(f"b_in/c_in must share float32 or bfloat16, got "
                        f"{b_in.dtype}/{c_in.dtype}")
    s = b_in.shape[-1]
    if s > MAX_STATE:
        raise ValueError(f"the kernel takes a state of at most {MAX_STATE} "
                         f"rows, got {s}")
    return _ssd_op(log_a, xbar, b_in, c_in, r, blk)


@torch.library.custom_op(
    "repro_torch::ssd", mutates_args=(), device_types="cuda",
    schema="(Tensor log_a, Tensor xbar, Tensor b_in, Tensor c_in, int r, "
           "int blk) -> Tensor")
def _ssd_op(log_a, xbar, b_in, c_in, r, blk):
    bh, n, p = xbar.shape
    bg, _, s = b_in.shape
    out = torch.empty_like(xbar)
    lib = build.library("ssd")
    ptrs = (log_a.data_ptr(), xbar.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), out.data_ptr())
    with torch.cuda.device(xbar.device):
        stream = torch.cuda.current_stream().cuda_stream
        if _tc_path(b_in, p):
            scratch = _tc_scratch(bh, n, p, s, blk, xbar.device)
            err = lib.ssd_tc_launch(*ptrs, *(t.data_ptr() for t in scratch),
                                    bh, bg, n, p, s, blk, stream)
        else:
            err = lib.ssd_launch(*ptrs, bh, bg, n, p, s, blk,
                                 _BCODES[b_in.dtype], stream)
    build.check(err, "ssd")
    ssd.launches += 1
    return out


@_ssd_op.register_fake
def _(log_a, xbar, b_in, c_in, r, blk):
    return torch.empty_like(xbar)


ssd.launches = 0
