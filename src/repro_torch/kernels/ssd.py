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
in VMEM.  Here one CTA per (head, 64 columns of P) loops over the chunks
and owns its columns of the state in shared memory.  A chunk is cut into
64-row tiles: per query tile the inter-chunk term, then the intra-chunk
term against each key tile up to it; after the last query tile the state
update.  Each of the 256 threads holds a 4 x 4 block of every product in
registers.  A CTA recomputes its group's C B^T for each of the r heads
that share it, as the TPU kernel did: r = 24 (mamba2-130m) and 112
(zamba2-7b).  Bound on the H100: fp32 operations (about 4 S P FLOPs per
head and step of the recurrent form, against the 8 P bytes of xbar in and
y out).

``ssd.launches`` counts the kernel's launches.  The wrapper runs the plain
version for a CPU tensor and launches the kernel for a CUDA tensor.
"""
from __future__ import annotations

import torch

from . import build

# The most state rows the CUDA kernel holds (8 per row of 16 threads).
MAX_STATE = 128
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
    bh, n, p = xbar.shape
    bg, _, s = b_in.shape
    if s > MAX_STATE:
        raise ValueError(f"the kernel takes a state of at most {MAX_STATE} "
                         f"rows, got {s}")
    out = torch.empty_like(xbar)
    lib = build.library("ssd")
    with torch.cuda.device(xbar.device):
        err = lib.ssd_launch(
            log_a.data_ptr(), xbar.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), out.data_ptr(), bh, bg, n, p, s, blk,
            _BCODES[b_in.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(err, "ssd")
    ssd.launches += 1
    return out


ssd.launches = 0
