"""Mamba2 — State Space Duality (SSD) blocks (port of ``repro.models.ssm``:
the training forward and the state-emitting full-sequence forward).

The SSD recurrence per head (state N = ssm_state, head dim P):

    h_t = exp(dt_t * A) h_{t-1} + B_t (dt_t x_t)^T      h: (N, P)
    y_t = C_t^T h_t + D x_t

computed in chunks: the dual quadratic form within a chunk plus a state
pass between chunks, with the decay in log space and the state in fp32.
With ``cfg.use_kernel`` the training forward (no ``state0``, no
``return_state``, L a multiple of ``ssm_chunk``) runs ``ops.ssd_scan``
(the CUDA kernel, its plain version or the core scan, as
``cfg.attn_backend`` selects); otherwise :func:`ssd_chunked` runs on B/C
repeated over the heads of each group.  The decode steps
(``ssm_cache_init``, ``ssm_decode``, ``ssm_decode_chunk``) are not ported
yet (ROADMAP.md queue 1, item 11).

Parameter names match the reference's ``ssm_init`` pytree (``w_z``,
``w_x``, ``w_B``, ``w_C``, ``w_dt``, ``dt_bias``, ``a_log``, ``d_skip``,
``conv_w``, ``conv_b``, ``norm``, ``out_w``); ``dt_bias``, ``a_log`` and
``d_skip`` stay fp32 whatever the parameter dtype.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.numerics import einsum_f32
from .layers import Norm, _dense_param, apply_norm, dense, trunc_normal


def _dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    h = di // cfg.ssm_head_dim
    return di, h, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups


class SSMBlock(nn.Module):
    """Parameters of one Mamba2 block (random init from ``generator``)."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        di, h, _, s, g = _dims(cfg)
        d = cfg.d_model
        conv_dim = di + 2 * g * s
        for name, d_out in (("w_z", di), ("w_x", di), ("w_B", g * s),
                            ("w_C", g * s), ("w_dt", h)):
            self.register_parameter(name, _dense_param(d, d_out, dtype,
                                                       device, generator))
        f32 = dict(dtype=torch.float32, device=device)
        self.dt_bias = nn.Parameter(torch.zeros(h, **f32))
        self.a_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, h,
                                                           **f32)))
        self.d_skip = nn.Parameter(torch.ones(h, **f32))
        self.conv_w = nn.Parameter(trunc_normal(
            (cfg.conv_width, conv_dim), conv_dim ** -0.5, dtype, device,
            generator))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, dtype=dtype,
                                               device=device))
        self.norm = Norm(di, "rmsnorm", dtype, device)
        self.out_w = _dense_param(di, d, dtype, device, generator)


def _causal_conv(x, w, b, dtype):
    """Depthwise causal conv, width W: y_t = sum_j x_{t-W+1+j} w_j,
    accumulated in ``dtype`` as the reference does."""
    wdt = w.shape[0]
    xf = x.to(dtype)
    out = torch.zeros_like(xf)
    for j in range(wdt):
        shift = wdt - 1 - j
        shifted = F.pad(xf, (0, 0, shift, 0))[:, :xf.shape[1]]
        out = out + shifted * w[j].to(dtype)
    return F.silu(out + b.to(dtype))


def _clip_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def _chunk_step(state, xb, bb, cb, la, tri):
    """One chunk of :func:`ssd_chunked`: (new state, y of the chunk)."""
    lcum = torch.cumsum(la, 1)                                # (B,C,H)
    # intra-chunk: score_ij = (C_i . B_j) exp(lcum_i - lcum_j), j <= i
    dot = einsum_f32("bihs,bjhs->bhij", cb, bb)
    dec = _clip_exp(lcum[:, :, None] - lcum[:, None, :]).permute(
        0, 3, 1, 2)                                           # (B,H,i,j)
    scores = dot * dec * tri
    y_intra = einsum_f32("bhij,bjhp->bihp", scores.to(xb.dtype), xb)
    # inter-chunk: y_i += exp(lcum_i) C_i . state
    y_inter = einsum_f32("bihs,bhsp->bihp", cb, state.to(cb.dtype)) \
        * _clip_exp(lcum)[..., None]
    # state pass: exp(l_last) state + sum_j exp(l_last - l_j) B_j xbar_j
    l_last = lcum[:, -1]                                      # (B,H)
    carry = _clip_exp(l_last[:, None] - lcum)
    state = state * _clip_exp(l_last)[:, :, None, None] + torch.einsum(
        "bjhs,bjh,bjhp->bhsp", bb.float(), carry, xb.float())
    return state, y_intra + y_inter


def ssd_chunked(xbar, b_in, c_in, log_a, *, chunk: int,
                state0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    xbar: (B, L, H, P) dt-scaled inputs; b_in/c_in: (B, L, H, S) (already
    group-broadcast); log_a: (B, L, H) per-step log decay (<= 0); state0:
    (B, H, S, P) fp32 or None.  Returns (y (B, L, H, P) fp32, final state
    (B, H, S, P) fp32).  Any L: a ragged tail is zero-padded (log_a = 0
    there, so the pad neither decays nor feeds the state).  As in the
    reference, the inter-chunk term reads the state cast to the B/C dtype
    (the kernel keeps it fp32).  With grad enabled each chunk step runs
    under ``torch.utils.checkpoint``, as the reference wraps its step in
    ``jax.checkpoint``: autograd keeps each chunk's inputs and carried
    state, and the backward recomputes the chunk's (c x c) scores.
    """
    bsz, l, h, p = xbar.shape
    s = b_in.shape[-1]
    c = min(chunk, l)
    pad = (-l) % c
    if pad:
        xbar, b_in, c_in = (F.pad(t, (0, 0, 0, 0, 0, pad))
                            for t in (xbar, b_in, c_in))
        log_a = F.pad(log_a, (0, 0, 0, pad))
    nc = xbar.shape[1] // c

    def chunks(t):
        return t.reshape((bsz, nc, c) + t.shape[2:]).unbind(1)

    tri = torch.tril(torch.ones(c, c, device=xbar.device))
    state = torch.zeros(bsz, h, s, p, device=xbar.device) \
        if state0 is None else state0
    step = _chunk_step
    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, _chunk_step, use_reentrant=False)
    ys = []
    for xb, bb, cb, la in zip(chunks(xbar), chunks(b_in), chunks(c_in),
                              chunks(log_a.float())):
        state, y = step(state, xb, bb, cb, la, tri)
        ys.append(y)
    y = torch.cat(ys, 1)
    return y[:, :l], state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (torch's softplus
    returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssm_apply(p: SSMBlock, x, cfg, *, state0=None,
              return_state: bool = False):
    """Full-sequence Mamba2 block.  x: (B, L, D) -> (B, L, D); with
    ``return_state`` also ``{"state": (B, H, S, P) fp32, "conv": the last
    W - 1 conv inputs (B, W - 1, conv_dim)}``."""
    di, h, p_dim, s, g = _dims(cfg)
    bsz, l, _ = x.shape
    dtype = cfg.cdtype
    z = dense(p.w_z, x, dtype)
    xs = dense(p.w_x, x, dtype)
    b_proj = dense(p.w_B, x, dtype)
    c_proj = dense(p.w_C, x, dtype)
    dt = dense(p.w_dt, x, dtype).float()

    # Depthwise conv per piece (x, B, C); channel-wise they are independent.
    gs = g * s
    xs_raw, b_raw, c_raw = xs, b_proj, c_proj
    xs = _causal_conv(xs, p.conv_w[:, :di], p.conv_b[:di], dtype)
    b_proj = _causal_conv(b_proj, p.conv_w[:, di:di + gs],
                          p.conv_b[di:di + gs], dtype)
    c_proj = _causal_conv(c_proj, p.conv_w[:, di + gs:], p.conv_b[di + gs:],
                          dtype)

    dt = _softplus(dt + p.dt_bias)
    a = -torch.exp(p.a_log.float())                           # (H,) < 0
    log_a = dt * a                                            # (B,L,H)

    xh = xs.reshape(bsz, l, h, p_dim)
    xbar = xh.float() * dt[..., None]
    if cfg.use_kernel and state0 is None and not return_state \
            and l % cfg.ssm_chunk == 0:
        # Training forward through the SSD kernel (groups by index, no
        # repeat of B/C).
        from repro_torch.kernels import ops
        y = ops.ssd_scan(xbar, b_proj.reshape(bsz, l, g, s),
                         c_proj.reshape(bsz, l, g, s), log_a, cfg.ssm_chunk,
                         backend=cfg.attn_backend)
        state = None
    else:
        rep = h // g
        b_in = torch.repeat_interleave(b_proj.reshape(bsz, l, g, s), rep, 2)
        c_in = torch.repeat_interleave(c_proj.reshape(bsz, l, g, s), rep, 2)
        y, state = ssd_chunked(xbar, b_in, c_in, log_a, chunk=cfg.ssm_chunk,
                               state0=state0)
    y = y + xh.float() * p.d_skip.float()[:, None]
    y = y.reshape(bsz, l, di).to(dtype)
    y = y * F.silu(z)
    y = apply_norm(p.norm, y)
    out = dense(p.out_w, y, dtype)
    if return_state:
        tail = torch.cat([xs_raw, b_raw, c_raw], -1)[:, -(cfg.conv_width - 1):]
        return out, {"state": state, "conv": tail.to(dtype)}
    return out
