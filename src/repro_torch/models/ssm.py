"""Mamba2 — State Space Duality (SSD) blocks (port of ``repro.models.ssm``:
the training forward, the state-emitting full-sequence forward and the
decode steps).

The SSD recurrence per head (state N = ssm_state, head dim P):

    h_t = exp(dt_t * A) h_{t-1} + B_t (dt_t x_t)^T      h: (N, P)
    y_t = C_t^T h_t + D x_t

computed in chunks: the dual quadratic form within a chunk plus a state
pass between chunks, with the decay in log space and the state in fp32.
With ``cfg.use_kernel`` the training forward (no ``state0``, no
``return_state``, L a multiple of ``ssm_chunk``) runs ``ops.ssd_scan``
(the CUDA kernel, its plain version or the core scan, as
``cfg.attn_backend`` selects); otherwise :func:`ssd_chunked` runs on B/C
repeated over the heads of each group.  Serving, as in the reference, runs
no kernel: the prefill is ``ssm_apply(..., return_state=True)`` on
:func:`ssd_chunked`, decode is :func:`ssm_decode` (one token) or
:func:`ssm_decode_chunk` (T tokens, the chunk's quadratic form against the
carried state), from the cache of :func:`ssm_cache_init`.

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

from repro_torch.core.lln import commit_lengths
from repro_torch.core.numerics import einsum_f32
from repro_torch.distributed.sharding import is_dtensor
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


def _mixer_weights(p: SSMBlock) -> tuple:
    """The weights of the sequence mixer, whole: (conv_w, conv_b, dt_bias,
    a_log, d_skip)."""
    return p.conv_w, p.conv_b, p.dt_bias, p.a_log, p.d_skip


def _head_weights(w, cfg, h0: int, h_loc: int) -> tuple:
    """The mixer weights of heads [h0, h0 + h_loc): the conv's x columns
    of those heads and its B / C columns, their conv biases, dt_bias,
    a_log and d_skip."""
    conv_w, conv_b, dt_bias, a_log, d_skip = w
    di, _, p_dim, s, g = _dims(cfg)
    x0, x1 = h0 * p_dim, (h0 + h_loc) * p_dim
    gs = g * s
    hs = slice(h0, h0 + h_loc)
    return ((conv_w[:, x0:x1], conv_w[:, di:di + gs], conv_w[:, di + gs:]),
            (conv_b[x0:x1], conv_b[di:di + gs], conv_b[di + gs:]),
            dt_bias[hs], a_log[hs], d_skip[hs])


def _mix(xs, b_proj, c_proj, dt, w, cfg, h0: int = 0, *, state0=None,
         return_state: bool = False):
    """The sequence mixer of :func:`ssm_apply` over heads [h0, h0 + H'),
    H' = ``dt.shape[-1]`` (all of them without a mesh, a rank's share on
    one): the causal conv of x, B and C piece by piece, the SSD scan (the
    kernel under ``cfg.use_kernel``), the skip term.  xs: (B, L, H' P) x
    projection, b_proj / c_proj: (B, L, G S), dt: (B, L, H') fp32 before
    the softplus; ``w`` the whole weights of :func:`_mixer_weights`.
    Returns (y (B, L, H' P) fp32, final state (B, H', S, P) or None)."""
    _, _, p_dim, s, g = _dims(cfg)
    bsz, l, _ = xs.shape
    h = dt.shape[-1]
    dtype = cfg.cdtype
    (cw_x, cw_b, cw_c), (cb_x, cb_b, cb_c), dt_bias, a_log, d_skip = \
        _head_weights(w, cfg, h0, h)
    # Depthwise conv per piece (x, B, C); channel-wise they are independent.
    xs = _causal_conv(xs, cw_x, cb_x, dtype)
    b_proj = _causal_conv(b_proj, cw_b, cb_b, dtype)
    c_proj = _causal_conv(c_proj, cw_c, cb_c, dtype)

    dt = _softplus(dt + dt_bias)
    a = -torch.exp(a_log.float())                             # (H,) < 0
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
    y = y + xh.float() * d_skip.float()[:, None]
    return y.reshape(bsz, l, h * p_dim), state


def ssm_apply(p: SSMBlock, x, cfg, *, state0=None,
              return_state: bool = False):
    """Full-sequence Mamba2 block.  x: (B, L, D) -> (B, L, D); with
    ``return_state`` also ``{"state": (B, H, S, P) fp32, "conv": the last
    W - 1 conv inputs (B, W - 1, conv_dim)}``.  On a mesh (DTensor x) the
    mixer runs per rank under ``local_map``
    (``distributed/local_ssm.py``)."""
    dtype = cfg.cdtype
    z = dense(p.w_z, x, dtype)
    xs = dense(p.w_x, x, dtype)
    b_proj = dense(p.w_B, x, dtype)
    c_proj = dense(p.w_C, x, dtype)
    dt = dense(p.w_dt, x, dtype).float()
    if is_dtensor(x):
        from repro_torch.distributed import local_ssm
        y, state = local_ssm.mix(xs, b_proj, c_proj, dt, _mixer_weights(p),
                                 cfg, state0=state0,
                                 return_state=return_state)
    else:
        y, state = _mix(xs, b_proj, c_proj, dt, _mixer_weights(p), cfg,
                        state0=state0, return_state=return_state)
    y = y.to(dtype)
    y = y * F.silu(z)
    y = apply_norm(p.norm, y)
    out = dense(p.out_w, y, dtype)
    if return_state:
        pieces = (xs, b_proj, c_proj)
        if is_dtensor(x):
            from repro_torch.distributed import local_ssm
            pieces = local_ssm.whole_columns(pieces)
        tail = torch.cat(pieces, -1)[:, -(cfg.conv_width - 1):]
        return out, {"state": state, "conv": tail.to(dtype)}
    return out


def ssm_cache_init(cfg, batch: int, device) -> dict:
    """Zeroed decode cache of one layer: ``{"state": (B, H, S, P) fp32,
    "conv": the last W - 1 conv inputs (B, W - 1, conv_dim) in the compute
    dtype}``."""
    di, h, p_dim, s, g = _dims(cfg)
    conv_dim = di + 2 * g * s
    return {"state": torch.zeros(batch, h, s, p_dim, dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros(batch, cfg.conv_width - 1, conv_dim,
                                dtype=cfg.cdtype, device=device)}


def _decode_proj(p: SSMBlock, x, cfg):
    """The input projections of a decode step: z, [x | B | C] (the conv's
    input) in the compute dtype, and dt in fp32.  On a mesh the conv
    input's columns are whole on every rank of 'model'."""
    dtype = cfg.cdtype
    pieces = (dense(p.w_x, x, dtype), dense(p.w_B, x, dtype),
              dense(p.w_C, x, dtype))
    if is_dtensor(x):
        from repro_torch.distributed import local_ssm
        pieces = local_ssm.whole_columns(pieces)
    return (dense(p.w_z, x, dtype), torch.cat(pieces, -1),
            dense(p.w_dt, x, dtype).float())


def _decode_out(p: SSMBlock, y, z, cfg):
    """The gate, the norm and the output projection of the mixer's y
    (B, T, di) fp32 (the skip term in)."""
    y = y.to(cfg.cdtype) * F.silu(z)
    return dense(p.out_w, apply_norm(p.norm, y), cfg.cdtype)


def _window_columns(window, cfg, h0: int, h: int):
    """The conv window's columns of heads [h0, h0 + h): their x columns
    and all the B / C columns."""
    di, _, p_dim, _, _ = _dims(cfg)
    return torch.cat([window[..., h0 * p_dim:(h0 + h) * p_dim],
                      window[..., di:]], -1)


def _decode_chunk_mix(conv_in, dt, state0, conv0, w, cfg, h0: int = 0, *,
                      row_mask=None, commit_len=None):
    """The mixer of :func:`ssm_decode_chunk` over heads [h0, h0 + H'),
    H' = ``dt.shape[-1]``: conv_in (B, T, conv_dim) and conv0 (B, W - 1,
    conv_dim) whole, dt (B, T, H') fp32 before the softplus, state0
    (B, H', S, P).  Returns (y (B, T, H' P) fp32 with the skip term, new
    state, new conv window (whole columns))."""
    _, _, p_dim, s, g = _dims(cfg)
    bsz, t, _ = conv_in.shape
    h = dt.shape[-1]
    dtype = cfg.cdtype
    wdt = cfg.conv_width
    dev = conv_in.device
    (cw_x, cw_b, cw_c), (cb_x, cb_b, cb_c), dt_bias, a_log, d_skip = \
        _head_weights(w, cfg, h0, h)
    cw = torch.cat([cw_x, cw_b, cw_c], -1)
    cb = torch.cat([cb_x, cb_b, cb_c], -1)
    # Causal conv over [cached window | chunk]: position t sees rows
    # t .. t+W-1 of the concatenation, the window a one-token loop sees.
    window = torch.cat([conv0.to(dtype), conv_in], 1)
    mine = _window_columns(window, cfg, h0, h)
    conv_out = torch.zeros(bsz, t, mine.shape[-1], dtype=dtype, device=dev)
    for j in range(wdt):
        conv_out = conv_out + mine[:, j:j + t] * cw[j].to(dtype)
    conv_out = F.silu(conv_out + cb.to(dtype))
    xs = conv_out[..., :h * p_dim]
    b_proj = conv_out[..., h * p_dim:h * p_dim + g * s]
    c_proj = conv_out[..., h * p_dim + g * s:]

    dt = _softplus(dt + dt_bias)                              # (B,T,H)
    log_a = dt * -torch.exp(a_log.float())
    xh = xs.reshape(bsz, t, h, p_dim).float()
    xbar = xh * dt[..., None]
    rep = h // g
    b_in = torch.repeat_interleave(b_proj.reshape(bsz, t, g, s), rep,
                                   2).float()
    c_in = torch.repeat_interleave(c_proj.reshape(bsz, t, g, s), rep,
                                   2).float()

    lcum = torch.cumsum(log_a, 1)                             # (B,T,H)
    dot = einsum_f32("bihs,bjhs->bhij", c_in, b_in)
    dec = _clip_exp(lcum[:, :, None] - lcum[:, None, :]).permute(0, 3, 1, 2)
    tri = torch.tril(torch.ones(t, t, device=dev))
    y = einsum_f32("bhij,bjhp->bihp", dot * dec * tri, xbar) \
        + einsum_f32("bihs,bhsp->bihp", c_in, state0) \
        * _clip_exp(lcum)[..., None]
    # Only tokens j < commit_len[b] enter the recurrence.
    cl = torch.as_tensor(commit_lengths(commit_len, row_mask, t),
                         device=dev).long().expand(bsz)
    lcum0 = torch.cat([torch.zeros(bsz, 1, h, device=dev), lcum], 1)
    l_tot = torch.take_along_dim(lcum0, cl[:, None, None].expand(-1, 1, h),
                                 dim=1)[:, 0]                 # (B,H)
    take = torch.arange(t, device=dev)[None, :] < cl[:, None]
    carry_dec = torch.where(take[..., None], _clip_exp(l_tot[:, None] - lcum),
                            torch.zeros_like(lcum))
    state = state0 * _clip_exp(l_tot)[:, :, None, None] \
        + torch.einsum("bjhs,bjh,bjhp->bhsp", b_in, carry_dec, xbar)
    # The conv window: rows cl .. cl+W-2 of [cache | chunk] are the last
    # W - 1 inputs a sequential decode of the accepted prefix saw.
    idx = cl[:, None] + torch.arange(wdt - 1, device=dev)[None, :]
    conv = torch.take_along_dim(window, idx[:, :, None], dim=1)
    if row_mask is not None:
        state = torch.where(row_mask[:, None, None, None], state, state0)
        conv = torch.where(row_mask[:, None, None], conv, conv0.to(dtype))
    y = y + xh * d_skip.float()[:, None]
    return y.reshape(bsz, t, h * p_dim), state, conv.to(dtype)


def ssm_decode_chunk(p: SSMBlock, x, cache, cfg, *, row_mask=None,
                     commit_len=None):
    """Chunked T-token decode under the serving contract.  x: (B, T, D).
    Every position is scored against the carried state and conv window
    plus the chunk's prefix (the chunk's quadratic form and the state term
    of :func:`ssd_chunked`, the decay exps clipped to [-60, 0]).  Only the
    accepted prefix enters the cache: ``commit_len`` (B,) int in [0, T]
    tokens per row (all T without it) fold into the state, and the conv
    window becomes the W - 1 rows of [cache | chunk] that a sequential
    decode of that prefix saw; ``row_mask`` (B,) bool rows keep their cache
    bitwise (their outputs are to be discarded).  Returns (out (B, T, D),
    new cache); the cache passed in is not modified."""
    z, conv_in, dt = _decode_proj(p, x, cfg)
    if is_dtensor(x):
        from repro_torch.distributed import local_ssm
        y, state, conv = local_ssm.decode_mix(
            _decode_chunk_mix, conv_in, dt, cache["state"], cache["conv"],
            _mixer_weights(p), cfg, row_mask=row_mask,
            commit_len=commit_len)
    else:
        y, state, conv = _decode_chunk_mix(
            conv_in, dt, cache["state"], cache["conv"], _mixer_weights(p),
            cfg, row_mask=row_mask, commit_len=commit_len)
    return _decode_out(p, y, z, cfg), {"state": state, "conv": conv}


def _decode_step_mix(conv_in, dt, state0, conv0, w, cfg, h0: int = 0):
    """The mixer of :func:`ssm_decode` over heads [h0, h0 + H') (the
    arguments of :func:`_decode_chunk_mix`, T = 1)."""
    _, _, p_dim, s, g = _dims(cfg)
    bsz = conv_in.shape[0]
    h = dt.shape[-1]
    dtype = cfg.cdtype
    (cw_x, cw_b, cw_c), (cb_x, cb_b, cb_c), dt_bias, a_log, d_skip = \
        _head_weights(w, cfg, h0, h)
    cw = torch.cat([cw_x, cw_b, cw_c], -1)
    cb = torch.cat([cb_x, cb_b, cb_c], -1)
    window = torch.cat([conv0.to(dtype), conv_in], 1)         # (B,W,Cd)
    mine = _window_columns(window, cfg, h0, h)
    conv_out = torch.einsum("bwc,wc->bc", mine, cw.to(dtype)) + cb.to(dtype)
    conv_out = F.silu(conv_out)[:, None]
    xs = conv_out[..., :h * p_dim]
    b_proj = conv_out[..., h * p_dim:h * p_dim + g * s]
    c_proj = conv_out[..., h * p_dim + g * s:]

    dt = _softplus(dt + dt_bias)[:, 0]                        # (B,H)
    decay = torch.exp(dt * -torch.exp(a_log.float()))
    xh = xs.reshape(bsz, h, p_dim).float()
    xbar = xh * dt[..., None]
    rep = h // g
    b_in = torch.repeat_interleave(b_proj.reshape(bsz, g, s), rep, 1).float()
    c_in = torch.repeat_interleave(c_proj.reshape(bsz, g, s), rep, 1).float()
    state = state0 * decay[..., None, None] \
        + torch.einsum("bhs,bhp->bhsp", b_in, xbar)
    y = torch.einsum("bhs,bhsp->bhp", c_in, state)
    y = y + xh * d_skip.float()[:, None]
    return (y.reshape(bsz, 1, h * p_dim), state,
            window[:, 1:].to(cfg.cdtype))


def ssm_decode(p: SSMBlock, x, cache, cfg):
    """One-token step.  x: (B, 1, D).  Returns (out (B, 1, D), new cache);
    the cache passed in is not modified."""
    z, conv_in, dt = _decode_proj(p, x, cfg)
    if is_dtensor(x):
        from repro_torch.distributed import local_ssm
        y, state, conv = local_ssm.decode_mix(
            _decode_step_mix, conv_in, dt, cache["state"], cache["conv"],
            _mixer_weights(p), cfg)
    else:
        y, state, conv = _decode_step_mix(conv_in, dt, cache["state"],
                                          cache["conv"], _mixer_weights(p),
                                          cfg)
    return _decode_out(p, y, z, cfg), {"state": state, "conv": conv}
