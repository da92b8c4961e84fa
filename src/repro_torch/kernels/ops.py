"""Ops around the kernels (port of ``repro.kernels.ops``): the training
entries ``lln_attention`` / ``lln_diag_attention`` (causal and
bidirectional) and ``block_diag_attention``, the serving entries
``lln_prefill`` / ``block_diag_fwd`` / ``lln_decode_chunk`` with its
commit half ``lln_commit_chunk``, the log-linear (Fenwick multi-scale)
entries ``loglin_attention`` / ``loglin_prefill`` /
``loglin_decode_chunk`` / ``loglin_commit_chunk`` (inference only), and the
Mamba2 SSD scan ``ssd_scan`` (training).

Responsibilities:
* layout: (B, N, H, D) model convention <-> (B*H, N, D) kernel convention,
  heads ordered ``bh = b*H + h`` so kv row ``bh // r`` is right for
  ``H = G*r``;
* LLN pre-scaling and stabilization: qs = alpha*q - c_q, ks = beta*k - c_k
  in fp32, with per-(batch, head) constants that cancel exactly;
* backend dispatch (``kernels/registry.py:resolve``): the CUDA kernel, its
  plain version, or the core reference;
* the training gradient: a ``torch.autograd.Function`` per op (the
  reference's ``custom_vjp``) whose forward saves the pre-scaled (qs, ks),
  the kernel-layout v (and q, k for the fused op), the output and the LLN
  normalizer ``den``, and whose backward runs the backward kernel (or its
  plain version) and applies the chain rule through qs = alpha*q - c_q.
  alpha, beta, c_q and c_k get no gradient, as in the reference.  The
  bidirectional forward also saves the summaries ``(s, z)``, and the
  bidirectional hybrid saves the LLN half of its output, as the
  reference does.  Any N: a causal sequence whose length is not a multiple
  of the block is padded with zeros at its end inside the Function
  (:func:`_pad_seq`); the bidirectional kernels take the true N, since
  every query sees every key and a pad key would enter the sums.
"""
from __future__ import annotations

import torch

from repro_torch.core import diag as core_diag
from repro_torch.core import lln as core_lln
from repro_torch.core import loglinear as core_loglin
from . import registry
from .block_diag import (block_diag, block_diag_bwd, block_diag_bwd_plain,
                         block_diag_plain)
from .lln_attention import (MAX_DECODE_T, NEG_INF, lln_bidir,
                            lln_bidir_plain, lln_causal, lln_causal_plain,
                            lln_decode, lln_decode_plain, lln_diag_fused,
                            lln_diag_fused_plain)
from .lln_backward import (lln_bidir_bwd, lln_bidir_bwd_plain, lln_causal_bwd,
                           lln_causal_bwd_plain, lln_diag_fused_bwd,
                           lln_diag_fused_bwd_plain)
from .loglinear import loglin_causal, loglin_causal_plain
from .ssd import ssd, ssd_plain


def _to_kernel(t: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) -> contiguous (B*H, N, D)."""
    b, n, h, d = t.shape
    return t.transpose(1, 2).reshape(b * h, n, d).contiguous()


def _from_kernel(t: torch.Tensor, b: int) -> torch.Tensor:
    bh, n, d = t.shape
    return t.reshape(b, bh // b, n, d).transpose(1, 2)


def _bcast_heads(p, heads: int, device) -> torch.Tensor:
    """Scalar -> (heads,); (heads,) and per-row (B, heads) pass through."""
    p = torch.as_tensor(p, dtype=torch.float32, device=device).detach()
    return p.expand(heads) if p.ndim == 0 else p


def _row_head_bcast(p: torch.Tensor) -> torch.Tensor:
    """Broadcast (H,) or per-row (B, H) calibration over (B, N, H, D)."""
    return p[:, None, :, None] if p.ndim == 2 else p[None, None, :, None]


def _scaled_stabilized(q, k, alpha, beta):
    """Return ``(qs, ks, c_k)``: fp32 pre-scaled, stabilized q/k in kernel
    layout (exponents <= 0) and the key constant c_k (B, 1, G, 1) — the
    decode state's reference constant.  c_q and c_k are detached, as the
    reference's ``stop_gradient``: they cancel in the normalized output."""
    alpha = _bcast_heads(alpha, q.shape[2], q.device)
    beta = _bcast_heads(beta, k.shape[2], k.device)
    aq = q.float() * _row_head_bcast(alpha)
    bk = k.float() * _row_head_bcast(beta)
    c_q = torch.amax(aq, dim=(1, 3), keepdim=True).detach()
    c_k = torch.amax(bk, dim=(1, 3), keepdim=True).detach()
    return _to_kernel(aq - c_q), _to_kernel(bk - c_k), c_k


def _pad_seq(t: torch.Tensor, n_to: int) -> torch.Tensor:
    """Zero-pad a (rows, N, D) kernel-layout tensor to N = ``n_to``.

    Under the causal mask a pad key (position >= N) is seen only by pad
    queries, so every real row of the forward is unchanged; a pad query's
    cotangent is zero, so it adds nothing to any gradient.  Not for the
    bidirectional kernels: there a zero pad key has Phi(k) = exp(-c_k) != 0.
    """
    pad = n_to - t.shape[1]
    return torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t


def _round_up(n: int, blk: int) -> int:
    return -(-n // blk) * blk


def _repeat_heads(t: torch.Tensor, h: int, dim: int = 2) -> torch.Tensor:
    g = t.shape[dim]
    return t if g == h else torch.repeat_interleave(t, h // g, dim=dim)


# ---------------------------------------------------------------------------
# Training: LLN and the LLN + diag hybrid with their gradients.
# ---------------------------------------------------------------------------

def _lln_ref(q, k, v, alpha, beta, causal, chunk):
    """Autograd through the core chunked scan (causal) or ``lln_bidir`` on
    repeated KV (the reference's ``_lln_ref``); alpha and beta get no
    gradient."""
    h, g = q.shape[2], k.shape[2]
    alpha, beta = (torch.as_tensor(p, dtype=torch.float32,
                                   device=q.device).detach()
                   for p in (alpha, beta))
    if beta.ndim and beta.shape[-1] == g:
        beta = _repeat_heads(beta, h, dim=-1)
    if causal:
        out, _ = core_lln.lln_causal_scan(
            q, _repeat_heads(k, h), _repeat_heads(v, h), alpha, beta,
            chunk=chunk)
    else:
        out = core_lln.lln_bidir(q, _repeat_heads(k, h), _repeat_heads(v, h),
                                 alpha, beta)
    return out.to(v.dtype)


def _diag_ref(q, k, v, block, causal):
    h = q.shape[2]
    return core_diag.block_diag_attn(q, _repeat_heads(k, h),
                                     _repeat_heads(v, h), block=block,
                                     causal=causal).to(v.dtype)


def _lln_diag_ref(q, k, v, alpha, beta, causal, block):
    lln = _lln_ref(q, k, v, alpha, beta, causal, block)
    diag = _diag_ref(q, k, v, block, causal)
    return (0.5 * (lln.float() + diag.float())).to(v.dtype)


def _calibrated(q, k, v, alpha, beta):
    """``(alpha (H,|B,H), beta (G,|B,G), qs, ks, vk)``: the broadcast
    calibration and the kernel-layout inputs of the LLN part."""
    h, g = q.shape[2], k.shape[2]
    alpha_b = _bcast_heads(alpha, h, q.device)
    beta_b = _bcast_heads(beta, g, q.device)
    qs, ks, _ = _scaled_stabilized(q, k, alpha_b, beta_b)
    return alpha_b, beta_b, qs, ks, _to_kernel(v)


class _LLNAttention(torch.autograd.Function):
    """LLN: causal, the forward kernel with ``den`` and the backward
    kernel; bidirectional, ``lln_bidir`` with ``(s, z, den)`` and
    ``lln_bidir_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, alpha, beta, chunk, causal, kind):
        b, n, h, _ = q.shape
        r = h // k.shape[2]
        alpha_b, beta_b, qs, ks, vk = _calibrated(q, k, v, alpha, beta)
        if causal:
            np_ = _round_up(n, chunk)
            qs, ks, vk = (_pad_seq(t, np_) for t in (qs, ks, vk))
            fn = lln_causal if kind == "kernel" else lln_causal_plain
            out_k, den = fn(qs, ks, vk, r=r, blk=chunk, return_res=True,
                            return_state=False)
            s = z = None
        else:
            fn = lln_bidir if kind == "kernel" else lln_bidir_plain
            out_k, s, z, den = fn(qs, ks, vk, r=r, return_res=True)
        ctx.save_for_backward(qs, ks, vk, out_k, den, s, z, alpha_b, beta_b)
        ctx.meta = (chunk, causal, kind, b, n, r, q.dtype, k.dtype, v.dtype)
        return _from_kernel(out_k[:, :n], b)

    @staticmethod
    def backward(ctx, g_out):
        qs, ks, vk, out_k, den, s, z, alpha_b, beta_b = ctx.saved_tensors
        chunk, causal, kind, b, n, r, tq, tk, tv = ctx.meta
        gk = _to_kernel(g_out.to(tv))
        if causal:
            fn = lln_causal_bwd if kind == "kernel" else lln_causal_bwd_plain
            dqs, dks, dvk = fn(qs, ks, vk, _pad_seq(gk, qs.shape[1]), out_k,
                               den, r=r, blk=chunk)
        else:
            fn = lln_bidir_bwd if kind == "kernel" else lln_bidir_bwd_plain
            dqs, dks, dvk = fn(qs, ks, vk, gk, out_k, den, s, z, r=r)
        dq = (_from_kernel(dqs[:, :n], b) * _row_head_bcast(alpha_b)).to(tq)
        dk = (_from_kernel(dks[:, :n], b) * _row_head_bcast(beta_b)).to(tk)
        dv = _from_kernel(dvk[:, :n], b).to(tv)
        return dq, dk, dv, None, None, None, None, None


class _LLNDiagAttention(torch.autograd.Function):
    """§4.2 hybrid.  Causal: the fused forward kernel with ``den``, the
    fused backward kernel.  Bidirectional (the reference has no fused
    kernel for it): ``lln_bidir`` and ``block_diag`` averaged in fp32, then
    ``lln_bidir_bwd`` and ``block_diag_bwd`` on g / 2, dv summed."""

    @staticmethod
    def forward(ctx, q, k, v, alpha, beta, block, causal, kind):
        b, n, h, _ = q.shape
        r = h // k.shape[2]
        alpha_b, beta_b, qs, ks, vk = _calibrated(q, k, v, alpha, beta)
        qk, kk = _to_kernel(q), _to_kernel(k)
        if causal:
            np_ = _round_up(n, block)
            qs, ks, qk, kk, vk = (_pad_seq(t, np_)
                                  for t in (qs, ks, qk, kk, vk))
            fn = lln_diag_fused if kind == "kernel" else lln_diag_fused_plain
            out_k, den = fn(qs, ks, qk, kk, vk, r=r, blk=block,
                            return_res=True)
            s = z = None
            res_k = out_k
        else:
            fn = lln_bidir if kind == "kernel" else lln_bidir_plain
            res_k, s, z, den = fn(qs, ks, vk, r=r, return_res=True)
            fn = block_diag if kind == "kernel" else block_diag_plain
            diag_k = fn(qk, kk, vk, r=r, blk=block, causal=False)
            out_k = (0.5 * (res_k.float() + diag_k.float())).to(v.dtype)
        # res_k: the saved output the backward reads (the LLN half when
        # bidirectional, as in the reference).
        ctx.save_for_backward(qs, ks, qk, kk, vk, res_k, den, s, z, alpha_b,
                              beta_b)
        ctx.meta = (block, causal, kind, b, n, r, q.dtype, k.dtype, v.dtype)
        return _from_kernel(out_k[:, :n], b)

    @staticmethod
    def backward(ctx, g_out):
        (qs, ks, qk, kk, vk, res_k, den, s, z, alpha_b,
         beta_b) = ctx.saved_tensors
        block, causal, kind, b, n, r, tq, tk, tv = ctx.meta
        gk = _to_kernel(g_out.to(tv))
        if causal:
            fn = lln_diag_fused_bwd if kind == "kernel" \
                else lln_diag_fused_bwd_plain
            dqs, dqd, dks, dkd, dvk = fn(qs, ks, qk, kk, vk,
                                         _pad_seq(gk, qs.shape[1]), res_k,
                                         den, r=r, blk=block)
        else:
            gh = 0.5 * gk               # exact: halving keeps g's dtype
            fn = lln_bidir_bwd if kind == "kernel" else lln_bidir_bwd_plain
            dqs, dks, dvl = fn(qs, ks, vk, gh, res_k, den, s, z, r=r)
            fn = block_diag_bwd if kind == "kernel" else block_diag_bwd_plain
            dqd, dkd, dvd = fn(qk, kk, vk, gh, r=r, blk=block, causal=False)
            dvk = dvl + dvd
        dq = (_from_kernel(dqs[:, :n], b) * _row_head_bcast(alpha_b)
              + _from_kernel(dqd[:, :n], b)).to(tq)
        dk = (_from_kernel(dks[:, :n], b) * _row_head_bcast(beta_b)
              + _from_kernel(dkd[:, :n], b)).to(tk)
        dv = _from_kernel(dvk[:, :n], b).to(tv)
        return dq, dk, dv, None, None, None, None, None


class _BlockDiagAttention(torch.autograd.Function):
    """Block-diagonal softmax: ``block_diag`` forward, ``block_diag_bwd``
    (which recomputes the probabilities) backward."""

    @staticmethod
    def forward(ctx, q, k, v, block, causal, kind):
        b, h = q.shape[0], q.shape[2]
        r = h // k.shape[2]
        qk, kk, vk = _to_kernel(q), _to_kernel(k), _to_kernel(v)
        fn = block_diag if kind == "kernel" else block_diag_plain
        out = fn(qk, kk, vk, r=r, blk=block, causal=causal)
        ctx.save_for_backward(qk, kk, vk)
        ctx.meta = (block, causal, kind, b, r, q.dtype, k.dtype, v.dtype)
        return _from_kernel(out, b)

    @staticmethod
    def backward(ctx, g_out):
        qk, kk, vk = ctx.saved_tensors
        block, causal, kind, b, r, tq, tk, tv = ctx.meta
        fn = block_diag_bwd if kind == "kernel" else block_diag_bwd_plain
        dq, dk, dv = fn(qk, kk, vk, _to_kernel(g_out.to(tv)), r=r, blk=block,
                        causal=causal)
        return (_from_kernel(dq, b).to(tq), _from_kernel(dk, b).to(tk),
                _from_kernel(dv, b).to(tv), None, None, None)


def lln_attention(q, k, v, alpha, beta, causal: bool = True,
                  chunk: int = 256, backend: str = "auto"):
    """LLN attention (paper eq. 8), the training entry point; causal (the
    decoder) or bidirectional (the encoder).

    q: (B,N,H,D); k/v: (B,N,G,D[v]) with G | H (GQA without repeated KV);
    output in v.dtype.  alpha/beta: scalar, (H,)/(G,) or (B, H)/(B, G);
    they get no gradient.  ``backend`` as ``kernels/registry.py``:
    ``kernel`` (or ``auto`` on a CUDA tensor) runs the CUDA forward and
    backward kernels, ``plain`` their plain versions inside the same
    autograd Function, ``ref`` autograd through ``core/lln.py``.  Any N:
    causal, where ``N % chunk != 0`` the Function zero-pads the sequence
    to a whole number of chunks (:func:`_pad_seq`); bidirectional, the
    kernels run at the true N (``chunk`` does not enter the math).  The
    reference sends such an N to its jnp autograd instead, which computes
    the same function.
    """
    kind = registry.resolve(backend, q.device)
    if kind == "ref":
        return _lln_ref(q, k, v, alpha, beta, causal, chunk)
    return _LLNAttention.apply(q, k, v, alpha, beta, chunk, causal, kind)


def lln_diag_attention(q, k, v, alpha, beta, causal: bool = True,
                       block: int = 256, backend: str = "auto"):
    """The paper's §4.2 hybrid, 0.5 * (LLN + block-diag softmax), the
    training entry point; ``block`` is both the LLN chunk and the diag
    block.  Shapes, dtypes, backends and any N as :func:`lln_attention`."""
    kind = registry.resolve(backend, q.device)
    if kind == "ref":
        return _lln_diag_ref(q, k, v, alpha, beta, causal, block)
    return _LLNDiagAttention.apply(q, k, v, alpha, beta, block, causal, kind)


def block_diag_attention(q, k, v, block: int = 256, causal: bool = False,
                         backend: str = "auto"):
    """Block-diagonal softmax attention (the §4.2 diag part) as a training
    op.  q: (B,N,H,D); k/v: (B,N,G,D[v]); output (B,N,H,Dv) in v.dtype;
    any N.  Backends as :func:`lln_attention` (``ref``: autograd through
    ``core/diag.py`` on repeated KV)."""
    kind = registry.resolve(backend, q.device)
    if kind == "ref":
        return _diag_ref(q, k, v, block, causal)
    return _BlockDiagAttention.apply(q, k, v, block, causal, kind)


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------

def lln_prefill(q, k, v, alpha, beta, chunk: int = 256, backend: str = "auto"):
    """Causal LLN prefill emitting outputs and the decode state in one pass.

    q: (B,N,H,D); k/v: (B,N,G,D[v]).  Returns ``(out (B,N,H,Dv), s
    (B,H,D,Dv), z (B,H,D), c_k (B,1,H,1))`` — the ``LLNState`` layout, with
    the group state repeated to each query head.  ``chunk`` is the plain
    scan's chunk; any N is taken.
    """
    b, n, h, _ = q.shape
    g = k.shape[2]
    kind = registry.resolve(backend, q.device)
    if kind == "ref":
        beta_h = torch.as_tensor(beta, dtype=torch.float32, device=q.device)
        if beta_h.ndim and beta_h.shape[-1] == g:
            beta_h = _repeat_heads(beta_h, h, dim=-1)
        out, st = core_lln.prefill(q, _repeat_heads(k, h), _repeat_heads(v, h),
                                   alpha, beta_h, chunk=chunk)
        return out, st.s, st.z, st.c_k
    qs, ks, c_k = _scaled_stabilized(q, k, alpha, beta)
    vk = _to_kernel(v)
    fn = lln_causal if kind == "kernel" else lln_causal_plain
    out_k, s, z = fn(qs, ks, vk, r=h // g, blk=chunk, return_state=True)
    return (_from_kernel(out_k, b), s.reshape(b, h, *s.shape[1:]),
            z.reshape(b, h, z.shape[-1]), _repeat_heads(c_k, h))


def block_diag_fwd(q, k, v, block: int = 256, causal: bool = True,
                   backend: str = "auto"):
    """Block-diagonal softmax for the §4.2 diag part of the prefill.
    q: (B,N,H,D); k/v: (B,N,G,D[v]); any N."""
    b, n, h, _ = q.shape
    g = k.shape[2]
    kind = registry.resolve(backend, q.device)
    if kind == "ref":
        return _diag_ref(q, k, v, block, causal)
    fn = block_diag if kind == "kernel" else block_diag_plain
    out = fn(_to_kernel(q), _to_kernel(k), _to_kernel(v), r=h // g, blk=block,
             causal=causal)
    return _from_kernel(out, b)


def lln_decode_chunk(state, q, k, v, alpha, beta, backend: str = "auto",
                     row_mask=None, commit_len=None, renorm=None):
    """Advance an ``LLNState`` over T new tokens in one launch.

    state: ``core.lln.LLNState`` (s (B,H,D,Dv), z (B,H,D), c_k (B,1,H,1),
    fp32).  q: (B,T,H,D); k/v: (B,T,G,D[v]).  alpha: scalar, (H,) or
    (B, H); beta: scalar, (G,), (B, G), or an (H,)/(B, H) repeat that is
    group-mean pooled to G.  Returns ``(out (B,T,H,Dv) in v.dtype, new
    LLNState)``.

    The serving contract (``core/lln.py:decode_chunk``): ``row_mask`` (B,)
    bool rows keep ``(s, z, c_k, log_scale)`` bitwise; ``commit_len`` (B,)
    in [0, T] scores every position but folds only the accepted prefix;
    ``renorm`` is the drift-renorm threshold, applied to the rows that
    folded at least one token.

    Kernel and plain kinds: one group-level max-rescale factor per query
    head (from its own old constant to the group's new one), applied to the
    carried state inside the decode kernel (or its plain version) over the
    chunk; no pass here touches s or z on a full commit.  Under
    ``commit_len`` the kernel still scores all T tokens and its (s1, z1)
    are discarded: the accepted prefix is refolded here from the carried
    (s, z), which the kernel leaves intact (it writes s1/z1 out of place),
    at the group constant advanced over the committed keys only.  ``ref``
    runs ``core/lln.py:decode_chunk`` on repeated KV.
    """
    b, t, h, d = q.shape
    g = k.shape[2]
    r = h // g
    kind = registry.resolve(backend, q.device)
    beta_b = _group_beta(beta, h, g, q.device)
    if kind == "ref":
        return core_lln.decode_chunk(state, q, _repeat_heads(k, h),
                                     _repeat_heads(v, h), alpha,
                                     _repeat_heads(beta_b, h, dim=-1),
                                     row_mask=row_mask,
                                     commit_len=commit_len, renorm=renorm)
    alpha_b = _bcast_heads(alpha, h, q.device)
    aq = q.float() * _row_head_bcast(alpha_b)
    bk = k.float() * _row_head_bcast(beta_b)
    c_q = torch.amax(aq, dim=(1, 3), keepdim=True)
    # Group-level new reference constant: the max of the group's carried
    # c_k and the chunk keys; each query head rescales from its own old one.
    c_old_g = torch.amax(state.c_k.reshape(b, 1, g, r, 1), dim=3)
    c_new_g = torch.maximum(c_old_g, torch.amax(bk, dim=(1, 3), keepdim=True))
    c_new_h = _repeat_heads(c_new_g, h)
    rescale = torch.exp(state.c_k - c_new_h)[:, 0, :, 0]          # (B, H)
    fn = lln_decode if kind == "kernel" else lln_decode_plain
    out_k, s1, z1 = fn(_to_kernel(aq - c_q), _to_kernel(bk - c_new_g),
                       _to_kernel(v), state.s.reshape(b * h, d, -1),
                       state.z.reshape(b * h, 1, d), r=r,
                       scale=rescale.reshape(b * h))
    if commit_len is not None:
        return _from_kernel(out_k, b), _fold_group(
            state, bk, v, core_lln.commit_lengths(commit_len, row_mask, t),
            row_mask, renorm)
    s_new, z_new = s1.reshape(b, h, d, -1), z1.reshape(b, h, d)
    log_scale = state.log_scale
    if renorm is not None and renorm > 0.0:
        s_new, z_new, c_new_h, log_scale = core_lln._renorm(
            s_new, z_new, c_new_h, log_scale,
            core_lln.folded_rows(row_mask), renorm)
    new = core_lln.LLNState(s=s_new, z=z_new, c_k=c_new_h,
                            log_scale=log_scale)
    return _from_kernel(out_k, b), core_lln.keep_rows(row_mask, new, state)


def _group_beta(beta, h: int, g: int, device) -> torch.Tensor:
    """beta at the G kv groups: scalar, (G,) and (B, G) pass through (a
    scalar broadcast to (G,)); an (H,)/(B, H) repeat is group-mean pooled."""
    beta_b = torch.as_tensor(beta, dtype=torch.float32, device=device)
    if beta_b.ndim and beta_b.shape[-1] == h and g != h:
        beta_b = beta_b.reshape(beta_b.shape[:-1] + (g, h // g)).mean(dim=-1)
    return _bcast_heads(beta_b, g, device)


def _fold_group(state, bk, v, cl, row_mask, renorm):
    """The kernel kinds' commit fold: each row's first ``cl`` keys (beta*k
    ``bk`` (B,T,G,D) fp32, values ``v`` (B,T,G,Dv)) folded into the carried
    (s, z) once per kv group, at the group constant advanced over the
    committed keys only, then the drift renorm and the row mask.  The
    state half of :func:`lln_decode_chunk` under ``commit_len`` and all of
    :func:`lln_commit_chunk`, so the two agree bit for bit."""
    b, t, g, _ = bk.shape
    h = state.s.shape[1]
    c_old_g = torch.amax(state.c_k.reshape(b, 1, g, h // g, 1), dim=3)
    cmask = torch.arange(t, device=bk.device)[None, :] < cl[:, None]
    bk_c = torch.where(cmask[:, :, None, None], bk, -torch.inf)
    c_com_g = torch.maximum(c_old_g,
                            torch.amax(bk_c, dim=(1, 3), keepdim=True))
    c_new_h = _repeat_heads(c_com_g, h)
    resc = torch.exp(state.c_k - c_new_h)[:, 0, :, 0]             # (B, H)
    fk_c = torch.exp(bk_c - c_com_g)                  # (B,T,G,D), 0 beyond
    add_s = _repeat_heads(torch.einsum("bjgd,bjgv->bgdv", fk_c, v.float()),
                          h, dim=1)
    add_z = _repeat_heads(fk_c.sum(1), h, dim=1)
    s_new = state.s * resc[..., None, None] + add_s
    z_new = state.z * resc[..., None] + add_z
    log_scale = state.log_scale
    if renorm is not None and renorm > 0.0:
        s_new, z_new, c_new_h, log_scale = core_lln._renorm(
            s_new, z_new, c_new_h, log_scale,
            core_lln.folded_rows(row_mask, cl), renorm)
    new = core_lln.LLNState(s=s_new, z=z_new, c_k=c_new_h,
                            log_scale=log_scale)
    return core_lln.keep_rows(row_mask, new, state)


def lln_commit_chunk(state, k, v, beta, backend: str = "auto",
                     row_mask=None, commit_len=None, renorm=None):
    """Fold a chunk's accepted prefix into an ``LLNState`` without scoring:
    the commit half of :func:`lln_decode_chunk`, the single-pass
    speculative verify's second step.  A ``commit_len=0`` verify scores
    the chunk and leaves the state as it was; this folds the accepted
    prefix from the chunk's (k, v), bit for bit the state
    :func:`lln_decode_chunk` gives with the final ``commit_len`` on the
    same backend (the kernel and plain kinds share :func:`_fold_group`,
    torch at the G kv groups; ``ref`` runs ``core/lln.py:commit_chunk``
    on repeated KV).  No kernel runs: the fold is O(T d^2).
    k/v: (B,T,G,D[v]); beta as in :func:`lln_decode_chunk`;
    ``commit_len`` None commits all T.  Returns the new ``LLNState``."""
    b, t, g, _ = k.shape
    h = state.s.shape[1]
    kind = registry.resolve(backend, k.device)
    beta_b = _group_beta(beta, h, g, k.device)
    if kind == "ref":
        return core_lln.commit_chunk(state, _repeat_heads(k, h),
                                     _repeat_heads(v, h),
                                     _repeat_heads(beta_b, h, dim=-1),
                                     row_mask=row_mask,
                                     commit_len=commit_len, renorm=renorm)
    bk = k.float() * _row_head_bcast(beta_b)
    cl = core_lln.commit_lengths(
        commit_len if commit_len is not None
        else core_lln.full_commit(t, k), row_mask, t)
    return _fold_group(state, bk, v, cl, row_mask, renorm)


# ---------------------------------------------------------------------------
# Log-linear (Fenwick multi-scale) LLN: full-sequence forward, the
# state-emitting prefill and the chunked decode.  Inference only: the
# reference has no backward kernel for it.
# ---------------------------------------------------------------------------

def _loglin_repeat(q, k, v, beta):
    """The ``ref`` kind's inputs: repeated KV and a per-head (H,) or
    (B, H) beta."""
    h, g = q.shape[2], k.shape[2]
    beta = torch.as_tensor(beta, dtype=torch.float32, device=q.device)
    if beta.ndim and beta.shape[-1] == g:
        beta = _repeat_heads(beta, h, dim=-1)
    return _repeat_heads(k, h), _repeat_heads(v, h), beta


def loglin_attention(q, k, v, alpha, beta, causal: bool = True,
                     chunk: int = 256, num_scales: int = 4,
                     scale_decay: float = 0.5, backend: str = "auto"):
    """Full-sequence log-linear LLN attention (causal only): each query
    mixes a causal intra-granule term with the Fenwick pyramid of its
    prefix, the granule of key j at level l weighing ``scale_decay**l``
    (``core/loglinear.py``).  q: (B,N,H,D); k/v: (B,N,G,D[v]); any N.
    ``kernel``/``plain`` run :func:`loglin_causal` (or its plain version),
    ``ref`` the quadratic oracle on repeated KV."""
    if not causal:
        raise ValueError("log_linear attention is causal-only")
    b, n, h, _ = q.shape
    kind = registry.resolve(backend, q.device)
    if kind == "ref":
        kf, vf, beta_h = _loglin_repeat(q, k, v, beta)
        return core_loglin.loglin_attention_ref(
            q, kf, vf, alpha, beta_h, granule=chunk, num_scales=num_scales,
            scale_decay=scale_decay)
    qs, ks, _ = _scaled_stabilized(q, k, alpha, beta)
    fn = loglin_causal if kind == "kernel" else loglin_causal_plain
    out = fn(qs, ks, _to_kernel(v), r=h // k.shape[2], blk=chunk,
             num_scales=num_scales, scale_decay=scale_decay)
    return _from_kernel(out, b)


def loglin_prefill(q, k, v, alpha, beta, chunk: int = 256,
                   num_scales: int = 4, scale_decay: float = 0.5,
                   backend: str = "auto"):
    """Causal log-linear prefill emitting the outputs and the multi-scale
    decode state in one pass.

    Returns ``(out, s, z, c_k, sl, zl, cl)`` in the ``LogLinState``
    layout: the open bucket ``s`` (B,H,D,Dv), ``z`` (B,H,D), ``c_k``
    (B,1,H,1) (the keys after the last closed granule; empty for N %
    chunk == 0) and the pyramid ``sl`` (B,L,H,D,Dv), ``zl`` (B,L,H,D),
    ``cl`` (B,L,H), fp32.  On the kernel and plain kinds every bucket
    shares the group's key constant, so ``cl`` is ``c_k`` broadcast; the
    ``ref`` kind (``core/loglinear.py:prefill`` on repeated KV) takes one
    constant per query head.  Outputs and decode do not depend on that
    choice; the raw states do.
    """
    b, n, h, d = q.shape
    g, dv = k.shape[2], v.shape[-1]
    ls = num_scales
    kind = registry.resolve(backend, q.device)
    if kind == "ref":
        kf, vf, beta_h = _loglin_repeat(q, k, v, beta)
        out, st = core_loglin.prefill(q, kf, vf, alpha, beta_h,
                                      granule=chunk, num_scales=ls,
                                      scale_decay=scale_decay)
        return out, st.s, st.z, st.c_k, st.sl, st.zl, st.cl
    qs, ks, c_k = _scaled_stabilized(q, k, alpha, beta)
    fn = loglin_causal if kind == "kernel" else loglin_causal_plain
    out_k, sl, zl, s, z = fn(qs, ks, _to_kernel(v), r=h // g, blk=chunk,
                             num_scales=ls, scale_decay=scale_decay,
                             return_state=True)
    c_kh = _repeat_heads(c_k, h)
    return (_from_kernel(out_k, b), s.reshape(b, h, d, dv),
            z.reshape(b, h, d), c_kh,
            sl.reshape(b, h, ls, d, dv).transpose(1, 2),
            zl.reshape(b, h, ls, d).transpose(1, 2),
            c_kh[:, 0, :, 0][:, None, :].expand(b, ls, h).contiguous())


def _decode_chained(qs, ks, vk, s0, z0, r: int, kind: str):
    """:func:`lln_decode` (or its plain version) over T tokens in launches
    of at most ``MAX_DECODE_T``, each carrying the last one's ``(s1,
    z1)``; exact, since each launch's keys enter the next one's state."""
    fn = lln_decode if kind == "kernel" else lln_decode_plain
    outs = []
    for i0 in range(0, qs.shape[1], MAX_DECODE_T):
        cut = slice(i0, i0 + MAX_DECODE_T)
        o, s0, z0 = fn(qs[:, cut].contiguous(), ks[:, cut].contiguous(),
                       vk[:, cut].contiguous(), s0, z0, r=r, scale=None)
        outs.append(o)
    return torch.cat(outs, 1)


def loglin_decode_chunk(state, q, k, v, alpha, beta, *, pos, granule: int,
                        num_scales: int, scale_decay: float,
                        backend: str = "auto", row_mask=None,
                        commit_len=None, renorm=None):
    """Advance a ``core.loglinear.LogLinState`` over T new tokens.

    q: (B,T,H,D); k/v: (B,T,G,D[v]); ``pos`` (B,) int32: the tokens each
    row has folded, which fixes its bucket layout.  alpha: scalar, (H,) or
    (B, H); beta: scalar, (G,), (B, G), or an (H,)/(B, H) repeat that is
    group-mean pooled to G.  Returns ``(out (B,T,H,Dv) in v.dtype, new
    LogLinState)``.  The serving contract of :func:`lln_decode_chunk`
    (``row_mask``, ``commit_len``, ``renorm`` per bucket) holds on every
    kind: the committed fold is the core ``_advance``.

    ``ref`` runs ``core/loglinear.py:decode_chunk`` on repeated KV.
    ``kernel``/``plain``: the new state is the core ``_advance`` at H heads
    (bitwise the core path's); the outputs come from two passes of
    :func:`lln_decode` (or its plain version) at one group-level reference:
    pass A masks the keys at or past each row's granule boundary to
    ``-1e30`` (Phi(k) = 0) and carries pyramid(n) + the open bucket as its
    ``s0``, pass B masks the keys before the boundary and carries the
    cascaded pyramid(n+1); each position takes the pass of its side.
    Each pass runs in launches of at most ``MAX_DECODE_T`` tokens.  T >
    granule runs in granule-sized sub-chunks (full commit only).
    """
    b, t, h, d = q.shape
    g = k.shape[2]
    r = h // g
    kind = registry.resolve(backend, q.device)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    beta_b = _group_beta(beta, h, g, q.device)
    beta_h = _repeat_heads(beta_b, h, dim=-1)
    kf, vf = _repeat_heads(k, h), _repeat_heads(v, h)
    if kind == "ref":
        return core_loglin.decode_chunk(
            state, q, kf, vf, alpha, beta_h, pos=pos, granule=granule,
            num_scales=num_scales, scale_decay=scale_decay,
            row_mask=row_mask, commit_len=commit_len, renorm=renorm)
    if t > granule:
        if commit_len is not None:
            raise ValueError(
                "log_linear decode_chunk supports commit_len only for "
                f"T <= granule (T={t}, granule={granule})")
        outs = []
        done = torch.zeros_like(pos)
        for i0 in range(0, t, granule):
            cut = slice(i0, min(i0 + granule, t))
            o, state = loglin_decode_chunk(
                state, q[:, cut], k[:, cut], v[:, cut], alpha, beta_b,
                pos=pos + done, granule=granule, num_scales=num_scales,
                scale_decay=scale_decay, backend=backend, row_mask=row_mask,
                renorm=renorm)
            step = cut.stop - cut.start
            done = done + (step * row_mask.to(torch.int32)
                           if row_mask is not None else step)
            outs.append(o)
        return torch.cat(outs, 1), state
    bk_h = kf.float() * _row_head_bcast(beta_h)
    new_state, aux = core_loglin._advance(
        state, bk_h, vf.float(), pos=pos, granule=granule,
        num_scales=num_scales, t=t, row_mask=row_mask,
        commit_len=commit_len, renorm=renorm)
    split = aux[0]
    # One group-level reference covering every bucket and chunk key (the
    # normalized form does not depend on it; pooling changes rounding).
    c_h = core_loglin.state_reference(state, aux, bk_h)
    c_g = torch.amax(c_h.reshape(b, 1, g, r, 1), dim=3)          # (B,1,G,1)
    w = core_loglin.level_weights(num_scales, scale_decay, q.device)
    (s_a, z_a), (s_b, z_b) = core_loglin.inter_views(
        state, aux, w, _repeat_heads(c_g, h))
    alpha_b = _bcast_heads(alpha, h, q.device)
    aq = q.float() * _row_head_bcast(alpha_b)
    qs = _to_kernel(aq - torch.amax(aq, dim=(1, 3), keepdim=True))
    ks = k.float() * _row_head_bcast(beta_b) - c_g               # (B,T,G,D)
    pre_key = (torch.arange(t, device=q.device)[None, :]
               < split[:, None])[:, :, None, None]               # (B,T,1,1)
    vk = _to_kernel(v)
    dv = v.shape[-1]
    out_a = _decode_chained(
        qs, _to_kernel(torch.where(pre_key, ks, NEG_INF)), vk,
        s_a.reshape(b * h, d, dv).contiguous(),
        z_a.reshape(b * h, 1, d).contiguous(), r, kind)
    out_b = _decode_chained(
        qs, _to_kernel(torch.where(pre_key, NEG_INF, ks)), vk,
        s_b.reshape(b * h, d, dv).contiguous(),
        z_b.reshape(b * h, 1, d).contiguous(), r, kind)
    out = torch.where(pre_key, _from_kernel(out_a, b), _from_kernel(out_b, b))
    return out, new_state


def loglin_commit_chunk(state, k, v, beta, *, pos, granule: int,
                        num_scales: int, backend: str = "auto",
                        row_mask=None, commit_len=None, renorm=None):
    """Fold a scored chunk's accepted prefix into a ``LogLinState`` without
    scoring: the commit half of :func:`loglin_decode_chunk`.  Every kind
    runs the core ``_advance`` at H heads on the (k, v) of the chunk, as
    :func:`loglin_decode_chunk` does for its state (``ref`` through
    ``core/loglinear.py:commit_chunk``), so the commit equals that decode
    with the final ``commit_len`` bit for bit.  No kernel runs.
    k/v: (B,T,G,D[v]), T <= granule; beta as in :func:`lln_decode_chunk`."""
    t, g = k.shape[1], k.shape[2]
    h = state.s.shape[1]
    kind = registry.resolve(backend, k.device)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k.device)
    beta_h = _repeat_heads(_group_beta(beta, h, g, k.device), h, dim=-1)
    kf, vf = _repeat_heads(k, h), _repeat_heads(v, h)
    if kind == "ref":
        return core_loglin.commit_chunk(
            state, kf, vf, beta_h, pos=pos, granule=granule,
            num_scales=num_scales, row_mask=row_mask,
            commit_len=commit_len, renorm=renorm)
    if t > granule:
        raise ValueError(f"log_linear commit_chunk requires T <= granule "
                         f"(T={t}, granule={granule})")
    new_state, _ = core_loglin._advance(
        state, kf.float() * _row_head_bcast(beta_h), vf.float(), pos=pos,
        granule=granule, num_scales=num_scales, t=t, row_mask=row_mask,
        commit_len=commit_len, renorm=renorm)
    return new_state


# ---------------------------------------------------------------------------
# Mamba2 SSD chunked scan (training).
# ---------------------------------------------------------------------------

def _ssd_ref(xbar, b_in, c_in, log_a, chunk):
    """The core scan ``models/ssm.py:ssd_chunked`` on B/C repeated over the
    r heads of each group; y in xbar.dtype."""
    from repro_torch.models.ssm import ssd_chunked
    h = xbar.shape[2]
    y, _ = ssd_chunked(xbar, _repeat_heads(b_in, h), _repeat_heads(c_in, h),
                       log_a, chunk=chunk)
    return y.to(xbar.dtype)


class _SSDScan(torch.autograd.Function):
    """Forward: :func:`ssd` (or its plain version) on the kernel layout,
    group row ``bh // r`` with ``r = H // G``.  Backward: autograd of the
    core scan :func:`_ssd_ref`, recomputed from the saved inputs, as the
    reference's ``jax.vjp`` of ``_ssd_ref`` (it has no backward kernel)."""

    @staticmethod
    def forward(ctx, xbar, b_in, c_in, log_a, chunk, kind):
        b, l, h, _ = xbar.shape
        fn = ssd if kind == "kernel" else ssd_plain
        out = fn(log_a.transpose(1, 2).reshape(b * h, l).contiguous(),
                 _to_kernel(xbar), _to_kernel(b_in), _to_kernel(c_in),
                 r=h // b_in.shape[2], blk=chunk)
        ctx.save_for_backward(xbar, b_in, c_in, log_a)
        ctx.chunk = chunk
        return _from_kernel(out, b)

    @staticmethod
    def backward(ctx, g_out):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = _ssd_ref(*inputs, ctx.chunk)
        grads = torch.autograd.grad(y.float(), inputs, g_out.float())
        return (*grads, None, None)


def ssd_scan(xbar, b_in, c_in, log_a, chunk: int = 256,
             backend: str = "auto"):
    """Mamba2 SSD scan, the training entry point.  xbar: (B,L,H,P) fp32;
    b_in/c_in: (B,L,G,S) with G | H (no repeat); log_a: (B,L,H).  Returns
    y (B,L,H,P) in xbar.dtype (no final state: the prefill runs the core
    ``ssd_chunked``, which returns it).  ``backend`` as
    ``kernels/registry.py``: ``kernel`` (or ``auto`` on a CUDA tensor) runs
    the CUDA kernel forward, ``plain`` its plain version, both inside one
    autograd Function whose backward differentiates the core scan; ``ref``
    autograd through the core scan.  As in the reference, an L that is not
    a multiple of ``chunk`` runs the core scan."""
    kind = registry.resolve(backend, xbar.device)
    if kind == "ref" or xbar.shape[1] % chunk:
        return _ssd_ref(xbar, b_in, c_in, log_a, chunk)
    return _SSDScan.apply(xbar, b_in, c_in, log_a, chunk, kind)
