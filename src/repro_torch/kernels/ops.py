"""Ops around the kernels (port of ``repro.kernels.ops``): the training
entries ``lln_attention`` / ``lln_diag_attention`` (causal and
bidirectional) and ``block_diag_attention``, and the serving entries
``lln_prefill`` / ``block_diag_fwd`` / ``lln_decode_chunk``.

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
from . import registry
from .block_diag import (block_diag, block_diag_bwd, block_diag_bwd_plain,
                         block_diag_plain)
from .lln_attention import (lln_bidir, lln_bidir_plain, lln_causal,
                            lln_causal_plain, lln_decode, lln_decode_plain,
                            lln_diag_fused, lln_diag_fused_plain)
from .lln_backward import (lln_bidir_bwd, lln_bidir_bwd_plain, lln_causal_bwd,
                           lln_causal_bwd_plain, lln_diag_fused_bwd,
                           lln_diag_fused_bwd_plain)


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
    decode state's reference constant."""
    alpha = _bcast_heads(alpha, q.shape[2], q.device)
    beta = _bcast_heads(beta, k.shape[2], k.device)
    aq = q.float() * _row_head_bcast(alpha)
    bk = k.float() * _row_head_bcast(beta)
    c_q = torch.amax(aq, dim=(1, 3), keepdim=True)
    c_k = torch.amax(bk, dim=(1, 3), keepdim=True)
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


def lln_decode_chunk(state, q, k, v, alpha, beta, backend: str = "auto"):
    """Advance an ``LLNState`` over T new tokens in one launch.

    state: ``core.lln.LLNState`` (s (B,H,D,Dv), z (B,H,D), c_k (B,1,H,1),
    fp32).  q: (B,T,H,D); k/v: (B,T,G,D[v]).  alpha: scalar, (H,) or
    (B, H); beta: scalar, (G,), (B, G), or an (H,)/(B, H) repeat that is
    group-mean pooled to G.  Returns ``(out (B,T,H,Dv) in v.dtype, new
    LLNState)``.

    Kernel and plain kinds: one group-level max-rescale of the carried state
    (each query head from its own old constant to the group's new one), then
    the decode kernel (or its plain version) over the chunk.  ``ref`` runs
    ``core/lln.py:decode_chunk`` on repeated KV.
    """
    b, t, h, d = q.shape
    g = k.shape[2]
    r = h // g
    kind = registry.resolve(backend, q.device)
    beta_b = torch.as_tensor(beta, dtype=torch.float32, device=q.device)
    if beta_b.ndim and beta_b.shape[-1] == h and g != h:
        beta_b = beta_b.reshape(beta_b.shape[:-1] + (g, r)).mean(dim=-1)
    beta_b = _bcast_heads(beta_b, g, q.device)
    if kind == "ref":
        return core_lln.decode_chunk(state, q, _repeat_heads(k, h),
                                     _repeat_heads(v, h), alpha,
                                     _repeat_heads(beta_b, h, dim=-1))
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
    s0 = (state.s * rescale[..., None, None]).reshape(b * h, d, -1)
    z0 = (state.z * rescale[..., None]).reshape(b * h, 1, d)
    fn = lln_decode if kind == "kernel" else lln_decode_plain
    out_k, s1, z1 = fn(_to_kernel(aq - c_q), _to_kernel(bk - c_new_g),
                       _to_kernel(v), s0, z0, r=r)
    new = core_lln.LLNState(s=s1.reshape(b, h, d, -1), z=z1.reshape(b, h, d),
                            c_k=c_new_h, log_scale=state.log_scale)
    return _from_kernel(out_k, b), new
