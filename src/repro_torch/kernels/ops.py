"""Serving ops around the kernels (port of the serving half of
``repro.kernels.ops``).

Responsibilities:
* layout: (B, N, H, D) model convention <-> (B*H, N, D) kernel convention,
  heads ordered ``bh = b*H + h`` so kv row ``bh // r`` is right for
  ``H = G*r``;
* LLN pre-scaling and stabilization: qs = alpha*q - c_q, ks = beta*k - c_k
  in fp32, with per-(batch, head) constants that cancel exactly;
* backend dispatch (``kernels/registry.py:resolve``): the CUDA kernel, its
  plain version, or the core reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import diag as core_diag
from repro_torch.core import lln as core_lln
from . import registry
from .block_diag import block_diag, block_diag_plain
from .lln_attention import (lln_causal, lln_causal_plain, lln_decode,
                            lln_decode_plain)


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


def _repeat_heads(t: torch.Tensor, h: int, dim: int = 2) -> torch.Tensor:
    g = t.shape[dim]
    return t if g == h else torch.repeat_interleave(t, h // g, dim=dim)


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
    out_k, s, z = fn(qs, ks, vk, r=h // g, blk=chunk)
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
        return core_diag.block_diag_attn(q, _repeat_heads(k, h),
                                         _repeat_heads(v, h), block=block,
                                         causal=causal)
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
