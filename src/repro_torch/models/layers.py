"""Shared model building blocks (port of ``repro.models.layers``).

Weights keep the reference's (d_in, d_out) layout and are applied as
``x @ w``, so converting a JAX pytree is a copy.  Parameters are stored in
``cfg.param_dtype`` (trainable; serving runs under ``torch.inference_mode``)
and cast to ``cfg.compute_dtype`` at use.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (constrain, is_dtensor,
                                              matmul, redistributed,
                                              replicated_like)


def trunc_normal(shape, std: float, dtype, device, generator) -> torch.Tensor:
    """Normal(0, std) truncated to [-2 std, 2 std], drawn in fp32.  Under
    ``FakeTensorMode`` (an abstract init: ``launch/dryrun.py``) nothing is
    drawn."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if isinstance(t, FakeTensor):
        return t.to(dtype)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def dense(w: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    return matmul(x.to(dtype), w.to(dtype))


class Norm(nn.Module):
    """RMSNorm / LayerNorm parameters (``scale``, plus ``bias`` for
    layernorm)."""

    def __init__(self, d: int, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        if kind != "rmsnorm":
            self.bias = nn.Parameter(
                torch.zeros(d, dtype=dtype, device=device))


def apply_norm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize in fp32 and cast back to ``x.dtype``."""
    xf = x.float()
    if p.kind == "rmsnorm":
        inv = torch.rsqrt(torch.mean(torch.square(xf), -1, keepdim=True) + eps)
        return (xf * inv * p.scale.float()).to(x.dtype)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p.scale.float() + p.bias.float()).to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS-normalize the last (head_dim) axis in fp32 (qwen3), cast
    back to ``x.dtype``."""
    xf = x.float()
    inv = torch.rsqrt(torch.mean(torch.square(xf), -1, keepdim=True) + eps)
    return (xf * inv * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         rotary_pct: float = 1.0) -> torch.Tensor:
    """x: (B, N, H, D); positions: (N,) or (B, N).  Rotates the first
    ``rotary_pct`` of D as two halves: x1 = x[..., :rd/2] and
    x2 = x[..., rd/2:rd] (the reference's code, half-split)."""
    d = x.shape[-1]
    rd = int(d * rotary_pct)
    rd -= rd % 2
    if rd == 0:
        return x
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    half = rd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * freqs[None, None, :]
    cos = replicated_like(x, torch.cos(ang)[:, :, None, :])
    sin = replicated_like(x, torch.sin(ang)[:, :, None, :])
    x1, x2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([rotated.to(x.dtype), x_pass], -1)


class MLP(nn.Module):
    """Gated (``*_glu``: wi_gate, wi_up, wo) or plain (wi, wo) MLP."""

    def __init__(self, d_model, d_ff, act, dtype, device, generator):
        super().__init__()
        self.act = act
        names = ("wi_gate", "wi_up") if act.endswith("_glu") else ("wi",)
        for name in names:
            self.register_parameter(name, _dense_param(
                d_model, d_ff, dtype, device, generator))
        self.wo = _dense_param(d_ff, d_model, dtype, device, generator)


def _dense_param(d_in, d_out, dtype, device, generator) -> nn.Parameter:
    return nn.Parameter(trunc_normal((d_in, d_out), 1.0 / math.sqrt(d_in),
                                     dtype, device, generator))


def _gelu(x):
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def apply_mlp(p: MLP, x: torch.Tensor, dtype) -> torch.Tensor:
    if p.act.endswith("_glu"):
        g = dense(p.wi_gate, x, dtype)
        u = dense(p.wi_up, x, dtype)
        g = F.silu(g) if p.act.startswith("silu") else _gelu(g)
        return dense(p.wo, g * u, dtype)
    return dense(p.wo, _gelu(dense(p.wi, x, dtype)), dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype,
                 scale: bool = False) -> torch.Tensor:
    x = _embed_mesh(table, tokens) if is_dtensor(table) else table[tokens]
    x = x.to(dtype)
    if scale:
        x = x * torch.tensor(math.sqrt(table.shape[1]), dtype=dtype)
    return x


def _embed_mesh(table, tokens):
    """``table[tokens]`` on a mesh, under ``local_map`` (Megatron's
    vocab-parallel embedding): where the table's rows (the vocab) are split
    over a mesh dim, every rank of it looks up all the rows' tokens in its
    slice and the output is a partial sum over that dim; the table is
    gathered over its other dims and the tokens keep their placement
    there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    t_in, k_in, out, t_grad, vocab_dims = [], [], [], [], []
    for i, (pt, pk) in enumerate(zip(table.placements, tokens.placements)):
        if pt == Shard(0):
            vocab_dims.append(i)
            t_in.append(Shard(0))
            k_in.append(Replicate())
            out.append(Partial())
            t_grad.append(Shard(0))
        else:
            t_in.append(Replicate())
            k_in.append(pk)
            out.append(pk)
            t_grad.append(Partial() if pk.is_shard() else Replicate())

    def lookup(tab, tok):
        v_loc = tab.shape[0]
        v0 = sum(mesh.get_local_rank(i) * v_loc for i in vocab_dims)
        if not vocab_dims:
            return tab[tok]
        local = tok - v0
        own = (local >= 0) & (local < v_loc)
        rows = tab[torch.clamp(local, 0, v_loc - 1)]
        return torch.where(own[..., None], rows, torch.zeros_like(rows))

    if len(vocab_dims) > 1:
        raise NotImplementedError("a table split over several mesh dims")
    table = redistributed(table, t_in)
    return local_map(lookup, out_placements=(tuple(out),),
                     in_placements=(tuple(t_in), tuple(k_in)),
                     in_grad_placements=(tuple(t_grad), tuple(k_in)),
                     device_mesh=mesh, redistribute_inputs=True)(
        table, tokens)


def logits_from_hidden(lm_head: torch.Tensor, h: torch.Tensor, dtype,
                       softcap: float = 0.0) -> torch.Tensor:
    logits = matmul(h.to(dtype), lm_head.to(dtype)).float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def chunked_xent(h: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, *, vocab: int, chunk: int = 1024,
                 dtype=torch.bfloat16, softcap: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over valid positions, computed in sequence chunks.

    h: (B, N, D); lm_head: (D, Vpad); labels/mask: (B, N).  Only one
    chunk's (B, C, Vpad) fp32 logits are live at a time: each chunk runs
    under ``torch.utils.checkpoint``, so the backward recomputes them.
    Pad-vocab columns are excluded by masking their logits to -1e30.
    On a mesh (DTensor ``h``) the logits stay split over the vocab
    (:func:`_xent_mesh`) and the mean is over the global token count.
    """
    if is_dtensor(h):
        return _xent_mesh(h, lm_head, labels, mask, vocab=vocab, chunk=chunk,
                          dtype=dtype, softcap=softcap)
    b, n, _ = h.shape
    c = min(chunk, n)
    pad = (-n) % c
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    vocab_ok = torch.arange(lm_head.shape[1], device=h.device) < vocab
    mask = mask.float()

    def nll_sum(hh, ll, mm):
        logits = logits_from_hidden(lm_head, hh, dtype, softcap)
        logits = torch.where(vocab_ok, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ll[..., None])[..., 0]
        return torch.sum((lse - gold) * mm)

    loss_sum = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for c0 in range(0, h.shape[1], c):
        sl = slice(c0, c0 + c)
        loss_sum = loss_sum + checkpoint(nll_sum, h[:, sl], labels[:, sl],
                                         mask[:, sl], use_reentrant=False)
        cnt = cnt + torch.sum(mask[:, sl])
    return loss_sum / torch.clamp(cnt, min=1.0)


def _xent_mesh(h, lm_head, labels, mask, *, vocab: int, chunk: int, dtype,
               softcap: float):
    """:func:`chunked_xent` on DTensors: rows over the batch's mesh axes
    and, per chunk, logits split over 'model' by the vocab (the
    reference's ``constrain(logits, "act_batch", None, "vocab")``) under
    ``local_map``: the log-sum-exp and the gold logit are summed over
    'model', each rank's (nll sum, token count) is a partial sum over the
    batch's axes, and the loss is their global ratio."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed import local_attention as la
    mesh = h.device_mesh
    names = mesh.mesh_dim_names
    h = constrain(h, "act_batch", None, None)
    labels = constrain(labels, "act_batch", None)
    mask = constrain(mask, "act_batch", None)
    batch = [n for n, p in zip(names, h.placements) if p == Shard(0)]
    # The vocab splits over 'model' unless the rows already do (the
    # ``replicate`` rules fold 'model' into the batch).
    vocab_split = "model" in names and "model" not in batch and \
        lm_head.shape[1] % mesh.shape[names.index("model")] == 0
    rank = mesh.get_local_rank(names.index("model")) if vocab_split else 0
    model_groups = [mesh.get_group("model")] if vocab_split else []

    def pl(row_dim=None, vocab_dim=None, partial_rows=False,
           partial_model=False):
        out = []
        for name in names:
            if name in batch and (partial_rows or row_dim is not None):
                out.append(Partial() if partial_rows else Shard(row_dim))
            elif name == "model" and vocab_split and vocab_dim is not None:
                out.append(Shard(vocab_dim))
            elif name == "model" and partial_model:
                out.append(Partial())
            else:
                out.append(Replicate())
        return tuple(out)

    def nll_sum(hh, head, ll, mm):
        v_loc = head.shape[1]
        v0 = rank * v_loc
        logits = logits_from_hidden(head, hh, dtype, softcap)
        cols = v0 + torch.arange(v_loc, device=hh.device)
        logits = torch.where(cols < vocab, logits, -1e30)
        mx = torch.amax(logits, dim=-1).detach()
        for g in model_groups:
            torch.distributed.all_reduce(mx, torch.distributed.ReduceOp.MAX,
                                         group=g)
        se = la.sum_over(torch.sum(torch.exp(logits - mx[..., None]), -1),
                         model_groups, replicated=True)
        lse = torch.log(se) + mx
        own = (ll >= v0) & (ll < v0 + v_loc)
        idx = torch.clamp(ll - v0, 0, v_loc - 1)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = la.sum_over(torch.where(own, gold, 0.0), model_groups,
                           replicated=True)
        mm = mm.float()
        return torch.sum((lse - gold) * mm), torch.sum(mm)

    rows = pl(row_dim=0)
    part = pl(partial_rows=True)
    fn = local_map(
        nll_sum, out_placements=(part, part),
        in_placements=(rows, pl(vocab_dim=1), rows, rows),
        in_grad_placements=(pl(row_dim=0, partial_model=vocab_split),
                            pl(vocab_dim=1, partial_rows=True), rows, rows),
        device_mesh=mesh, redistribute_inputs=True)
    n = h.shape[1]
    c = min(chunk, n)
    loss_sum = cnt = None
    for c0 in range(0, n, c):
        sl = slice(c0, c0 + c)
        ls, ct = checkpoint(fn, h[:, sl], lm_head, labels[:, sl],
                            mask[:, sl], use_reentrant=False)
        loss_sum = ls if loss_sum is None else loss_sum + ls
        cnt = ct if cnt is None else cnt + ct
    loss_sum = loss_sum.redistribute(mesh, (Replicate(),) * mesh.ndim)
    cnt = cnt.redistribute(mesh, (Replicate(),) * mesh.ndim)
    return loss_sum / torch.clamp(cnt, min=1.0)
