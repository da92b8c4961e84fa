"""Shared model building blocks (port of ``repro.models.layers``).

Weights keep the reference's (d_in, d_out) layout and are applied as
``x @ w``, so converting a JAX pytree is a copy.  Parameters are stored in
``cfg.param_dtype`` and cast to ``cfg.compute_dtype`` at use.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def trunc_normal(shape, std: float, dtype, device, generator) -> torch.Tensor:
    """Normal(0, std) truncated to [-2 std, 2 std], drawn in fp32."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def dense(w: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) @ w.to(dtype)


class Norm(nn.Module):
    """RMSNorm / LayerNorm parameters (``scale``, plus ``bias`` for
    layernorm)."""

    def __init__(self, d: int, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)
        if kind != "rmsnorm":
            self.bias = nn.Parameter(
                torch.zeros(d, dtype=dtype, device=device),
                requires_grad=False)


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
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
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
                                     dtype, device, generator),
                        requires_grad=False)


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
    x = table[tokens].to(dtype)
    if scale:
        x = x * torch.tensor(math.sqrt(table.shape[1]), dtype=dtype)
    return x


def logits_from_hidden(lm_head: torch.Tensor, h: torch.Tensor, dtype,
                       softcap: float = 0.0) -> torch.Tensor:
    logits = (h.to(dtype) @ lm_head.to(dtype)).float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
