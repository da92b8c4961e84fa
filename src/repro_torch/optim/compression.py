"""Gradient compression for a slow cross-node reduction (port of
``repro.optim.compression``).  Nothing on the training path calls it, as in
the reference.

* ``bf16_allreduce_cast`` - cast gradients to bf16 before the all-reduce
  (half the bytes on the slowest link).
* int8 error-feedback compression (residual carrying, as in 1-bit Adam):
  q_t = Q(g_t + e_t);  e_{t+1} = (g_t + e_t) - DQ(q_t).  The residual makes
  the quantization error telescope instead of accumulate.

Trees are dicts of tensors (nested, or an ``nn.Module``'s parameters by
name).  The int8 codes round half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves_with_path, map_with_path, tree_map


def bf16_allreduce_cast(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize_int8(x: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(grads, residual):
    """Returns (a tree of (int8 codes, scale) pairs, the new residual)."""
    res = dict(leaves_with_path(residual))
    xq = {}

    def one(path, g):
        x = g.to(torch.float32) + res[path]
        xq[path] = (x, _quantize_int8(x))
        return xq[path][1]
    qs = map_with_path(one, grads)
    new_e = map_with_path(
        lambda p, _: xq[p][0] - _dequantize_int8(*xq[p][1]), grads)
    return qs, new_e


def ef_decompress(qs):
    """The tree of fp32 gradients from ``ef_compress``'s codes."""
    if isinstance(qs, tuple) and len(qs) == 2 and all(
            torch.is_tensor(t) for t in qs):
        return _dequantize_int8(*qs)
    if isinstance(qs, dict):
        return {k: ef_decompress(v) for k, v in qs.items()}
    if isinstance(qs, list):
        return [ef_decompress(v) for v in qs]
    return qs
