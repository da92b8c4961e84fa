"""fp32-accumulating einsum (port of ``repro.core.numerics.einsum_f32``).

The reference keeps bf16 operands with fp32 accumulation on the TPU and
upcasts them where it executes on the CPU; the port upcasts everywhere:
the operands go to fp32, then ``torch.einsum``.
"""
from __future__ import annotations

import torch


def einsum_f32(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` on fp32 copies of the operands."""
    return torch.einsum(subscripts, *(o.float() for o in operands))
