"""Carry the reference's weights and decode state across as numpy arrays.

The reference's parameter pytree (``repro.models.transformer.lm_init``)
stacks the per-layer subtrees along a leading layer axis under
``"layers"``.  :func:`params_from_numpy` takes that tree with numpy leaves
(the caller maps ``np.asarray`` over it, so this module never sees JAX),
splits the layer axis into per-layer modules and copies every array.  The
weight layout stays (d_in, d_out): the port computes ``x @ w``.  bf16
leaves travel through fp32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import LLN_FIELDS, AttentionState
from repro_torch.models.transformer import DenseLM


def _tensor(a, dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind not in "iub":          # float32, float64, bfloat16
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device=device,
                                                           dtype=dtype)


def _copy(param: torch.Tensor, a) -> None:
    arr = _tensor(a, param.dtype, param.device)
    if arr.shape != param.shape:
        raise ValueError(f"shape mismatch: {tuple(arr.shape)} vs "
                         f"{tuple(param.shape)}")
    param.data.copy_(arr)


def _copy_module(mod: torch.nn.Module, tree: dict, layer=None) -> None:
    """Copy ``tree``'s leaves (at ``layer`` along the stacked axis) into the
    module's parameters of the same names."""
    names = dict(mod.named_parameters(recurse=False))
    if set(names) != set(tree):
        raise ValueError(f"parameter names differ: {sorted(names)} vs "
                         f"{sorted(tree)}")
    for name, a in tree.items():
        _copy(names[name], a if layer is None else np.asarray(a)[layer])


def params_from_numpy(tree: dict, cfg: ArchConfig, device) -> DenseLM:
    """A :class:`DenseLM` on ``device`` holding the reference's weights."""
    gen = torch.Generator(device=device)
    model = DenseLM(cfg, device, gen)         # shapes and names; overwritten
    _copy(model.embed_table, tree["embed"]["table"])
    _copy_module(model.final_norm, tree["final_norm"])
    if "lm_head" in tree:
        _copy(model.lm_head, tree["lm_head"])
    layers = tree["layers"]
    for i, block in enumerate(model.layers):
        for name in ("ln1", "ln2", "attn", "mlp"):
            _copy_module(getattr(block, name), layers[name], layer=i)
    return model


def state_from_numpy(tree, device) -> AttentionState:
    """One layer's :class:`AttentionState` from the reference's state
    (anything indexable by field name: the reference's ``AttentionState``
    with numpy leaves, or a dict)."""
    out = {}
    for name in LLN_FIELDS:
        arr = np.asarray(tree[name])
        dtype = torch.int32 if arr.dtype.kind in "iu" else (
            torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32)
        out[name] = _tensor(arr, dtype, device)
    return AttentionState(**out)
