"""Carry the reference's weights, train state and decode state across as
numpy arrays.

The reference's parameter pytrees (``repro.models.transformer.lm_init``
and ``repro.models.encoder.encoder_init``) stack the per-layer subtrees
along a leading layer axis under ``"layers"``.  :func:`leaves_from_numpy`
names their leaves as the port's parameters (``layers.3.attn.q_w``),
splitting the layer axis; the caller maps ``np.asarray`` over the tree, so
this module never sees JAX.  :func:`params_from_numpy` copies them into a
:class:`DenseLM` or, for the encoder family, an :class:`Encoder`,
:func:`train_state_from_numpy` also the AdamW moments and step.  The weight
layout stays (d_in, d_out): the port computes ``x @ w``.  bf16 leaves
travel through fp32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import LLN_FIELDS, AttentionState
from repro_torch.models.encoder import Encoder
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


def leaves_from_numpy(tree: dict, cfg: ArchConfig) -> dict:
    """``{port parameter name: numpy array}`` from a reference-shaped tree
    (the params, or one AdamW moment tree)."""
    out = {"embed_table": np.asarray(tree["embed"]["table"])}
    for k, a in tree["final_norm"].items():
        out[f"final_norm.{k}"] = np.asarray(a)
    if "lm_head" in tree:
        out["lm_head"] = np.asarray(tree["lm_head"])
    for i in range(cfg.n_layers):
        for sub in ("ln1", "ln2", "attn", "mlp"):
            for k, a in tree["layers"][sub].items():
                out[f"layers.{i}.{sub}.{k}"] = np.asarray(a)[i]
    return out


def params_from_numpy(tree: dict, cfg: ArchConfig, device) -> DenseLM:
    """A :class:`DenseLM` (an :class:`Encoder` for the encoder family) on
    ``device`` holding the reference's weights."""
    gen = torch.Generator(device=device)
    cls = Encoder if cfg.family == "encoder" else DenseLM
    model = cls(cfg, device, gen)             # shapes and names; overwritten
    named = dict(model.named_parameters())
    leaves = leaves_from_numpy(tree, cfg)
    if set(named) != set(leaves):
        raise ValueError(f"parameter names differ: "
                         f"{sorted(set(named) ^ set(leaves))}")
    with torch.no_grad():
        for name, a in leaves.items():
            _copy(named[name], a)
    return model


def train_state_from_numpy(tree: dict, cfg: ArchConfig, device) -> dict:
    """The port's train state ``{"params": module, "opt": {"m", "v",
    "step"}}`` from the reference's ``{"params", "opt": {"m", "v",
    "step"}}`` with numpy leaves (fp32 moments, int32 step)."""
    params = params_from_numpy(tree["params"], cfg, device)
    opt = {"step": torch.tensor(int(np.asarray(tree["opt"]["step"])),
                                dtype=torch.int32, device=device)}
    for moment in ("m", "v"):
        opt[moment] = {name: _tensor(a, torch.float32, device)
                       for name, a in leaves_from_numpy(
                           tree["opt"][moment], cfg).items()}
    return {"params": params, "opt": opt}


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
