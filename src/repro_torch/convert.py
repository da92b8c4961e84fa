"""Carry the reference's weights, train state and decode state across as
numpy arrays.

The reference's parameter pytrees (``repro.models.transformer.lm_init``,
``repro.models.encoder.encoder_init``, ``repro.models.hybrid.
hybrid_init``, ``repro.models.encdec.encdec_init`` and
``repro.models.vlm.vlm_init``) stack the per-layer subtrees along a
leading layer axis under ``"layers"``, and deepseek-v2's dense first
blocks under ``"first_layers"``, the encoder-decoder's encoder under
``"enc_layers"``.  :func:`leaves_from_numpy` names their leaves as the
port's parameters (``layers.3.attn.q_w``, ``layers.3.attn.q_norm_scale``
of a qk-norm config, ``layers.3.ssm.norm.scale``, ``layers.1.moe.exp_wo``,
``first_layers.0.attn.w_dkv``, ``layers.0.cross.k_w``), splitting each
stack over its own depth; every other subtree (the hybrid's one
``shared`` block, ``patch_proj``, ``frontend_proj``) is named as it
stands.  The caller maps ``np.asarray``
over the tree, so this module never sees JAX.  :func:`params_from_numpy`
copies them into a :class:`DenseLM` (the dense and MoE families), an
:class:`Encoder` (encoder family), a :class:`HybridLM` (ssm and hybrid
families), an :class:`EncDec` or a :class:`VLM`,
:func:`train_state_from_numpy` also the AdamW moments and step.  The weight
layout stays (d_in, d_out): the port computes ``x @ w``.  bf16 leaves
travel through fp32, which is exact.  Decode state: :func:`state_from_numpy`
converts one layer's attention state (softmax KV cache or LLN state),
:func:`hybrid_cache_from_numpy` the ssm / hybrid caches, whose per-layer
and per-application entries the reference stacks along a leading axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import AttentionState
from repro_torch.models.encdec import EncDec
from repro_torch.models.encoder import Encoder
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.transformer import DenseLM
from repro_torch.models.vlm import VLM

# The subtrees the reference stacks along a leading layer axis.
_STACKS = ("first_layers", "layers", "enc_layers")


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


def _flatten(tree: dict, prefix: str = ""):
    """(dotted name, leaf) pairs of a nested dict."""
    for k, a in tree.items():
        if isinstance(a, dict):
            yield from _flatten(a, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", a


def leaves_from_numpy(tree: dict, cfg: ArchConfig) -> dict:
    """``{port parameter name: numpy array}`` from a reference-shaped tree
    (the params, or one AdamW moment tree)."""
    del cfg                           # each stack has its own depth
    out = {"embed_table": np.asarray(tree["embed"]["table"])}
    rest = {k: a for k, a in tree.items()
            if k != "embed" and k not in _STACKS}
    for name, a in _flatten(rest):
        out[name] = np.asarray(a)
    for stack in _STACKS:
        for name, a in _flatten(tree.get(stack, {})):
            a = np.asarray(a)
            for i in range(a.shape[0]):
                out[f"{stack}.{i}.{name}"] = a[i]
    return out


def params_from_numpy(tree: dict, cfg: ArchConfig, device):
    """A :class:`DenseLM` (an :class:`Encoder` for the encoder family, a
    :class:`HybridLM` for the ssm and hybrid families, an :class:`EncDec`
    for the encoder-decoder, a :class:`VLM` for the VLM) on ``device``
    holding the reference's weights."""
    gen = torch.Generator(device=device)
    cls = {"encoder": Encoder, "ssm": HybridLM, "hybrid": HybridLM,
           "encdec": EncDec, "vlm": VLM}.get(cfg.family, DenseLM)
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


def _field(tree, name):
    """``tree[name]``, None where the state lacks the field."""
    try:
        return tree[name]
    except KeyError:
        return None


def _leaf(a, device) -> torch.Tensor:
    """A state leaf in its own dtype: int32, bf16 or fp32."""
    arr = np.asarray(a)
    dtype = torch.int32 if arr.dtype.kind in "iu" else (
        torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32)
    return _tensor(arr, dtype, device)


def state_from_numpy(tree, device) -> AttentionState:
    """One layer's :class:`AttentionState` from the reference's state
    (anything indexable by field name: the reference's ``AttentionState``
    with numpy leaves, or a dict).  The fields the state does not hold
    (the KV cache of an LLN state, the diag tails of a ``log_linear``
    state, its pyramid for ``lln``, the LLN fields of a softmax state,
    MLA's latent ``ckv`` / ``kr`` cache outside its softmax decode) stay
    None."""
    out = {}
    for f in dataclasses.fields(AttentionState):
        a = _field(tree, f.name)
        if a is not None:
            out[f.name] = _leaf(a, device)
    return AttentionState(**out)


def hybrid_cache_from_numpy(tree, device) -> dict:
    """The port's ssm / hybrid decode caches (``models/hybrid.py``) from
    the reference's: ``{"layers": {"state", "conv"}}`` with each leaf
    stacked over the layers becomes a list of per-layer dicts, and
    ``"shared"`` (an ``AttentionState`` with each leaf stacked over the
    applications of the shared block, for the hybrid) a list of
    :class:`AttentionState`."""
    layers = {name: np.asarray(tree["layers"][name])
              for name in ("state", "conv")}
    out = {"layers": [{name: _leaf(a[i], device)
                       for name, a in layers.items()}
                      for i in range(layers["state"].shape[0])]}
    if "shared" in tree:
        stacked = {f.name: np.asarray(a)
                   for f in dataclasses.fields(AttentionState)
                   if (a := _field(tree["shared"], f.name)) is not None}
        apps = next(iter(stacked.values())).shape[0]
        out["shared"] = [state_from_numpy(
            {name: a[i] for name, a in stacked.items()}, device)
            for i in range(apps)]
    return out
