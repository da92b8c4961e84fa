"""AdamW with decoupled weight decay, global-norm clipping and fp32 moments
whatever the parameter dtype (port of ``repro.optim.adamw``).

Trees are dicts of tensors keyed by parameter name (``dict(module.
named_parameters())``).  The reference is pure-functional; here
:func:`adamw_update` writes the new parameters and moments into the given
tensors in place, which saves a copy of each (at 8 layers of yi-9b, 7.6 GB
per copy of the parameters alone), and clips each gradient leaf as it
updates it, which saves a clipped copy of the gradients.  The order of
operations is the reference's: clip, bias correction, then decay on every
leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Union

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


Tree = Union[nn.Module, Mapping[str, torch.Tensor]]


def _leaves(tree: Tree) -> dict:
    return dict(tree.named_parameters()) if isinstance(tree, nn.Module) \
        else dict(tree)


def adamw_init(params: Tree) -> dict:
    """``{"m": {name: 0}, "v": {name: 0}, "step": 0}``, fp32 moments on the
    parameters' devices."""
    leaves = _leaves(params)
    dev = next(iter(leaves.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in leaves.items()}
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in _leaves(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(grads: dict, max_norm: float):
    """``(min(1, max_norm / norm), norm)`` of the tree's global norm."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads: Tree, max_norm: float):
    """Scale every leaf by min(1, max_norm / norm); returns ``(clipped,
    norm)`` with each leaf in its own dtype."""
    grads = _leaves(grads)
    scale, norm = _clip_scale(grads, max_norm)
    return {n: _clipped(g, scale) for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: Tree, state: dict, params: Tree, lr,
                 cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step, in place.  Returns ``(params, state, {"grad_norm"})``
    with ``params`` and ``state`` the objects passed in, updated."""
    grads = _leaves(grads)
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    step = state["step"] + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    leaves = _leaves(params)
    for name, p in leaves.items():
        # One leaf at a time, in place where the value is the same: the
        # clipped leaf is clip_by_global_norm's, and each product and sum
        # below is the one the reference's formula takes, in its order.
        # The transients stay at a few copies of the largest leaf (a
        # clipped copy of the tree would cost the gradients' bytes again).
        gf = _clipped(grads[name], scale).float()
        m, v = state["m"][name], state["v"][name]
        m.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(gf).mul_(1 - cfg.b2))
        del gf
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps)) \
            .add_(cfg.weight_decay * p.float())
        p.copy_((p.float() - delta.mul_(lr)).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm}
