"""Step builders (port of ``repro.launch.steps``): the train step and the
serving steps.

The reference jits its steps and folds generation into one ``lax.scan``;
here PyTorch runs eagerly, generation is a Python loop of decode steps and
the train step updates the parameters and moments in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import Model, build_model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)


@dataclasses.dataclass
class TrainSetup:
    """The train step for one (cfg, batch shape) on one device.

    ``init_state(seed) -> {"params": DenseLM, "opt": {"m", "v", "step"}}``;
    ``step_fn(state, batch) -> (state, {"loss", "lr", "grad_norm"})``, the
    state updated in place and returned.
    """
    model: Model
    step_fn: Any
    init_state: Any
    batch: int
    seq_len: int

    @property
    def device(self) -> torch.device:
        return self.model.device


@contextlib.contextmanager
def _substituted(module: torch.nn.Module, leaves: dict):
    """Run with some of ``module``'s parameters replaced by other tensors;
    the backward must run inside too, since remat recomputes the forward
    there."""
    saved = []
    try:
        for name, t in leaves.items():
            owner, _, attr = name.rpartition(".")
            mod = module.get_submodule(owner)
            saved.append((mod, attr, mod._parameters[attr]))
            mod._parameters[attr] = t
        yield
    finally:
        for mod, attr, p in saved:
            mod._parameters[attr] = p


def make_train_setup(cfg: ArchConfig, shape: ShapeSpec, device=None, *,
                     peak_lr: float = 3e-4, total_steps: int = 10000,
                     cast_params_once: bool | None = None,
                     opt_cfg: AdamWConfig = AdamWConfig()) -> TrainSetup:
    """The reference's train step on ``device`` (the CUDA card unless the
    caller asks for another device): value and gradient of ``model.loss``
    (``cfg.grad_accum`` microbatches summed in fp32), the warmup-cosine
    learning rate at the pre-update step (warmup ``min(500,
    total_steps // 10)``), then AdamW.  ``cast_params_once``: take the
    gradient with respect to compute-dtype copies of the fp32 matrices
    (ndim >= 2), as the reference does, so gradients arrive in that dtype.
    """
    model = build_model(cfg, device)
    if cast_params_once is None:
        cast_params_once = cfg.cast_params_once
    accum = max(int(cfg.grad_accum), 1)

    def init_state(seed: int = 0):
        params = model.init(seed)
        return {"params": params, "opt": adamw_init(params)}

    def loss_and_grads(params, leaves, batch):
        loss = model.loss(params, batch)
        return loss.detach(), torch.autograd.grad(loss, list(leaves.values()))

    def compute_grads(params, batch):
        leaves = dict(params.named_parameters())
        cast = {}
        if cast_params_once:
            cast = {n: p.detach().to(cfg.cdtype).requires_grad_()
                    for n, p in leaves.items()
                    if p.dtype == torch.float32 and p.ndim >= 2}
            leaves.update(cast)
        with _substituted(params, cast):
            if accum == 1:
                loss, grads = loss_and_grads(params, leaves, batch)
                return loss, dict(zip(leaves, grads))
            rows = next(iter(batch.values())).shape[0]
            if rows % accum:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"grad_accum={accum} microbatches")
            loss_sum = torch.zeros((), device=model.device)
            gacc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in leaves.items()}
            for i in range(accum):
                mb = {k: v.reshape(accum, rows // accum, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, grads = loss_and_grads(params, leaves, mb)
                loss_sum = loss_sum + loss
                for n, g in zip(leaves, grads):
                    gacc[n] += g.float()
            return loss_sum / accum, {n: g / accum for n, g in gacc.items()}

    def step_fn(state, batch):
        params = state["params"]
        loss, grads = compute_grads(params, batch)
        lr = warmup_cosine(state["opt"]["step"], peak_lr=peak_lr,
                           warmup_steps=min(500, total_steps // 10),
                           total_steps=total_steps)
        _, opt, metrics = adamw_update(grads, state["opt"], params, lr,
                                       opt_cfg)
        return ({"params": params, "opt": opt},
                {"loss": loss, "lr": lr, **metrics})

    return TrainSetup(model=model, step_fn=step_fn, init_state=init_state,
                      batch=shape.global_batch, seq_len=shape.seq_len)


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature == 0: argmax over the padded vocab, first index
    on ties) or temperature sampling."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


@dataclasses.dataclass
class ServeSetup:
    """Serving entry points for one (cfg, batch shape) on one device.

    ``prefill_fn(params, batch) -> (last logits, caches)``;
    ``decode_fn(params, caches, token, pos) -> (logits, caches)``;
    ``make_generate(steps, temperature)`` returns
    ``gen(params, caches, tok, pos0, generator) -> (tokens (B, steps),
    caches)``, a loop of ``steps`` decode steps starting from token ``tok``
    at absolute position ``pos0``.  All rows advance in lockstep.
    """
    model: Model
    prefill_fn: Any
    decode_fn: Any
    make_generate: Any
    batch: int
    seq_len: int

    @property
    def device(self) -> torch.device:
        return self.model.device


def make_serve_setup(cfg: ArchConfig, shape: ShapeSpec,
                     device=None) -> ServeSetup:
    """Serving steps for ``cfg`` at ``shape`` on ``device`` (the CUDA card
    unless the caller asks for another device)."""
    model = build_model(cfg, device)

    def make_generate(steps: int, temperature: float = 0.0):
        def gen(params, caches, tok, pos0: int, generator=None):
            toks = []
            for i in range(steps):
                logits, caches = model.decode(params, caches, tok, pos0 + i)
                tok = sample_token(logits, temperature, generator)
                toks.append(tok)
            return torch.stack(toks, 1), caches
        return gen

    return ServeSetup(model=model, prefill_fn=model.prefill,
                      decode_fn=model.decode, make_generate=make_generate,
                      batch=shape.global_batch, seq_len=shape.seq_len)
