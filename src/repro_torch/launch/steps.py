"""Step builders (port of ``repro.launch.steps``): the train step, the
serving steps and the continuous-batching pool (``PoolSetup``).

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
from repro_torch.core.engine import evict_rows
from repro_torch.core.health import HealthConfig, unhealthy_rows
from repro_torch.core.metrics import streaming_concentration_tree
from repro_torch.models import Model, build_model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)
from repro_torch.tree import tree_map


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

    ``prefill_fn(params, batch) -> (last logits, caches)``, softmax KV
    caches sized to ``seq_len`` (the prompt plus the tokens to generate);
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
    max_len = shape.seq_len

    def prefill_fn(params, batch):
        return model.prefill(params, batch, max_len)

    def make_generate(steps: int, temperature: float = 0.0):
        def gen(params, caches, tok, pos0: int, generator=None):
            toks = []
            for i in range(steps):
                logits, caches = model.decode(params, caches, tok, pos0 + i)
                tok = sample_token(logits, temperature, generator)
                toks.append(tok)
            return torch.stack(toks, 1), caches
        return gen

    return ServeSetup(model=model, prefill_fn=prefill_fn,
                      decode_fn=model.decode, make_generate=make_generate,
                      batch=shape.global_batch, seq_len=shape.seq_len)


# ---------------------------------------------------------------------------
# Continuous batching: a slotted request pool over per-row caches.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PoolSetup:
    """The building blocks of the continuous-batching pool
    (``launch/batcher.py`` drives them).  The caches are the model's
    per-layer lists with the slots on axis 0 of every leaf.

    * ``cache_init()`` - zeroed pool caches for ``slots`` rows at
      ``max_len``: (B,) positions and lengths, (B, H) calibration, so each
      slot sits at its own depth with its own prompt's constants.
    * ``prefill_fn(params, tokens (batch, plen)) -> (last logits, slot
      caches)`` at the requests' exact prompt length (an
      LLN state sums every key it sees, so a right-padded prompt would
      corrupt it).  With per-row calibration a same-length group prefills
      in one call and stays exact per request.
    * ``admit_fn(pooled, slot_caches, slot_idx)`` - the pooled caches with
      the k rows of a slot-local cache written into rows ``slot_idx`` ((k,)
      int); the caches passed in are not modified.
    * ``segment_fn(params, caches, tok, pos, remaining, active,
      generator=None) -> (caches, tok, pos, remaining, active, tokens (S,
      B), emitted (S, B), unhealthy (B,), metrics)`` - ``segment`` decode
      steps in an eager loop.  Each step decodes every slot under
      ``row_mask=active``, zeroes the masked rows' logits before sampling
      (they are garbage by the decode contract, NaN even after a fault),
      advances the active rows' positions and retires the rows whose
      ``remaining`` reaches zero.  After the loop, ``unhealthy`` is the
      health sentinel (``core/health.py``) on the post-segment caches
      (all False with ``health=None``) and ``metrics`` the streaming
      concentration telemetry (``log_mass``, ``log_mass_var``,
      ``tau_hat``, ``conc_drift``; None without LLN state); with ``health.check_drift`` an active row whose
      ``|conc_drift|`` exceeds ``health.max_conc_drift`` is unhealthy too.
    * ``replay_fn(params, caches, chunk (B, R), pos (B,), commit (B,))``
      - advance rows over tokens they already committed, emitting nothing:
      one chunked decode under ``commit_len`` (rows with ``commit = 0``
      are untouched).  The quarantine recovery re-prefills a row's prompt
      and replays its emitted tokens in ``REPLAY_CHUNK`` pieces.
    * ``evict_fn(caches, row_mask)`` - the engine's ``evict`` over the
      whole cache tree: the rows where ``row_mask`` ((slots,) bool) is
      True reset to zero, their ``alpha``/``beta`` to one.
    """
    cfg: Any
    model: Model
    slots: int
    max_len: int
    segment: int
    temperature: float
    cache_init: Any
    prefill_fn: Any
    admit_fn: Any
    segment_fn: Any
    evict_fn: Any
    replay_fn: Any
    health: Any = None

    @property
    def device(self) -> torch.device:
        return self.model.device


_HEALTH_DEFAULT = HealthConfig()
REPLAY_CHUNK = 8            # tokens per replay_fn call in a recovery


def make_pool_setup(cfg: ArchConfig, device=None, *, slots: int,
                    max_len: int, segment: int = 8,
                    temperature: float = 0.0,
                    health: Optional[HealthConfig] = _HEALTH_DEFAULT,
                    spec_k: int = 0) -> PoolSetup:
    """The pool's building blocks for ``cfg`` on ``device`` (the CUDA card
    unless the caller asks for another device): the dense decoders and the
    ssm / hybrid LMs, with every serving impl.  The pool's model calibrates
    per row (``lln_per_row_calib=True``, as in the reference): each
    request's alpha/beta come from its own prompt, which keeps a batched
    slot prefill exact per request.  ``health=None`` turns the sentinel
    off.
    ``spec_k >= 1`` (speculative pool rows) waits for ROADMAP.md queue 1,
    item 9, and MoE / MLA configs for item 11b."""
    if cfg.family in ("moe", "mla_moe", "encdec", "vlm") or cfg.kv_lora > 0:
        raise NotImplementedError(
            f"continuous batching of the {cfg.family} family is not ported "
            "yet (ROADMAP.md queue 1, item 11b)")
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            "continuous batching serves decoders only "
            f"(family={cfg.family})")
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    if spec_k >= 1:
        raise NotImplementedError(
            "speculative pool rows are not ported yet (ROADMAP.md queue 1, "
            "item 9)")
    cfg = cfg.replace(lln_per_row_calib=True)
    model = build_model(cfg, device)

    def cache_init():
        return model.cache_init(None, slots, max_len, per_row=True)

    def prefill_fn(params, tokens):
        return model.prefill(params, {"inputs": tokens}, max_len)

    @torch.inference_mode()
    def admit_fn(pooled, slot_caches, slot_idx):
        idx = torch.as_tensor(slot_idx, dtype=torch.long,
                              device=model.device)
        return tree_map(
            lambda pl, sl: pl.index_copy(0, idx, sl.to(pl.dtype)),
            pooled, slot_caches)

    @torch.inference_mode()
    def evict_fn(pooled, row_mask):
        return evict_rows(pooled, row_mask)

    def _sentinel(caches, active):
        if health is not None:
            unhealthy = unhealthy_rows(caches, config=health)
        else:
            unhealthy = torch.zeros(slots, dtype=torch.bool,
                                    device=model.device)
        conc = streaming_concentration_tree(caches)
        metrics = None
        if conc is not None:
            zero = torch.zeros(slots, dtype=torch.float32,
                               device=model.device)
            metrics = {k: conc.get(k, zero).float()
                       for k in ("log_mass", "log_mass_var", "tau_hat",
                                 "conc_drift")}
            if health is not None and health.check_drift:
                # Gated on active: a free slot's zero state has a
                # meaningless (hugely negative) log mass.
                unhealthy = unhealthy | (
                    active & (metrics["conc_drift"].abs()
                              > health.max_conc_drift))
        return unhealthy, metrics

    @torch.inference_mode()
    def segment_fn(params, caches, tok, pos, remaining, active,
                   generator=None):
        toks, emitted = [], []
        for _ in range(segment):
            logits, caches = model.decode(params, caches, tok, pos,
                                          row_mask=active)
            logits = logits.masked_fill(~active[:, None], 0.0)
            nxt = sample_token(logits, temperature, generator)
            tok = torch.where(active, nxt, tok)
            toks.append(tok)
            emitted.append(active)
            adv = active.to(pos.dtype)
            pos = pos + adv
            remaining = remaining - adv
            active = active & (remaining > 0)
        unhealthy, metrics = _sentinel(caches, active)
        return (caches, tok, pos, remaining, active, torch.stack(toks),
                torch.stack(emitted), unhealthy, metrics)

    @torch.inference_mode()
    def replay_fn(params, caches, chunk, pos, commit):
        _, caches = model.decode(params, caches, chunk, pos,
                                 commit_len=commit)
        return caches

    return PoolSetup(cfg=cfg, model=model, slots=slots, max_len=max_len,
                     segment=segment, temperature=temperature,
                     cache_init=cache_init, prefill_fn=prefill_fn,
                     admit_fn=admit_fn, segment_fn=segment_fn,
                     evict_fn=evict_fn, replay_fn=replay_fn, health=health)
