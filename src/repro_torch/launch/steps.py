"""Step builders (port of ``repro.launch.steps``): the train step, the
serving steps, speculative decoding (``SpecSetup``) and the
continuous-batching pool (``PoolSetup``, with speculative rows at
``spec_k >= 1``).

The reference jits its steps and folds generation into one ``lax.scan``;
here PyTorch runs eagerly, generation is a Python loop of decode steps and
the train step updates the parameters and moments in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.engine import evict_rows
from repro_torch.core.health import HealthConfig, unhealthy_rows
from repro_torch.core.metrics import streaming_concentration_tree
from repro_torch.core import speculative
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import check_mesh_family
from repro_torch.models import (Model, build_model, draft_config,
                                draft_params)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)
from repro_torch.tree import leaves_with_path, path_str, tree_map


# ---------------------------------------------------------------------------
# Input and cache placement on a mesh.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafStruct:
    """One input's global shape, dtype and fitted spec (the reference's
    ``ShapeDtypeStruct`` with its sharding)."""
    shape: tuple
    dtype: torch.dtype
    spec: shd.P


def batch_axes(cfg: ArchConfig, rules) -> dict:
    """The logical-to-mesh axes of each batch entry (the reference's
    ``batch_struct`` specs before fitting): tokens, targets and the mask
    by (batch, sequence), ``src`` frames by (batch, sequence, None), a
    VLM's ``patches`` by the batch only."""
    rows, seq = rules["act_batch"], rules["act_seq"]
    out = {name: (rows, seq) for name in ("inputs", "targets", "mask")}
    if cfg.family == "encdec":
        out["src"] = (rows, seq, None)
    if cfg.family == "vlm":
        out["patches"] = (rows, None, None)
    return out


def batch_struct(cfg: ArchConfig, shape: ShapeSpec, mesh, rules) -> dict:
    """Training / prefill batch structs with their specs."""
    b, n = shape.global_batch, shape.seq_len
    axes = batch_axes(cfg, rules)

    def leaf(name, shape_, dtype):
        return LeafStruct(tuple(shape_), dtype,
                          shd.fit_spec(shd.P(*axes[name]), shape_, mesh))

    n_text = n
    if cfg.family == "vlm":
        n_text = max(n - cfg.num_prefix_tokens, 8)
    out = {name: leaf(name, (b, n_text), torch.int64)
           for name in ("inputs", "targets")}
    out["mask"] = leaf("mask", (b, n_text), torch.float32)
    if cfg.family == "encdec":
        out["src"] = leaf("src", (b, n, cfg.frontend_dim), torch.float32)
    if cfg.family == "vlm":
        out["patches"] = leaf("patches", (b, cfg.num_prefix_tokens,
                                          cfg.frontend_dim), torch.float32)
    return out


def batch_placements(struct: dict, mesh) -> dict:
    return {k: shd.to_placements(v.spec, mesh) for k, v in struct.items()}


def place_batch(batch: dict, struct: dict, mesh) -> dict:
    """A batch of plain tensors (the whole global batch on every rank)
    placed by ``struct``; DTensor entries stay as they are."""
    return {k: shd.place_leaf(v, shd.NamedSharding(mesh, struct[k].spec))
            for k, v in batch.items()}


def cache_shardings(cache_tree, cfg, mesh, rules) -> dict:
    """``{leaf path: NamedSharding}`` of a decode-cache tree on ``mesh``.

    The dominant bytes at decode are the caches, so they use the model
    axis.  Heads shard over 'model' when divisible; otherwise the
    *feature* dim (head_dim) shards.  Scalars and per-row counters
    replicate.  A leaf's spec is the reference's for the same path without
    the reference's leading layer axis."""
    msize = shd._axis_size(mesh, "model")
    kv_div = cfg.n_kv_heads % msize == 0
    h_div = cfg.n_heads % msize == 0
    kv_ax = "model" if kv_div else None
    kv_fd = None if kv_div else "model"
    h_ax = "model" if h_div else None
    h_fd = None if h_div else "model"
    b_ax = rules["act_batch"]

    per_name = [
        (r"(^|/)(len|pos|alpha|beta|log_scale)$", ()),
        # LLN tails carry G kv-heads on the kernelized serve path (H on the
        # seed path / MLA); fit_spec drops non-divisible axes either way.
        (r"(^|/)(tail_k|tail_v)$", (b_ax, None, kv_ax, kv_fd)),
        # MLA latent cache: shard the latent dim
        (r"(^|/)ckv$", (b_ax, None, "model")),
        (r"(^|/)kr$", (b_ax, None, None)),
        (r"(^|/)c_k$", (b_ax, None, h_ax, None)),
        # log_linear Fenwick pyramid: (B, L, H, D[, Dv]) - scale axis
        # replicates (L = lln_num_scales is tiny), heads/feature as LLN
        (r"(^|/)sl$", (b_ax, None, h_ax, h_fd, None)),
        (r"(^|/)zl$", (b_ax, None, h_ax, h_fd)),
        (r"(^|/)cl$", (b_ax, None, h_ax)),
        # softmax KV caches (kv heads) / cross-attn caches
        (r"(^|/)(ck|cv|k|v)$", (b_ax, None, kv_ax, kv_fd)),
        # LLN state: heads when divisible, else the feature dim
        (r"(^|/)s$", (b_ax, h_ax, h_fd, None)),
        (r"(^|/)z$", (b_ax, h_ax, h_fd)),
        # SSM state: heads when divisible (zamba 112 ok, mamba 24 not)
        (r"(^|/)state$", (b_ax, h_ax, None, None)),
        (r"(^|/)conv$", (b_ax, None, None)),
    ]

    def leaf(kp, a):
        path = path_str(kp)
        axes: tuple = (None,) * a.ndim
        for pat, ax in per_name:
            if re.search(pat, path):
                lead = a.ndim - len(ax)
                axes = (None,) * lead + tuple(ax)
                break
        return shd.NamedSharding(mesh, shd.fit_spec(shd.P(*axes), a.shape,
                                                    mesh))
    return {path_str(kp): leaf(kp, a)
            for kp, a in leaves_with_path(cache_tree)}


def _multi_pod(mesh) -> bool:
    """The rules' batch axes take the 'pod' axis where the mesh has one."""
    return "pod" in shd.mesh_axes(mesh)


def _full(t):
    """A DTensor's whole value on every rank (a plain tensor as it is)."""
    return t.full_tensor() if shd.is_dtensor(t) else t


class OnMesh:
    """A ``Model``'s serving calls on ``mesh`` under the serve ``rules``:
    each runs inside ``logical_rules``; a batch is placed by
    :func:`batch_axes` (plain tensors, the whole batch on every rank),
    tokens and verify chunks by the rows; per-row positions, ``row_mask``
    and ``commit_len`` come whole on every rank, as the host keeps them,
    and the attention and SSM layers place them with the rows.  Logits come
    back whole on every rank, so every rank samples the same tokens and
    makes the same decisions; caches come back placed by
    :func:`cache_shardings`.  ``score``'s residuals stay as the layers
    placed them, which is what ``commit`` takes."""

    def __init__(self, model: Model, mesh, rules: dict):
        self.model, self.mesh, self.rules = model, mesh, rules
        self.cfg, self.device = model.cfg, model.device
        self.axes = batch_axes(model.cfg, rules)

    def _place(self, t, spec):
        return shd.place_leaf(t, shd.NamedSharding(
            self.mesh, shd.fit_spec(shd.P(*spec), t.shape, self.mesh)))

    def _rows(self, token):
        return self._place(token, (self.rules["act_batch"],)
                           + (None,) * (token.ndim - 1))

    def placed(self, caches):
        return shd.shard_tree(caches, cache_shardings(
            caches, self.cfg, self.mesh, self.rules))

    @torch.inference_mode()
    def cache_init(self, params, batch: int, max_len: int, per_row=False):
        return self.placed(self.model.cache_init(params, batch, max_len,
                                                 per_row=per_row))

    @torch.inference_mode()
    def prefill(self, params, batch, max_len: int):
        batch = {k: self._place(v, self.axes[k]) for k, v in batch.items()}
        with shd.logical_rules(self.mesh, self.rules):
            logits, caches = self.model.prefill(params, batch, max_len)
            return _full(logits), self.placed(caches)

    @torch.inference_mode()
    def decode(self, params, caches, token, pos, row_mask=None,
               commit_len=None):
        # The encoder-decoder and the VLM take no serving contract.
        kw = {k: v for k, v in (("row_mask", row_mask),
                                ("commit_len", commit_len))
              if v is not None}
        with shd.logical_rules(self.mesh, self.rules):
            logits, caches = self.model.decode(params, caches,
                                               self._rows(token), pos, **kw)
            return _full(logits), self.placed(caches)

    @torch.inference_mode()
    def score(self, params, caches, token, pos, row_mask=None):
        with shd.logical_rules(self.mesh, self.rules):
            logits, resid = self.model.score(params, caches,
                                             self._rows(token), pos,
                                             row_mask=row_mask)
            return _full(logits), resid

    @torch.inference_mode()
    def commit(self, caches, resid, commit_len, row_mask=None):
        with shd.logical_rules(self.mesh, self.rules):
            return self.placed(self.model.commit(caches, resid, commit_len,
                                                 row_mask=row_mask))


def _serving(model: Model, mesh, rules=None):
    """``(calls, rules)``: ``model`` itself and None without a mesh; on one
    its :class:`OnMesh` calls under ``rules`` (by default the serve rules
    of its config)."""
    if mesh is None:
        return model, None
    if rules is None:
        rules = shd.make_rules(model.cfg, multi_pod=_multi_pod(mesh),
                               serve=True)
    return OnMesh(model, mesh, rules), rules


def _shard_params(params, mesh):
    """``params`` (the whole tree on every rank) placed by
    ``param_shardings`` on ``mesh``; as they are without one."""
    if mesh is None:
        return params
    return shd.shard_tree(params, shd.param_shardings(params, mesh))


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
    mesh: Any = None
    rules: Optional[dict] = None
    batch_placements: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def state_shardings(self, state) -> dict:
        """``{leaf path: placements}`` of a train state on the mesh (the
        parameters' rules; the AdamW moments follow their parameters)."""
        return shd.param_shardings(state, self.mesh)


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
                     opt_cfg: AdamWConfig = AdamWConfig(),
                     mesh=None) -> TrainSetup:
    """The reference's train step on ``device`` (the CUDA card unless the
    caller asks for another device): value and gradient of ``model.loss``
    (``cfg.grad_accum`` microbatches summed in fp32), the warmup-cosine
    learning rate at the pre-update step (warmup ``min(500,
    total_steps // 10)``), then AdamW.  ``cast_params_once``: take the
    gradient with respect to compute-dtype copies of the fp32 matrices
    (ndim >= 2), as the reference does, so gradients arrive in that dtype.

    ``mesh``: a DeviceMesh (``launch/mesh.py``), the device its type; the
    state is sharded by ``param_shardings``, a batch is placed by
    ``batch_struct`` (``batch_placements``; a batch of plain tensors, the
    whole global batch on every rank, is placed on entry) and the step
    runs inside ``logical_rules(mesh, make_rules(cfg, ...))``.  ``None``
    is the one-device path."""
    if mesh is not None:
        check_mesh_family(cfg)
        device = mesh.device_type
    model = build_model(cfg, device)
    if cast_params_once is None:
        cast_params_once = cfg.cast_params_once
    accum = max(int(cfg.grad_accum), 1)
    rules = struct = None
    if mesh is not None:
        rules = shd.make_rules(cfg, multi_pod=_multi_pod(mesh))
        struct = batch_struct(cfg, shape, mesh, rules)

    def init_state(seed: int = 0):
        params = model.init(seed)
        state = {"params": params, "opt": adamw_init(params)}
        if mesh is not None:
            state = shd.shard_tree(state, shd.param_shardings(state, mesh))
        return state

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
            gacc = {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in leaves.items()}
            mbr = rows // accum
            for i in range(accum):
                mb = {k: v[i * mbr:(i + 1) * mbr] if shd.is_dtensor(v)
                      else v.reshape(accum, mbr, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, grads = loss_and_grads(params, leaves, mb)
                loss_sum = loss_sum + loss
                for n, g in zip(leaves, grads):
                    gacc[n] += g.float()
            return loss_sum / accum, {n: g / accum for n, g in gacc.items()}

    def step(state, batch):
        params = state["params"]
        loss, grads = compute_grads(params, batch)
        lr = warmup_cosine(_full(state["opt"]["step"]), peak_lr=peak_lr,
                           warmup_steps=min(500, total_steps // 10),
                           total_steps=total_steps)
        _, opt, metrics = adamw_update(grads, state["opt"], params, lr,
                                       opt_cfg)
        return ({"params": params, "opt": opt},
                {"loss": _full(loss), "lr": lr, **metrics})

    def step_fn(state, batch):
        if mesh is None:
            return step(state, batch)
        batch = place_batch(batch, struct, mesh)
        with shd.logical_rules(mesh, rules):
            return step(state, batch)

    return TrainSetup(model=model, step_fn=step_fn, init_state=init_state,
                      batch=shape.global_batch, seq_len=shape.seq_len,
                      mesh=mesh, rules=rules,
                      batch_placements=None if mesh is None
                      else batch_placements(struct, mesh))


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
    mesh: Any = None
    rules: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def shard_params(self, params):
        """``params`` (the whole tree on every rank: the same seed or the
        same restored file) placed by ``param_shardings`` on the mesh; as
        they are without one."""
        return _shard_params(params, self.mesh)

    def cache_shardings(self, caches) -> dict:
        return cache_shardings(caches, self.model.cfg, self.mesh, self.rules)


def make_serve_setup(cfg: ArchConfig, shape: ShapeSpec, device=None, *,
                     mesh=None) -> ServeSetup:
    """Serving steps for ``cfg`` at ``shape`` on ``device`` (the CUDA card
    unless the caller asks for another device), every family with a decode
    step.  The batch carries the family's inputs (``src`` for the
    encoder-decoder, ``patches`` for the VLM, whose decode positions start
    after its ``num_prefix_tokens`` patches).

    ``mesh``: a DeviceMesh, the dense and MoE decoders.  The parameters are
    placed by :meth:`ServeSetup.shard_params`, a batch of plain tensors
    (the whole batch on every rank) by ``batch_struct`` and the token by
    the batch axes; prefill and decode run inside ``logical_rules`` and
    leave their caches placed by :func:`cache_shardings`; the logits come
    back whole on every rank, so every rank samples the same tokens."""
    if mesh is not None:
        check_mesh_family(cfg)
        device = mesh.device_type
    model = build_model(cfg, device)
    max_len = shape.seq_len
    calls, rules = _serving(model, mesh)
    prefill, decode = calls.prefill, calls.decode

    def prefill_fn(params, batch):
        return prefill(params, batch, max_len)

    def make_generate(steps: int, temperature: float = 0.0):
        def gen(params, caches, tok, pos0: int, generator=None):
            toks = []
            for i in range(steps):
                logits, caches = decode(params, caches, tok, pos0 + i)
                tok = sample_token(logits, temperature, generator)
                toks.append(tok)
            return torch.stack(toks, 1), caches
        return gen

    return ServeSetup(model=model, prefill_fn=prefill_fn,
                      decode_fn=decode, make_generate=make_generate,
                      batch=shape.global_batch, seq_len=shape.seq_len,
                      mesh=mesh, rules=rules)


# ---------------------------------------------------------------------------
# Speculative decoding: draft-then-verify over the partial-commit contract.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpecSetup:
    """Speculative decoding for one (cfg, batch shape) on one device.

    Draft-then-verify (Leviathan et al.; Chen et al.) over the engine's
    partial commit: each iteration the tied first-``draft_layers`` draft
    proposes ``spec_k`` tokens one by one on scratch state, the target
    scores the chunk ``[tok, d_1..d_k]`` in one ``commit_len=0`` pass
    (``Model.score``: its caches unchanged), the acceptance rule
    (``core/speculative.py``) gives per-row commit lengths, the target
    folds the accepted prefix from the score's residuals
    (``Model.commit``) and the draft decodes the chunk under the same
    ``commit_len``.  A rejected draft never enters a running sum.

    * ``prefill_fn(params, batch) -> (last logits, tgt_caches,
      draft_caches)``: both models prefill the prompt (the draft's
      parameters are a view of the target's first layers).
    * ``make_generate(steps, temperature=0.0, iters=None)`` returns
      ``gen(params, tgt_caches, draft_caches, tok, pos0, generator=None)
      -> (toks (B, iters, k+1), n_emit (B, iters), n_accept (B, iters),
      live (B, iters), tgt_caches, draft_caches)``; one iteration emits
      1..k+1 tokens per row, and a row stops (``commit_len`` 0, the
      masked row) once it has ``steps`` tokens.  ``iters`` defaults to
      ``steps``, the worst case of one token per verify.  The reference
      scans all ``iters``; the eager loop here stops when no row is live,
      and the iterations it leaves out are zero (``live`` False, nothing
      emitted), which is what running them would give but for their
      unused token slots.  :func:`flatten_spec_tokens` makes (B, steps)
      sequences.

    Greedy speculative decoding gives the plain greedy loop's tokens.
    """
    cfg: Any
    draft_cfg: Any
    model: Model
    draft_model: Model
    spec_k: int
    draft_layers: int
    max_len: int
    prefill_fn: Any
    make_generate: Any = None
    mesh: Any = None
    rules: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def shard_params(self, params):
        """The target's parameters placed on the mesh (the draft shares
        them); as they are without one."""
        return _shard_params(params, self.mesh)


def _draft_chunk(dmodel, dparams, dr_caches, tok, pos, k: int,
                 temperature: float, generator, row_mask=None):
    """k draft tokens from ``tok`` at per-row positions ``pos``, decoded
    one by one on scratch caches (discarded).  Returns ``(drafts (B, k),
    draft logits (B, k, V))``; with ``row_mask`` the masked rows' logits
    are zeroed before sampling (garbage by the decode contract)."""
    drafts, dlogits = [], []
    cur = tok
    for j in range(k):
        lg, dr_caches = dmodel.decode(dparams, dr_caches, cur, pos + j,
                                      row_mask=row_mask)
        if row_mask is not None:
            lg = lg.masked_fill(~row_mask[:, None], 0.0)
        cur = sample_token(lg, temperature, generator)
        drafts.append(cur)
        dlogits.append(lg)
    return torch.stack(drafts, 1), torch.stack(dlogits, 1)


def _verify_step(model, dmodel, params, dparams, tgt, dr, tok, pos, k: int,
                 temperature: float, generator, live, row_mask=None):
    """One draft / score / accept / commit iteration.  ``live`` (B,) bool:
    the rows that may commit (the others commit 0).  Returns ``(tgt, dr,
    emitted (B, k+1), n_accept (B,), next token (B,), commit (B,), verify
    chunk (B, k+1))``."""
    drafts, dlogits = _draft_chunk(dmodel, dparams, dr, tok, pos, k,
                                   temperature, generator, row_mask)
    chunk = torch.cat([tok[:, None], drafts], 1)
    tlogits, resid = model.score(params, tgt, chunk, pos, row_mask=row_mask)
    if row_mask is not None:
        tlogits = tlogits.masked_fill(~row_mask[:, None, None], 0.0)
    n_acc, nxt, commit = speculative.verify_tokens(
        drafts, tlogits, temperature, generator=generator,
        draft_logits=dlogits)
    commit = torch.where(live, commit, torch.zeros_like(commit))
    tgt = model.commit(tgt, resid, commit, row_mask=row_mask)
    _, dr = dmodel.decode(dparams, dr, chunk, pos, row_mask=row_mask,
                          commit_len=commit)
    return (tgt, dr, speculative.emit_tokens(drafts, n_acc, nxt), n_acc,
            nxt, commit, chunk)


def make_spec_setup(cfg: ArchConfig, shape: ShapeSpec, device=None, *,
                    spec_k: int, draft_layers: int,
                    mesh=None) -> SpecSetup:
    """The speculative loop for a dense or MoE decoder on ``device`` (the CUDA
    card unless the caller asks for another device).  ``shape.seq_len`` is
    the cache budget: the prompt, the generation budget and one verify
    chunk of overshoot (``prompt + steps + spec_k + 1``).

    ``mesh``: a DeviceMesh.  The target and the draft serve through
    :class:`OnMesh` under one set of serve rules: parameters placed by
    :meth:`SpecSetup.shard_params` (the draft's are the same shards), both
    caches by :func:`cache_shardings`, the logits whole on every rank, so
    the acceptance rule, the tokens and the per-row commit lengths are the
    same on every rank."""
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    dcfg = draft_config(cfg, draft_layers)   # validates k and the family
    if mesh is not None:
        check_mesh_family(cfg)
        device = mesh.device_type
    tmodel, dbuilt = build_model(cfg, device), build_model(dcfg, device)
    model, rules = _serving(tmodel, mesh)
    dmodel, _ = _serving(dbuilt, mesh, rules)
    draft_layers = draft_layers or cfg.draft_layers
    max_len = shape.seq_len
    k = spec_k

    def prefill_fn(params, batch):
        logits, tgt = model.prefill(params, batch, max_len)
        _, dr = dmodel.prefill(draft_params(params, cfg, draft_layers),
                               batch, max_len)
        return logits, tgt, dr

    def make_generate(steps: int, temperature: float = 0.0,
                      iters: Optional[int] = None):
        n_iters = steps if iters is None else iters

        @torch.inference_mode()
        def gen(params, tgt_caches, dr_caches, tok, pos0, generator=None):
            b = tok.shape[0]
            dev = tok.device
            dparams = draft_params(params, cfg, draft_layers)
            pos = torch.as_tensor(pos0, dtype=torch.int32,
                                  device=dev).expand(b).clone()
            count = torch.zeros(b, dtype=torch.int32, device=dev)
            toks = torch.zeros(b, n_iters, k + 1, dtype=tok.dtype,
                               device=dev)
            n_emit = torch.zeros(b, n_iters, dtype=torch.int32, device=dev)
            n_accept = torch.zeros_like(n_emit)
            live_all = torch.zeros(b, n_iters, dtype=torch.bool, device=dev)
            for i in range(n_iters):
                live = count < steps
                if not bool(live.any()):
                    break
                tgt_caches, dr_caches, out, n_acc, nxt, commit, _ = \
                    _verify_step(model, dmodel, params, dparams, tgt_caches,
                                 dr_caches, tok, pos, k, temperature,
                                 generator, live)
                emit = torch.where(live, n_acc + 1, torch.zeros_like(n_acc))
                toks[:, i] = out
                n_emit[:, i] = emit
                n_accept[:, i] = torch.where(live, n_acc,
                                             torch.zeros_like(n_acc))
                live_all[:, i] = live
                tok = torch.where(live, nxt, tok)
                pos = pos + commit
                count = count + emit
            return toks, n_emit, n_accept, live_all, tgt_caches, dr_caches

        return gen

    return SpecSetup(cfg=cfg, draft_cfg=dcfg, model=tmodel,
                     draft_model=dbuilt, spec_k=spec_k,
                     draft_layers=draft_layers,
                     max_len=max_len, prefill_fn=prefill_fn,
                     make_generate=make_generate, mesh=mesh, rules=rules)


def flatten_spec_tokens(toks, n_emit, steps: int) -> np.ndarray:
    """One speculative run's (B, steps) token sequences: each row's
    emitted prefixes ``toks[r, it, :n_emit[r, it]]`` concatenated, the
    overshoot past ``steps`` dropped.  Raises if a row has fewer than
    ``steps`` tokens (too few iterations)."""
    toks = np.asarray(toks.cpu() if torch.is_tensor(toks) else toks)
    n_emit = np.asarray(n_emit.cpu() if torch.is_tensor(n_emit) else n_emit)
    b = toks.shape[0]
    out = np.zeros((b, steps), np.int32)
    for r in range(b):
        seq: list[int] = []
        for it in range(toks.shape[1]):
            seq.extend(int(x) for x in toks[r, it, :int(n_emit[r, it])])
            if len(seq) >= steps:
                break
        if len(seq) < steps:
            raise ValueError(f"row {r} emitted {len(seq)} < {steps} tokens"
                             " - increase iters")
        out[r] = np.asarray(seq[:steps], np.int32)
    return out


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
      B), emitted (S, B), unhealthy (B,), metrics, inputs (S, B, 1))`` -
      ``segment`` decode steps in an eager loop.  Each step decodes every slot under
      ``row_mask=active``, zeroes the masked rows' logits before sampling
      (they are garbage by the decode contract, NaN even after a fault),
      advances the active rows' positions and retires the rows whose
      ``remaining`` reaches zero.  After the loop, ``unhealthy`` is the
      health sentinel (``core/health.py``) on the post-segment caches
      (all False with ``health=None``) and ``metrics`` the streaming
      concentration telemetry (``log_mass``, ``log_mass_var``,
      ``tau_hat``, ``conc_drift``; None without LLN state); with ``health.check_drift`` an active row whose
      ``|conc_drift|`` exceeds ``health.max_conc_drift`` is unhealthy too.
      ``inputs`` are each step's input tokens per row, the steps' record
      that a recovery replays.
    * ``replay_fn(params, caches, chunk (B, E), pos (B,), commit (B,))``
      - rerun one recorded step on the rows with ``commit > 0``, emitting
      nothing: the segment's own calls on the step's ``inputs`` (E = 1: a
      decode step; speculative: the score and commit of the verify chunk
      and the draft's commit decode) under ``row_mask = commit > 0``, so
      the other rows are untouched and the replayed rows' caches come out
      bit for bit as the step left them.  The quarantine recovery
      re-prefills a row's admission group and replays its steps.
    * ``evict_fn(caches, row_mask)`` - the engine's ``evict`` over the
      whole cache tree: the rows where ``row_mask`` ((slots,) bool) is
      True reset to zero, their ``alpha``/``beta`` to one.

    Speculative pool (``spec_k >= 1``): every cache tree is the pair
    ``{"target", "draft"}`` (both prefill on admission and advance together
    through replay and evict; the draft is the target's first
    ``draft_layers`` layers, ``draft_model`` its ``Model``), each segment
    step is one draft / verify / accept iteration, and ``segment_fn``'s
    tokens are (S, B, k+1) with ``emitted`` (S, B) int counts (0 for a
    frozen row, up to ``spec_k + 1``) and its ``inputs`` the verify chunks
    ``[tok, d_1..d_k]`` (S, B, k+1): the rejected drafts set the chunk's
    stabilization constants, so an exact replay needs them.  The health
    sentinel and the telemetry read the target's caches.
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
    spec_k: int = 0
    draft_layers: int = 0
    draft_model: Optional[Model] = None
    mesh: Any = None
    rules: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def shard_params(self, params):
        """The parameters placed on the mesh; as they are without one."""
        return _shard_params(params, self.mesh)


_HEALTH_DEFAULT = HealthConfig()


def _admit_rows(pooled, slot, idx):
    """``pooled`` with rows ``idx`` ((k,) long) set to the k rows of
    ``slot``, out of place.  On a mesh the slot's rows come whole to every
    rank and each rank writes the ones it holds into its shard (the other
    dims cut to its shard as well): no DTensor op, no communication."""
    slot = _full(slot).to(pooled.dtype)
    if not shd.is_dtensor(pooled):
        return pooled.index_copy(0, idx, slot)
    from torch.distributed.tensor import Replicate
    part = shd.local_slice(slot, pooled.device_mesh, [
        Replicate() if p.is_shard(0) else p for p in pooled.placements])

    def write(loc, rows):
        where = torch.full((pooled.shape[0],), -1, dtype=torch.long,
                           device=loc.device)
        where[rows] = torch.arange(rows.numel(), device=loc.device)
        at = where[idx]
        held = at >= 0
        return loc.index_copy(0, at[held], part[held])
    return shd.map_rows(pooled, write)


def make_pool_setup(cfg: ArchConfig, device=None, *, slots: int,
                    max_len: int, segment: int = 8,
                    temperature: float = 0.0,
                    health: Optional[HealthConfig] = _HEALTH_DEFAULT,
                    spec_k: int = 0, draft_layers: int = 0,
                    mesh=None) -> PoolSetup:
    """The pool's building blocks for ``cfg`` on ``device`` (the CUDA card
    unless the caller asks for another device): the dense and MoE decoders
    (not MLA) and the ssm / hybrid LMs, with every serving impl.  The pool's model calibrates
    per row (``lln_per_row_calib=True``, as in the reference): each
    request's alpha/beta come from its own prompt, which keeps a batched
    slot prefill exact per request.  ``health=None`` turns the sentinel
    off.

    ``spec_k >= 1`` makes the rows speculative (dense and MoE): paired
    target and draft caches (the draft the tied first ``draft_layers``
    layers), and per segment step one draft-k / verify / accept iteration
    whose per-row accept counts become per-row ``commit_len``; done, free
    and quarantined rows ride ``commit_len=0``.  The verify is one
    ``commit_len=0`` target score and the ``lm_commit`` fold of the
    accepted prefix.  A row may overshoot its budget by up to ``spec_k``
    tokens in its last iteration: the batcher caps the harvest at the
    budget and ``check_request`` reserves ``spec_k`` positions of slack.
    MLA, the encoder-decoder and the VLM are refused, as in the
    reference.

    ``mesh``: a DeviceMesh.  The pool serves through :class:`OnMesh` under
    the serve rules: the parameters placed by :meth:`PoolSetup.shard_params`,
    the pool's and a prefill's caches by :func:`cache_shardings`; the
    per-row carry (token, position, budget, active) stays whole on every
    rank, as the logits come back; admit and evict write each rank's own
    rows of its shards; the sentinel's reductions give every rank the
    same per-row vectors (``core/health.py``, ``core/metrics.py``), so
    every rank's batcher makes the same decisions."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid") \
            or cfg.kv_lora > 0:
        raise NotImplementedError(
            "continuous batching supports dense/moe decoders and "
            "ssm/hybrid models "
            f"(family={cfg.family}, kv_lora={cfg.kv_lora})")
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    if spec_k >= 1 and cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            "speculative pools need a first-k-layers draft "
            f"(family={cfg.family})")
    if mesh is not None:
        check_mesh_family(cfg)
        device = mesh.device_type
    cfg = cfg.replace(lln_per_row_calib=True)
    pmodel = build_model(cfg, device)
    model, rules = _serving(pmodel, mesh)
    spec = spec_k >= 1
    dmodel = dbuilt = None
    if spec:
        dbuilt = build_model(draft_config(cfg, draft_layers), device)
        dmodel, _ = _serving(dbuilt, mesh, rules)
        draft_layers = draft_layers or cfg.draft_layers
    k = spec_k

    def cache_init():
        tgt = model.cache_init(None, slots, max_len, per_row=True)
        if not spec:
            return tgt
        return {"target": tgt,
                "draft": dmodel.cache_init(None, slots, max_len,
                                           per_row=True)}

    def prefill_fn(params, tokens):
        logits, tgt = model.prefill(params, {"inputs": tokens}, max_len)
        if not spec:
            return logits, tgt
        _, dr = dmodel.prefill(draft_params(params, cfg, draft_layers),
                               {"inputs": tokens}, max_len)
        return logits, {"target": tgt, "draft": dr}

    @torch.inference_mode()
    def admit_fn(pooled, slot_caches, slot_idx):
        idx = torch.as_tensor(slot_idx, dtype=torch.long,
                              device=model.device)
        return tree_map(lambda pl, sl: _admit_rows(pl, sl, idx), pooled,
                        slot_caches)

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
        toks, emitted, inputs = [], [], []
        for _ in range(segment):
            inputs.append(tok)
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
                torch.stack(emitted), unhealthy, metrics,
                torch.stack(inputs)[..., None])

    @torch.inference_mode()
    def segment_spec_fn(params, caches, tok, pos, remaining, active,
                        generator=None):
        """``segment`` draft / verify / accept iterations over the paired
        caches; frozen rows ride ``commit_len=0`` on both.  Emits (S, B,
        k+1) tokens, (S, B) int32 counts and the (S, B, k+1) verify
        chunks."""
        dparams = draft_params(params, cfg, draft_layers)
        tgt, dr = caches["target"], caches["draft"]
        toks, emitted, inputs = [], [], []
        for _ in range(segment):
            tgt, dr, out, n_acc, nxt, commit, chunk = _verify_step(
                model, dmodel, params, dparams, tgt, dr, tok, pos, k,
                temperature, generator, active, row_mask=active)
            inputs.append(chunk)
            n_emit = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
            tok = torch.where(active, nxt, tok)
            toks.append(out)
            emitted.append(n_emit)
            pos = pos + commit
            remaining = remaining - n_emit
            active = active & (remaining > 0)
        unhealthy, metrics = _sentinel(tgt, active)
        return ({"target": tgt, "draft": dr}, tok, pos, remaining, active,
                torch.stack(toks), torch.stack(emitted), unhealthy, metrics,
                torch.stack(inputs))

    @torch.inference_mode()
    def replay_fn(params, caches, chunk, pos, commit):
        rows = commit > 0
        if not spec:
            _, caches = model.decode(params, caches, chunk[:, 0], pos,
                                     row_mask=rows)
            return caches
        # Both states rerun the step's commits on its verify chunk.
        _, resid = model.score(params, caches["target"], chunk, pos,
                               row_mask=rows)
        tgt = model.commit(caches["target"], resid, commit, row_mask=rows)
        _, dr = dmodel.decode(draft_params(params, cfg, draft_layers),
                              caches["draft"], chunk, pos, row_mask=rows,
                              commit_len=commit)
        return {"target": tgt, "draft": dr}

    return PoolSetup(cfg=cfg, model=pmodel, slots=slots, max_len=max_len,
                     segment=segment, temperature=temperature,
                     cache_init=cache_init, prefill_fn=prefill_fn,
                     admit_fn=admit_fn,
                     segment_fn=segment_spec_fn if spec else segment_fn,
                     evict_fn=evict_fn, replay_fn=replay_fn, health=health,
                     spec_k=spec_k, draft_layers=draft_layers,
                     draft_model=dbuilt, mesh=mesh, rules=rules)
