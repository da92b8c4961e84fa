"""Shared helpers of the port's family tests (``test_torch_moe.py``,
``test_torch_mla.py``, ``test_torch_encdec.py``, ``test_torch_vlm.py``).

:func:`reference_run` runs the reference's SMOKE model once (a module-scoped
fixture caches it per file): ``Model.hidden`` and ``Model.loss`` on a
synthetic batch, the serving prefill and ``STEPS`` greedy decode steps,
and returns everything as numpy with the weights.  :func:`port_matches`
converts the weights with ``convert.py``, runs the port's model on the
same batch on the CPU, teacher-forced with the reference's tokens, and
holds every output to the reference's within ``REL`` of the largest entry
(fp32), the greedy tokens exactly.

:func:`trains_like_the_reference` holds the family's training path:
both packages start from the reference's initial train state (params and
AdamW moments, converted through numpy) and take the same numpy batches
(:func:`train_batches`); the port's first-step gradient of every leaf
against ``jax.grad(model.loss)`` within ``TRAIN_REL`` of that leaf's
largest entry, then ``TRAIN_STEPS`` steps of both packages'
``make_train_setup``: loss, grad norm and lr within ``TRAIN_REL``
relative, and the params after the steps within 2 x the summed learning
rate (m / sqrt(v) turns a tiny gradient difference on a near-zero
gradient into a full-size update difference, so the bound says that no
weight moved differently by more than the updates themselves can).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.launch.mesh import compat_mesh
from repro.launch.steps import make_train_setup as j_make_train_setup
from repro.models import build_model as j_build_model
from repro.models import synthetic_batch as j_synthetic_batch
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import (leaves_from_numpy, params_from_numpy,
                                 train_state_from_numpy)
from repro_torch.data import torch_placer
from repro_torch.launch.steps import make_train_setup
from repro_torch.models import build_model

REL = 1e-5                  # of the largest entry, fp32
BATCH, STEPS = 2, 8


def close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    if torch.is_tensor(got):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _overrides(impl, over):
    return dict(attn_impl=impl, compute_dtype="float32", **over)


def reference_run(arch, impl, *, prompt=20, steps=STEPS, **over):
    """The reference's outputs at SMOKE size: a dict of numpy arrays with
    the batch, the weights (``params``), ``hidden``, ``aux``, ``loss``,
    ``prefill`` logits, ``steps`` (each decode step's logits), ``tokens``
    (the greedy tokens, the prefill's first) and ``pos0`` (the first
    decode position)."""
    cfg = j_get_config(arch, smoke=True, **_overrides(impl, over))
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    max_len = prompt + steps + 1 + cfg.num_prefix_tokens
    batch = j_synthetic_batch(cfg, BATCH, max_len, text_seq=prompt)
    hidden, aux = jax.jit(model.hidden)(params, batch)
    loss = jax.jit(model.loss)(params, batch)
    logits, caches = jax.jit(model.prefill, static_argnums=2)(
        params, batch, max_len)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    pos0 = batch["inputs"].shape[1] + (cfg.num_prefix_tokens
                                       if cfg.family == "vlm" else 0)
    decode = jax.jit(model.decode)
    toks, step_logits = [tok], []
    for i in range(steps):
        lg, caches = decode(params, caches, tok, jnp.asarray(pos0 + i,
                                                             jnp.int32))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        step_logits.append(lg)
        toks.append(tok)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"batch": as_np(batch), "params": as_np(params),
            "hidden": np.asarray(hidden), "aux": np.asarray(aux),
            "loss": np.asarray(loss), "prefill": np.asarray(logits),
            "steps": np.stack([np.asarray(x) for x in step_logits], 1),
            "tokens": np.stack([np.asarray(x) for x in toks], 1),
            "pos0": pos0, "max_len": max_len}


def port_batch(ref) -> dict:
    """The reference's batch as the port's tensors (int64 tokens)."""
    return {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if np.asarray(v).dtype.kind in "iu" else np.float32))
        for k, v in ref["batch"].items()}


def port_model(arch, impl, ref, **over):
    cfg = get_config(arch, smoke=True, **_overrides(impl, over))
    model = build_model(cfg, "cpu")
    return cfg, model, params_from_numpy(ref["params"], cfg, "cpu")


def port_matches(arch, impl, ref, **over):
    """Hold the port's hidden states, aux loss, loss, prefill logits and
    each teacher-forced decode step (greedy tokens equal) to ``ref``."""
    cfg, model, params = port_model(arch, impl, ref, **over)
    batch = port_batch(ref)
    with torch.no_grad():
        hidden, aux = model.hidden(params, batch)
        loss = model.loss(params, batch)
    close(hidden, ref["hidden"])
    close(aux, ref["aux"])
    close(loss, ref["loss"])
    logits, caches = model.prefill(params, batch, ref["max_len"])
    close(logits, ref["prefill"])
    toks = torch.from_numpy(ref["tokens"].astype(np.int64))
    assert torch.equal(torch.argmax(logits[:, -1], -1), toks[:, 0])
    for i in range(ref["steps"].shape[1]):
        lg, caches = model.decode(params, caches, toks[:, i],
                                  ref["pos0"] + i)
        close(lg, ref["steps"][:, i])
        assert torch.equal(torch.argmax(lg, -1), toks[:, i + 1]), i
    return cfg, model, params, caches


# The train parity runs: batch x sequence (the VLM's sequence counts its
# patches, as the reference's ``synthetic_batch``), the encoder-decoder's
# source frames, steps and schedule.
TRAIN_BATCH, TRAIN_SEQ, SRC_FRAMES = 2, 32, 48
TRAIN_STEPS, TRAIN_LR = 3, 1e-3
TRAIN_REL = 1e-4


def train_overrides(impl, use_kernel):
    """fp32 compute, and one microbatch: the MoE configs accumulate 8,
    which a 2-row batch does not split into (both packages take the
    override)."""
    return dict(attn_impl=impl, compute_dtype="float32",
                use_kernel=use_kernel, grad_accum=1)


def train_batches(cfg, seed=0) -> list:
    """``TRAIN_STEPS`` batches with the family's inputs, from numpy: tokens
    in the vocab, a loss mask with the last 5 targets of row 1 off, the
    encoder-decoder's ``SRC_FRAMES`` source frames, the VLM's patches."""
    rng = np.random.default_rng(seed)
    n = TRAIN_SEQ - (cfg.num_prefix_tokens if cfg.family == "vlm" else 0)
    out = []
    for _ in range(TRAIN_STEPS):
        toks = rng.integers(0, cfg.vocab, (TRAIN_BATCH, n + 1)
                            ).astype(np.int32)
        mask = np.ones((TRAIN_BATCH, n), np.float32)
        mask[1, -5:] = 0.0
        b = {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}
        if cfg.family == "encdec":
            b["src"] = rng.normal(size=(TRAIN_BATCH, SRC_FRAMES,
                                        cfg.frontend_dim)).astype(np.float32)
        if cfg.family == "vlm":
            b["patches"] = rng.normal(size=(
                TRAIN_BATCH, cfg.num_prefix_tokens,
                cfg.frontend_dim)).astype(np.float32)
        out.append(b)
    return out


@functools.lru_cache(maxsize=None)
def _reference_init(arch, impl):
    """The reference's initial train state as numpy (jitted init; the
    params do not depend on ``use_kernel``, so the cases share it)."""
    jcfg = j_get_config(arch, smoke=True, **train_overrides(impl, False))
    params = jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        np.asarray, {"params": params, "opt": j_adamw_init(params)})


def reference_train(arch, impl, use_kernel, batches):
    """(initial state and first-step gradients as numpy, per-step metrics,
    final params as numpy) of the reference's ``make_train_setup``."""
    jcfg = j_get_config(arch, smoke=True,
                        **train_overrides(impl, use_kernel))
    state0 = _reference_init(arch, impl)
    mesh = compat_mesh((1, 1), ("data", "model"))
    with mesh:
        jsetup = j_make_train_setup(
            jcfg, JShape("t", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh,
            multi_pod=False, peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS)
        model = j_build_model(jcfg)
        grads0 = jax.tree_util.tree_map(np.asarray, jax.jit(
            jax.grad(model.loss))(state0["params"], batches[0]))
        # Copies (the step donates its state; the cached numpy stays), placed
        # as the step wants them: an unplaced first state would make the
        # second step compile again.
        state = jax.device_put(jax.tree_util.tree_map(jnp.array, state0),
                               jsetup.state_shardings)
        metrics = []
        for batch in batches:
            state, m = jsetup.step_fn(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        final = jax.tree_util.tree_map(np.asarray, state["params"])
    return state0, grads0, metrics, final


def trains_like_the_reference(arch, impl, use_kernel):
    """Hold the port's training path on the CPU (see the module
    docstring); returns the port's train setup."""
    over = train_overrides(impl, use_kernel)
    tcfg = get_config(arch, smoke=True, **over)
    batches = train_batches(tcfg)
    state0, grads0, j_metrics, j_final = reference_train(arch, impl,
                                                         use_kernel, batches)
    state = train_state_from_numpy(state0, tcfg, "cpu")
    setup = make_train_setup(tcfg, ShapeSpec("t", TRAIN_SEQ, TRAIN_BATCH,
                                             "train"), device="cpu",
                             peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS)
    place = torch_placer("cpu")
    tbatches = [place(b) for b in batches]
    params = dict(state["params"].named_parameters())
    loss = setup.model.loss(state["params"], tbatches[0])
    grads = torch.autograd.grad(loss, list(params.values()))
    want = leaves_from_numpy(grads0, tcfg)
    assert set(want) == set(params)
    for (name, _), g in zip(params.items(), grads):
        w = want[name]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=TRAIN_REL * max(float(np.abs(w).max()), 1e-30),
            err_msg=name)
    lr_sum = 0.0
    for batch, jm in zip(tbatches, j_metrics):
        state, m = setup.step_fn(state, batch)
        for key in ("loss", "grad_norm", "lr"):
            got, ref = float(m[key]), jm[key]
            assert abs(got - ref) <= TRAIN_REL * max(abs(ref), 1e-6), \
                f"{key}: port {got} vs reference {ref}"
        lr_sum += jm["lr"]
    assert int(state["opt"]["step"]) == TRAIN_STEPS
    for name, w in leaves_from_numpy(j_final, tcfg).items():
        np.testing.assert_allclose(params[name].detach().numpy(), w, rtol=0,
                                   atol=2 * lr_sum, err_msg=name)
    return setup
