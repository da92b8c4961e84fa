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
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import synthetic_batch as j_synthetic_batch
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
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
