"""Item 12b: the ssm, hybrid, MLA, enc-dec, VLM and encoder families on a
DTensor mesh, with ``mask`` / ``prefix_len``, given ``alpha`` / ``beta``
and the ``log_linear`` state.

One world-4 gloo spawn on mesh (2, 2) (``tests/_torch_dist.py:
families_on_mesh``) runs every case at SMOKE size in fp32, from the
reference's weights (serving) and initial train state (training),
converted through numpy:

* serving: a prefill and 5 greedy decode steps (6 tokens) through
  ``make_serve_setup(mesh=...)``; the tokens equal the meshless port's and
  the reference's, and every cache leaf's local shape is the one
  ``cache_shardings`` gives (checked on every rank after every step).
  mamba2-130m (heads whole on 'model'), zamba2-7b (``lln_diag`` and
  ``softmax``: the SSM heads and the shared block's heads split),
  deepseek-v2-236b (MLA and its MoE layers; ``softmax``: the absorbed
  decode over the latent cache split on its latent dim),
  seamless-m4t-medium (the bidirectional
  encoder, the cross-attention over ``src``), paligemma-3b (``softmax``
  with the patch prefix's ``prefix_len`` and its query rows over 'model';
  ``lln_diag``) and yi-9b ``log_linear`` (the Fenwick pyramid);
* training: 2 steps of ``make_train_setup(mesh=...)``, the losses within
  1e-5 (relative) of the meshless port's and the reference's, the same
  families and roberta-lln (MLM).  deepseek-v2 trains with
  ``router_aux_coef = 0``: on a mesh the MoE's aux loss is the mean of
  the shards' (the reference's too), a different number from the one
  batch's;
* attention calls: a key ``mask`` through roberta-lln's bidirectional
  ``lln_diag`` (batch over (data, model)), and given ``alpha`` / ``beta``
  through yi-9b's ``lln_diag`` attention and the engine's prefill (its
  state too), within 1e-5 of the largest entry of the meshless port's and
  the reference's.

The reference runs once per case in a module-scoped fixture, in a pool of
2 worker processes beside two world-4 spawns (serving; training and the
attention calls).
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_threads  # noqa: F401  (one torch thread per test worker)
from _torch_dist import (ATTN, LR, SERVE, SERVE_PORT, STEPS, TOTAL, TRAIN,
                         _attention_case, _attn_arrays, _port_serve,
                         _port_train, _serve_inputs, _train_over,
                         family_train_batches, spawn)
from _torch_families import _reference_init

import repro.launch.steps as j_steps
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.core.attention import multi_head_attention as j_mha
from repro.launch.mesh import compat_mesh
from repro.models import build_model as j_build_model
from repro.models.attention_block import attn_cfg_of as j_attn_cfg_of
from repro.models.attention_block import attn_engine as j_attn_engine
from repro_torch.configs import get_config

REL = 1e-5


def _init(arch):
    """The reference's initial train state as numpy, one per arch (the
    weights do not depend on the impl)."""
    return _reference_init(arch, "softmax")


def _reference_serve(arch, impl, over, inputs):
    """The reference's greedy tokens (the prefill's first, then ``STEPS``
    decode steps) of a serving case, as numpy."""
    cfg = j_get_config(arch, smoke=True, attn_impl=impl,
                       compute_dtype="float32", **over)
    model = j_build_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    logits, caches = jax.jit(model.prefill, static_argnums=2)(
        params, {k: jnp.asarray(v) for k, v in inputs["batch"].items()},
        inputs["max_len"])
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    decode = jax.jit(model.decode)
    toks = [tok]
    for i in range(STEPS):
        lg, caches = decode(params, caches, tok,
                            jnp.asarray(inputs["pos0"] + i, jnp.int32))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(tok)
    return np.stack([np.asarray(t) for t in toks], 1)


def _train_cfgs(arch, impl, over):
    kw = dict(smoke=True, attn_impl=impl, compute_dtype="float32",
              **_train_over(over))
    return j_get_config(arch, **kw), get_config(arch, **kw)


def _reference_train(arch, impl, over, state0, batches):
    """The reference's ``make_train_setup`` losses from ``state0``."""
    jcfg, _ = _train_cfgs(arch, impl, over)
    n = batches[0]["inputs"].shape[1] + (
        jcfg.num_prefix_tokens if jcfg.family == "vlm" else 0)
    mesh = compat_mesh((1, 1), ("data", "model"))
    with mesh:
        jsetup = j_steps.make_train_setup(
            jcfg, JShape("t", n, 2, "train"), mesh, multi_pod=False,
            peak_lr=LR, total_steps=TOTAL)
        state = jax.device_put(jax.tree_util.tree_map(jnp.array, state0),
                               jsetup.state_shardings)
        out = []
        for batch in batches:
            state, m = jsetup.step_fn(state, batch)
            out.append(float(m["loss"]))
    return out


def _reference_attention(arch, arrays):
    cfg = j_get_config(arch, smoke=True, attn_impl="lln_diag",
                       compute_dtype="float32")
    causal = bool(arrays["causal"])
    j = {k: jnp.asarray(v) for k, v in arrays.items() if k != "causal"}
    ab = {k: j[k] for k in ("alpha", "beta") if k in j}
    out = {"out": np.asarray(j_mha(j["q"], j["k"], j["v"],
                                   j_attn_cfg_of(cfg, causal),
                                   mask=j.get("mask"), **ab))}
    if ab:
        o, st = j_attn_engine(cfg, causal).prefill(
            j["q"], j["k"], j["v"], max_len=arrays["q"].shape[1], **ab)
        out["prefill"] = np.asarray(o)
        for f in ("s", "z", "alpha", "beta"):
            out[f] = np.asarray(getattr(st, f))
    return out


def _reference_case(kind, args):
    """One reference run in a worker process: an initial state, a serving
    case's tokens, or a training case's losses."""
    if kind == "init":
        return _init(*args)
    if kind == "serve":
        return _reference_serve(*args)
    return _reference_train(*args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs in a pool of 2 processes, the meshless port's
    here, and two world-4 spawns on (2, 2) running every case, in threads
    beside them."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx) as refs, \
            concurrent.futures.ThreadPoolExecutor(2) as mesh:
        archs = sorted({c[1] for c in SERVE + TRAIN})
        inits = dict(zip(archs, refs.map(_reference_case,
                                         ["init"] * len(archs),
                                         [(a,) for a in archs])))
        serve_in = {}
        for i, (name, arch, impl, over) in enumerate(SERVE + SERVE_PORT):
            params = inits[arch]["params"] if (name, arch, impl, over) \
                in SERVE else None
            serve_in[name] = _serve_inputs(arch, impl, over, i, params)
        train_in = {}
        for name, arch, impl, over in TRAIN:
            _, cfg = _train_cfgs(arch, impl, over)
            train_in[name] = (inits[arch], family_train_batches(cfg))
        attn_in = {name: _attn_arrays(name) for name in ATTN}
        # Two world-4 groups at once: the serving cases, and the training
        # and attention cases.
        serve_runs = mesh.submit(
            spawn, "_torch_dist:families_on_mesh", 4,
            tmp_path_factory.mktemp("serve"),
            [(name, arch, impl, over, serve_in[name]["params"],
              serve_in[name]["batch"], serve_in[name]["max_len"], STEPS,
              serve_in[name]["pos0"])
             for name, arch, impl, over in SERVE + SERVE_PORT], [], [])
        train_runs = mesh.submit(
            spawn, "_torch_dist:families_on_mesh", 4,
            tmp_path_factory.mktemp("train"), [],
            [(name, arch, impl, _train_over(over), *train_in[name], LR,
              TOTAL) for name, arch, impl, over in TRAIN],
            [(name, arch, "lln_diag", arrays)
             for name, (arch, arrays) in attn_in.items()])
        ref_serve = {name: refs.submit(_reference_case, "serve",
                                       (arch, impl, over, serve_in[name]))
                     for name, arch, impl, over in SERVE}
        ref_train = {name: refs.submit(_reference_case, "train",
                                       (arch, impl, over, *train_in[name]))
                     for name, arch, impl, over in TRAIN}
        want = {"serve": {}, "train": {}, "attn": {}}
        for name, arch, impl, over in SERVE + SERVE_PORT:
            want["serve"][name] = [None, _port_serve(arch, impl, over,
                                                     serve_in[name])]
        for name, arch, impl, over in TRAIN:
            want["train"][name] = [None, _port_train(arch, impl, over,
                                                     *train_in[name])]
        for name, (arch, arrays) in attn_in.items():
            want["attn"][name] = _reference_attention(arch, arrays)
        for name, fut in ref_serve.items():
            want["serve"][name][0] = fut.result()
        for name, fut in ref_train.items():
            want["train"][name][0] = fut.result()
        ranks = [{"serve": a["serve"], "train": b["train"],
                  "attn": b["attn"]}
                 for a, b in zip(serve_runs.result(), train_runs.result())]
    return want, ranks


@pytest.mark.parametrize("name", [c[0] for c in SERVE + SERVE_PORT])
def test_serves_on_a_2x2_mesh(runs, name):
    """Tokens equal to the meshless port's and (but for ``SERVE_PORT``)
    the reference's on every rank; some cache leaf is split on the
    mesh."""
    want, ranks = runs
    ref, port = want["serve"][name]
    if ref is not None:
        np.testing.assert_array_equal(port, ref,
                                      err_msg="meshless vs reference")
    for r in ranks:
        got = r["serve"][name]
        np.testing.assert_array_equal(got["tokens"], port, err_msg=name)
    assert ranks[0]["serve"][name]["split"] > 0, name


@pytest.mark.parametrize("name", [c[0] for c in TRAIN])
def test_trains_on_a_2x2_mesh(runs, name):
    """2 steps' losses within 1e-5 (relative) of the meshless port's and
    the reference's, equal on every rank; the state is split."""
    want, ranks = runs
    ref, port = want["train"][name]
    got = ranks[0]["train"][name]
    assert got["split"] > 0, name
    for i, (g, p, j) in enumerate(zip(got["loss"], port, ref)):
        assert abs(g - p) <= REL * abs(p), (name, i, g, p)
        assert abs(g - j) <= REL * abs(j), (name, i, g, j)
    for r in ranks[1:]:
        assert r["train"][name]["loss"] == got["loss"], name


@pytest.mark.parametrize("name", ATTN)
def test_attention_options_on_a_2x2_mesh(runs, name):
    """A key mask, and given alpha / beta (the engine's prefill and state
    too), on the mesh within 1e-5 of the largest entry of the meshless
    port's and of the reference's."""
    want, ranks = runs
    ref = want["attn"][name]
    for r in ranks:
        got, meshless = r["attn"][name]
        assert set(got) == set(ref) == set(meshless)
        for key, w in ref.items():
            tol = REL * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(meshless[key], w, rtol=0, atol=tol,
                                       err_msg=f"{name} {key} meshless")
            np.testing.assert_allclose(got[key], meshless[key], rtol=0,
                                       atol=tol, err_msg=f"{name} {key}")


def test_attention_case_runs_without_a_mesh():
    """The attention cases' meshless path in process (no group): the
    given constants reach the output (a scaled alpha changes it)."""
    arch, arrays = _attn_arrays("yi-9b alpha-beta")
    base = _attention_case(None, arch, "lln_diag", arrays)
    scaled = dict(arrays, alpha=arrays["alpha"] * 2)
    other = _attention_case(None, arch, "lln_diag", scaled)
    assert not np.allclose(base["out"], other["out"])
    np.testing.assert_allclose(other["alpha"], np.broadcast_to(
        scaled["alpha"], other["alpha"].shape))
