"""Item 12a: the mesh, the sharding rules, elastic resharding and sharded
checkpoints, with the dense and MoE decoders training and serving on a
DTensor mesh.

* In process, with no process group: duck-typed meshes (axis names and
  sizes; the reference's ``fit_spec`` reads only ``axis_names`` and
  ``devices.shape``) at (2, 4), (16, 16) and (2, 16, 16).  For every
  assigned arch's SMOKE tree the port's ``param_specs`` (params and AdamW
  moments), ``make_rules`` (``multi_pod`` and ``serve`` both ways),
  ``viable_mesh_shapes`` and ``cache_shardings`` of a SMOKE prefill's
  caches (the arch's default impl and ``lln_diag``) equal the reference's,
  each leaf's spec without the reference's leading layer axis.
* Spawned gloo process groups on the CPU (``tests/_torch_dist.py``):
  three at world 4 on mesh (2, 2) and one at world 2, with the ``batch``
  calibration pooled over the mesh.  Training: yi-9b SMOKE, ``lln_diag``
  and ``softmax``, 2 steps of ``make_train_setup(mesh=...)`` from the
  reference's converted initial state; losses within 1e-5 (relative) of
  the meshless port's and of the reference's, the AdamW moments within
  1e-5 of each leaf's largest entry of the meshless port's, every local
  shape the fitted spec's shard; and the train CLI under ``--mesh 2,2``.
  Serving: yi-9b (``tp_heads``, ``lln_diag``), qwen3-14b (``context``,
  ``softmax``: query rows over 'model') and an MQA override of yi-9b (one
  kv head: k/v replicated, the caches' feature dim split), prefill and 8
  greedy steps: tokens equal to the meshless port's and the reference's,
  cache local shapes as ``cache_shardings`` says.  qwen3-moe through the
  expert-parallel path.  Elastic: a world-4 save restored onto a world-2
  (2, 1) mesh decodes the same tokens.
* Item 12c, cases of the same world-4 spawn: the request pool on (2, 2)
  (the reference's elastic-pool config from its converted weights) equals
  the meshless port's and the reference's ``make_pool_setup`` segment,
  and again after ``make_degraded_mesh`` + ``reshard_state`` of the
  parameters and the pool caches onto the (1, 2) mesh; speculative pool
  rows, a mamba2 SMOKE pool, ``make_spec_setup`` against the reference's
  greedy tokens, the pool's engine with speculative rows on the mesh of
  ``mesh_from_flag(continuous=True, speculative=True)`` (every rank's
  batcher decides the same) and ``data.device_placer``.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)
from _torch_dist import spawn
from _torch_families import (TRAIN_BATCH, TRAIN_LR, TRAIN_REL, TRAIN_SEQ,
                             TRAIN_STEPS, _reference_init, port_batch,
                             train_batches, train_overrides)

import repro.launch.steps as j_steps
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.configs.registry import ASSIGNED_ARCHS
from repro.distributed import elastic as j_elastic
from repro.distributed import sharding as j_shd
from repro.launch.mesh import compat_mesh
from repro.models import build_model as j_build_model
from repro.models import synthetic_batch as j_synthetic_batch
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.data import torch_placer
from repro_torch.distributed import elastic, sharding as shd
from repro_torch.launch import steps, train
from repro_torch.models import build_model, synthetic_batch
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves_with_path, path_str

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
REL = 1e-5
CLI_ARGS = ["--arch", "yi-9b", "--smoke", "--attn-impl", "lln_diag",
            "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"]


def _duck(shape, names):
    return SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=shape))


def _ref_flat(tree) -> dict:
    return {j_shd._path_str(kp): leaf for kp, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _ref_path(port_path: str) -> str:
    return "/".join(p for p in port_path.split("/") if not p.isdigit())


def _same_spec(port, ref, ndim, what):
    """The port leaf's spec is the reference's without its leading
    (stacked-layer) axes."""
    ref = tuple(ref)
    assert tuple(port) == ref[len(ref) - ndim:], (what, port, ref)
    assert all(a is None for a in ref[:len(ref) - ndim]), (what, ref)


@pytest.fixture(scope="module")
def trees():
    """Per arch: the reference's train-state struct and the port's state
    (SMOKE, params and AdamW moments)."""
    out = {}
    for arch in ASSIGNED_ARCHS:
        jcfg = j_get_config(arch, smoke=True)
        jm = j_build_model(jcfg)
        jstate = jax.eval_shape(
            lambda key, jm=jm: {"params": jm.init(key),
                                "opt": j_adamw_init(jm.init(key))},
            jax.random.PRNGKey(0))
        params = build_model(get_config(arch, smoke=True), "cpu").init(0)
        out[arch] = (jstate, {"params": params, "opt": adamw_init(params)})
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_specs_match_the_reference(trees, mesh):
    duck = _duck(*MESHES[mesh])
    for arch, (jstate, state) in trees.items():
        want = _ref_flat(j_shd.param_specs(jstate, duck))
        got = shd.param_specs(state, duck)
        assert {shd.reference_path(tuple(k.split("/"))) for k in got} \
            == set(want), arch
        for (kp, leaf) in leaves_with_path(state):
            key = path_str(kp)
            _same_spec(got[key], want[shd.reference_path(kp)], leaf.ndim,
                       f"{arch} {key}")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("serve", [False, True])
def test_make_rules_match_the_reference(multi_pod, serve):
    for arch in ASSIGNED_ARCHS:
        for impl in ("softmax", "lln_diag"):
            got = shd.make_rules(get_config(arch, smoke=True,
                                            attn_impl=impl),
                                 multi_pod=multi_pod, serve=serve)
            want = j_shd.make_rules(j_get_config(arch, smoke=True,
                                                 attn_impl=impl),
                                    multi_pod=multi_pod, serve=serve)
            assert got == want, (arch, impl)


def test_viable_mesh_shapes_match_the_reference():
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 96, 128, 256, 255,
              384, 512):
        for prefer in (1, 2, 4, 8, 16, 32):
            assert elastic.viable_mesh_shapes(n, prefer) \
                == j_elastic.viable_mesh_shapes(n, prefer), (n, prefer)


@pytest.fixture(scope="module")
def prefills():
    """Per (arch, impl): the reference's SMOKE prefill caches (their
    structs) and the port's (real, at the same size)."""
    out = {}
    for arch in ASSIGNED_ARCHS:
        for impl in (None, "lln_diag"):
            over = {} if impl is None else {"attn_impl": impl}
            jcfg = j_get_config(arch, smoke=True, **over)
            jm = j_build_model(jcfg)
            jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
            jbatch = j_synthetic_batch(jcfg, 2, 24, text_seq=16)
            _, jcaches = jax.eval_shape(
                lambda p, b, jm=jm: jm.prefill(p, b, 24), jparams, jbatch)
            cfg = get_config(arch, smoke=True, **over)
            model = build_model(cfg, "cpu")
            _, caches = model.prefill(model.init(0), synthetic_batch(
                cfg, 2, 24, text_seq=16, device="cpu"), 24)
            out[arch, impl] = (jcfg, jcaches, cfg, caches)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_shardings_match_the_reference(prefills, mesh, monkeypatch):
    """The reference builds a NamedSharding per leaf, which wants a real
    mesh: here it gives back the spec instead."""
    monkeypatch.setattr(j_steps, "NamedSharding", lambda m, spec: spec)
    duck = _duck(*MESHES[mesh])
    multi_pod = len(MESHES[mesh][0]) == 3
    for (arch, impl), (jcfg, jcaches, cfg, caches) in prefills.items():
        want = _ref_flat(j_steps.cache_shardings(
            jcaches, jcfg, duck, j_shd.make_rules(
                jcfg, multi_pod=multi_pod, serve=True)))
        got = steps.cache_shardings(caches, cfg, duck, shd.make_rules(
            cfg, multi_pod=multi_pod, serve=True))
        assert {_ref_path(k) for k in got} == set(want), (arch, impl)
        for kp, leaf in leaves_with_path(caches):
            key = path_str(kp)
            _same_spec(got[key].spec, want[_ref_path(key)], leaf.ndim,
                       f"{arch} {impl} {key}")


def test_mesh_flag_refusals():
    """The CLIs' ``--mesh``: ``1,1`` is the meshless path; every family
    (MLA included) passes the family check since item 12b and reaches the
    mesh's own check, in every serving mode (the pool and speculative ones
    too, since item 12c); a mesh larger than the world raises
    ``ValueError`` before any group starts.  The pool's and the
    speculative loop's family refusals (MLA; a first-k-layers draft of an
    SSM) come before the mesh is read."""
    from repro_torch.configs.registry import list_archs
    from repro_torch.launch.mesh import (check_mesh_family, compat_mesh,
                                         mesh_from_flag)
    yi = get_config("yi-9b", smoke=True)
    assert mesh_from_flag("1,1", yi, "cpu") is None
    for arch in list_archs():
        assert check_mesh_family(get_config(arch, smoke=True)) is None
    for arch in ("mamba2-130m", "deepseek-v2-236b", "paligemma-3b",
                 "seamless-m4t-medium", "roberta-lln"):
        with pytest.raises(ValueError, match="4 devices needs 4 processes"):
            mesh_from_flag("2,2", get_config(arch, smoke=True), "cpu")
    for kw in ({"continuous": True}, {"speculative": True},
               {"continuous": True, "speculative": True}):
        with pytest.raises(ValueError, match="4 devices needs 4 processes"):
            mesh_from_flag("2,2", yi, "cpu", **kw)
    with pytest.raises(ValueError, match="4 devices needs 4 processes"):
        compat_mesh((2, 2), ("data", "model"), "cpu")
    assert not torch.distributed.is_initialized()
    for fn, arch, kw, msg in (
            (steps.make_pool_setup, "deepseek-v2-236b",
             {"slots": 2, "max_len": 8}, "continuous batching supports"),
            (steps.make_spec_setup, "mamba2-130m",
             {"shape": ShapeSpec("s", 8, 2, "decode"), "spec_k": 2,
              "draft_layers": 1}, "first-k-layers draft")):
        with pytest.raises(NotImplementedError, match=msg):
            fn(get_config(arch, smoke=True), device="cpu", mesh=object(),
               **kw)


# ---------------------------------------------------------------------------
# Multi-rank runs (gloo, spawned processes).
# ---------------------------------------------------------------------------

def _reference_losses(impl, state0, batches):
    """The reference's ``make_train_setup`` losses over ``batches`` from
    ``state0`` (numpy), at the train overrides of ``_torch_families``."""
    jcfg = j_get_config("yi-9b", smoke=True,
                        **train_overrides(impl, False))
    mesh = compat_mesh((1, 1), ("data", "model"))
    with mesh:
        jsetup = j_steps.make_train_setup(
            jcfg, JShape("t", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh,
            multi_pod=False, peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS)
        state = jax.device_put(jax.tree_util.tree_map(jnp.array, state0),
                               jsetup.state_shardings)
        out = []
        for batch in batches:
            state, m = jsetup.step_fn(state, batch)
            out.append({k: float(v) for k, v in m.items()})
    return out


def _reference_serve(arch, impl, over, prompt=20, steps=8):
    """The reference's SMOKE weights, batch and greedy tokens (the
    prefill's first, then ``steps`` decode steps), as numpy."""
    cfg = j_get_config(arch, smoke=True, attn_impl=impl,
                       compute_dtype="float32", **over)
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    max_len = prompt + steps + 1
    batch = j_synthetic_batch(cfg, TRAIN_BATCH, max_len, text_seq=prompt)
    logits, caches = jax.jit(model.prefill, static_argnums=2)(
        params, batch, max_len)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    decode = jax.jit(model.decode)
    toks = [tok]
    for i in range(steps):
        lg, caches = decode(params, caches, tok,
                            jnp.asarray(prompt + i, jnp.int32))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(tok)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": as_np(params), "batch": as_np(batch),
            "tokens": np.stack([np.asarray(t) for t in toks], 1),
            "max_len": max_len, "pos0": prompt, "steps": steps}


def _rel(got, want, what):
    assert abs(got - want) <= REL * max(abs(want), 1e-6), \
        f"{what}: {got} vs {want}"


def test_trains_on_a_2x2_mesh(tmp_path):
    """yi-9b SMOKE, 2 steps on (2, 2) against the meshless port and the
    reference, from the reference's initial state (``softmax`` with
    ``remat="full"`` and ``cast_params_once``); the train CLI under
    ``--mesh 2,2`` against its meshless run, with a ``--ckpt-dir`` save
    (gathered, rank 0 writes).

    The parameters after the steps are held within 2 x the summed
    learning rate and the AdamW moments within 1e-4 of each leaf's
    largest entry, as the port's other train tests hold them: the
    gradients' partial sums over the mesh are added in another order, and
    m / sqrt(v) turns such a rounding difference on a near-zero gradient
    into a full-size update difference (4e-5 on an entry of softmax's
    ``mlp.wo`` whose first moment is 2e-9)."""
    cases, wants = [], []
    for impl in ("lln_diag", "softmax"):
        over = {"use_kernel": False, "grad_accum": 1}
        if impl == "softmax":
            # DTensor parameters through the cast copies and remat (values
            # as without: the compute dtype is fp32).
            over.update(remat="full", cast_params_once=True)
        cfg = get_config("yi-9b", smoke=True, attn_impl=impl,
                         compute_dtype="float32", **over)
        batches = train_batches(cfg)[:2]
        state0 = _reference_init("yi-9b", impl)
        j_metrics = _reference_losses(impl, state0, batches)
        setup = steps.make_train_setup(
            cfg, ShapeSpec("t", 32, 2, "train"), "cpu", peak_lr=TRAIN_LR,
            total_steps=TRAIN_STEPS)
        state = train_state_from_numpy(state0, cfg, "cpu")
        place = torch_placer("cpu")
        losses = []
        for batch in batches:
            state, m = setup.step_fn(state, place(batch))
            losses.append(float(m["loss"]))
        wants.append((losses, [m["loss"] for m in j_metrics], state,
                      sum(m["lr"] for m in j_metrics)))
        cases.append(("yi-9b", impl, over, state0, batches, TRAIN_LR,
                      TRAIN_STEPS))
    ckpt = str(tmp_path / "ckpt")
    results = spawn("_torch_dist:train_on_mesh", 4, tmp_path, cases, ckpt)
    got, cli = results[0]
    for (impl, res), (losses, j_losses, state, lr_sum) in zip(
            zip(("lln_diag", "softmax"), got), wants):
        for i, (g, w, j) in enumerate(zip(res["loss"], losses, j_losses)):
            _rel(g, w, f"{impl} step {i} loss vs the meshless port")
            _rel(g, j, f"{impl} step {i} loss vs the reference")
        assert res["split"] > 0
        for name, p in state["params"].named_parameters():
            np.testing.assert_allclose(res["params"][name],
                                       p.detach().numpy(), rtol=0,
                                       atol=2 * lr_sum, err_msg=name)
            for mom in ("m", "v"):
                w = state["opt"][mom][name].numpy()
                np.testing.assert_allclose(
                    res[mom][name], w, rtol=0,
                    atol=TRAIN_REL * max(float(np.abs(w).max()), 1e-30),
                    err_msg=f"{impl} {mom} {name}")
    for r in results[1:]:
        assert [c["loss"] for c in r[0]] == [c["loss"] for c in got]
        assert r[1] == cli
    # The CLI's config computes in bf16: its losses agree to bf16's
    # rounding of the mesh's other summation order.
    plain = train.main(CLI_ARGS)
    assert len(cli) == len(plain) == 2
    for i, (g, h) in enumerate(zip(cli, plain)):
        assert abs(g - h["loss"]) <= 1e-3 * abs(h["loss"]), (i, g, h)
    assert sorted(os.listdir(ckpt)) == ["step_00000001", "step_00000002"]


SERVE_CASES = (("yi-9b", "yi-9b", "lln_diag", {}),
               ("qwen3-14b", "qwen3-14b", "softmax", {}),
               ("mqa", "yi-9b", "lln_diag", {"n_kv_heads": 1}))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reference's SMOKE serving runs (prompt 20, 8 greedy steps), the
    meshless port's tokens from the converted weights, the reference's
    elastic pool, and one world-4 spawn on (2, 2): the three serve cases,
    the MoE checks, the elastic save and item 12c's cases."""
    tmp = tmp_path_factory.mktemp("served")
    out = {}
    for name, arch, impl, over in SERVE_CASES:
        ref = _reference_serve(arch, impl, over)
        cfg = get_config(arch, smoke=True, attn_impl=impl,
                         compute_dtype="float32", **over)
        setup = steps.make_serve_setup(
            cfg, ShapeSpec("s", ref["max_len"], 2, "decode"), "cpu")
        params = params_from_numpy(ref["params"], cfg, "cpu")
        logits, caches = setup.prefill_fn(params, port_batch(ref))
        tok = torch.argmax(logits[:, -1], -1)
        toks, _ = setup.make_generate(ref["steps"])(
            params, caches, tok, ref["pos0"])
        out[name] = (arch, impl, over, ref,
                     torch.cat([tok[:, None], toks], 1).numpy())
    cases = [(arch, impl, over, ref["params"], ref["batch"],
              ref["max_len"], ref["steps"], ref["pos0"])
             for arch, impl, over, ref, _ in out.values()]
    moe_cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    ckpt = str(tmp / "elastic")
    pool_ref = _reference_pool()
    arch, impl, _, ref, _ = out["yi-9b"]
    ranks = spawn("_torch_dist:serve_on_mesh", 4, tmp, cases,
                  moe_cfg.n_experts / moe_cfg.top_k, ckpt,
                  pool_cases(pool_ref["params"]),
                  (arch, impl, ref["params"], ref["batch"], ref["max_len"],
                   SPEC_STEPS, ref["pos0"]))
    out["pool reference"] = pool_ref
    return out, ranks, ckpt, tmp


SPEC_STEPS = 4


def pool_cases(elastic_params) -> list:
    """Item 12c's pool cases: the reference's elastic-pool config from its
    converted weights, plain (then degraded) and with speculative rows
    (k = 2, a 1-layer draft); mamba2-130m SMOKE from the port's seeded
    weights."""
    return [{"name": "elastic", "arch": "elastic", "params": elastic_params,
             "spec_k": 0, "draft_layers": 0, "degrade": True},
            {"name": "elastic spec", "arch": "elastic",
             "params": elastic_params, "spec_k": 2, "draft_layers": 1},
            {"name": "mamba2", "arch": "mamba2-130m", "params": None,
             "spec_k": 0, "draft_layers": 0}]


def _reference_pool() -> dict:
    """The reference's ``make_pool_setup`` on its elastic-pool config (a
    (1, 1) mesh): the schedule of ``_torch_dist.pool_schedule`` admitted
    as one group, one segment.  Returns its weights (numpy) and each
    row's emitted tokens."""
    from _torch_dist import ELASTIC, POOL, flat_pool_tokens, pool_schedule
    from repro.configs.base import ArchConfig as JArchConfig
    from repro.launch.steps import make_pool_setup as j_make_pool_setup
    cfg = JArchConfig(**ELASTIC)
    params = j_build_model(cfg).init(jax.random.PRNGKey(0))
    sched = pool_schedule(cfg.vocab)
    mesh = compat_mesh((1, 1), ("data", "model"))
    with mesh:
        setup = j_make_pool_setup(cfg, mesh, **POOL)
        _, slot = setup.prefill_fn(8, 2)(params,
                                         jnp.asarray(sched["prompts"]))
        caches = setup.admit_fn(setup.cache_init(), slot,
                                jnp.asarray([0, 1], jnp.int32))
        out = setup.segment_fn(
            params, caches, jnp.asarray(sched["tok"], jnp.int32),
            jnp.asarray(sched["pos"], jnp.int32),
            jnp.asarray(sched["remaining"], jnp.int32),
            jnp.asarray([True, True]), jax.random.PRNGKey(2))
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "tokens": flat_pool_tokens({"tokens": np.asarray(out[5]),
                                        "emitted": np.asarray(out[6])})}


def test_serves_on_a_2x2_mesh(served):
    """Tokens on (2, 2) equal the meshless port's and the reference's;
    caches placed and split as ``cache_shardings`` says (checked on every
    rank after every step); qwen3-moe's expert-parallel path within 1e-5
    of its meshless path, reduce-scattered at n = 16 and all-reduced at
    n = 1, and a train step's loss on the mesh.  The MoE runs at capacity
    factor E / k, where no slot is dropped: the capacity is per rank's
    tokens, in the reference too."""
    out, ranks, _, _ = served
    got = ranks[0]
    for (name, (_, _, _, ref, port)), res in zip(out.items(),
                                                 got["serve"]):
        np.testing.assert_array_equal(port, ref["tokens"], err_msg=name)
        np.testing.assert_array_equal(res["tokens"], port, err_msg=name)
        assert res["split"] > 0, name
    for r in ranks[1:]:
        for a, b in zip(r["serve"], got["serve"]):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    moe = got["moe"]
    for kind, coll in (("prefill", "reduce_scatter_tensor"),
                       ("decode", "all_reduce")):
        assert moe[kind]["err"] <= REL * max(moe[kind]["scale"], 1.0), kind
        assert any(coll in op for op in moe[kind]["comm"]), moe[kind]
    from torch.distributed.tensor import Replicate, Shard
    assert moe["prefill"]["placements"] == (str(Shard(0)), str(Shard(1)))
    assert moe["decode"]["placements"] == (str(Shard(0)), str(Replicate()))
    (loss0, aux0), (loss1, aux1) = moe["train"]
    c = moe["aux_coef"]
    _rel(loss1 - c * aux1, loss0 - c * aux0, "MoE train loss without aux")


def test_elastic_restart_on_fewer_ranks(served):
    """A world-4 (2, 2) save of the params and the prefill's caches,
    restored with the shardings of a world-2 (2, 1) restart (every leaf
    bit for bit), decodes the tokens of the run that was not restarted;
    ``make_degraded_mesh`` over 3 surviving ranks of 4 is 2 ranks."""
    out, ranks, ckpt, tmp = served
    arch, impl, _, ref, port = out["yi-9b"]
    before = ranks[0]["elastic"]
    np.testing.assert_array_equal(before["tokens"], port[:, 1:])
    assert [r["elastic"]["degraded"] for r in ranks] == [
        ((1, 2), True)] * 2 + [((1, 2), False)] * 2
    after = spawn("_torch_dist:elastic_restore", 2, tmp, arch, impl,
                  ref["max_len"], TRAIN_BATCH, ref["steps"], ref["pos0"],
                  ckpt)
    assert after[0]["mesh"] == (2, 1)
    for r in after:
        np.testing.assert_array_equal(r["tokens"], before["tokens"])


def test_pools_on_a_2x2_mesh(served):
    """Item 12c: one segment of the request pool on (2, 2), two requests
    admitted as one group (caches placed by ``cache_shardings``, admit
    writing each rank's own rows), equals the meshless port's and the
    reference's ``make_pool_setup`` tokens at the reference's elastic
    config; the same pool, its parameters and caches resharded onto the
    (1, 2) mesh of ranks 0 and 1 (``make_degraded_mesh`` over 3 of 4
    ranks, then ``reshard_state``), gives the same segment; speculative
    rows (k = 2) emit the plain rows' tokens; a mamba2 SMOKE pool equals
    the meshless one.  The sentinel's flags agree on every rank."""
    from _torch_dist import flat_pool_tokens
    out, ranks, _, _ = served
    want = out["pool reference"]["tokens"]
    pools = ranks[0]["items"]["pool"]
    for name, runs in pools.items():
        base = flat_pool_tokens(runs["meshless"])
        for tag, run in runs.items():
            assert flat_pool_tokens(run) == base, (name, tag)
            assert not run["unhealthy"].any(), (name, tag)
    assert flat_pool_tokens(pools["elastic"]["meshless"]) == want
    assert "degraded" in pools["elastic"]
    spec = flat_pool_tokens(pools["elastic spec"]["mesh"])
    for row, toks in zip(want, spec):
        assert toks[:len(row)] == row
    for r in ranks[1:]:
        got = r["items"]["pool"]
        for name, runs in pools.items():
            np.testing.assert_array_equal(got[name]["mesh"]["tokens"],
                                          runs["mesh"]["tokens"])
        assert ("degraded" in got["elastic"]) == (r is ranks[1])


def test_speculative_decoding_on_a_2x2_mesh(served):
    """``make_spec_setup`` on (2, 2) (yi-9b SMOKE ``lln_diag`` from the
    reference's weights, k = 3, a 1-layer draft): the greedy tokens of the
    meshless port and of the reference's plain greedy loop.  The pool's
    engine with speculative rows, on the mesh ``mesh_from_flag`` gives
    for ``--continuous --speculative``, finishes every request with the
    meshless engine's tokens, the same on every rank."""
    out, ranks, _, _ = served
    ref = out["yi-9b"][3]
    spec = ranks[0]["items"]["spec"]
    np.testing.assert_array_equal(spec["mesh"], spec["meshless"])
    np.testing.assert_array_equal(spec["mesh"],
                                  ref["tokens"][:, :SPEC_STEPS + 1])
    bat = [r["batcher"] for r in ranks]
    assert all(b == bat[0] for b in bat[1:])
    assert bat[0]["mesh"] == bat[0]["meshless"]
    assert set(bat[0]["mesh"]["statuses"].values()) == {"done"}


def test_device_placer_places_like_mesh_placer(served):
    """``data.device_placer`` (the reference's name, by specs) places a
    numpy batch as ``mesh_placer`` does by placements, each rank its
    rows."""
    _, ranks, _, _ = served
    for r in ranks:
        assert all(r["placer"].values()), r["placer"]
