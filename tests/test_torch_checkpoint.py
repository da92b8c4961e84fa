"""The port's checkpoints, gradient compression and ``remat="dots"``.

* ``checkpoint/``: each case of the reference's ``tests/test_checkpoint.py``
  on the port's trees (nested dicts, lists, dataclasses, ``nn.Module``
  parameters): roundtrip, atomicity, CRC corruption, async saves and
  garbage collection, manager resume, shape mismatch, a missing leaf, a
  truncated step skipped and removed, the legacy ``"ok"`` sentinel, the
  sidecar manifest, and bf16 stored as its bits (no ``ml_dtypes``), back
  bit for bit; ``save_async`` keeps what it was given when the tensors
  change in place right after the call.
* ``optim/compression.py`` against the reference on the same numpy
  inputs: the int8 codes and scales bitwise, the residual and the
  decompressed gradients within 1e-6 of the largest entry.
* ``remat="dots"``: one AdamW step of yi-9b SMOKE (``lln_diag``,
  ``use_kernel`` False and True) and of roberta-lln SMOKE held to
  ``jax.grad`` of the reference with ``remat="dots"`` within the train
  tolerance (1e-4 of each leaf's largest entry; loss and grad norm 1e-4
  relative), and bitwise to the port's ``remat="none"`` gradients.
* The train CLI resumes through ``--ckpt-dir`` (the reference's
  ``tests/test_system.py`` restart case), and a resume from a
  ``maybe_save`` checkpoint runs the same losses in both packages from
  the same converted state: the saved state is the one after step
  ``step`` and the resume starts at ``step``, the reference's step labels.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.launch.mesh import compat_mesh
from repro.launch.steps import make_train_setup as j_make_train_setup
from repro.models import build_model as j_build_model
from repro.optim import adamw_init as j_adamw_init
from repro.optim import global_norm as j_global_norm
from repro.optim import compression as jcomp
from repro_torch.checkpoint import (AsyncCheckpointer, CheckpointManager,
                                    committed_steps, is_valid, read_extra,
                                    restore, save, valid_steps)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import leaves_from_numpy, train_state_from_numpy
from repro_torch.core.engine import AttentionState
from repro_torch.data import torch_placer
from repro_torch.data.synthetic import lm_batches, mlm_batches
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_setup
from repro_torch.optim import (bf16_allreduce_cast, ef_compress,
                               ef_decompress, ef_init)
from repro_torch.tree import leaves_with_path, map_with_path

REL = 1e-4          # the train tolerance of tests/test_torch_train.py


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "b": torch.zeros(8)},
            "opt": {"m": {"w": torch.ones(8, 8), "b": torch.ones(8)},
                    "step": torch.tensor(7, dtype=torch.int32)},
            "caches": [AttentionState(s=torch.randn(2, 3, generator=g),
                                      pos=torch.tensor([4, 5],
                                                       dtype=torch.int32))]}


def _map(fn, tree):
    return map_with_path(lambda _, t: fn(t), tree)


def _assert_trees_equal(a, b):
    la, lb = list(leaves_with_path(a)), list(leaves_with_path(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, p
        assert torch.equal(x, y), p


def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 5, t)
    out = restore(str(tmp_path), 5, _map(torch.zeros_like, t))
    _assert_trees_equal(out, t)
    assert isinstance(out["caches"][0], AttentionState)
    assert out["caches"][0].k is None


def test_module_restores_in_place(tmp_path):
    """An ``nn.Module`` of the template is filled in place and returned;
    the saved paths are its parameter names."""
    src = torch.nn.Linear(4, 3)
    save(str(tmp_path), 1, {"params": src})
    dst = torch.nn.Linear(4, 3)
    out = restore(str(tmp_path), 1, {"params": dst})
    assert out["params"] is dst
    assert torch.equal(dst.weight, src.weight)
    index = json.loads((tmp_path / "step_00000001" / "index.json")
                       .read_text())
    assert sorted(m["path"] for m in index["leaves"].values()) == \
        ["params/bias", "params/weight"]


def test_atomicity_ignores_uncommitted(tmp_path):
    save(str(tmp_path), 1, _tree())
    (tmp_path / "step_00000002").mkdir()     # a crashed write
    assert committed_steps(str(tmp_path)) == [1]


def test_crc_corruption_detection(tmp_path):
    t = _tree()
    save(str(tmp_path), 3, t)
    idx = tmp_path / "step_00000003" / "index.json"
    meta = json.loads(idx.read_text())
    meta["leaves"][next(iter(meta["leaves"]))]["crc"] ^= 0xFF
    idx.write_text(json.dumps(meta))
    with pytest.raises(IOError):
        restore(str(tmp_path), 3, _map(torch.zeros_like, t))


def test_async_and_gc(tmp_path):
    ckpt = AsyncCheckpointer(str(tmp_path), keep_n=2)
    for s in (10, 20, 30, 40):
        ckpt.save_async(s, _tree(s))
    ckpt.wait()
    assert committed_steps(str(tmp_path)) == [30, 40]


def test_save_async_snapshots_before_returning(tmp_path):
    """The port's AdamW updates in place: what ``save_async`` was given
    is what lands on disk, even when the tensors change right after the
    call returns."""
    t = _tree(1)
    want = _map(torch.clone, t)
    ckpt = AsyncCheckpointer(str(tmp_path))
    ckpt.save_async(1, t)
    for _, leaf in leaves_with_path(t):
        leaf.add_(1)
    ckpt.wait()
    _assert_trees_equal(restore(str(tmp_path), 1, _map(torch.zeros_like,
                                                       t)), want)


def test_manager_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=2, keep_n=3)
    state, start = mgr.restore_or_init(lambda: _tree(1))
    assert start == 0
    mgr.maybe_save(1, state)                 # off the interval: no save
    mgr.maybe_save(2, state)
    mgr.async_ckpt.wait()
    assert committed_steps(str(tmp_path)) == [2]
    state2, start2 = CheckpointManager(str(tmp_path), interval=2) \
        .restore_or_init(lambda: _tree(99))
    assert start2 == 2
    _assert_trees_equal(state2, state)


def test_shape_mismatch_raises(tmp_path):
    save(str(tmp_path), 1, {"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError):
        restore(str(tmp_path), 1, {"w": torch.zeros(8, 8)})


def test_missing_leaf_raises(tmp_path):
    save(str(tmp_path), 1, {"w": torch.zeros(4)})
    with pytest.raises(KeyError):
        restore(str(tmp_path), 1, {"w": torch.zeros(4),
                                   "extra": torch.zeros(2)})


def test_truncated_checkpoint_skipped_and_gced(tmp_path):
    """A committed but truncated step never becomes ``latest_step``: the
    size manifest catches it, and its directory is removed so that it
    cannot shadow the older restorable step."""
    mgr = CheckpointManager(str(tmp_path), interval=1)
    save(str(tmp_path), 1, _tree(1))
    save(str(tmp_path), 2, _tree(2))
    shard = tmp_path / "step_00000002" / "shard_0.npz"
    data = shard.read_bytes()
    shard.write_bytes(data[: len(data) // 2])
    assert committed_steps(str(tmp_path)) == [1, 2]
    assert valid_steps(str(tmp_path)) == [1]
    assert mgr.latest_step() == 1
    assert not (tmp_path / "step_00000002").exists()
    state, start = mgr.restore_or_init(lambda: _tree(0))
    assert start == 1
    assert torch.equal(state["params"]["w"], _tree(1)["params"]["w"])


def test_legacy_ok_sentinel_still_restorable(tmp_path):
    save(str(tmp_path), 4, _tree(4))
    (tmp_path / "step_00000004" / "_COMMITTED").write_text("ok")
    assert is_valid(str(tmp_path), 4)
    assert CheckpointManager(str(tmp_path), interval=1).latest_step() == 4


def test_extra_sidecar_roundtrip_and_manifest(tmp_path):
    save(str(tmp_path), 1, _tree(),
         extra={"meta.json": json.dumps({"queue": [3, 4]})})
    assert json.loads(read_extra(str(tmp_path), 1, "meta.json")) == \
        {"queue": [3, 4]}
    (tmp_path / "step_00000001" / "meta.json").write_text("x")
    assert not is_valid(str(tmp_path), 1)


def test_bf16_roundtrip_without_ml_dtypes(tmp_path):
    """bf16 is stored as its uint16 bits, the dtype named in the index,
    and read back bit for bit (NaN, -0.0 and subnormals included)."""
    bits = torch.from_numpy(np.array(
        [0x3F80, 0x8000, 0x7FC1, 0x0001, 0xFF80, 0x4049],
        np.uint16).view(np.int16))
    t = {"x": bits.view(torch.bfloat16),
         "y": torch.arange(8, dtype=torch.float32).to(torch.bfloat16)}
    save(str(tmp_path), 1, t)
    index = json.loads((tmp_path / "step_00000001" / "index.json")
                       .read_text())
    assert {m["dtype"] for m in index["leaves"].values()} == {"bfloat16"}
    with np.load(tmp_path / "step_00000001" / "shard_0.npz") as data:
        assert {data[k].dtype for k in data.files} == {np.dtype(np.uint16)}
    out = restore(str(tmp_path), 1, _map(torch.zeros_like, t))
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"].view(torch.int16), bits)
    assert torch.equal(out["y"], t["y"])


# ---------------------------------------------------------------------------
# Gradient compression against the reference.
# ---------------------------------------------------------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(64, 64)).astype(np.float32),
            "b": {"c": (rng.normal(size=(37,)) * 1e-3).astype(np.float32)}}


def test_ef_compression_matches_the_reference():
    """Two rounds of error feedback: int8 codes and scales bitwise, the
    residual and the decompressed gradients within 1e-6 of the largest
    entry (the reference's own roundtrip bound)."""
    g0, g1 = _grads(0), _grads(1)
    tj = jax.tree_util.tree_map(jnp.asarray, g0)
    tt = jax.tree_util.tree_map(torch.from_numpy, g0)
    jres, tres = jcomp.ef_init(tj), ef_init(tt)
    for g in (g0, g1):
        jq, jres = jcomp.ef_compress(jax.tree_util.tree_map(jnp.asarray, g),
                                     jres)
        tq, tres = ef_compress(jax.tree_util.tree_map(torch.from_numpy, g),
                               tres)
        for path in (("w",), ("b", "c")):
            jqq, tqq = jq, tq
            jr, tr = jres, tres
            for k in path:
                jqq, tqq, jr, tr = jqq[k], tqq[k], jr[k], tr[k]
            assert tqq[0].dtype == torch.int8
            np.testing.assert_array_equal(tqq[0].numpy(), np.asarray(jqq[0]))
            assert np.float32(tqq[1].item()) == np.float32(jqq[1])
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                       atol=1e-6 * float(np.abs(jr).max()))
    jd, td = jcomp.ef_decompress(jq), ef_decompress(tq)
    np.testing.assert_allclose(td["w"].numpy(), np.asarray(jd["w"]), rtol=0,
                               atol=1e-6 * float(np.abs(jd["w"]).max()))
    # One round from a zero residual: the residual is the quantization
    # error exactly.
    g = {"w": torch.from_numpy(g0["w"])}
    q, res = ef_compress(g, ef_init(g))
    assert torch.equal(res["w"], g["w"] - ef_decompress(q)["w"])


def test_bf16_allreduce_cast():
    out = bf16_allreduce_cast({"w": torch.ones(4), "b": [torch.ones(2)]})
    assert out["w"].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# remat="dots" against jax.grad of the reference.
# ---------------------------------------------------------------------------

BATCH, SEQ, LR, TOTAL = 2, 32, 1e-3, 3


def _reference_step(jcfg, batch):
    """(initial state, first gradients, the first step's loss and grad
    norm), numpy; the reference's train step takes the same value, gradient
    and global norm before its AdamW update."""
    with compat_mesh((1, 1), ("data", "model")):
        jmodel = j_build_model(jcfg)
        params = jmodel.init(jax.random.PRNGKey(0))
        state0 = jax.tree_util.tree_map(
            np.asarray, {"params": params, "opt": j_adamw_init(params)})
        loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(params, batch)
        metrics = {"loss": float(loss),
                   "grad_norm": float(j_global_norm(grads))}
    return state0, jax.tree_util.tree_map(np.asarray, grads), metrics


@pytest.mark.parametrize("arch,impl,use_kernel", [
    ("yi-9b", "lln_diag", False), ("yi-9b", "lln_diag", True),
    ("roberta-lln", "lln_diag", True)],
    ids=["yi-9b-core", "yi-9b-kernel", "roberta-lln-kernel"])
def test_remat_dots_matches_the_reference(arch, impl, use_kernel):
    over = dict(attn_impl=impl, compute_dtype="float32",
                use_kernel=use_kernel, remat="dots")
    jcfg = j_get_config(arch, smoke=True, **over)
    tcfg = get_config(arch, smoke=True, **over)
    batches = mlm_batches if tcfg.family == "encoder" else lm_batches
    batch = next(batches(jcfg.vocab, BATCH, SEQ, seed=0))
    state0, grads0, jm = _reference_step(jcfg, batch)
    tbatch = torch_placer("cpu")(batch)

    grads = {}
    for remat in ("none", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        setup = make_train_setup(cfg, ShapeSpec("t", SEQ, BATCH, "train"),
                                 device="cpu", peak_lr=LR, total_steps=TOTAL)
        state = train_state_from_numpy(state0, cfg, "cpu")
        params = dict(state["params"].named_parameters())
        loss = setup.model.loss(state["params"], tbatch)
        grads[remat] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        if remat == "dots":
            _, m = setup.step_fn(state, tbatch)
            for key in ("loss", "grad_norm"):
                assert abs(float(m[key]) - jm[key]) <= \
                    REL * max(abs(jm[key]), 1e-6), key
    want = leaves_from_numpy(grads0, tcfg)
    assert set(want) == set(grads["dots"])
    for name, g in grads["dots"].items():
        w = want[name]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=REL * max(float(np.abs(w).max()), 1e-30), err_msg=name)
        assert torch.equal(g, grads["none"][name]), name


# ---------------------------------------------------------------------------
# Resume: the CLI, and the step labels against the reference.
# ---------------------------------------------------------------------------

def test_train_cli_with_restart(tmp_path):
    """Run 6 steps, 'crash', resume to 10 (the reference's system test)."""
    ckpt = str(tmp_path / "ckpt")
    base = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--ckpt-dir", ckpt,
            "--ckpt-interval", "2", "--log-every", "100"]
    h1 = train.main(base + ["--steps", "6"])
    h2 = train.main(base + ["--steps", "10"])
    assert h1[-1]["step"] == 5
    assert h2[0]["step"] >= 6, "resume must continue, not restart"
    assert h2[-1]["step"] == 9
    assert committed_steps(ckpt)[-1] == 10


def test_train_cli_resumes_at_the_saved_step(tmp_path):
    """``--steps 4 --ckpt-interval 2`` leaves steps 2 and 4 (the final
    one); ``--steps 6`` resumes at step 4."""
    ckpt = str(tmp_path / "ckpt")
    base = ["--arch", "yi-9b", "--smoke", "--device", "cpu", "--batch",
            "4", "--seq", "32", "--ckpt-dir", ckpt, "--ckpt-interval", "2"]
    train.main(base + ["--steps", "4"])
    assert committed_steps(ckpt) == [2, 4]
    hist = train.main(base + ["--steps", "6"])
    assert [h["step"] for h in hist] == [4, 5]


def test_resume_step_labels_match_the_reference(tmp_path):
    """Both packages from the same converted state: 4 steps with
    ``maybe_save`` every 2 (the state after step 2 saved under label 2),
    then a resume that starts at step 2 and runs steps 2-4 again from the
    restored state.  The AdamW counters say 3 updates were saved; the
    losses after the resume agree within the train tolerance."""
    cfg_kw = dict(attn_impl="lln_diag", compute_dtype="float32")
    jcfg = j_get_config("yi-9b", smoke=True, **cfg_kw)
    tcfg = get_config("yi-9b", smoke=True, **cfg_kw)
    gen = lm_batches(jcfg.vocab, BATCH, SEQ, seed=0)
    batches = [next(gen) for _ in range(5)]
    place = torch_placer("cpu")
    mesh = compat_mesh((1, 1), ("data", "model"))

    def loop(step_fn, mgr, state, start, stop):
        losses = []
        for step in range(start, stop):
            state, m = step_fn(state, batches[step] if mgr[1] == "j"
                               else place(batches[step]))
            losses.append(float(m["loss"]))
            mgr[0].maybe_save(step, state)
        mgr[0].async_ckpt.wait()
        return state, losses

    with mesh:
        jsetup = j_make_train_setup(jcfg, JShape("t", SEQ, BATCH, "train"),
                                    mesh, multi_pod=False, peak_lr=LR,
                                    total_steps=8)
        jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
        jstate = {"params": jparams, "opt": j_adamw_init(jparams)}
        state0 = jax.tree_util.tree_map(np.asarray, jstate)
        jdir = str(tmp_path / "jax")
        loop(jsetup.step_fn, (JManager(jdir, interval=2), "j"), jstate, 0, 4)
        jstate, jstart = JManager(jdir, interval=2).restore_or_init(
            lambda: {"params": jparams, "opt": j_adamw_init(jparams)})
        jsaved_updates = int(jstate["opt"]["step"])
        _, jlosses = loop(jsetup.step_fn, (JManager(jdir, interval=100), "j"),
                          jstate, jstart, 5)

    setup = make_train_setup(tcfg, ShapeSpec("t", SEQ, BATCH, "train"),
                             device="cpu", peak_lr=LR, total_steps=8)
    tdir = str(tmp_path / "torch")
    loop(setup.step_fn, (CheckpointManager(tdir, interval=2), "t"),
         train_state_from_numpy(state0, tcfg, "cpu"), 0, 4)
    state, start = CheckpointManager(tdir, interval=2).restore_or_init(
        lambda: setup.init_state(5))
    saved_updates = int(state["opt"]["step"])
    _, losses = loop(setup.step_fn, (CheckpointManager(tdir, interval=100),
                                     "t"), state, start, 5)

    assert start == jstart == 2
    assert saved_updates == jsaved_updates == 3
    assert len(losses) == len(jlosses) == 3
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= REL * abs(want), (losses, jlosses)


def test_remat_dots_keeps_the_matrix_products():
    """The backward of ``remat="dots"`` recomputes no matrix product of the
    blocks (``aten.mm`` / ``addmm`` outputs are kept), as ``none`` does;
    ``full`` recomputes them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.n += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in ("none", "full", "dots"):
        cfg = get_config("yi-9b", smoke=True, attn_impl="lln_diag",
                         compute_dtype="float32", remat=remat)
        model = make_train_setup(cfg, ShapeSpec("t", SEQ, BATCH, "train"),
                                 device="cpu").model
        params = model.init(0)
        batch = torch_placer("cpu")(next(lm_batches(cfg.vocab, BATCH, SEQ,
                                                    seed=0)))
        loss = model.loss(params, batch)
        with CountMM() as mode:
            loss.backward()
        counts[remat] = mode.n
    assert counts["dots"] == counts["none"] < counts["full"], counts
