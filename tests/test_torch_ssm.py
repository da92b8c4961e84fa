"""The ssm/hybrid training slice: mamba2-130m and zamba2-7b SMOKE trained by
the port against the JAX reference.

Weights and the initial train state come from the reference through numpy
(``convert.params_from_numpy`` / ``train_state_from_numpy``); both packages
run fp32 compute (``compute_dtype="float32"``) on the same numpy inputs and
``lm_batches`` batches.  Held, with the tolerance stated at each:
- the core scan ``ssd_chunked`` (y and the final state, with a carried
  ``state0``, whole and ragged L): 1e-5 of the largest reference entry;
- ``ssm_apply`` with ``use_kernel`` off (the core scan) and on (the
  ``ssd_scan`` op; the reference runs its Pallas kernel in interpret
  mode), and with ``return_state``: 1e-5 of the largest entry;
- ``hybrid_hidden`` and the tied-head logits for mamba2-130m and zamba2-7b
  (``lln``, ``lln_diag``): 1e-4 of the largest entry, as the dense slice;
- 3 AdamW steps of both packages' ``make_train_setup`` for mamba2-130m and
  zamba2-7b (``lln_diag``) x ``use_kernel``: each step's loss, grad norm
  and lr within 1e-4 relative, as ``tests/test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.launch.mesh import compat_mesh
from repro.launch.steps import make_train_setup as j_make_train_setup
from repro.models import build_model as j_build_model
from repro.models import hybrid as j_hy
from repro.models import ssm as j_ssm
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.data import torch_placer
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_setup
from repro_torch.models import build_model
from repro_torch.models import hybrid as hy
from repro_torch.models import ssm

BATCH, SEQ, STEPS = 2, 32, 3
LR, TOTAL = 1e-3, 3
CORE, MODEL, REL = 1e-5, 1e-4, 1e-4


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _cfgs(arch, **over):
    over = dict(compute_dtype="float32", **over)
    return j_get_config(arch, smoke=True, **over), get_config(
        arch, smoke=True, **over)


@pytest.mark.parametrize("l", [48, 40], ids=["whole-chunks", "ragged-l40"])
def test_ssd_chunked_matches_the_reference(l):
    rng = np.random.default_rng(l)
    b, h, p, s = 2, 4, 8, 4
    xbar = rng.normal(size=(b, l, h, p)).astype(np.float32)
    b_in = rng.normal(size=(b, l, h, s)).astype(np.float32)
    c_in = rng.normal(size=(b, l, h, s)).astype(np.float32)
    log_a = -np.logaddexp(rng.normal(size=(b, l, h)), 0.0).astype(np.float32)
    state0 = rng.normal(size=(b, h, s, p)).astype(np.float32)
    for s0 in (None, state0):
        jy, js = j_ssm.ssd_chunked(
            *(jnp.asarray(a) for a in (xbar, b_in, c_in, log_a)), chunk=16,
            state0=None if s0 is None else jnp.asarray(s0))
        ty, ts = ssm.ssd_chunked(
            *(torch.from_numpy(a) for a in (xbar, b_in, c_in, log_a)),
            chunk=16, state0=None if s0 is None else torch.from_numpy(s0))
        _close(ty, jy, CORE)
        _close(ts, js, CORE)


def _ssd_grad_inputs(seed, l, b=2, h=4, p=8, s=4):
    rng = np.random.default_rng(seed)
    xbar = rng.normal(size=(b, l, h, p)).astype(np.float32)
    b_in = rng.normal(size=(b, l, h, s)).astype(np.float32)
    c_in = rng.normal(size=(b, l, h, s)).astype(np.float32)
    log_a = -np.logaddexp(rng.normal(size=(b, l, h)), 0.0).astype(np.float32)
    wy = rng.normal(size=(b, l, h, p)).astype(np.float32)
    ws = rng.normal(size=(b, h, s, p)).astype(np.float32)
    return (xbar, b_in, c_in, log_a), wy, ws


def _torch_ssd_grads(args, wy, ws, chunk):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, st = ssm.ssd_chunked(*ts, chunk=chunk)
    loss = (y * torch.from_numpy(wy)).sum() + (st * torch.from_numpy(ws)).sum()
    return y, torch.autograd.grad(loss, ts)


@pytest.mark.parametrize("l", [64, 40], ids=["whole-chunks", "ragged-l40"])
def test_ssd_chunked_remat_keeps_the_reference_gradients(l):
    """Each chunk step runs under torch.utils.checkpoint when grad is on;
    y and the gradients of xbar, B, C and log a match jax.grad of the
    reference (whose step is under jax.checkpoint), 1e-5 of the largest
    entry."""
    args, wy, ws = _ssd_grad_inputs(l + 1, l)

    def j_loss(*a):
        y, st = j_ssm.ssd_chunked(*a, chunk=16)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in args))
    jy, _ = j_ssm.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=16)
    y, got = _torch_ssd_grads(args, wy, ws, 16)
    _close(y, jy, CORE)
    for gt, wt in zip(got, want):
        _close(gt, wt, CORE)


def test_ssd_chunked_remat_saves_fewer_bytes(monkeypatch):
    """Autograd keeps less with the per-chunk remat than without it (the
    checkpoint replaced by a direct call), at 8 chunks of 16, and the
    gradients are equal."""
    args, wy, ws = _ssd_grad_inputs(0, 128)

    def saved_bytes():
        total = []

        def pack(t):
            total.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            _, grads = _torch_ssd_grads(args, wy, ws, 16)
        return sum(total), grads

    remat, g_remat = saved_bytes()
    monkeypatch.setattr(ssm, "checkpoint",
                        lambda fn, *a, use_reentrant=None: fn(*a))
    plain, g_plain = saved_bytes()
    assert remat < plain / 2, (remat, plain)
    for a, b in zip(g_remat, g_plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ssm_apply_matches_the_reference():
    """One Mamba2 block (layer 0 of the converted mamba2-130m SMOKE): the
    core scan, the ``ssd_scan`` op and the state-emitting forward."""
    jcfg, tcfg = _cfgs("mamba2-130m")
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(2))
    block = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu").layers[0].ssm
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["ssm"])
    x = np.random.default_rng(2).normal(size=(2, 32, jcfg.d_model)).astype(
        np.float32)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        for use_kernel in (False, True):
            want = j_ssm.ssm_apply(jp, jnp.asarray(x),
                                   jcfg.replace(use_kernel=use_kernel))
            got = ssm.ssm_apply(block, tx, tcfg.replace(use_kernel=use_kernel))
            _close(got, want, CORE)
        want, jcache = j_ssm.ssm_apply(jp, jnp.asarray(x), jcfg,
                                       return_state=True)
        got, cache = ssm.ssm_apply(block, tx, tcfg, return_state=True)
    _close(got, want, CORE)
    _close(cache["state"], jcache["state"], CORE)
    _close(cache["conv"], jcache["conv"], CORE)


@pytest.mark.parametrize("arch,impl", [("mamba2-130m", None),
                                       ("zamba2-7b", "lln"),
                                       ("zamba2-7b", "lln_diag")])
def test_hybrid_hidden_and_logits_match_the_reference(arch, impl):
    over = {"use_kernel": True} if impl is None else {"attn_impl": impl,
                                                      "use_kernel": True}
    jcfg, tcfg = _cfgs(arch, **over)
    batch = next(lm_batches(jcfg.vocab, BATCH, SEQ, seed=1))
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    j_hidden, _ = jmodel.hidden(jparams, batch)
    j_logits, _ = j_hy.hybrid_logits(jparams, batch["inputs"], jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               tcfg, "cpu")
    assert hasattr(params, "shared") == (arch == "zamba2-7b")
    assert not hasattr(params, "lm_head") == tcfg.tie_embeddings
    tbatch = torch_placer("cpu")(batch)
    with torch.no_grad():
        hidden, aux = build_model(tcfg, "cpu").hidden(params, tbatch)
        logits, _ = hy.hybrid_logits(params, tbatch["inputs"], tcfg)
    assert float(aux) == 0.0
    _close(hidden, j_hidden, MODEL)
    _close(logits, j_logits, MODEL)


def _rel_close(got, want, what):
    assert abs(got - want) <= REL * max(abs(want), 1e-6), \
        f"{what}: port {got} vs reference {want}"


@pytest.mark.parametrize("arch,impl,use_kernel", [
    ("mamba2-130m", None, False), ("mamba2-130m", None, True),
    ("zamba2-7b", "lln_diag", False), ("zamba2-7b", "lln_diag", True)],
    ids=["mamba2-core", "mamba2-kernel", "zamba2-lln_diag-core",
         "zamba2-lln_diag-kernel"])
def test_port_trains_like_the_reference(arch, impl, use_kernel):
    over = {"use_kernel": use_kernel}
    if impl:
        over["attn_impl"] = impl
    jcfg, tcfg = _cfgs(arch, **over)
    gen = lm_batches(jcfg.vocab, BATCH, SEQ, seed=0)
    batches = [next(gen) for _ in range(STEPS)]
    with compat_mesh((1, 1), ("data", "model")) as mesh:
        jsetup = j_make_train_setup(jcfg, JShape("t", SEQ, BATCH, "train"),
                                    mesh, multi_pod=False, peak_lr=LR,
                                    total_steps=TOTAL)
        params = j_build_model(jcfg).init(jax.random.PRNGKey(0))
        jstate = {"params": params, "opt": j_adamw_init(params)}
        state = train_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jstate), tcfg, "cpu")
        j_metrics = []
        for batch in batches:
            jstate, m = jsetup.step_fn(jstate, batch)
            j_metrics.append({k: float(v) for k, v in m.items()})

    setup = make_train_setup(tcfg, ShapeSpec("t", SEQ, BATCH, "train"),
                             device="cpu", peak_lr=LR, total_steps=TOTAL)
    place = torch_placer("cpu")
    for batch, jm in zip(batches, j_metrics):
        state, m = setup.step_fn(state, place(batch))
        for key in ("loss", "grad_norm", "lr"):
            _rel_close(float(m[key]), jm[key], key)
    assert int(state["opt"]["step"]) == STEPS


@pytest.mark.parametrize("argv", [["--arch", "mamba2-130m"],
                                  ["--arch", "zamba2-7b", "--attn-impl",
                                   "lln_diag"]])
def test_train_cli_on_cpu(argv):
    hist = train.main(argv + ["--smoke", "--device", "cpu", "--steps", "3",
                              "--seq", "32", "--batch", "2"])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_ssm_entry_points_raise_where_unported_or_without_a_device(
        monkeypatch):
    """The serving entry points now serve (``tests/test_torch_hybrid_serve.py``
    holds them against the reference), zamba2-7b trains with its default
    softmax shared block, and without a card and without an explicit
    device every entry point still raises."""
    cfg = get_config("mamba2-130m", smoke=True)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    tokens = torch.zeros(2, 8, dtype=torch.int64)
    logits, caches = model.prefill(params, {"inputs": tokens}, 12)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    logits, caches = model.decode(params, caches, tokens[:, 0], 8)
    assert logits.shape == (2, cfg.padded_vocab)
    assert len(model.cache_init(params, 2, 12)["layers"]) == cfg.n_layers
    hist = train.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
                       "--steps", "1", "--seq", "32", "--batch", "2"])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("mamba2-130m", "zamba2-7b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(get_config(arch, smoke=True, attn_impl="lln_diag"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "mamba2-130m", "--smoke", "--steps", "1"])
