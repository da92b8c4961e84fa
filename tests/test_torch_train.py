"""The whole slice: yi-9b SMOKE trained by the port against the JAX reference.

The reference's initial train state (params and AdamW moments) is converted
through numpy; both packages then run their own ``make_train_setup`` step
for 3 steps on the CPU in fp32 (``compute_dtype="float32"``) over the same
``lm_batches`` batches, for ``lln`` and ``lln_diag`` with ``use_kernel``
False (the core scan) and True (the kernels' autograd Functions, plain
versions on the CPU), and once with ``grad_accum=2`` (the calibration
statistics are pooled per microbatch, on both sides).  Held: each step's
loss and grad norm within 1e-4 relative, and the first step's gradient of
every leaf within 1e-4 of that leaf's largest entry.  Params after the 3 AdamW steps are held only
loosely, within 2 x the summed learning rate: m/sqrt(v) turns a tiny
gradient difference on a near-zero gradient into a full-size update
difference, so the bound says no weight moved differently by more than the
updates themselves can.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.launch.mesh import compat_mesh
from repro.launch.steps import make_train_setup as j_make_train_setup
from repro.models import build_model as j_build_model
from repro.models import transformer as j_tr
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import (leaves_from_numpy, params_from_numpy,
                                 train_state_from_numpy)
from repro_torch.data import torch_placer
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_setup
from repro_torch.models import build_model
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

BATCH, SEQ, STEPS = 2, 32, 3
LR, TOTAL = 1e-3, 3
REL = 1e-4


def _rel_close(got, want, what):
    assert abs(got - want) <= REL * max(abs(want), 1e-6), \
        f"{what}: port {got} vs reference {want}"


def _reference_run(jcfg, batches):
    """(initial state and first-step gradients as numpy, per-step
    metrics, final params as numpy)."""
    mesh = compat_mesh((1, 1), ("data", "model"))
    with mesh:
        jsetup = j_make_train_setup(jcfg, JShape("t", SEQ, BATCH, "train"),
                                    mesh, multi_pod=False, peak_lr=LR,
                                    total_steps=TOTAL)
        jmodel = j_build_model(jcfg)
        params = jmodel.init(jax.random.PRNGKey(0))
        state = {"params": params, "opt": j_adamw_init(params)}
        state0 = jax.tree_util.tree_map(np.asarray, state)
        grads0 = jax.tree_util.tree_map(
            np.asarray, jax.grad(jmodel.loss)(params, batches[0]))
        metrics = []
        for batch in batches:
            state, m = jsetup.step_fn(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        final = jax.tree_util.tree_map(np.asarray, state["params"])
    return state0, grads0, metrics, final


@pytest.mark.parametrize("impl,use_kernel,accum", [
    ("lln", False, 1), ("lln", True, 1), ("lln_diag", False, 1),
    ("lln_diag", True, 1), ("lln_diag", True, 2)],
    ids=["lln-core", "lln-kernel", "lln_diag-core", "lln_diag-kernel",
         "lln_diag-kernel-accum2"])
def test_port_trains_like_the_reference(impl, use_kernel, accum):
    over = dict(attn_impl=impl, compute_dtype="float32",
                use_kernel=use_kernel, grad_accum=accum)
    jcfg = j_get_config("yi-9b", smoke=True, **over)
    tcfg = get_config("yi-9b", smoke=True, **over)
    gen = lm_batches(jcfg.vocab, BATCH, SEQ, seed=0)
    batches = [next(gen) for _ in range(STEPS)]
    state0, grads0, j_metrics, j_final = _reference_run(jcfg, batches)

    state = train_state_from_numpy(state0, tcfg, "cpu")
    setup = make_train_setup(tcfg, ShapeSpec("t", SEQ, BATCH, "train"),
                             device="cpu", peak_lr=LR, total_steps=TOTAL)
    place = torch_placer("cpu")
    tbatches = [place(b) for b in batches]

    params = dict(state["params"].named_parameters())
    if accum == 1:
        loss = setup.model.loss(state["params"], tbatches[0])
        grads = torch.autograd.grad(loss, list(params.values()))
        want = leaves_from_numpy(grads0, tcfg)
        assert set(want) == set(params)
        for (name, _), g in zip(params.items(), grads):
            w = want[name]
            np.testing.assert_allclose(
                g.numpy(), w, rtol=0,
                atol=REL * max(float(np.abs(w).max()), 1e-30), err_msg=name)

    lr_sum = 0.0
    for batch, jm in zip(tbatches, j_metrics):
        state, m = setup.step_fn(state, batch)
        for key in ("loss", "grad_norm", "lr"):
            _rel_close(float(m[key]), jm[key], key)
        lr_sum += jm["lr"]
    assert int(state["opt"]["step"]) == STEPS
    for name, w in leaves_from_numpy(j_final, tcfg).items():
        np.testing.assert_allclose(params[name].detach().numpy(), w, rtol=0,
                                   atol=2 * lr_sum, err_msg=name)


@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_hidden_and_logits_match_the_reference(impl):
    """``Model.hidden`` and ``lm_logits`` (fp32, the kernels' plain
    versions) on the reference's converted weights, held to 1e-4 of the
    largest reference entry."""
    over = dict(attn_impl=impl, compute_dtype="float32", use_kernel=True)
    jcfg = j_get_config("yi-9b", smoke=True, **over)
    tcfg = get_config("yi-9b", smoke=True, **over)
    batch = next(lm_batches(jcfg.vocab, BATCH, SEQ, seed=1))
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    j_hidden, _ = jmodel.hidden(jparams, batch)
    j_logits, _ = j_tr.lm_logits(jparams, batch["inputs"], jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               tcfg, "cpu")
    tbatch = torch_placer("cpu")(batch)
    with torch.no_grad():
        hidden, aux = build_model(tcfg, "cpu").hidden(params, tbatch)
        logits, _ = tr.lm_logits(params, tbatch["inputs"], tcfg)
    assert float(aux) == 0.0
    for got, want in ((hidden, j_hidden), (logits, j_logits)):
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=REL * float(np.abs(want).max()))


def test_cast_params_once_takes_compute_dtype_gradients():
    """With bf16 compute, ``cast_params_once`` differentiates with respect to
    bf16 copies of the fp32 matrices: the forward is the same computation
    (each matrix is cast at use either way), so the loss is equal, and the
    gradients are the same bf16 values up to the bf16 sums of repeated
    token rows in the embedding gradient (grad norm within 1e-3)."""
    cfg = get_config("yi-9b", smoke=True, attn_impl="lln_diag",
                     use_kernel=True)
    batch = torch_placer("cpu")(next(lm_batches(cfg.vocab, BATCH, SEQ)))
    shape = ShapeSpec("t", SEQ, BATCH, "train")
    runs = {}
    for cast in (False, True):
        setup = make_train_setup(cfg, shape, device="cpu", peak_lr=LR,
                                 total_steps=TOTAL, cast_params_once=cast)
        state, runs[cast] = setup.step_fn(setup.init_state(0), batch)
        assert all(p.dtype == torch.float32
                   for p in state["params"].parameters())
    assert float(runs[True]["loss"]) == float(runs[False]["loss"])
    assert abs(float(runs[True]["grad_norm"]) - float(runs[False]["grad_norm"])
               ) <= 1e-3 * float(runs[False]["grad_norm"])


@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_train_cli_on_cpu(impl, tmp_path):
    out = tmp_path / "metrics.json"
    hist = train.main(["--arch", "yi-9b", "--smoke", "--attn-impl", impl,
                       "--device", "cpu", "--steps", "3", "--seq", "32",
                       "--batch", "2", "--metrics-out", str(out)])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert out.exists()


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "2,1", "--arch", "mamba2-130m"],
     "2 devices needs 2 processes"),
    (["--mesh", "2,2"], "4 devices needs 4 processes"),
])
def test_train_cli_refuses_unported_options(argv, match):
    """Every family trains on a mesh (items 12a and 12b; every ``--mesh``
    raised before meshes were ported, the families other than the dense
    and MoE decoders before item 12b): a mesh larger than the one-process
    world is refused before any group starts."""
    base = ["--arch", "yi-9b", "--smoke", "--device", "cpu", "--steps", "1",
            "--attn-impl", "lln"]
    with pytest.raises(ValueError, match=match):
        train.main(base + argv)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("argv", [[], ["--attn-impl", "softmax"]],
                         ids=["default", "explicit"])
def test_train_cli_trains_softmax(argv):
    """``softmax``, every config's default impl, trains (it was refused
    before the softmax impl was ported)."""
    hist = train.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq", "32", "--batch", "2"] + argv)
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)


def _adamw_formula(grads, state, params, lr, cfg):
    """AdamW as the reference writes it, a whole-tree clipped copy of the
    gradients first, each leaf's update as one expression."""
    norm = torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.float())) for g in grads.values()])))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(norm, min=1e-9),
                        max=1.0)
    clipped = {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}
    t = (state["step"] + 1).float()
    bc1, bc2 = 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t
    for name, p in params.items():
        gf = clipped[name].float()
        m, v = state["m"][name], state["v"][name]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * gf)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(gf))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = state["step"] + 1
    return norm


def _adamw_matches_the_formula(device):
    """Four steps of ``adamw_update`` and of the formula from the same
    fp32 and bf16 leaves, with the clip inactive and active: params,
    moments and the returned norm bitwise equal."""
    cfg = AdamWConfig()
    gen = torch.Generator(device=device).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for size in (0.01, 100.0):      # gradient norm below / above clip
            params = {f"w{i}": torch.randn(
                67, 33, generator=gen, device=device).to(dtype)
                for i in range(3)}
            params["b"] = torch.randn(5, generator=gen,
                                      device=device).to(dtype)
            ref = {n: p.clone() for n, p in params.items()}
            state, ref_state = adamw_init(params), adamw_init(ref)
            for step in range(4):
                grads = {n: (size * torch.randn(
                    p.shape, generator=gen, device=device)).to(dtype)
                    for n, p in params.items()}
                lr = torch.tensor(1e-3 * (step + 1), device=device)
                _, state, m = adamw_update(grads, state, params, lr, cfg)
                norm = _adamw_formula(grads, ref_state, ref, lr, cfg)
                assert torch.equal(m["grad_norm"], norm)
                for n in params:
                    assert torch.equal(params[n], ref[n]), (dtype, n)
                    assert torch.equal(state["m"][n], ref_state["m"][n])
                    assert torch.equal(state["v"][n], ref_state["v"][n])


def test_adamw_update_is_the_formula_bit_for_bit():
    """``adamw_update`` runs leaf by leaf in place (no clipped copy of the
    tree); every value is the formula's, bit for bit."""
    _adamw_matches_the_formula("cpu")
