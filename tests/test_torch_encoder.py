"""The encoder slice: roberta-lln SMOKE trained by the port against the JAX
reference.

``mlm_batches`` is held bit for bit; ``Model.hidden`` and
``encoder_logits`` on the reference's converted weights to 1e-4 of the
largest reference entry; 3 MLM AdamW steps of both packages'
``make_train_setup`` from the same converted state, on the CPU in fp32,
for ``lln`` / ``lln_diag`` x ``use_kernel`` (False: the core bidirectional
form with torch autograd; True: the kernels' autograd Functions, plain
versions on the CPU): each step's loss and grad norm within 1e-4
relative.  ``block_diag_attention``'s output and gradients against the
reference's custom_vjp.  Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.data.synthetic import mlm_batches as j_mlm_batches
from repro.kernels import ops as jops
from repro.launch.mesh import compat_mesh
from repro.launch.steps import make_train_setup as j_make_train_setup
from repro.models import build_model as j_build_model
from repro.models import encoder as j_enc
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.data import torch_placer
from repro_torch.data.synthetic import mlm_batches
from repro_torch.kernels import ops as tops
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_setup
from repro_torch.models import build_model
from repro_torch.models import encoder as enc
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

BATCH, SEQ, STEPS = 2, 32, 3
LR, TOTAL = 1e-3, 3
REL = 1e-4


def _rel_close(got, want, what):
    assert abs(got - want) <= REL * max(abs(want), 1e-6), \
        f"{what}: port {got} vs reference {want}"


def test_mlm_batches_equal_the_reference():
    ours, ref = mlm_batches(512, 3, 40, seed=5), j_mlm_batches(512, 3, 40,
                                                              seed=5)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert set(a) == set(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
        masked = a["mask"].mean()
        assert 0.05 < masked < 0.3
        assert (a["inputs"][a["mask"] == 0] == a["targets"][a["mask"] == 0]
                ).all()


@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["core", "kernel"])
def test_hidden_and_logits_match_the_reference(impl, use_kernel):
    over = dict(attn_impl=impl, compute_dtype="float32",
                use_kernel=use_kernel)
    jcfg = j_get_config("roberta-lln", smoke=True, **over)
    tcfg = get_config("roberta-lln", smoke=True, **over)
    batch = next(j_mlm_batches(jcfg.vocab, BATCH, SEQ, seed=1))
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    j_hidden, _ = jmodel.hidden(jparams, batch)
    j_logits, _ = j_enc.encoder_logits(jparams, batch["inputs"], jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               tcfg, "cpu")
    assert isinstance(params, enc.Encoder)
    tbatch = torch_placer("cpu")(batch)
    with torch.no_grad():
        hidden, aux = build_model(tcfg, "cpu").hidden(params, tbatch)
        logits, _ = enc.encoder_logits(params, tbatch["inputs"], tcfg)
    assert float(aux) == 0.0
    for got, want in ((hidden, j_hidden), (logits, j_logits)):
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=REL * float(np.abs(want).max()))


@pytest.mark.parametrize("impl,use_kernel", [
    ("lln", False), ("lln", True), ("lln_diag", False), ("lln_diag", True)],
    ids=["lln-core", "lln-kernel", "lln_diag-core", "lln_diag-kernel"])
def test_port_trains_mlm_like_the_reference(impl, use_kernel):
    over = dict(attn_impl=impl, compute_dtype="float32",
                use_kernel=use_kernel)
    jcfg = j_get_config("roberta-lln", smoke=True, **over)
    tcfg = get_config("roberta-lln", smoke=True, **over)
    gen = j_mlm_batches(jcfg.vocab, BATCH, SEQ, seed=0)
    batches = [next(gen) for _ in range(STEPS)]
    mesh = compat_mesh((1, 1), ("data", "model"))
    with mesh:
        jsetup = j_make_train_setup(jcfg, JShape("t", SEQ, BATCH, "train"),
                                    mesh, multi_pod=False, peak_lr=LR,
                                    total_steps=TOTAL)
        jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
        jstate = {"params": jparams, "opt": j_adamw_init(jparams)}
        state0 = jax.tree_util.tree_map(np.asarray, jstate)
        j_metrics = []
        for batch in batches:
            jstate, m = jsetup.step_fn(jstate, batch)
            j_metrics.append({k: float(v) for k, v in m.items()})

    state = train_state_from_numpy(state0, tcfg, "cpu")
    setup = make_train_setup(tcfg, ShapeSpec("t", SEQ, BATCH, "train"),
                             device="cpu", peak_lr=LR, total_steps=TOTAL)
    place = torch_placer("cpu")
    for batch, jm in zip(batches, j_metrics):
        state, m = setup.step_fn(state, place(batch))
        for key in ("loss", "grad_norm", "lr"):
            _rel_close(float(m[key]), jm[key], key)
    assert int(state["opt"]["step"]) == STEPS


def test_encoder_has_no_decode_step():
    model = build_model(get_config("roberta-lln", smoke=True), "cpu")
    for fn in (model.prefill, model.decode, model.cache_init):
        with pytest.raises(NotImplementedError, match="no decode step"):
            fn(None, None)


def _bd_case(seed, n, r):
    rng = np.random.default_rng(seed)
    b, g, d = 2, 2, 16
    return (rng.normal(size=(b, n, g * r, d)).astype(np.float32),
            rng.normal(size=(b, n, g, d)).astype(np.float32),
            rng.normal(size=(b, n, g, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("n,r", [(32, 1), (32, 4), (40, 2)],
                         ids=["n32-r1", "n32-r4", "ragged-n40-r2"])
def test_block_diag_attention_matches_reference_vjp(n, r, causal):
    """Output and gradients of sum(out^2) through the port's Function
    (plain versions on the CPU) against ``jax.grad`` through the
    reference's custom_vjp, 1e-5 / 1e-4 of the largest entry; a ragged N
    runs the Function too (the reference takes its jnp fallback)."""
    q, k, v = _bd_case(n + r, n, r)

    def jloss(q_, k_, v_):
        out = jops.block_diag_attention(q_, k_, v_, 16, causal)
        return jnp.sum(jnp.square(out.astype(jnp.float32)))

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    j_out = jops.block_diag_attention(jq, jk, jv, 16, causal)
    j_grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tops.block_diag_attention(tq, tk, tv, 16, causal)
    assert type(out.grad_fn).__name__.startswith("_BlockDiag")
    grads = torch.autograd.grad(torch.sum(torch.square(out.float())),
                                (tq, tk, tv))
    for got, want, rel in ((out, j_out, 1e-5),) + tuple(
            (g_, w_, 1e-4) for g_, w_ in zip(grads, j_grads)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(
            got.detach().numpy(), want, rtol=0,
            atol=rel * max(1.0, float(np.abs(want).max())))


def test_train_cli_on_cpu(tmp_path):
    out = tmp_path / "metrics.json"
    hist = train.main(["--arch", "roberta-lln", "--smoke", "--device", "cpu",
                       "--steps", "3", "--seq", "32", "--batch", "2",
                       "--metrics-out", str(out)])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert out.exists()


def test_encoder_mlm_learns_with_lln_diag():
    """The port's twin of ``tests/test_system.py::
    test_encoder_mlm_learns_with_lln_diag``: roberta-lln SMOKE (lln_diag)
    on MLM batches, AdamW at lr 3e-3 with weight decay 0.01 for 60 steps;
    the smoothed loss trends down over the last two thirds and the median
    loss drops by more than 0.15."""
    cfg = get_config("roberta-lln", smoke=True)
    assert cfg.attn_impl == "lln_diag"
    model = build_model(cfg, "cpu")
    params = model.init(0)
    opt = adamw_init(params)
    opt_cfg = AdamWConfig(weight_decay=0.01)
    gen = mlm_batches(cfg.vocab, 8, 64, seed=0)
    place = torch_placer("cpu")
    losses = []
    for _ in range(60):
        loss = model.loss(params, place(next(gen)))
        grads = dict(zip(dict(params.named_parameters()), torch.autograd.grad(
            loss, list(params.parameters()))))
        _, opt, _ = adamw_update(grads, opt, params, 3e-3, opt_cfg)
        losses.append(float(loss.detach()))
    losses = np.asarray(losses)
    smooth = np.convolve(losses, np.ones(9) / 9, mode="valid")
    tail = smooth[smooth.size // 3:]
    slope = np.polyfit(np.arange(tail.size), tail, 1)[0]
    assert slope < 0, (slope, tail[:3], tail[-3:])
    drop = float(np.median(losses[:10]) - np.median(losses[-10:]))
    assert drop > 0.15, (drop, losses[:3], losses[-3:])
