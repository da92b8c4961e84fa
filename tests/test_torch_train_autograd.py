"""The training autograd Functions (``kernels/ops.py:lln_attention`` and
``lln_diag_attention``) held against the JAX reference's custom_vjps.

``torch.autograd.grad`` of sum(out^2) through the port's Function (the
plain versions of the kernels on the CPU) against ``jax.grad`` through the
reference's, once with its scan-twin backward and once with
``FORCE_KERNEL_BWD`` (the Pallas backward kernels, interpreted), as
``tests/test_kernels.py`` does.  At a ragged N the reference takes its jnp
autograd fallback while the port zero-pads the sequence inside its
Function and still runs the kernels' plain versions.  Inputs are made with numpy from a seed.  Tolerances: outputs
1e-5 and gradients 1e-4 of the largest reference entry (at least 1): fp32
sums taken in another order through the quotient and chain rules (the
reference's own kernel-vs-core tolerance is 2e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

BLK, D = 16, 16
FP32 = 1e-5
GRAD = 1e-4


def _close(got, want, rel):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    atol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ---------------------------------------------------------------------------

def _model_case(seed, n, r):
    rng = np.random.default_rng(seed)
    b, g = 2, 2
    h = g * r
    q = rng.normal(size=(b, n, h, D)).astype(np.float32)
    k = rng.normal(size=(b, n, g, D)).astype(np.float32)
    v = rng.normal(size=(b, n, g, D)).astype(np.float32)
    alpha = rng.uniform(0.8, 1.6, h).astype(np.float32)
    beta = rng.uniform(0.8, 1.6, g).astype(np.float32)
    return q, k, v, alpha, beta


@pytest.mark.parametrize("force_kernel_bwd", [False, True],
                         ids=["scan-bwd", "pallas-bwd"])
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
@pytest.mark.parametrize("n,r", [(2 * BLK, 1), (2 * BLK, 4), (40, 2)],
                         ids=["n32-r1", "n32-r4", "ragged-n40-r2"])
def test_autograd_matches_reference_vjp(impl, n, r, force_kernel_bwd,
                                        monkeypatch):
    monkeypatch.setattr(jops, "FORCE_KERNEL_BWD", force_kernel_bwd)
    q, k, v, alpha, beta = _model_case(7 * n + r, n, r)
    jfn = jops.lln_attention if impl == "lln" else jops.lln_diag_attention
    tfn = tops.lln_attention if impl == "lln" else tops.lln_diag_attention

    def jloss(q_, k_, v_):
        out = jfn(q_, k_, v_, jnp.asarray(alpha), jnp.asarray(beta), True,
                  BLK)
        return jnp.sum(jnp.square(out.astype(jnp.float32)))

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    j_out = jfn(jq, jk, jv, jnp.asarray(alpha), jnp.asarray(beta), True, BLK)
    j_grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfn(tq, tk, tv, torch.from_numpy(alpha), torch.from_numpy(beta),
              True, BLK)
    grads = torch.autograd.grad(torch.sum(torch.square(out.float())),
                                (tq, tk, tv))
    _close(out, j_out, FP32)
    for g_, w_ in zip(grads, j_grads):
        _close(g_, w_, GRAD)


@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_ragged_n_runs_the_function_and_matches_ref(impl):
    """A ragged N goes through the autograd Function (zero-padded), not
    the core autograd; its outputs and gradients match backend ``ref``."""
    q, k, v, alpha, beta = _model_case(5, 40, 2)
    fn = tops.lln_attention if impl == "lln" else tops.lln_diag_attention
    results = {}
    for backend in ("plain", "ref"):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = fn(tq, tk, tv, torch.from_numpy(alpha), torch.from_numpy(beta),
                 True, BLK, backend=backend)
        results[backend] = (out, torch.autograd.grad(
            torch.sum(torch.square(out.float())), (tq, tk, tv)))
    out, grads = results["plain"]
    assert type(out.grad_fn).__name__.startswith("_LLN")
    ref_out, ref_grads = results["ref"]
    _close(out, ref_out.detach().numpy(), FP32)
    for g_, w_ in zip(grads, ref_grads):
        _close(g_, w_.numpy(), GRAD)


def test_bidirectional_raises_not_implemented():
    """Bidirectional attention (``causal=False``) raised
    NotImplementedError until the encoder slice ported it; it now runs the
    autograd Functions and matches the core reference (backend ``ref``).
    ``tests/test_torch_encoder_kernels.py`` holds it against the JAX
    reference."""
    q, k, v, alpha, beta = (torch.from_numpy(a)
                            for a in _model_case(0, BLK, 1))
    for fn in (tops.lln_attention, tops.lln_diag_attention):
        out = fn(q, k, v, alpha, beta, False, BLK)
        ref = fn(q, k, v, alpha, beta, False, BLK, backend="ref")
        _close(out, ref.numpy(), FP32)
