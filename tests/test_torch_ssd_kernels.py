"""The port's SSD kernel and its autograd op, held against the JAX reference.

On the CPU ``ssd`` runs its plain PyTorch version; the reference's
``ssd_pallas`` runs in interpret mode, as its own tests run it (each
interpret call costs about half a second here, so each case makes one call
per dtype).  ``ops.ssd_scan`` (backend ``plain``: the plain forward inside
the autograd Function, whose backward differentiates the core scan) is held
against the reference's ``ssd_scan`` under ``jax.grad``.  Inputs are made
with numpy from a seed and fed to both sides.  Tolerances: fp32 outputs
3e-4 absolute and gradients 3e-3 absolute, the reference's own
(``tests/test_kernels.py::TestSSDKernel``); with bf16 B/C both sides read
the same bf16 values and compute in fp32, so the same 3e-4 holds.

``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
version on the card; here the tensor-core path's route and scratch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.kernels import ssd_scan as j_ssd_scan
from repro.kernels.ssd import ssd_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ssd import _tc_path, _tc_scratch, ssd, ssd_plain

FWD, GRAD = 3e-4, 3e-3
BLK = 16


def _kernel_inputs(seed, bh, bg, n, p=16, s=8):
    rng = np.random.default_rng(seed)
    log_a = -np.logaddexp(rng.normal(size=(bh, n)), 0.0).astype(np.float32)
    xbar = rng.normal(size=(bh, n, p)).astype(np.float32)
    b_in = rng.normal(size=(bg, n, s)).astype(np.float32)
    c_in = rng.normal(size=(bg, n, s)).astype(np.float32)
    return log_a, xbar, b_in, c_in


@pytest.mark.parametrize("nblk", [1, 3])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_ssd_plain_matches_pallas(g, nblk):
    """Two batch rows of four heads in g groups (r = 4 / g), fp32 B/C, then
    the same values in bf16."""
    log_a, xbar, b_in, c_in = _kernel_inputs(10 * g + nblk, 8, 2 * g,
                                             nblk * BLK)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        want = ssd_pallas(jnp.asarray(log_a), jnp.asarray(xbar),
                          jnp.asarray(b_in).astype(jdtype),
                          jnp.asarray(c_in).astype(jdtype), r=4 // g,
                          blk=BLK, interpret=True)
        got = ssd(torch.from_numpy(log_a), torch.from_numpy(xbar),
                  torch.from_numpy(b_in).to(dtype),
                  torch.from_numpy(c_in).to(dtype), r=4 // g, blk=BLK)
        assert got.dtype == torch.float32 and got.shape == xbar.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD,
                                   rtol=0)


def test_ssd_refuses_a_ragged_sequence():
    log_a, xbar, b_in, c_in = _kernel_inputs(0, 2, 1, 24)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_plain(*(torch.from_numpy(a) for a in (log_a, xbar, b_in, c_in)),
                  r=2, blk=BLK)


def _model_inputs(seed, l, b=2, h=4, g=2, p=8, s=4):
    rng = np.random.default_rng(seed)
    xbar = rng.normal(size=(b, l, h, p)).astype(np.float32)
    b_in = rng.normal(size=(b, l, g, s)).astype(np.float32)
    c_in = rng.normal(size=(b, l, g, s)).astype(np.float32)
    log_a = -np.logaddexp(rng.normal(size=(b, l, h)), 0.0).astype(np.float32)
    cot = rng.normal(size=(b, l, h, p)).astype(np.float32)
    return (xbar, b_in, c_in, log_a), cot


def _reference(inputs, cot):
    def loss(*a):
        return jnp.sum(j_ssd_scan(*a, BLK) * cot)
    args = [jnp.asarray(a) for a in inputs]
    y = j_ssd_scan(*args, BLK)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return np.asarray(y), [np.asarray(x) for x in grads]


def _port(inputs, cot, backend):
    args = [torch.from_numpy(a).requires_grad_() for a in inputs]
    y = tops.ssd_scan(*args, BLK, backend=backend)
    grads = torch.autograd.grad(y, args, torch.from_numpy(cot))
    return y.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("l", [48, 40], ids=["whole-chunks", "ragged-l40"])
def test_ssd_scan_forward_and_gradients_match_the_reference(l):
    """L = 48 runs the reference's Pallas kernel (interpret) and the port's
    plain forward, both with the core scan's backward; a ragged L = 40
    runs the core scan on both sides.  The port's ``ref`` backend (the
    core scan under autograd) is held the same way."""
    inputs, cot = _model_inputs(l, l)
    want_y, want_g = _reference(inputs, cot)
    for backend in ("plain", "ref"):
        got_y, got_g = _port(inputs, cot, backend)
        np.testing.assert_allclose(got_y, want_y, atol=FWD, rtol=0)
        for name, got, want in zip(("xbar", "b_in", "c_in", "log_a"), got_g,
                                   want_g):
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got, want, atol=GRAD, rtol=0,
                                       err_msg=f"{backend} d{name}")


def test_ssd_scan_kernel_backend_needs_a_card():
    inputs, _ = _model_inputs(0, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.ssd_scan(*(torch.from_numpy(a) for a in inputs), BLK,
                      backend="kernel")


@pytest.mark.parametrize("dtype,p,want", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.float32, 64, False), (torch.bfloat16, 160, False)],
    ids=["mamba2", "p128", "fp32-bc", "wide-p"])
def test_ssd_tensor_core_route(dtype, p, want):
    """bf16 B/C with P <= 128 take the tensor-core kernels; fp32 B/C or a
    wider P the CUDA-core kernel."""
    assert _tc_path(torch.zeros(1, 1, 8, dtype=dtype), p) is want


@pytest.mark.parametrize("n,blk", [(2048, 256), (256, 256)])
def test_ssd_tensor_core_scratch(n, blk):
    """lcum per step, G_c for every chunk but the last (at least one slot),
    state_c for every chunk as two bf16 planes."""
    lcum, gs, st = _tc_scratch(6, n, 64, 128, blk, "cpu")
    nc = n // blk
    assert lcum.shape == (6, n) and lcum.dtype == torch.float32
    assert gs.shape == (6, max(nc - 1, 1), 128, 64)
    assert st.shape == (2, 6, nc, 128, 64) and st.dtype == torch.bfloat16
