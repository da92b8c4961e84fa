"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

The kernels have no CPU mode, so every test here skips where there is no
CUDA card.  This file imports neither JAX nor the reference package, so it
runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 outputs and the fp32 (s, z) state 2e-4 relative to the
largest entry (the CPU suite's fp32 tolerance); bf16 outputs one bf16
rounding step, 2^-7 of the largest entry, since both sides compute in fp32
and round once.  The training kernels' fp32 outputs (den and every
gradient) are held to 1e-5 of the largest entry, as on the CPU against the
reference; gradients through the autograd Functions to 1e-4.  The
encoder's kernels (``lln_bidir``, ``lln_bidir_bwd``, ``block_diag_bwd``)
are held the same way at D = 64, r in {1, 4}, whole and ragged N.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.block_diag import (block_diag, block_diag_bwd,
                                            block_diag_bwd_plain,
                                            block_diag_plain)
from repro_torch.kernels.lln_attention import (lln_bidir, lln_bidir_plain,
                                               lln_causal, lln_causal_plain,
                                               lln_decode, lln_decode_plain,
                                               lln_diag_fused,
                                               lln_diag_fused_plain)
from repro_torch.kernels.lln_backward import (lln_bidir_bwd,
                                              lln_bidir_bwd_plain,
                                              lln_causal_bwd,
                                              lln_causal_bwd_plain,
                                              lln_diag_fused_bwd,
                                              lln_diag_fused_bwd_plain)

ATOL = 2e-4
TRAIN = 1e-5
BF16 = 2.0 ** -7


def _kernel_inputs(seed, bh, bg, n, d, dv, shift=-0.5):
    rng = np.random.default_rng(seed)
    qs = (rng.normal(size=(bh, n, d)) + shift).astype(np.float32)
    ks = (rng.normal(size=(bg, n, d)) + shift).astype(np.float32)
    v = rng.normal(size=(bg, n, dv)).astype(np.float32)
    return qs, ks, v


def _close(got, want, rel):
    want = want.float().cpu()
    atol = rel * max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               atol=atol, rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *arrays, dtype=None):
    out = [torch.from_numpy(a).to(dev) for a in arrays]
    return [o.to(dtype) for o in out] if dtype is not None else out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [48, 300])
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
def test_cuda_lln_causal_matches_plain(cuda, n, vdtype):
    qs, ks, v = _kernel_inputs(n, 8, 2, n, 64, 64)
    qs, ks = _on(cuda, qs, ks)
    (v,) = _on(cuda, v, dtype=vdtype)
    got = lln_causal(qs, ks, v, r=4, blk=16)
    want = lln_causal_plain(qs, ks, v, r=4, blk=16)
    torch.cuda.synchronize()
    _close(got[0], want[0], ATOL if vdtype == torch.float32 else 2.0 ** -7)
    _close(got[1], want[1], ATOL)
    _close(got[2], want[2], ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,blk,dtype", [(64, 16, torch.float32),
                                         (300, 256, torch.bfloat16)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_block_diag_matches_plain(cuda, n, blk, dtype, causal):
    rng = np.random.default_rng(n)
    q = rng.normal(size=(8, n, 64)).astype(np.float32)
    k = rng.normal(size=(2, n, 64)).astype(np.float32)
    v = rng.normal(size=(2, n, 64)).astype(np.float32)
    q, k, v = _on(cuda, q, k, v, dtype=dtype)
    got = block_diag(q, k, v, r=4, blk=blk, causal=causal)
    want = block_diag_plain(q, k, v, r=4, blk=blk, causal=causal)
    torch.cuda.synchronize()
    _close(got, want, ATOL if dtype == torch.float32 else 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 20])
def test_cuda_lln_decode_matches_plain(cuda, t):
    qs, ks, v = _kernel_inputs(t, 8, 2, t, 64, 64)
    rng = np.random.default_rng(t)
    s0 = rng.normal(size=(8, 64, 64)).astype(np.float32)
    z0 = rng.uniform(0.5, 3.0, (8, 1, 64)).astype(np.float32)
    args = _on(cuda, qs, ks, v, s0, z0)
    got = lln_decode(*args, r=4)
    want = lln_decode_plain(*args, r=4)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        _close(gt, wt, ATOL)


@pytest.mark.cuda
def test_cuda_wrappers_count_launches_and_refuse_bad_inputs(cuda):
    qs, ks, v = _on(cuda, *_kernel_inputs(0, 4, 2, 32, 16, 16))
    before = lln_causal.launches
    lln_causal(qs, ks, v, r=2)
    assert lln_causal.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        lln_causal(qs.transpose(1, 2).contiguous().transpose(1, 2), ks, v,
                   r=2)
    with pytest.raises(TypeError, match="float32"):
        lln_causal(qs.half(), ks, v, r=2)
    with pytest.raises(ValueError, match="shape"):
        block_diag(qs, ks, v, r=1, blk=16)
    assert lln_causal.launches == before + 1


def _train_inputs(dev, seed, r, n, d, dtype):
    """fp32 qs/ks; q/k/v/g in ``dtype``; kernel layout, 2 kv heads."""
    rng = np.random.default_rng(seed)
    bg = 2
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(dev)
    qs, ks = f(bg * r, n, d) - 0.5, f(bg, n, d) - 0.5
    q, k, v, g = (f(bg * r, n, d).to(dtype), f(bg, n, d).to(dtype),
                  f(bg, n, d).to(dtype), f(bg * r, n, d).to(dtype))
    return qs, ks, q, k, v, g


TRAIN_CASES = [pytest.param(r, n, blk, dt, id=f"r{r}-n{n}-blk{blk}-{nm}")
               for r in (1, 4) for n, blk in ((64, 16), (128, 64))
               for dt, nm in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))]


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,blk,dtype", TRAIN_CASES)
def test_cuda_training_forwards_match_plain(cuda, r, n, blk, dtype):
    qs, ks, q, k, v, _ = _train_inputs(cuda, n + r, r, n, 64, dtype)
    out_tol = TRAIN if dtype == torch.float32 else BF16
    got = lln_causal(qs, ks, v, r=r, blk=blk, return_res=True,
                     return_state=False)
    want = lln_causal_plain(qs, ks, v, r=r, blk=blk, return_res=True,
                            return_state=False)
    torch.cuda.synchronize()
    _close(got[0], want[0], out_tol)
    _close(got[1], want[1], TRAIN)
    got = lln_diag_fused(qs, ks, q, k, v, r=r, blk=blk, return_res=True)
    want = lln_diag_fused_plain(qs, ks, q, k, v, r=r, blk=blk,
                                return_res=True)
    torch.cuda.synchronize()
    _close(got[0], want[0], out_tol)
    _close(got[1], want[1], TRAIN)


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,blk,dtype", TRAIN_CASES)
def test_cuda_backward_kernels_match_plain(cuda, r, n, blk, dtype):
    qs, ks, q, k, v, g = _train_inputs(cuda, 2 * n + r, r, n, 64, dtype)
    o, den = lln_causal_plain(qs, ks, v, r=r, blk=blk, return_res=True,
                              return_state=False)
    got = lln_causal_bwd(qs, ks, v, g, o, den, r=r, blk=blk)
    want = lln_causal_bwd_plain(qs, ks, v, g, o, den, r=r, blk=blk)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        _close(gt, wt, TRAIN)
    o, den = lln_diag_fused_plain(qs, ks, q, k, v, r=r, blk=blk,
                                  return_res=True)
    got = lln_diag_fused_bwd(qs, ks, q, k, v, g, o, den, r=r, blk=blk)
    want = lln_diag_fused_bwd_plain(qs, ks, q, k, v, g, o, den, r=r, blk=blk)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        _close(gt, wt, TRAIN)


def _model_inputs(dev, seed, n=64, r=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(dev)
    return (f(2, n, 2 * r, 32), f(2, n, 2, 32), f(2, n, 2, 32),
            torch.full((2 * r,), 1.3, device=dev),
            torch.full((2,), 1.1, device=dev))


def _grads(fn, backend, q, k, v, alpha, beta, blk=16):
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v, alpha, beta, True, blk, backend=backend)
    return torch.autograd.grad(torch.sum(torch.square(out.float())),
                               (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_cuda_autograd_function_matches_plain_and_core(cuda, impl):
    """The Function's backward on the kernels against the same Function on
    the plain versions and against autograd through the core scan."""
    fn = ops.lln_attention if impl == "lln" else ops.lln_diag_attention
    args = _model_inputs(cuda, 3)
    got = _grads(fn, "kernel", *args)
    for backend in ("plain", "ref"):
        want = _grads(fn, backend, *args)
        for gt, wt in zip(got, want):
            _close(gt, wt, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_cuda_ragged_n_runs_the_kernels(cuda, impl):
    """N % blk != 0 with backend ``kernel``: the Function zero-pads the
    sequence and launches the forward and backward kernels (no fallback to
    the core scan); gradients match the core autograd."""
    fn = ops.lln_attention if impl == "lln" else ops.lln_diag_attention
    fwd = ops.lln_causal if impl == "lln" else ops.lln_diag_fused
    bwd = ops.lln_causal_bwd if impl == "lln" else ops.lln_diag_fused_bwd
    args = _model_inputs(cuda, 5, n=40)
    before = (fwd.launches, bwd.launches)
    got = _grads(fn, "kernel", *args)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    want = _grads(fn, "ref", *args)
    for gt, wt in zip(got, want):
        _close(gt, wt, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_cuda_gradients_are_bitwise_reproducible(cuda, impl):
    """No atomics: dk and dv are summed over the r heads in a fixed order,
    so the same inputs give the same gradients bit for bit."""
    fn = ops.lln_attention if impl == "lln" else ops.lln_diag_attention
    args = _model_inputs(cuda, 4, n=128, r=4)
    before = (ops.lln_causal_bwd.launches, ops.lln_diag_fused_bwd.launches)
    a = _grads(fn, "kernel", *args, blk=64)
    b = _grads(fn, "kernel", *args, blk=64)
    after = (ops.lln_causal_bwd.launches, ops.lln_diag_fused_bwd.launches)
    assert sum(after) - sum(before) == 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


BIDIR_CASES = [pytest.param(r, n, blk, dt, id=f"r{r}-n{n}-blk{blk}-{nm}")
               for r in (1, 4) for n, blk in ((128, 64), (300, 256))
               for dt, nm in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))]


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,blk,dtype", BIDIR_CASES)
def test_cuda_bidir_kernels_match_plain(cuda, r, n, blk, dtype):
    """lln_bidir (out, s, z, den), lln_bidir_bwd and block_diag_bwd (both
    on the hybrid's cotangent 0.5 g when r = 4) against their plain
    versions at D = Dv = 64; n = 300 is ragged for blk 256."""
    qs, ks, q, k, v, g = _train_inputs(cuda, 3 * n + r, r, n, 64, dtype)
    if r > 1:
        g = 0.5 * g
    out_tol = TRAIN if dtype == torch.float32 else BF16
    got = lln_bidir(qs, ks, v, r=r, return_res=True)
    want = lln_bidir_plain(qs, ks, v, r=r, return_res=True)
    torch.cuda.synchronize()
    _close(got[0], want[0], out_tol)
    for gt, wt in zip(got[1:], want[1:]):
        assert gt.shape == wt.shape
        _close(gt, wt, TRAIN)
    o, s, z, den = want
    got = lln_bidir_bwd(qs, ks, v, g, o, den, s, z, r=r)
    want = lln_bidir_bwd_plain(qs, ks, v, g, o, den, s, z, r=r)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        _close(gt, wt, TRAIN)
    for causal in (False, True):
        got = block_diag_bwd(q, k, v, g, r=r, blk=blk, causal=causal)
        want = block_diag_bwd_plain(q, k, v, g, r=r, blk=blk, causal=causal)
        torch.cuda.synchronize()
        for gt, wt in zip(got, want):
            _close(gt, wt, TRAIN)


def _bidir_grads(fn, backend, q, k, v, alpha, beta, blk=16):
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v, alpha, beta, False, blk, backend=backend)
    return torch.autograd.grad(torch.sum(torch.square(out.float())),
                               (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 40], ids=["n64", "ragged-n40"])
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_cuda_bidir_autograd_runs_the_kernels(cuda, impl, n):
    """causal=False with backend ``kernel``, whole and ragged N (blk 16):
    the Function launches lln_bidir and lln_bidir_bwd (and block_diag and
    block_diag_bwd for lln_diag) once each at the true N, and its gradients
    match the plain versions and autograd through the core reference."""
    fn = ops.lln_attention if impl == "lln" else ops.lln_diag_attention
    kernels = [lln_bidir, lln_bidir_bwd]
    if impl == "lln_diag":
        kernels += [block_diag, block_diag_bwd]
    args = _model_inputs(cuda, 6, n=n)
    before = [f.launches for f in kernels]
    got = _bidir_grads(fn, "kernel", *args)
    assert [f.launches - b for f, b in zip(kernels, before)] == \
        [1] * len(kernels)
    for backend in ("plain", "ref"):
        want = _bidir_grads(fn, backend, *args)
        for gt, wt in zip(got, want):
            _close(gt, wt, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_cuda_bidir_gradients_are_bitwise_reproducible(cuda, impl):
    """No atomics in the bidirectional backward either: (dS, dz) are summed
    over the sequence and the r heads, and block_diag_bwd's dk/dv over the
    heads and query tiles, in a fixed order."""
    fn = ops.lln_attention if impl == "lln" else ops.lln_diag_attention
    args = _model_inputs(cuda, 7, n=128, r=4)
    before = lln_bidir_bwd.launches
    a = _bidir_grads(fn, "kernel", *args, blk=64)
    b = _bidir_grads(fn, "kernel", *args, blk=64)
    assert lln_bidir_bwd.launches - before == 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_block_diag_attention_matches_plain_and_core(cuda):
    """The standalone training op: block_diag and block_diag_bwd through
    its Function against the plain versions and autograd through
    ``core/diag.py``, causal and not, at a ragged N."""
    q, k, v, _, _ = _model_inputs(cuda, 8, n=40)
    for causal in (False, True):
        results = {}
        for backend in ("kernel", "plain", "ref"):
            qq, kk, vv = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            out = ops.block_diag_attention(qq, kk, vv, 16, causal,
                                           backend=backend)
            results[backend] = (out, torch.autograd.grad(
                torch.sum(torch.square(out.float())), (qq, kk, vv)))
        out, grads = results["kernel"]
        for backend in ("plain", "ref"):
            _close(out.detach(), results[backend][0].detach(), ATOL)
            for gt, wt in zip(grads, results[backend][1]):
                _close(gt, wt, 1e-4)
