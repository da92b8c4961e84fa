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
reference; gradients through the autograd Functions to 1e-4.
``block_diag`` and ``block_diag_bwd`` (bf16 on the tensor cores, with the
fp32 p and dsm as hi + lo bf16; fp32 on the CUDA cores) are held at blk 16,
64 and 256, N 64, 300 and 512, D = Dv = 64 and 128 and one D != Dv, r in
{1, 4, 8}, causal and not, their backward's two runs bitwise equal.  The
encoder's kernels (``lln_bidir``, ``lln_bidir_bwd``, ``block_diag_bwd``)
are held the same way at D = 64, r in {1, 4}, whole and ragged N; the
tensor-core path of ``lln_bidir`` and ``lln_bidir_bwd`` (bf16 v: (s, z)
and (dS, dz) by the causal pair's state kernel with one block of N rows,
every fp32 operand of the backward and the state in three bf16 planes)
also at N in {1025, 512, 300, 40, 1}, (D, Dv) in {(64, 64), (128, 128), (64,
112)}, out within one bf16 step, s, z, den and the gradients within 1e-5,
two runs of each bitwise equal, and through the Functions on bf16 inputs
(one launch each).  The
log-linear kernel (``loglin_causal``) is held the same way at r in {1, 8},
whole and ragged N, with and without the state (the pyramid and the open
bucket, fp32, 2e-4 of the largest entry); its two-pass decode
(``ops.loglin_decode_chunk``) on the kernels against the plain versions.
The SSD kernel (``ssd``) is held against its plain version at the
mamba2-130m and zamba2-7b training shapes and at small ones (G = 4, blk
not a multiple of the 64-row tile, P not a multiple of the 64 columns),
fp32 y within 1e-4 of the largest entry (sums and the cumulative sum of
log a taken in another order); ``ops.ssd_scan``'s gradients on the kernel
route against the plain route within 1e-5 (both differentiate the core
scan).  The fused LLN + diag kernels are held at zamba2-7b's head dim
D = 112; one mamba2-130m SMOKE train step counts its launches.  The fused
pair's bf16 tensor-core path (its fp32 operands as two bf16 planes
forward, three backward) is held at r in {1, 4, 8}, (N, blk) in {(64,
16), (256, 64), (512, 256)} and (D, Dv) in {(64, 64), (112, 112), (128,
128), (64, 128)}, out within one bf16 step, den and the five gradients
within 1e-5 of the largest plain entry, two backward runs bitwise equal;
the model-level gradients' bitwise check runs bf16 inputs too.  The
tensor-core paths of ``loglin_causal`` (bf16 v: Phi(k) in three bf16 planes
for the state, two for the outputs) and ``ssd`` (bf16 B/C: three planes in
the state, two for the scores and xbar) are held at r in {1, 4, 8}, N in
{2048, 2040, 300}, blk in {16, 64, 256}, levels 1-5 and D != Dv, out within
one bf16 step and the state within 1e-5 of the largest plain entry; and at
r in {1, 24, 112}, S in {16, 64, 128}, P in {32, 64}, blk in {64, 256}, y
within 1e-4; two runs of each bitwise equal.  The tensor-core paths of
``lln_causal`` and ``lln_causal_bwd`` (bf16 v: the states with Phi in three
planes, the outputs two, the backward three throughout) are held at r in
{1, 4, 8}, N in {64, 512, 300}, (D, Dv) in {(64, 64), (128, 128), (64,
128)} and the kernels' blocks of 64, 128 and 256 rows: out within one bf16
step, den, the final (s, z) and the gradients within 1e-5 of the largest
plain entry, two backward runs bitwise equal; their fp32 cases hold the
CUDA-core kernels.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.loglinear import LogLinState
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
from repro_torch.kernels.loglinear import loglin_causal, loglin_causal_plain
from repro_torch.kernels.ssd import ssd, ssd_plain

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


# (n, blk, d, dv, r): blk 16 and 64 (below and at the tensor-core kernels'
# 64-row tile) and 256, whole and ragged N, D = Dv = 64 and 128, one
# D != Dv, r in {1, 4, 8} (the serve shape has r = 8).
BLOCK_DIAG_CASES = [
    pytest.param(*c, id="n{}-blk{}-d{}-dv{}-r{}".format(*c))
    for c in ((64, 16, 64, 64, 4), (300, 256, 64, 64, 4),
              (512, 256, 128, 128, 8), (300, 64, 128, 128, 1),
              (512, 64, 64, 64, 1), (64, 64, 128, 128, 8),
              (300, 16, 64, 64, 8), (300, 256, 64, 128, 4),
              (512, 16, 128, 128, 4))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,blk,d,dv,r", BLOCK_DIAG_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_block_diag_matches_plain(cuda, n, blk, d, dv, r, dtype, causal):
    """block_diag (bf16: the tensor-core kernel; fp32: the CUDA-core one)
    within one bf16 step (fp32: ATOL) of its plain version, and
    block_diag_bwd's fp32 dq/dk/dv within 1e-5 of the largest plain entry,
    two runs bitwise equal."""
    rng = np.random.default_rng(n + blk + d + dv + r)
    q = rng.normal(size=(2 * r, n, d)).astype(np.float32)
    k = rng.normal(size=(2, n, d)).astype(np.float32)
    v = rng.normal(size=(2, n, dv)).astype(np.float32)
    g = rng.normal(size=(2 * r, n, dv)).astype(np.float32)
    q, k, v, g = _on(cuda, q, k, v, g, dtype=dtype)
    got = block_diag(q, k, v, r=r, blk=blk, causal=causal)
    want = block_diag_plain(q, k, v, r=r, blk=blk, causal=causal)
    torch.cuda.synchronize()
    _close(got, want, ATOL if dtype == torch.float32 else BF16)
    got = block_diag_bwd(q, k, v, g, r=r, blk=blk, causal=causal)
    want = block_diag_bwd_plain(q, k, v, g, r=r, blk=blk, causal=causal)
    again = block_diag_bwd(q, k, v, g, r=r, blk=blk, causal=causal)
    torch.cuda.synchronize()
    for gt, wt, ag in zip(got, want, again):
        _close(gt, wt, TRAIN)
        assert torch.equal(gt, ag)


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
    wide = torch.zeros(2, 32, 256, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="128"):
        block_diag(wide, wide, wide, r=1, blk=16)
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
@pytest.mark.parametrize("impl,dtype", [
    pytest.param("lln", torch.float32, id="lln"),
    pytest.param("lln_diag", torch.float32, id="lln_diag"),
    pytest.param("lln_diag", torch.bfloat16, id="lln_diag-bf16")])
def test_cuda_gradients_are_bitwise_reproducible(cuda, impl, dtype):
    """No atomics: dk and dv are summed over the r heads in a fixed order,
    so the same inputs give the same gradients bit for bit (bf16: the
    fused pair's tensor-core path)."""
    fn = ops.lln_attention if impl == "lln" else ops.lln_diag_attention
    q, k, v, alpha, beta = _model_inputs(cuda, 4, n=128, r=4)
    args = (q.to(dtype), k.to(dtype), v.to(dtype), alpha, beta)
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
@pytest.mark.parametrize("n", [64, 40], ids=["n64", "ragged-n40"])
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_cuda_bidir_autograd_bf16_runs_the_kernels(cuda, impl, n):
    """The bidirectional Functions on bf16 q/k/v, the route the encoder
    takes on the card (lln_bidir's and lln_bidir_bwd's tensor-core
    kernels): one launch of each kernel, bf16 gradients of the right shape
    within 2^-4 of the largest entry of the plain versions' (two bf16
    routes that round in different places: the outputs differentiated may
    be a bf16 step apart and the cotangent 2 out is rounded to bf16; the
    plain route and the core reference differ by up to 2% here)."""
    fn = ops.lln_attention if impl == "lln" else ops.lln_diag_attention
    kernels = [lln_bidir, lln_bidir_bwd]
    if impl == "lln_diag":
        kernels += [block_diag, block_diag_bwd]
    q, k, v, alpha, beta = _model_inputs(cuda, 6, n=n)
    args = (q.bfloat16(), k.bfloat16(), v.bfloat16(), alpha, beta)
    before = [f.launches for f in kernels]
    got = _bidir_grads(fn, "kernel", *args)
    assert [f.launches - b for f, b in zip(kernels, before)] == \
        [1] * len(kernels)
    want = _bidir_grads(fn, "plain", *args)
    for gt, wt, x in zip(got, want, args):
        assert gt.dtype == torch.bfloat16 and gt.shape == x.shape
        _close(gt, wt, 2.0 ** -4)


BIDIR_TC_CASES = [pytest.param(r, n, d, dv, id=f"r{r}-n{n}-d{d}-dv{dv}")
                  for r in (1, 4) for n in (1025, 512, 300, 40, 1)
                  for d, dv in ((64, 64), (128, 128), (64, 112))]


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,d,dv", BIDIR_TC_CASES)
def test_cuda_bidir_tensor_core_path_matches_plain(cuda, r, n, d, dv):
    """lln_bidir and lln_bidir_bwd on bf16 v (the tensor-core path)
    against their plain twins: N of several 64-row tiles, ragged (300, 40)
    and one row, 1025 (17 steps of the state walk, the last of one row),
    D = Dv = 64 (the encoder's) and 128, D != Dv with Dv = 112,
    r = 4 on the hybrid's cotangent 0.5 g.  out within one bf16 step; s, z,
    den and the three fp32 gradients within 1e-5 of the largest plain
    entry; two runs of each kernel bitwise equal."""
    qs, ks, v = _kernel_inputs(100 * r + n + d + dv, 2 * r, 2, n, d, dv)
    g = np.random.default_rng(n + r + dv).normal(size=(2 * r, n, dv))
    qs, ks = _on(cuda, qs, ks)
    vb, g = _on(cuda, v, g.astype(np.float32), dtype=torch.bfloat16)
    if r > 1:
        g = 0.5 * g
    before = lln_bidir.launches
    got = lln_bidir(qs, ks, vb, r=r, return_res=True)
    again = lln_bidir(qs, ks, vb, r=r, return_res=True)
    want = lln_bidir_plain(qs, ks, vb, r=r, return_res=True)
    torch.cuda.synchronize()
    assert lln_bidir.launches == before + 2
    _close(got[0], want[0], BF16)
    for gt, wt in zip(got[1:], want[1:]):
        assert gt.shape == wt.shape
        _close(gt, wt, TRAIN)
    for gt, ag in zip(got, again):
        assert torch.equal(gt, ag)
    o, s, z, den = want
    before = lln_bidir_bwd.launches
    got = lln_bidir_bwd(qs, ks, vb, g, o, den, s, z, r=r)
    again = lln_bidir_bwd(qs, ks, vb, g, o, den, s, z, r=r)
    want = lln_bidir_bwd_plain(qs, ks, vb, g, o, den, s, z, r=r)
    torch.cuda.synchronize()
    assert lln_bidir_bwd.launches == before + 2
    for gt, wt, ag in zip(got, want, again):
        _close(gt, wt, TRAIN)
        assert torch.equal(gt, ag)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_lln_bidir_is_bitwise_reproducible(cuda, dtype):
    """(s, z) are summed over the sequence in a fixed order, without
    atomics, on both routes: two runs give out, s, z and den bit for
    bit."""
    qs, ks, v = _kernel_inputs(21, 8, 2, 300, 64, 64)
    qs, ks = _on(cuda, qs, ks)
    (v,) = _on(cuda, v, dtype=dtype)
    a = lln_bidir(qs, ks, v, r=4, return_res=True)
    b = lln_bidir(qs, ks, v, r=4, return_res=True)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


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


LOGLIN_CASES = [pytest.param(r, n, st, id=f"r{r}-n{n}-{nm}")
                for r in (1, 8) for n in (128, 200)
                for st, nm in ((True, "state"), (False, "out"))]


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,return_state", LOGLIN_CASES)
def test_cuda_loglin_causal_matches_plain(cuda, r, n, return_state):
    """Granule 32 (whole tiles of 32 rows inside a 64-row tile walk), four
    levels: N = 128 closes four granules, N = 200 six and leaves an open
    bucket of 8 keys; fp32 v, then bf16 v."""
    qs, ks, v = _kernel_inputs(n + r, 2 * r, 2, n, 64, 64)
    qs, ks = _on(cuda, qs, ks)
    for vdtype, tol in ((torch.float32, ATOL), (torch.bfloat16, BF16)):
        (vv,) = _on(cuda, v, dtype=vdtype)
        kw = dict(r=r, blk=32, num_scales=4, scale_decay=0.5,
                  return_state=return_state)
        got = loglin_causal(qs, ks, vv, **kw)
        want = loglin_causal_plain(qs, ks, vv, **kw)
        torch.cuda.synchronize()
        if not return_state:
            got, want = (got,), (want,)
        _close(got[0], want[0], tol)
        for gt, wt in zip(got[1:], want[1:]):
            _close(gt, wt, ATOL)


@pytest.mark.cuda
def test_cuda_loglin_causal_is_bitwise_reproducible(cuda):
    """No atomics: two runs give the same outputs and state bit for bit."""
    qs, ks, v = _on(cuda, *_kernel_inputs(9, 16, 2, 300, 64, 64))
    kw = dict(r=8, blk=64, num_scales=3, scale_decay=0.5, return_state=True)
    before = loglin_causal.launches
    a = loglin_causal(qs, ks, v, **kw)
    b = loglin_causal(qs, ks, v, **kw)
    assert loglin_causal.launches == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


LOGLIN_TC_DIMS = ((128, 128), (64, 96), (96, 64))
LOGLIN_TC_CASES = [
    pytest.param(r, n, blk, 1 + i % 5, *LOGLIN_TC_DIMS[i % 3], st,
                 id=f"r{r}-n{n}-blk{blk}-L{1 + i % 5}-d{LOGLIN_TC_DIMS[i % 3][0]}"
                    f"-dv{LOGLIN_TC_DIMS[i % 3][1]}-{'state' if st else 'out'}")
    for i, (r, n, blk, st) in enumerate(
        (r, n, blk, st) for r in (1, 4, 8) for n in (2048, 2040, 300)
        for blk in (16, 64, 256) for st in (True, False))]


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,blk,levels,d,dv,return_state", LOGLIN_TC_CASES)
def test_cuda_loglin_tensor_core_path_matches_plain(cuda, r, n, blk, levels,
                                                    d, dv, return_state):
    """loglin_causal on bf16 v (the tensor-core path) against its plain
    twin: out within one bf16 step, the pyramid and the open bucket within
    1e-5 of the largest plain entry, two runs bitwise equal.  N = 2040 and
    300 leave an open bucket at every blk; blk 16 with N = 2048 closes 128
    granules, so every level fills and the top one saturates."""
    qs, ks, v = _kernel_inputs(r * n + blk + levels, 2 * r, 2, n, d, dv)
    qs, ks = _on(cuda, qs, ks)
    (vb,) = _on(cuda, v, dtype=torch.bfloat16)
    kw = dict(r=r, blk=blk, num_scales=levels, scale_decay=0.5,
              return_state=return_state)
    got = loglin_causal(qs, ks, vb, **kw)
    again = loglin_causal(qs, ks, vb, **kw)
    want = loglin_causal_plain(qs, ks, vb, **kw)
    torch.cuda.synchronize()
    if not return_state:
        got, again, want = (got,), (again,), (want,)
    _close(got[0], want[0], BF16)
    for gt, wt in zip(got[1:], want[1:]):
        _close(gt, wt, TRAIN)
    for gt, ag in zip(got, again):
        assert torch.equal(gt, ag)


@pytest.mark.cuda
def test_cuda_decode_takes_masked_keys(cuda):
    """Keys masked to -1e30 (the log-linear decode's passes) give Phi(k) =
    0 in the decode kernel: finite outputs equal to the plain version, and
    a state that the masked keys leave unchanged."""
    qs, ks, v = _kernel_inputs(12, 8, 2, 20, 64, 64)
    ks[:, 3:11] = -1e30
    rng = np.random.default_rng(12)
    s0 = rng.normal(size=(8, 64, 64)).astype(np.float32)
    z0 = rng.uniform(0.5, 3.0, (8, 1, 64)).astype(np.float32)
    args = _on(cuda, qs, ks, v, s0, z0)
    got = lln_decode(*args, r=4)
    want = lln_decode_plain(*args, r=4)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    for gt, wt in zip(got, want):
        _close(gt, wt, ATOL)
    kept = lln_decode(*[a[:, :3].contiguous() if i < 3 else a
                        for i, a in enumerate(args)], r=4)
    _close(got[1], kept[1] + torch.repeat_interleave(
        torch.einsum("gjd,gjv->gdv", torch.exp(args[1][:, 11:]),
                     args[2][:, 11:]), 4, 0), ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 100])
def test_cuda_loglin_decode_matches_plain(cuda, t):
    """``ops.loglin_decode_chunk`` on the kernels against the plain
    versions, from a prefill state 10 tokens short of a granule boundary:
    T = 100 crosses it and runs each pass as two chained launches; T = 1
    runs one launch per pass."""
    rng = np.random.default_rng(t)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(cuda)
    b, g, r, d, blk = 2, 2, 4, 64, 128
    h = g * r
    n = 3 * blk - 10
    alpha, beta = torch.full((h,), 1.3, device=cuda), torch.full(
        (g,), 1.1, device=cuda)
    kw = dict(chunk=blk, num_scales=3, scale_decay=0.5)
    pre = ops.loglin_prefill(f(b, n, h, d), f(b, n, g, d), f(b, n, g, d),
                             alpha, beta, backend="plain", **kw)
    state = LogLinState(*pre[1:], log_scale=torch.zeros(b, h, device=cuda))
    q, k, v = f(b, t, h, d), f(b, t, g, d), f(b, t, g, d)
    pos = torch.full((b,), n, dtype=torch.int32, device=cuda)
    before = lln_decode.launches
    got, gst = ops.loglin_decode_chunk(
        state, q, k, v, alpha, beta, pos=pos, granule=blk, num_scales=3,
        scale_decay=0.5, backend="kernel")
    assert lln_decode.launches == before + (2 if t == 1 else 4)
    want, wst = ops.loglin_decode_chunk(
        state, q, k, v, alpha, beta, pos=pos, granule=blk, num_scales=3,
        scale_decay=0.5, backend="plain")
    torch.cuda.synchronize()
    _close(got, want, ATOL)
    for name in ("s", "z", "c_k", "sl", "zl", "cl"):
        assert torch.equal(getattr(gst, name), getattr(wst, name)), name


def _ssd_inputs(dev, seed, bh, bg, n, p, s, dtype, h=None):
    """Kernel-layout SSD inputs: log a = dt * a with dt = softplus(.) and
    a = -linspace(1, 16) over the ``h`` heads (mamba2's decays), xbar =
    x dt, B/C in ``dtype``."""
    rng = np.random.default_rng(seed)
    h = h or bh
    dt = np.logaddexp(rng.normal(size=(bh, n)) * 0.5 - 0.5, 0.0)
    a = -np.tile(np.linspace(1.0, 16.0, h), bh // h)[:, None]
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)  # noqa: E731
    log_a = (dt * a).astype(np.float32)
    xbar = (f(bh, n, p) * dt[..., None]).astype(np.float32)
    out = _on(dev, log_a, xbar, f(bg, n, s), f(bg, n, s))
    return out[0], out[1], out[2].to(dtype), out[3].to(dtype)


def _ssd_close(got, want):
    want = want.float().cpu()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * max(1.0, float(want.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s", [(8, 24, 128), (4, 112, 64)],
                         ids=["mamba2-130m", "zamba2-7b"])
def test_cuda_ssd_matches_plain_at_the_train_shapes(cuda, b, h, s):
    """N = 2048, P = 64, blk 256, bf16 B/C, one group; two runs bitwise
    equal (no atomics)."""
    args = _ssd_inputs(cuda, h, b * h, b, 2048, 64, s, torch.bfloat16, h=h)
    before = ssd.launches
    got = ssd(*args, r=h, blk=256)
    again = ssd(*args, r=h, blk=256)
    want = ssd_plain(*args, r=h, blk=256)
    torch.cuda.synchronize()
    assert ssd.launches == before + 2
    _ssd_close(got, want)
    assert torch.equal(got, again)


SSD_CASES = [pytest.param(g, n, blk, p, dt, id=f"g{g}-n{n}-blk{blk}-p{p}-{nm}")
             for g, n, blk, p in ((4, 256, 256, 64), (1, 192, 96, 70),
                                  (2, 64, 16, 32))
             for dt, nm in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))]


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,blk,p,dtype", SSD_CASES)
def test_cuda_ssd_matches_plain(cuda, g, n, blk, p, dtype):
    """Two batch rows of eight heads in g groups (r = 8 / g); blk 96 leaves
    a 32-row second tile, P = 70 a second CTA of 6 columns, blk 16 one
    short tile; S = 48."""
    args = _ssd_inputs(cuda, n + g, 16, 2 * g, n, p, 48, dtype, h=8)
    got = ssd(*args, r=8 // g, blk=blk)
    want = ssd_plain(*args, r=8 // g, blk=blk)
    torch.cuda.synchronize()
    _ssd_close(got, want)


SSD_TC_CASES = [pytest.param(r, s, p, blk, id=f"r{r}-s{s}-p{p}-blk{blk}")
                for r in (1, 24, 112) for s in (16, 64, 128) for p in (32, 64)
                for blk in (64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,p,blk", SSD_TC_CASES)
def test_cuda_ssd_tensor_core_path_matches_plain(cuda, r, s, p, blk):
    """ssd on bf16 B/C (the tensor-core path) against its plain twin: two
    batch rows of r heads in one group each (mamba2-130m's r = 24,
    zamba2-7b's 112), N = 512; y within 1e-4 of the largest entry, two runs
    bitwise equal."""
    args = _ssd_inputs(cuda, r + s + p + blk, 2 * r, 2, 512, p, s,
                       torch.bfloat16, h=r)
    got = ssd(*args, r=r, blk=blk)
    again = ssd(*args, r=r, blk=blk)
    want = ssd_plain(*args, r=r, blk=blk)
    torch.cuda.synchronize()
    _ssd_close(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_ssd_refuses_bad_inputs(cuda):
    la, xb, bb, cc = _ssd_inputs(cuda, 0, 4, 2, 64, 32, 16, torch.float32)
    before = ssd.launches
    with pytest.raises(TypeError, match="float32"):
        ssd(la, xb.bfloat16(), bb, cc, r=2, blk=16)
    with pytest.raises(TypeError, match="share"):
        ssd(la, xb, bb, cc.bfloat16(), r=2, blk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd(la, xb.transpose(0, 1).contiguous().transpose(0, 1), bb, cc, r=2,
            blk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd(la, xb, bb, cc, r=2, blk=24)
    big = torch.zeros(2, 64, 160, device=cuda)
    with pytest.raises(ValueError, match="at most 128"):
        ssd(la, xb, big, big, r=2, blk=16)
    assert ssd.launches == before


@pytest.mark.cuda
def test_cuda_ssd_scan_kernel_route_matches_plain(cuda):
    """``ops.ssd_scan``: y within 1e-4 of the largest entry, and the
    gradients of all four inputs within 1e-5 (the same backward, the core
    scan, on both routes)."""
    b, l, h, g, p, s = 2, 512, 8, 2, 64, 32
    la, xb, bb, cc = _ssd_inputs(cuda, 5, b * h, b * g, l, p, s,
                                 torch.float32, h=h)
    inputs = [xb.reshape(b, h, l, p).transpose(1, 2),
              bb.reshape(b, g, l, s).transpose(1, 2),
              cc.reshape(b, g, l, s).transpose(1, 2),
              la.reshape(b, h, l).transpose(1, 2)]
    cot = torch.randn(b, l, h, p, device=cuda)
    runs = {}
    for kind in ("kernel", "plain"):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        before = ssd.launches
        y = ops.ssd_scan(*leaves, 256, backend=kind)
        assert ssd.launches == before + (kind == "kernel")
        runs[kind] = (y.detach(), torch.autograd.grad(y, leaves, cot))
    _ssd_close(runs["kernel"][0], runs["plain"][0])
    for gt, wt in zip(runs["kernel"][1], runs["plain"][1]):
        _close(gt, wt, TRAIN)


@pytest.mark.cuda
def test_cuda_fused_kernels_match_plain_at_head_dim_112(cuda):
    """zamba2-7b's shared attention head dim, D = Dv = 112: 3.5 of the
    kernels' 32-column groups."""
    qs, ks, q, k, v, g = _train_inputs(cuda, 112, 1, 512, 112,
                                       torch.bfloat16)
    got = lln_diag_fused(qs, ks, q, k, v, r=1, blk=256, return_res=True)
    o, den = lln_diag_fused_plain(qs, ks, q, k, v, r=1, blk=256,
                                  return_res=True)
    torch.cuda.synchronize()
    _close(got[0], o, BF16)
    _close(got[1], den, TRAIN)
    got = lln_diag_fused_bwd(qs, ks, q, k, v, g, o, den, r=1, blk=256)
    want = lln_diag_fused_bwd_plain(qs, ks, q, k, v, g, o, den, r=1,
                                    blk=256)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        _close(gt, wt, TRAIN)


FUSED_TC_CASES = [
    pytest.param(r, n, blk, d, dv, id=f"r{r}-n{n}-blk{blk}-d{d}-dv{dv}")
    for r in (1, 4, 8) for n, blk in ((64, 16), (256, 64), (512, 256))
    for d, dv in ((64, 64), (112, 112), (128, 128), (64, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,blk,d,dv", FUSED_TC_CASES)
def test_cuda_fused_tensor_core_path_matches_plain(cuda, r, n, blk, d, dv):
    """lln_diag_fused and lln_diag_fused_bwd on bf16 inputs (the tensor-core
    path: blk below, at and above the 64-row tile, zamba2-7b's D = 112, D
    != Dv, r up to yi-9b's 8) against their plain twins: out within one
    bf16 step, den and the five fp32 gradients within 1e-5 of the largest
    plain entry, two backward runs bitwise equal."""
    rng = np.random.default_rng(1000 * r + n + blk + d + dv)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(cuda)
    qs, ks = f(2 * r, n, d) - 0.5, f(2, n, d) - 0.5
    q, k = f(2 * r, n, d).bfloat16(), f(2, n, d).bfloat16()
    v, g = f(2, n, dv).bfloat16(), f(2 * r, n, dv).bfloat16()
    got = lln_diag_fused(qs, ks, q, k, v, r=r, blk=blk, return_res=True)
    o, den = lln_diag_fused_plain(qs, ks, q, k, v, r=r, blk=blk,
                                  return_res=True)
    torch.cuda.synchronize()
    _close(got[0], o, BF16)
    _close(got[1], den, TRAIN)
    got = lln_diag_fused_bwd(qs, ks, q, k, v, g, o, den, r=r, blk=blk)
    again = lln_diag_fused_bwd(qs, ks, q, k, v, g, o, den, r=r, blk=blk)
    want = lln_diag_fused_bwd_plain(qs, ks, q, k, v, g, o, den, r=r, blk=blk)
    torch.cuda.synchronize()
    for gt, wt, ag in zip(got, want, again):
        _close(gt, wt, TRAIN)
        assert torch.equal(gt, ag)


LLN_TC_DIMS = ((64, 64), (128, 128), (64, 128))
LLN_TC_CASES = [
    pytest.param(r, n, *LLN_TC_DIMS[j], (64, 128, 256)[(i + j) % 3],
                 id=f"r{r}-n{n}-d{LLN_TC_DIMS[j][0]}-dv{LLN_TC_DIMS[j][1]}"
                    f"-blk{(64, 128, 256)[(i + j) % 3]}")
    for r in (1, 4, 8) for i, n in enumerate((64, 512, 300))
    for j in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,d,dv,tc_blk", LLN_TC_CASES)
def test_cuda_lln_causal_tensor_core_path_matches_plain(cuda, monkeypatch, r,
                                                         n, d, dv, tc_blk):
    """lln_causal (both forms) and lln_causal_bwd on bf16 v (the
    tensor-core paths) against their plain twins, at the kernels' blocks of
    64, 128 and 256 rows: N of one block, of several and ragged (300, a
    short last block in the forward, the state and the backward, whose
    caller's chunk of 20 divides it), D != Dv, r up to yi-9b's 8.  out
    within one bf16 step; den, s, z and the three fp32 gradients within
    1e-5 of the largest plain entry; two backward runs bitwise equal."""
    # The package exports a function of the module's name: take the module.
    monkeypatch.setattr(
        importlib.import_module("repro_torch.kernels.lln_attention"),
        "TC_BLOCK", tc_blk)
    qs, ks, v = _kernel_inputs(100 * r + n + d + dv, 2 * r, 2, n, d, dv)
    g = np.random.default_rng(n + r).normal(size=(2 * r, n, dv))
    qs, ks = _on(cuda, qs, ks)
    vb, g = _on(cuda, v, g.astype(np.float32), dtype=torch.bfloat16)
    blk = 20 if n % 16 else 16
    got = lln_causal(qs, ks, vb, r=r, blk=blk, return_res=True)
    want = lln_causal_plain(qs, ks, vb, r=r, blk=blk, return_res=True)
    torch.cuda.synchronize()
    _close(got[0], want[0], BF16)
    for gt, wt in zip(got[1:], want[1:]):
        _close(gt, wt, TRAIN)
    o, den = want[:2]
    before = lln_causal_bwd.launches
    got = lln_causal_bwd(qs, ks, vb, g, o, den, r=r, blk=blk)
    again = lln_causal_bwd(qs, ks, vb, g, o, den, r=r, blk=blk)
    want = lln_causal_bwd_plain(qs, ks, vb, g, o, den, r=r, blk=blk)
    torch.cuda.synchronize()
    assert lln_causal_bwd.launches == before + 2
    for gt, wt, ag in zip(got, want, again):
        _close(gt, wt, TRAIN)
        assert torch.equal(gt, ag)


@pytest.mark.cuda
def test_cuda_mamba2_smoke_train_step_counts_launches(cuda):
    """One mamba2-130m SMOKE step (2 layers, use_kernel, remat full, seq
    64 = four chunks of 16): two ssd launches per layer (forward and the
    remat recompute) and no other kernel."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import torch_placer
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.steps import make_train_setup
    cfg = get_config("mamba2-130m", smoke=True, use_kernel=True,
                     remat="full")
    setup = make_train_setup(cfg, ShapeSpec("t", 64, 2, "train"),
                             device=cuda, total_steps=3)
    state = setup.init_state(0)
    batch = torch_placer(cuda)(next(lm_batches(cfg.vocab, 2, 64)))
    counted = (ssd, lln_causal, lln_diag_fused, lln_diag_fused_bwd,
               lln_causal_bwd)
    before = [f.launches for f in counted]
    state, m = setup.step_fn(state, batch)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counted, before)] == [
        2 * cfg.n_layers, 0, 0, 0, 0]
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
