"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

The kernels have no CPU mode, so every test here skips where there is no
CUDA card.  This file imports neither JAX nor the reference package, so it
runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 outputs and the fp32 (s, z) state 2e-4 relative to the
largest entry (the CPU suite's fp32 tolerance); bf16 outputs one bf16
rounding step, 2^-7 of the largest entry, since both sides compute in fp32
and round once.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.block_diag import block_diag, block_diag_plain
from repro_torch.kernels.lln_attention import (lln_causal, lln_causal_plain,
                                               lln_decode, lln_decode_plain)

ATOL = 2e-4


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
