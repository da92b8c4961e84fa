"""The training kernels' plain versions, held against the JAX reference's
Pallas kernels.

Inputs are made with numpy from a seed and fed to both sides.  The
reference's Pallas kernels run in interpret mode, as its own tests run them
on the CPU.  Tolerances: fp32 outputs and gradients within 1e-5 of the
largest reference entry (at least 1); bf16 outputs within one bf16 rounding
step (2^-7 of the largest entry), since both sides compute in fp32 and
round once.  ``tests/test_torch_train_autograd.py`` holds the autograd
Functions; ``tests/test_torch_cuda.py`` each CUDA kernel against its plain
version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lln_attention import (lln_causal_pallas,
                                         lln_diag_fused_pallas)
from repro.kernels.lln_backward import (lln_causal_bwd_pallas,
                                        lln_diag_fused_bwd_pallas)
from repro_torch.kernels.lln_attention import (lln_causal, lln_causal_plain,
                                               lln_diag_fused,
                                               lln_diag_fused_plain)
from repro_torch.kernels.lln_backward import (lln_causal_bwd,
                                              lln_causal_bwd_plain,
                                              lln_diag_fused_bwd,
                                              lln_diag_fused_bwd_plain)

BLK, D = 16, 16
FP32 = 1e-5
BF16 = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, rel):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    atol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _case(seed, r, n, dtype):
    """Kernel-layout inputs on both sides: fp32 qs/ks, raw q/k/v and a
    cotangent g in ``dtype`` (rounded once, from the same numpy draws)."""
    rng = np.random.default_rng(seed)
    bg = 2
    bh = bg * r
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    arrays = {"qs": f(bh, n, D) - 0.5, "ks": f(bg, n, D) - 0.5,
              "q": f(bh, n, D), "k": f(bg, n, D), "v": f(bg, n, D),
              "g": f(bh, n, D)}
    jdt, tdt = DTYPES[dtype]
    jx, tt = {}, {}
    for name, a in arrays.items():
        cast = name not in ("qs", "ks")
        jx[name] = jnp.asarray(a, jdt if cast else jnp.float32)
        tt[name] = torch.from_numpy(np.array(jx[name], np.float32)).to(
            tdt if cast else torch.float32)
    return jx, tt


CASES = [pytest.param(r, n, dt, id=f"r{r}-n{n}-{dt}")
         for r in (1, 4) for n in (BLK, 2 * BLK) for dt in DTYPES]


@pytest.mark.parametrize("r,n,dtype", CASES)
def test_lln_causal_res_matches_pallas(r, n, dtype):
    jx, tt = _case(1, r, n, dtype)
    j_out, j_den = lln_causal_pallas(jx["qs"], jx["ks"], jx["v"], r=r,
                                     blk=BLK, interpret=True, return_res=True)
    out, den = lln_causal(tt["qs"], tt["ks"], tt["v"], r=r, blk=BLK,
                          return_res=True, return_state=False)
    assert out.dtype == tt["v"].dtype and den.dtype == torch.float32
    _close(out, j_out, FP32 if dtype == "float32" else BF16)
    _close(den, j_den, FP32)


@pytest.mark.parametrize("r,n,dtype", CASES)
def test_lln_diag_fused_matches_pallas(r, n, dtype):
    jx, tt = _case(2, r, n, dtype)
    j_out, j_den = lln_diag_fused_pallas(
        jx["qs"], jx["ks"], jx["q"], jx["k"], jx["v"], r=r, blk=BLK,
        interpret=True, return_res=True)
    out, den = lln_diag_fused(tt["qs"], tt["ks"], tt["q"], tt["k"], tt["v"],
                              r=r, blk=BLK, return_res=True)
    assert out.dtype == tt["v"].dtype
    _close(out, j_out, FP32 if dtype == "float32" else BF16)
    _close(den, j_den, FP32)
    assert torch.equal(lln_diag_fused(tt["qs"], tt["ks"], tt["q"], tt["k"],
                                      tt["v"], r=r, blk=BLK), out)


@pytest.mark.parametrize("r,n,dtype", CASES)
def test_lln_causal_bwd_matches_pallas(r, n, dtype):
    jx, tt = _case(3, r, n, dtype)
    j_out, j_den = lln_causal_pallas(jx["qs"], jx["ks"], jx["v"], r=r,
                                     blk=BLK, interpret=True, return_res=True)
    want = lln_causal_bwd_pallas(jx["qs"], jx["ks"], jx["v"], jx["g"], j_out,
                                 j_den, r=r, blk=BLK, interpret=True)
    o = torch.from_numpy(np.asarray(j_out, np.float32)).to(tt["v"].dtype)
    den = torch.from_numpy(np.asarray(j_den))
    got = lln_causal_bwd(tt["qs"], tt["ks"], tt["v"], tt["g"], o, den, r=r,
                         blk=BLK)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        _close(g_, w_, FP32)


@pytest.mark.parametrize("r,n,dtype", CASES)
def test_lln_diag_fused_bwd_matches_pallas(r, n, dtype):
    jx, tt = _case(4, r, n, dtype)
    j_out, j_den = lln_diag_fused_pallas(
        jx["qs"], jx["ks"], jx["q"], jx["k"], jx["v"], r=r, blk=BLK,
        interpret=True, return_res=True)
    want = lln_diag_fused_bwd_pallas(
        jx["qs"], jx["ks"], jx["q"], jx["k"], jx["v"], jx["g"], j_out, j_den,
        r=r, blk=BLK, interpret=True)
    o = torch.from_numpy(np.asarray(j_out, np.float32)).to(tt["v"].dtype)
    den = torch.from_numpy(np.asarray(j_den))
    got = lln_diag_fused_bwd(tt["qs"], tt["ks"], tt["q"], tt["k"], tt["v"],
                             tt["g"], o, den, r=r, blk=BLK)
    assert len(got) == 5
    for g_, w_ in zip(got, want):
        _close(g_, w_, FP32)


def test_wrappers_run_plain_on_cpu_and_check_blocks():
    """On a CPU tensor each wrapper is its plain version (no launch); the
    block contract N % blk == 0 is the reference's."""
    _, tt = _case(5, 2, 2 * BLK, "float32")
    counts = [fn.launches for fn in (lln_causal, lln_diag_fused,
                                     lln_causal_bwd, lln_diag_fused_bwd)]
    a = lln_diag_fused(tt["qs"], tt["ks"], tt["q"], tt["k"], tt["v"], r=2,
                       blk=BLK)
    b = lln_diag_fused_plain(tt["qs"], tt["ks"], tt["q"], tt["k"], tt["v"],
                             r=2, blk=BLK)
    assert torch.equal(a, b)
    out, den = lln_causal_plain(tt["qs"], tt["ks"], tt["v"], r=2, blk=BLK,
                                return_res=True, return_state=False)
    got = lln_causal_bwd(tt["qs"], tt["ks"], tt["v"], tt["g"], out, den, r=2,
                         blk=BLK)
    want = lln_causal_bwd_plain(tt["qs"], tt["ks"], tt["v"], tt["g"], out,
                                den, r=2, blk=BLK)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert counts == [fn.launches for fn in (lln_causal, lln_diag_fused,
                                             lln_causal_bwd,
                                             lln_diag_fused_bwd)]
    with pytest.raises(ValueError, match="multiple of blk"):
        lln_diag_fused_bwd_plain(tt["qs"], tt["ks"], tt["q"], tt["k"],
                                 tt["v"], tt["g"], out, den, r=2, blk=12)
