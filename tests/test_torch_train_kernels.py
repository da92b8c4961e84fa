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

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.kernels.lln_attention import (lln_causal_pallas,
                                         lln_diag_fused_pallas)
from repro.kernels.lln_backward import (lln_causal_bwd_pallas,
                                        lln_diag_fused_bwd_pallas)
from repro.kernels.ref import (block_diag_ref, lln_bwd_ref,
                               lln_diag_fused_bwd_ref, lln_diag_fused_ref)
from repro_torch.kernels.block_diag import block_diag_plain
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


@pytest.mark.parametrize("r", [1, 4])
def test_lln_causal_bwd_plain_is_independent_of_its_chunk(r):
    """The gradients at blk 16, 64 and 256 agree within 1e-5 of the
    largest entry: the chunk splits the sums, no more, so the CUDA kernels
    take their own block whatever the caller's blk."""
    _, tt = _case(6 + r, r, 256, "float32")
    o, den = lln_causal_plain(tt["qs"], tt["ks"], tt["v"], r=r, blk=BLK,
                              return_res=True, return_state=False)
    runs = [lln_causal_bwd_plain(tt["qs"], tt["ks"], tt["v"], tt["g"], o,
                                 den, r=r, blk=b) for b in (16, 64, 256)]
    for run in runs[1:]:
        for got, want in zip(run, runs[0]):
            _close(got, want.numpy(), FP32)


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


@pytest.mark.parametrize("r,d,dv", [(1, 192, 128), (8, 256, 256)],
                         ids=["mla-d192-dv128", "paligemma-r8-d256"])
def test_wide_head_plain_versions_match_the_reference(r, d, dv):
    """At the families' wide heads, whose bf16 kernels on the card are the
    tensor-core routes held to these plain versions: causal
    ``block_diag_plain`` against ``block_diag_ref``,
    ``lln_diag_fused_plain`` against ``lln_diag_fused_ref``,
    ``lln_diag_fused_bwd_plain`` against ``lln_diag_fused_bwd_ref`` and
    ``lln_causal_bwd_plain`` against ``lln_bwd_ref`` (the reference's
    quadratic oracles), fp32, N 64, blk 32, within 1e-5 of the largest
    reference entry."""
    n, blk, bg = 64, 32, 2
    bh = bg * r
    rng = np.random.default_rng(32 * r + d)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    a = {"qs": f(bh, n, d) - 0.5, "ks": f(bg, n, d) - 0.5, "q": f(bh, n, d),
         "k": f(bg, n, d), "v": f(bg, n, dv), "g": f(bh, n, dv)}
    tt = {k: torch.from_numpy(v) for k, v in a.items()}
    got = block_diag_plain(tt["q"], tt["k"], tt["v"], r=r, blk=blk,
                           causal=True)
    want = block_diag_ref(jnp.asarray(a["q"]), jnp.asarray(a["k"]),
                          jnp.asarray(a["v"]), block=blk, causal=True, r=r)
    _close(got, want, FP32)
    o, den = lln_diag_fused_plain(tt["qs"], tt["ks"], tt["q"], tt["k"],
                                  tt["v"], r=r, blk=blk, return_res=True)
    want = lln_diag_fused_ref(
        *(jnp.asarray(a[k]) for k in ("qs", "ks", "q", "k", "v")),
        block=blk, causal=True, r=r)
    _close(o, want, FP32)
    got = lln_diag_fused_bwd_plain(tt["qs"], tt["ks"], tt["q"], tt["k"],
                                   tt["v"], tt["g"], o, den, r=r, blk=blk)
    want = lln_diag_fused_bwd_ref(
        *(jnp.asarray(a[k]) for k in ("qs", "ks", "q", "k", "v", "g")),
        jnp.asarray(o.numpy()), jnp.asarray(den.numpy()), block=blk, r=r)
    for gt, wt in zip(got, want):
        _close(gt, wt, FP32)
    lo, lden = lln_causal_plain(tt["qs"], tt["ks"], tt["v"], r=r, blk=blk,
                                return_res=True, return_state=False)
    got = lln_causal_bwd_plain(tt["qs"], tt["ks"], tt["v"], tt["g"], lo,
                               lden, r=r, blk=blk)
    want = lln_bwd_ref(
        *(jnp.asarray(a[k]) for k in ("qs", "ks", "v", "g")),
        jnp.asarray(lo.numpy()), jnp.asarray(lden.numpy()), causal=True, r=r)
    for gt, wt in zip(got, want):
        _close(gt, wt, FP32)
