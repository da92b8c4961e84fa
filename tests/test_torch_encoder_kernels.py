"""The encoder's kernels: plain versions against the JAX reference's Pallas
kernels, and the bidirectional autograd Functions against its custom_vjps.

Inputs are made with numpy from a seed and fed to both sides; the Pallas
kernels run in interpret mode, as the reference's own tests run them on the
CPU.  Cases: r in {1, 4}, N in {blk, 2 blk}, fp32 and bf16, D in {16, 64}.
In the bf16 cases the backward's cotangent is ``0.5 g`` in bf16 (the
bidirectional hybrid's), against the reference's fp32 ``0.5 g``.  The
backward tests feed both sides the same forward residuals, the plain
version's, so no case pays for a second Pallas forward.  Tolerances as
``tests/test_torch_train_kernels.py``: fp32 outputs and gradients within
1e-5 of the largest reference entry (at least 1); bf16 outputs within one
bf16 rounding step (2^-7 of the largest entry).
Through the Functions: outputs 1e-5, gradients 1e-4 of the largest entry.
``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card.  The tensor-core route of ``lln_bidir`` and
``lln_bidir_bwd`` is checked here without the card: which inputs take it,
the backward's scratch, and that zero-Phi pad rows (how its kernels stage
a ragged N) leave the plain versions' results unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.block_diag import block_diag_bwd_pallas, block_diag_pallas
from repro.kernels.lln_attention import lln_bidir_pallas
from repro.kernels.lln_backward import lln_bidir_bwd_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels.block_diag import (block_diag, block_diag_bwd,
                                            block_diag_bwd_plain,
                                            block_diag_plain)
from repro_torch.kernels.lln_attention import (_tc_path, lln_bidir,
                                               lln_bidir_plain)
from repro_torch.kernels.lln_backward import (_bidir_scratch, lln_bidir_bwd,
                                              lln_bidir_bwd_plain)

BLK = 16
FP32 = 1e-5
BF16 = 2.0 ** -7
GRAD = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, rel):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    atol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _case(seed, r, n, d, dtype):
    """Kernel-layout inputs on both sides: fp32 qs/ks, raw q/k/v and a
    cotangent g in ``dtype`` (rounded once, from the same numpy draws)."""
    rng = np.random.default_rng(seed)
    bg = 2
    bh = bg * r
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    arrays = {"qs": f(bh, n, d) - 0.5, "ks": f(bg, n, d) - 0.5,
              "q": f(bh, n, d), "k": f(bg, n, d), "v": f(bg, n, d),
              "g": f(bh, n, d)}
    jdt, tdt = DTYPES[dtype]
    jx, tt = {}, {}
    for name, a in arrays.items():
        cast = name not in ("qs", "ks")
        jx[name] = jnp.asarray(a, jdt if cast else jnp.float32)
        tt[name] = torch.from_numpy(np.array(jx[name], np.float32)).to(
            tdt if cast else torch.float32)
    return jx, tt


def _cotangent(jx, tt, dtype):
    """(reference cotangent, port cotangent): g itself in fp32; 0.5 g in
    fp32 against 0.5 g in bf16 (exact), as the bidirectional hybrid."""
    if dtype == "float32":
        return jx["g"], tt["g"]
    return 0.5 * jx["g"].astype(jnp.float32), 0.5 * tt["g"]


def _to_jax(t):
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


CASES = [pytest.param(r, n, d, dt, id=f"r{r}-n{n}-d{d}-{dt}")
         for r in (1, 4) for n in (BLK, 2 * BLK) for d in (16, 64)
         for dt in DTYPES]


@pytest.mark.parametrize("r,n,d,dtype", CASES)
def test_lln_bidir_matches_pallas(r, n, d, dtype):
    jx, tt = _case(n + r, r, n, d, dtype)
    want = lln_bidir_pallas(jx["qs"], jx["ks"], jx["v"], r=r, blk=BLK,
                            interpret=True, return_res=True)
    got = lln_bidir(tt["qs"], tt["ks"], tt["v"], r=r, return_res=True)
    assert got[0].dtype == tt["v"].dtype
    _close(got[0], want[0], FP32 if dtype == "float32" else BF16)
    for g_, w_ in zip(got[1:], want[1:]):
        assert g_.dtype == torch.float32 and g_.shape == w_.shape
        _close(g_, w_, FP32)
    assert torch.equal(lln_bidir(tt["qs"], tt["ks"], tt["v"], r=r), got[0])


@pytest.mark.parametrize("r,n,d,dtype", CASES)
def test_lln_bidir_bwd_matches_pallas(r, n, d, dtype):
    jx, tt = _case(2 * n + r, r, n, d, dtype)
    # Both backwards read the same residuals (the forward is held to the
    # Pallas kernel above).
    o, s, z, den = lln_bidir_plain(tt["qs"], tt["ks"], tt["v"], r=r,
                                   return_res=True)
    j_g, g = _cotangent(jx, tt, dtype)
    want = lln_bidir_bwd_pallas(jx["qs"], jx["ks"], jx["v"], j_g, _to_jax(o),
                                _to_jax(den), _to_jax(s), _to_jax(z), r=r,
                                blk=BLK, interpret=True)
    got = lln_bidir_bwd(tt["qs"], tt["ks"], tt["v"], g, o, den, s, z, r=r)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32 and g_.shape == w_.shape
        _close(g_, w_, FP32)


@pytest.mark.parametrize("r,n,d,dtype", CASES)
def test_block_diag_bidir_matches_pallas(r, n, d, dtype):
    jx, tt = _case(3 * n + r, r, n, d, dtype)
    want = block_diag_pallas(jx["q"], jx["k"], jx["v"], r=r, blk=BLK,
                             causal=False, interpret=True)
    got = block_diag(tt["q"], tt["k"], tt["v"], r=r, blk=BLK, causal=False)
    assert got.dtype == tt["v"].dtype
    _close(got, want, FP32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("r,n,d,dtype", CASES)
def test_block_diag_bwd_matches_pallas(r, n, d, dtype):
    jx, tt = _case(4 * n + r, r, n, d, dtype)
    j_g, g = _cotangent(jx, tt, dtype)
    want = block_diag_bwd_pallas(jx["q"], jx["k"], jx["v"], j_g, r=r,
                                 blk=BLK, causal=False, interpret=True)
    got = block_diag_bwd(tt["q"], tt["k"], tt["v"], g, r=r, blk=BLK,
                         causal=False)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32 and g_.shape == w_.shape
        _close(g_, w_, FP32)


@pytest.mark.parametrize("r", [1, 4])
def test_block_diag_bwd_causal_matches_pallas(r):
    """The causal option of the same backward (the standalone
    ``block_diag_attention`` op takes it)."""
    jx, tt = _case(5 + r, r, 2 * BLK, 16, "float32")
    want = block_diag_bwd_pallas(jx["q"], jx["k"], jx["v"], jx["g"], r=r,
                                 blk=BLK, causal=True, interpret=True)
    got = block_diag_bwd(tt["q"], tt["k"], tt["v"], tt["g"], r=r, blk=BLK,
                         causal=True)
    for g_, w_ in zip(got, want):
        _close(g_, w_, FP32)


def test_wrappers_run_plain_on_cpu():
    """On a CPU tensor each wrapper is its plain version (no launch)."""
    _, tt = _case(9, 2, 40, 16, "float32")
    counts = [fn.launches for fn in (lln_bidir, lln_bidir_bwd,
                                     block_diag_bwd)]
    out, s, z, den = lln_bidir(tt["qs"], tt["ks"], tt["v"], r=2,
                               return_res=True)
    want = lln_bidir_plain(tt["qs"], tt["ks"], tt["v"], r=2, return_res=True)
    assert all(torch.equal(a, b) for a, b in zip((out, s, z, den), want))
    got = lln_bidir_bwd(tt["qs"], tt["ks"], tt["v"], tt["g"], out, den, s, z,
                        r=2)
    want = lln_bidir_bwd_plain(tt["qs"], tt["ks"], tt["v"], tt["g"], out,
                               den, s, z, r=2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = block_diag_bwd(tt["q"], tt["k"], tt["v"], tt["g"], r=2, blk=BLK)
    want = block_diag_bwd_plain(tt["q"], tt["k"], tt["v"], tt["g"], r=2,
                                blk=BLK)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counts == [fn.launches for fn in (lln_bidir, lln_bidir_bwd,
                                             block_diag_bwd)]


@pytest.mark.parametrize("dtype,d,dv,want", [
    (torch.bfloat16, 64, 64, True),
    (torch.bfloat16, 128, 128, True),
    (torch.bfloat16, 64, 112, True),
    (torch.float32, 64, 64, False),
    (torch.bfloat16, 160, 64, False),
    (torch.bfloat16, 64, 256, False)],
    ids=["encoder", "wide", "dv112", "fp32-v", "wide-d", "wide-dv"])
def test_bidir_tensor_core_route(dtype, d, dv, want):
    """bf16 v with D, Dv <= 128 takes lln_bidir's and lln_bidir_bwd's
    tensor-core kernels; fp32 v or a wider head the CUDA-core ones."""
    assert _tc_path(torch.zeros(1, 1, dv, dtype=dtype), d, dv) is want


@pytest.mark.parametrize("bh,bg,n,d,dv", [(384, 384, 512, 64, 64),
                                          (8, 2, 300, 64, 112),
                                          (4, 1, 1, 128, 128),
                                          (4, 2, 1025, 128, 64)],
                         ids=["encoder", "ragged", "n1", "n1025"])
def test_bidir_bwd_scratch(bh, bg, n, d, dv):
    """lln_bidir_bwd's scratch, the same on both routes: each query
    row's w (BH,N), the reverse totals dS (BG,D,Dv) and dz (BG,D), all
    fp32 (the tensor-core path keeps no plane or block state)."""
    w, ds, dz = _bidir_scratch(bh, bg, n, d, dv, "cpu")
    assert (w.shape, ds.shape, dz.shape) == ((bh, n), (bg, d, dv), (bg, d))
    assert all(x.dtype == torch.float32 for x in (w, ds, dz))


@pytest.mark.parametrize("r,n,pad,dtype", [(1, 40, 24, "float32"),
                                           (4, 1, 63, "bfloat16"),
                                           (4, 300, 20, "float32"),
                                           (1, 64, 64, "bfloat16")],
                         ids=["r1-n40", "r4-n1", "r4-n300", "r1-n64-bf16"])
def test_bidir_plain_ignores_zero_phi_pad_rows(r, n, pad, dtype):
    """What the tensor-core kernels' staging of a ragged N rests on: pad
    keys and pad query rows with Phi = exp(-inf) = 0 (v any value, g zero)
    leave lln_bidir_plain's out, s, z and den and lln_bidir_bwd_plain's
    gradients on the true rows as they were, and the pad rows' gradients
    zero.  (Zero-padded qs or ks would not: exp(0) = 1.)"""
    _, tt = _case(7 * n + r + pad, r, n + pad, 16, dtype)
    qs, ks, v, g = tt["qs"], tt["ks"], tt["v"], tt["g"]
    true = dict(qs=qs[:, :n], ks=ks[:, :n], v=v[:, :n], g=g[:, :n])
    padded = dict(qs=qs.clone(), ks=ks.clone(), v=v, g=g.clone())
    padded["qs"][:, n:] = -float("inf")
    padded["ks"][:, n:] = -float("inf")
    padded["g"][:, n:] = 0
    res = {}
    for name, x in (("true", true), ("padded", padded)):
        fwd = lln_bidir_plain(x["qs"], x["ks"], x["v"], r=r, return_res=True)
        o, s, z, den = fwd
        res[name] = fwd, lln_bidir_bwd_plain(x["qs"], x["ks"], x["v"],
                                             x["g"], o, den, s, z, r=r)
    (fo, so, zo, do), grads = res["true"]
    (fp, sp, zp, dp), pgrads = res["padded"]
    for got, want in ((fp[:, :n], fo), (sp, so), (zp, zo), (dp[:, :n], do)):
        _close(got, want.float().numpy(), FP32)
    for got, want in zip(pgrads, grads):
        assert torch.isfinite(got).all()
        _close(got[:, :n], want.numpy(), FP32)
        assert not got[:, n:].any()


def test_block_diag_bwd_plain_is_the_gradient_of_the_forward():
    """At a ragged N (40, blk 16) the plain backward equals torch
    autograd through ``block_diag_plain``: the pad keys are masked."""
    _, tt = _case(11, 2, 40, 16, "float32")
    q, k, v = (tt[x].clone().requires_grad_() for x in ("q", "k", "v"))
    out = block_diag_plain(q, k, v, r=2, blk=BLK)
    want = torch.autograd.grad(torch.sum(out * tt["g"]), (q, k, v))
    got = block_diag_bwd_plain(tt["q"], tt["k"], tt["v"], tt["g"], r=2,
                               blk=BLK)
    for g_, w_ in zip(got, want):
        _close(g_, w_.numpy(), FP32)


# ---------------------------------------------------------------------------
# The autograd Functions, bidirectional.
# ---------------------------------------------------------------------------

def _model_case(seed, n, r, d=16):
    rng = np.random.default_rng(seed)
    b, g = 2, 2
    h = g * r
    q = rng.normal(size=(b, n, h, d)).astype(np.float32)
    k = rng.normal(size=(b, n, g, d)).astype(np.float32)
    v = rng.normal(size=(b, n, g, d)).astype(np.float32)
    alpha = rng.uniform(0.8, 1.6, h).astype(np.float32)
    beta = rng.uniform(0.8, 1.6, g).astype(np.float32)
    return q, k, v, alpha, beta


def _torch_grads(fn, q, k, v, alpha, beta, backend="auto"):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(tq, tk, tv, torch.from_numpy(alpha), torch.from_numpy(beta),
             False, BLK, backend=backend)
    return out, torch.autograd.grad(torch.sum(torch.square(out.float())),
                                    (tq, tk, tv))


@pytest.mark.parametrize("force_kernel_bwd", [False, True],
                         ids=["scan-bwd", "pallas-bwd"])
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
@pytest.mark.parametrize("n,r", [(2 * BLK, 1), (2 * BLK, 4)],
                         ids=["n32-r1", "n32-r4"])
def test_bidir_autograd_matches_reference_vjp(impl, n, r, force_kernel_bwd,
                                              monkeypatch):
    """sum(out^2) through the port's Function (plain versions on the CPU)
    against ``jax.grad`` through the reference's custom_vjp, once with its
    scan-twin backward and once with its Pallas backward kernels."""
    monkeypatch.setattr(jops, "FORCE_KERNEL_BWD", force_kernel_bwd)
    q, k, v, alpha, beta = _model_case(11 * n + r, n, r)
    jfn = jops.lln_attention if impl == "lln" else jops.lln_diag_attention
    tfn = tops.lln_attention if impl == "lln" else tops.lln_diag_attention

    def jloss(q_, k_, v_):
        out = jfn(q_, k_, v_, jnp.asarray(alpha), jnp.asarray(beta), False,
                  BLK)
        return jnp.sum(jnp.square(out.astype(jnp.float32)))

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    j_out = jfn(jq, jk, jv, jnp.asarray(alpha), jnp.asarray(beta), False, BLK)
    j_grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    out, grads = _torch_grads(tfn, q, k, v, alpha, beta)
    assert type(out.grad_fn).__name__.startswith("_LLN")
    _close(out, j_out, FP32)
    for g_, w_ in zip(grads, j_grads):
        _close(g_, w_, GRAD)


@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_bidir_ragged_n_runs_the_function_and_matches_ref(impl):
    """A ragged N (40, blk 16) under causal=False goes through the autograd
    Function at the true N and matches autograd through ``core/`` (backend
    ``ref``): no pad key enters the LLN sums or the last diag block."""
    q, k, v, alpha, beta = _model_case(5, 40, 2)
    fn = tops.lln_attention if impl == "lln" else tops.lln_diag_attention
    out, grads = _torch_grads(fn, q, k, v, alpha, beta, backend="plain")
    assert type(out.grad_fn).__name__.startswith("_LLN")
    ref_out, ref_grads = _torch_grads(fn, q, k, v, alpha, beta,
                                      backend="ref")
    _close(out, ref_out.detach().numpy(), FP32)
    for g_, w_ in zip(grads, ref_grads):
        _close(g_, w_.numpy(), GRAD)
