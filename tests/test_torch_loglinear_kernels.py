"""The port's log-linear kernel, held against the JAX reference's Pallas
kernel and core path.

On the CPU ``loglin_causal`` runs its plain PyTorch version; the
reference's ``loglin_causal_pallas`` runs in interpret mode, as the
reference's own tests run it (each interpret call costs about 0.5 s here,
so the cases share one call per kind).  Inputs are made with numpy from a
seed and fed to both sides.  Tolerances: fp32 outputs 2e-4 absolute (the
tolerance of ``tests/test_kernels.py``), the fp32 pyramid 2e-4 of its
largest entry (sums over up to N keys); bf16 outputs one bf16 step, 2^-7
of the largest entry, since both sides compute in fp32 and round once.

``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
version on the card.  Here, on the CPU: the fact the tensor-core path
rests on (after j closed granules the weighted read is a sum of closed
granule states with weights fixed by (i, j), against the reference's
cascade, occupancy and level matrix), and the path's route and scratch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.core import loglinear as jcore
from repro.kernels import ops as jops
from repro.kernels.loglinear import loglin_causal_pallas
from repro_torch.core import loglinear as tcore
from repro_torch.kernels import ops as tops
from repro_torch.kernels.lln_attention import (MAX_DECODE_T, lln_causal,
                                               lln_decode_plain)
from repro_torch.kernels.loglinear import (_tc_path, _tc_scratch,
                                           loglin_causal, loglin_causal_plain)

ATOL = 2e-4
BF16 = 2.0 ** -7
BLK = 16
N = 9 * BLK           # nine granules: the top of three or four levels fills


def _close(got, want, atol=ATOL, rel=False):
    want = np.asarray(want, np.float32)
    if rel:
        atol = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=atol, rtol=0)


def _kernel_inputs(seed, r, n=N, d=16, dv=16):
    rng = np.random.default_rng(seed)
    bg = 2 if r == 1 else 1
    qs = (rng.normal(size=(bg * r, n, d)) - 0.5).astype(np.float32)
    ks = (rng.normal(size=(bg, n, d)) - 0.5).astype(np.float32)
    v = rng.normal(size=(bg, n, dv)).astype(np.float32)
    return qs, ks, v


@pytest.mark.parametrize("num_scales", [1, 3, 4])
@pytest.mark.parametrize("r", [1, 4])
def test_loglin_causal_plain_matches_pallas(r, num_scales):
    """fp32 v with the state, then bf16 v without it, on shared inputs."""
    qs, ks, v = _kernel_inputs(10 * r + num_scales, r)
    kw = dict(num_scales=num_scales, scale_decay=0.5, r=r, blk=BLK)
    j_out, j_sl, j_zl = loglin_causal_pallas(
        jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(v), interpret=True,
        return_state=True, **kw)
    t_out, t_sl, t_zl, t_s, t_z = loglin_causal(
        torch.from_numpy(qs), torch.from_numpy(ks), torch.from_numpy(v),
        return_state=True, **kw)
    _close(t_out, j_out)
    _close(t_sl, j_sl, rel=True)
    _close(t_zl, j_zl, rel=True)
    # N is a whole number of granules: the open bucket is empty.
    assert not t_s.any() and not t_z.any()
    assert t_s.shape == (qs.shape[0], 16, 16) and t_z.shape == (
        qs.shape[0], 1, 16)

    vb = jnp.asarray(v).astype(jnp.bfloat16)
    j_out = loglin_causal_pallas(jnp.asarray(qs), jnp.asarray(ks), vb,
                                 interpret=True, **kw)
    t_out = loglin_causal(torch.from_numpy(qs), torch.from_numpy(ks),
                          torch.from_numpy(v).bfloat16(), **kw)
    assert t_out.dtype == torch.bfloat16
    _close(t_out, np.asarray(j_out.astype(jnp.float32)), BF16, rel=True)


def test_plain_takes_any_n_and_returns_the_open_bucket():
    """A ragged N: the first whole granules equal a run on them alone; the
    keys after them are the open bucket."""
    r, n_full, tail = 2, 3 * BLK, 5
    qs, ks, v = (torch.from_numpy(a) for a in _kernel_inputs(5, r,
                                                             n_full + tail))
    kw = dict(r=r, blk=BLK, num_scales=3, scale_decay=0.5,
              return_state=True)
    out, sl, zl, s, z = loglin_causal_plain(qs, ks, v, **kw)
    out0, sl0, zl0, s0, z0 = loglin_causal_plain(
        qs[:, :n_full].contiguous(), ks[:, :n_full].contiguous(),
        v[:, :n_full].contiguous(), **kw)
    _close(out[:, :n_full], out0.numpy(), 1e-6)
    _close(sl, sl0.numpy(), 1e-6, rel=True)
    _close(zl, zl0.numpy(), 1e-6, rel=True)
    assert not s0.any() and not z0.any()
    fk = torch.exp(ks[:, n_full:])
    want_s = torch.einsum("gjd,gjv->gdv", fk, v[:, n_full:])
    _close(s, torch.repeat_interleave(want_s, r, 0).numpy(), 1e-5, rel=True)
    _close(z[:, 0], torch.repeat_interleave(fk.sum(1), r, 0).numpy(), 1e-5,
           rel=True)


@pytest.mark.parametrize("num_scales,decay", [(3, 1.0), (1, 0.5)],
                         ids=["decay1", "scales1"])
def test_plain_reduces_to_lln_causal(num_scales, decay):
    """One level, or a decay of 1, is plain causal LLN: outputs equal to
    the LLN kernel's plain version; the pyramid sums to its state."""
    r = 4
    qs, ks, v = (torch.from_numpy(a) for a in _kernel_inputs(3, r))
    out, sl, zl, _, _ = loglin_causal(qs, ks, v, r=r, blk=BLK,
                                      num_scales=num_scales,
                                      scale_decay=decay, return_state=True)
    want, s, z = lln_causal(qs, ks, v, r=r, blk=BLK)
    _close(out, want.numpy(), 1e-5)
    _close(sl.sum(1), s.numpy(), 1e-5, rel=True)
    _close(zl.sum(1), z.numpy(), 1e-5, rel=True)


def test_chained_decode_launches_equal_one_pass():
    """The log-linear decode splits a pass into launches of at most
    MAX_DECODE_T tokens, each carrying the last one's state: equal to one
    pass over all T tokens, with -1e30 keys contributing nothing."""
    rng = np.random.default_rng(11)
    t, r, d = MAX_DECODE_T + 36, 2, 16
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    qs, ks, v = f(4, t, d) - 1.0, f(2, t, d) - 1.0, f(2, t, d)
    ks[:, 7:30] = -1e30
    s0, z0 = f(4, d, d), f(4, 1, d).abs()
    want, s1, z1 = lln_decode_plain(qs, ks, v, s0, z0, r=r)
    got = tops._decode_chained(qs, ks, v, s0, z0, r, "plain")
    _close(got, want.numpy(), 1e-5)
    assert torch.isfinite(got).all()


def test_ops_prefill_ragged_matches_reference_core():
    """A ragged prompt: the reference takes its core path (one constant per
    query head), the port its kernel's plain version (one per kv group).
    Outputs match directly; the states are compared at the reference's
    constant, ``x * exp(c_port - c_ref)`` for every field, because a raw
    state depends on the reference it was built at."""
    rng = np.random.default_rng(4)
    b, n, g, r, d = 2, 3 * BLK + 7, 2, 2, 16
    h = g * r
    q = rng.normal(size=(b, n, h, d)).astype(np.float32)
    k = rng.normal(size=(b, n, g, d)).astype(np.float32)
    v = rng.normal(size=(b, n, g, d)).astype(np.float32)
    alpha = rng.uniform(1.5, 2.5, h).astype(np.float32)
    beta = rng.uniform(1.5, 2.5, g).astype(np.float32)
    kw = dict(chunk=BLK, num_scales=3, scale_decay=0.5)
    want = jops.loglin_prefill(*(jnp.asarray(a) for a in (q, k, v, alpha,
                                                          beta)), **kw)
    got = tops.loglin_prefill(*(torch.from_numpy(a) for a in (q, k, v, alpha,
                                                              beta)), **kw)
    _close(got[0], want[0])
    out, s, z, c_k, sl, zl, cl = got
    _, js, jz, jc_k, jsl, jzl, jcl = (np.asarray(a) for a in want)
    shift = torch.exp(c_k - torch.tensor(jc_k))[:, 0, :, 0]        # (B,H)
    _close(s * shift[..., None, None], js, rel=True)
    _close(z * shift[..., None], jz, rel=True)
    lshift = torch.exp(cl - torch.tensor(jcl))                      # (B,L,H)
    _close(sl * lshift[..., None, None], jsl, rel=True)
    _close(zl * lshift[..., None], jzl, rel=True)


GRANULES = 40


@pytest.mark.parametrize("num_scales", [1, 2, 3, 4, 5])
def test_granule_reads_weigh_closed_granules_by_level(num_scales):
    """The tensor-core path reads granule j's pyramid as A_j = sum_{i<j}
    decay^level(i, j) G_i.  With one-hot granule states G_i = e_i, the
    cascade (the reference's and the port's) leaves, after each of 0 to 40
    closed granules, every closed granule on exactly one level, the level
    that the level matrix (granule 1: query j, key i) gives, only levels
    that occupancy marks occupied, and the weighted read decay^level."""
    ls, decay = num_scales, 0.5
    count = GRANULES + 1
    lev_j = np.asarray(jcore.level_matrix(count, granule=1, num_scales=ls))
    lev_t = tcore.level_matrix(count, granule=1, num_scales=ls).numpy()
    np.testing.assert_array_equal(lev_t, lev_j)
    w = decay ** np.arange(ls)
    sides = {
        "reference": (jcore._cascade_same_ref, jnp.zeros, jnp.eye,
                      jnp.ones, jcore.occupancy),
        "port": (tcore._cascade_same_ref, torch.zeros, torch.eye,
                 torch.ones, tcore.occupancy)}
    for side, (cascade, zeros, eye, ones, occupancy) in sides.items():
        sl, zl = zeros((1, ls, count)), zeros((1, ls))
        basis = eye(count)
        for j in range(count):
            pyr = np.asarray(sl[0], np.float32)
            closed = np.arange(count) < j
            np.testing.assert_array_equal(pyr[:, ~closed], 0, err_msg=side)
            np.testing.assert_array_equal(pyr[:, closed].sum(0), 1,
                                          err_msg=side)
            np.testing.assert_array_equal(
                pyr[lev_j[j, closed], np.flatnonzero(closed)], 1,
                err_msg=f"{side}: j={j}")
            np.testing.assert_array_equal(
                np.asarray(occupancy(j, ls), np.float32),
                (pyr.sum(1) > 0).astype(np.float32), err_msg=side)
            np.testing.assert_allclose(
                w @ pyr, np.where(closed, decay ** lev_j[j], 0.0),
                rtol=1e-6, err_msg=side)
            np.testing.assert_allclose(np.asarray(zl[0]), pyr.sum(1),
                                       err_msg=side)
            sl, zl = cascade(sl, zl, basis[j][None], ones((1,)), j, ls)


@pytest.mark.parametrize("dtype,d,dv,levels,want", [
    (torch.bfloat16, 128, 128, 4, True),
    (torch.bfloat16, 64, 96, 8, True),
    (torch.float32, 128, 128, 4, False),
    (torch.bfloat16, 160, 128, 4, False),
    (torch.bfloat16, 128, 128, 9, False)],
    ids=["serve", "narrow-deepest", "fp32-v", "wide-d", "too-deep"])
def test_tensor_core_route(dtype, d, dv, levels, want):
    """bf16 v with D, Dv <= 128 and at most 8 levels takes the tensor-core
    kernels; anything else the CUDA-core kernel."""
    assert _tc_path(torch.zeros(1, 1, dv, dtype=dtype), d, dv, levels) is want


@pytest.mark.parametrize("n,blk,granules", [(2048, 256, 8), (2040, 256, 8),
                                            (300, 64, 5), (16, 64, 1)])
def test_tensor_core_scratch_covers_every_granule(n, blk, granules):
    """Phi(k) as two bf16 planes, and one A_j (two planes) and zA_j per
    granule, the open last one included."""
    phk, aw, za = _tc_scratch(2, n, 64, 96, blk, "cpu")
    assert phk.shape == (2, 2, n, 64) and phk.dtype == torch.bfloat16
    assert aw.shape == (2, 2, granules, 64, 96) and aw.dtype == torch.bfloat16
    assert za.shape == (2, granules, 64) and za.dtype == torch.float32
