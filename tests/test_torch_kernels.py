"""The port's kernels, held against the JAX reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the reference's
Pallas kernels run in interpret mode, as the reference's own tests run them.
Inputs are made with numpy from a seed and fed to both sides.  fp32 atol
2e-4 is the tolerance of ``tests/test_kernels.py``.

``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.core.diag import block_diag_attn as j_block_diag_attn
from repro.core.engine import AttentionEngine as JEngine
from repro.core.lln import LLNState as JLLNState
from repro.kernels import ops as jops
from repro.kernels.block_diag import block_diag_pallas
from repro.kernels.lln_attention import lln_causal_pallas, lln_decode_pallas
from repro.kernels.registry import AttnSpec as JSpec
from repro_torch.convert import state_from_numpy
from repro_torch.core.lln import LLNState
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.block_diag import block_diag
from repro_torch.kernels.lln_attention import (TC_BLOCK, _tc_path,
                                               _tc_scratch, lln_causal,
                                               lln_causal_plain, lln_decode)

ATOL = 2e-4


def _kernel_inputs(seed, bh, bg, n, d, dv, shift=-0.5):
    rng = np.random.default_rng(seed)
    qs = (rng.normal(size=(bh, n, d)) + shift).astype(np.float32)
    ks = (rng.normal(size=(bg, n, d)) + shift).astype(np.float32)
    v = rng.normal(size=(bg, n, dv)).astype(np.float32)
    return qs, ks, v


def _close(got, want, atol=ATOL):
    got = got.detach().cpu().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _state_close(got, want):
    """(s, z) grow with the sequence: hold them to ATOL relative to the
    largest entry."""
    want = np.asarray(want, np.float32)
    _close(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("n", [32, 48])
def test_lln_causal_plain_matches_pallas(r, n):
    qs, ks, v = _kernel_inputs(r * 100 + n, 2 * r, 2, n, 16, 16)
    j_out, j_s, j_z = lln_causal_pallas(jnp.asarray(qs), jnp.asarray(ks),
                                        jnp.asarray(v), r=r, blk=16,
                                        interpret=True, return_state=True)
    t_out, t_s, t_z = lln_causal(torch.from_numpy(qs), torch.from_numpy(ks),
                                 torch.from_numpy(v), r=r, blk=16)
    _close(t_out, j_out)
    _state_close(t_s, j_s)
    _state_close(t_z, j_z)


@pytest.mark.parametrize("r", [1, 2])
def test_lln_prefill_ragged_matches_reference(r):
    rng = np.random.default_rng(7)
    b, n, g, d = 2, 40, 2, 16
    q = rng.normal(size=(b, n, g * r, d)).astype(np.float32)
    k = rng.normal(size=(b, n, g, d)).astype(np.float32)
    v = rng.normal(size=(b, n, g, d)).astype(np.float32)
    alpha = rng.uniform(1.5, 2.5, g * r).astype(np.float32)
    beta = rng.uniform(1.5, 2.5, g).astype(np.float32)
    want = jops.lln_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(alpha), jnp.asarray(beta), chunk=16)
    got = tops.lln_prefill(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(alpha),
                           torch.from_numpy(beta), chunk=16)
    _close(got[0], want[0])
    for gt, wt in zip(got[1:], want[1:]):
        _state_close(gt, wt)


def test_lln_causal_plain_matches_quadratic_oracle_ragged():
    qs, ks, v = _kernel_inputs(3, 4, 2, 40, 16, 8)
    args = [torch.from_numpy(a) for a in (qs, ks, v)]
    out, s, z = lln_causal_plain(*args, r=2, blk=16)
    o_ref, s_ref, z_ref = tref.lln_prefill_state_ref(*args, r=2)
    _close(out, o_ref.numpy())
    _state_close(s, s_ref.numpy())
    _state_close(z, z_ref.numpy())


@pytest.mark.parametrize("n", [300, 512], ids=["ragged-n300", "n512"])
@pytest.mark.parametrize("r", [1, 4])
def test_lln_causal_plain_is_independent_of_its_chunk(r, n):
    """The chunk only splits the causal sum: out, den and the final (s, z)
    at blk 16, 64 and 256 agree within 1e-5 of the largest entry, a ragged
    N included.  That is why the CUDA kernels take their own block
    (TC_BLOCK rows on the tensor cores) whatever the caller's blk."""
    qs, ks, v = _kernel_inputs(10 * r + n, 2 * r, 2, n, 32, 16)
    args = [torch.from_numpy(a) for a in (qs, ks, v)]
    runs = [lln_causal_plain(*args, r=r, blk=b, return_res=True)
            for b in (16, 64, 256)]
    for run in runs[1:]:
        for got, want in zip(run, runs[0]):
            _close(got, want.numpy(),
                   atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("dtype,d,dv,want", [
    (torch.bfloat16, 128, 128, True),
    (torch.bfloat16, 64, 112, True),
    (torch.float32, 128, 128, False),
    (torch.bfloat16, 160, 128, False),
    (torch.bfloat16, 128, 256, False)],
    ids=["serve", "narrow", "fp32-v", "wide-d", "wide-dv"])
def test_lln_causal_tensor_core_route(dtype, d, dv, want):
    """bf16 v with D, Dv <= 128 takes lln_causal's tensor-core kernels;
    fp32 v or a wider head the CUDA-core ones (the backward's route is
    wider: test_wide_tensor_core_routes)."""
    v = torch.zeros(1, 1, dv, dtype=dtype)
    assert _tc_path(v, d, dv, "lln_causal") is want


WIDE_ROUTES = pytest.mark.parametrize("dtype,d,dv,want", [
    (torch.bfloat16, 128, 128, True),
    (torch.bfloat16, 192, 128, True),
    (torch.bfloat16, 256, 256, True),
    (torch.bfloat16, 160, 96, True),
    (torch.float32, 192, 128, False),
    (torch.bfloat16, 320, 128, False),
    (torch.bfloat16, 128, 288, False)],
    ids=["yi-9b", "mla", "paligemma", "untiled", "fp32-v", "wide-d",
         "wide-dv"])


@WIDE_ROUTES
def test_lln_diag_fused_bwd_tensor_core_route(dtype, d, dv, want):
    """lln_diag_fused_bwd takes its tensor-core kernels for bf16 with D,
    Dv <= 256 (MLA's D = 192 / Dv = 128 and paligemma's D = Dv = 256
    included); fp32 or a wider head its CUDA-core ones.  lln_causal,
    lln_bidir, their backward lln_bidir_bwd and loglin_causal stay at
    128."""
    v = torch.zeros(1, 1, dv, dtype=dtype)
    assert _tc_path(v, d, dv, "lln_diag_fused_bwd") is want
    for kernel in ("lln_causal", "lln_bidir", "lln_bidir_bwd",
                   "loglin_causal"):
        assert _tc_path(v, d, dv, kernel) is (want and max(d, dv) <= 128)


@WIDE_ROUTES
@pytest.mark.parametrize("kernel", ["lln_diag_fused", "lln_causal_bwd"])
def test_wide_tensor_core_routes(kernel, dtype, d, dv, want):
    """lln_diag_fused (row 4) and lln_causal_bwd (row 6) take their
    tensor-core kernels for bf16 with D, Dv <= 256, as row 9 does: MLA's D
    = 192 / Dv = 128, paligemma's D = Dv = 256 and the untiled D = 160 /
    Dv = 96; fp32, or D or Dv above 256, their CUDA-core ones."""
    v = torch.zeros(1, 1, dv, dtype=dtype)
    assert _tc_path(v, d, dv, kernel) is want


@pytest.mark.parametrize("n,blk,blocks", [(1024, 64, 16), (300, 64, 5),
                                          (512, 256, 2), (40, 64, 1)])
def test_lln_causal_tensor_core_scratch_covers_every_block(n, blk, blocks):
    """Phi(k) as bf16 planes (and Phi(q) for the backward), one exclusive
    state S_c (bf16 planes) and z_c per block, the short last one
    included: two planes and no Phi(q) forward, three backward."""
    assert TC_BLOCK in (64, 128, 256)
    for planes, phi_q in ((2, False), (3, True)):
        phq, phk, sst, zst = _tc_scratch(8, 2, n, 64, 96, blk, "cpu",
                                         planes=planes, phi_q=phi_q)
        assert (phq is None) is not phi_q
        if phi_q:
            assert phq.shape == (planes, 8, n, 64)
        assert phk.shape == (planes, 2, n, 64) and phk.dtype == torch.bfloat16
        assert sst.shape == (planes, 2, blocks, 64, 96)
        assert sst.dtype == torch.bfloat16
        assert zst.shape == (2, blocks, 64) and zst.dtype == torch.float32


@pytest.mark.parametrize("r", [1, 2])
def test_block_diag_plain_matches_pallas(r):
    rng = np.random.default_rng(11 + r)
    q = rng.normal(size=(2 * r, 48, 16)).astype(np.float32)
    k = rng.normal(size=(2, 48, 16)).astype(np.float32)
    v = rng.normal(size=(2, 48, 16)).astype(np.float32)
    want = block_diag_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             r=r, blk=16, causal=True, interpret=True)
    got = block_diag(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), r=r, blk=16, causal=True)
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_block_diag_ragged_matches_core_diag(causal):
    rng = np.random.default_rng(5)
    b, n, g, r, d = 2, 40, 2, 2, 16
    q = rng.normal(size=(b, n, g * r, d)).astype(np.float32)
    k = rng.normal(size=(b, n, g, d)).astype(np.float32)
    v = rng.normal(size=(b, n, g, d)).astype(np.float32)
    want = j_block_diag_attn(jnp.asarray(q), jnp.repeat(jnp.asarray(k), r, 2),
                             jnp.repeat(jnp.asarray(v), r, 2), block=16,
                             causal=causal)
    got = tops.block_diag_fwd(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), 16, causal=causal)
    _close(got, want)


@pytest.mark.parametrize("r,t", [(1, 1), (2, 4)])
def test_lln_decode_plain_matches_pallas(r, t):
    qs, ks, v = _kernel_inputs(20 + t, 2 * r, 2, t, 16, 16)
    rng = np.random.default_rng(t)
    s0 = rng.normal(size=(2 * r, 16, 16)).astype(np.float32)
    z0 = rng.uniform(0.5, 3.0, (2 * r, 1, 16)).astype(np.float32)
    want = lln_decode_pallas(*(jnp.asarray(a) for a in (qs, ks, v, s0, z0)),
                             r=r, interpret=True)
    got = lln_decode(*(torch.from_numpy(a) for a in (qs, ks, v, s0, z0)), r=r)
    _close(got[0], want[0])
    _state_close(got[1], want[1])
    _state_close(got[2], want[2])


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("t", [1, 3, 16])
def test_lln_decode_plain_with_scale_matches_pallas(r, t):
    """``scale`` rescales the carried state first: the plain version on
    (s, z, f) against the Pallas decode on s0 = f·s, z0 = f·z made in
    numpy."""
    qs, ks, v = _kernel_inputs(40 + t, 2 * r, 2, t, 16, 16)
    rng = np.random.default_rng(50 + r * t)
    s = rng.normal(size=(2 * r, 16, 16)).astype(np.float32)
    z = rng.uniform(0.5, 3.0, (2 * r, 1, 16)).astype(np.float32)
    f = np.exp(-rng.uniform(0.0, 2.0, 2 * r)).astype(np.float32)
    want = lln_decode_pallas(*(jnp.asarray(a) for a in (
        qs, ks, v, s * f[:, None, None], z * f[:, None, None])), r=r,
        interpret=True)
    got = lln_decode(*(torch.from_numpy(a) for a in (qs, ks, v, s, z)), r=r,
                     scale=torch.from_numpy(f))
    _close(got[0], want[0])
    _state_close(got[1], want[1])
    _state_close(got[2], want[2])


def _j_lln_state(st):
    return JLLNState(s=jnp.asarray(st.s), z=jnp.asarray(st.z),
                     c_k=jnp.asarray(st.c_k),
                     log_scale=jnp.asarray(st.log_scale))


@pytest.mark.parametrize("t", [1, 3])
def test_lln_decode_chunk_from_converted_state(t):
    """Prefill with the reference engine, carry its state across, then hold
    the port's decode op to the reference's Pallas decode path."""
    rng = np.random.default_rng(30 + t)
    b, n, g, r, d = 2, 32, 2, 2, 16
    h = g * r
    q, k, v = (rng.normal(size=(b, n, hh, d)).astype(np.float32)
               for hh in (h, g, g))
    eng = JEngine(spec=JSpec(impl="lln", r=r, lln_chunk=16, diag_block=16),
                  heads=h, kv_heads=g, head_dim=d, v_dim=d)
    _, jstate = eng.prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            max_len=n + t)
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    qn, kn, vn = (rng.normal(size=(b, t, hh, d)).astype(np.float32)
                  for hh in (h, g, g))
    want_out, want = jops.lln_decode_chunk(
        _j_lln_state(jstate), jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(jstate.alpha), jnp.asarray(jstate.beta), backend="pallas")
    st = state_from_numpy(jstate, "cpu")
    got_out, got = tops.lln_decode_chunk(
        LLNState(s=st.s, z=st.z, c_k=st.c_k, log_scale=st.log_scale),
        torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn),
        st.alpha, st.beta)
    _close(got_out, want_out)
    _state_close(got.s, want.s)
    _state_close(got.z, want.z)
    _close(got.c_k, want.c_k, atol=1e-6)
