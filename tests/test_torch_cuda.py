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
fp32 p as hi + lo bf16 forward and in the backward's dq kernel, p and dsm
as three bf16 planes in its dk/dv kernel; fp32 on the CUDA cores) are held
at blk 16, 64 and 256, N 64, 300 and 512, D = Dv = 64 and 128 and one
D != Dv, r in {1, 4, 5, 8, 16}, causal and not, their backward's two runs
bitwise equal.  The serving kernels (``lln_causal`` with the state,
causal ``block_diag``, ``lln_decode``) are also held, bf16, at the model
families' wide heads: D = 192 with Dv = 128 (MLA, r = 1), D = Dv = 256
with r = 8 (paligemma) and D = 160 with Dv = 96 (r = 2, no multiple of the
64-column tiles), N 512 and 300, blk 256 and 64, and so are the training
kernels there: ``block_diag_bwd`` in bf16 (causal and not, N 512 and
300), the fused pair and the causal pair with ``den`` and their
backwards, each within the tolerances above and two runs bitwise equal;
at those widths bf16 ``block_diag`` and ``lln_diag_fused_bwd`` run their
tensor-core kernels and fp32 their CUDA-core ones (by the profiler's
kernel names);
the fused pair also at r = 16 on the tensor cores (qwen3-moe).  A 2-slot continuous-batching pool of yi-9b SMOKE on the
serving kernels equals solo runs token for token.  The
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
CUDA-core kernels.  ``lln_decode`` (its state rescale folded in with
``scale``) is held at T in {1, 4, 16, 20, 64}, (D, Dv) in {(128, 128),
(128, 64), (112, 66)}, r in {1, 4, 8}, fp32 and bf16 v, with and without
``scale``, and at every column block it takes: out within one bf16 step
(fp32: ATOL), s1 and z1 within 1e-5 of the largest entry, two runs bitwise
equal, and the folded rescale bitwise equal to a torch rescale followed by
``scale=None``.  ``log_linear`` through ``multi_head_attention`` refuses a
gradient on the kernel and gives one on the plain kind.  The speculative
verify on the kernel route: a ``commit_len = 0`` verify leaves the state
bitwise, ``commit`` equals ``decode(commit_len)`` bitwise and the plain
kind within the tolerances above, for every impl in fp32 and bf16; greedy
speculative decoding and a speculative pool of yi-9b SMOKE give the plain
greedy loop's and the solo runs' tokens.  On a one-rank NCCL group and a
1 x 1 DeviceMesh (the one mesh with real collectives a single card runs),
SMOKE serving (yi-9b ``lln_diag`` and ``softmax``, qwen3-moe through the
expert-parallel path) and training give the meshless run's tokens and
losses (1e-5) with the same kernel launches.  Every kernel's custom op
(``repro_torch::<wrapper>``) passes ``torch.library.opcheck`` at one small
shape (its schema, fake and AOT dispatch).
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
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

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
# D != Dv, r in {1, 4, 8} (the yi-9b serve shape has r = 8), and qwen3-14b's
# r = 5 and chatglm3-6b's r = 16.
BLOCK_DIAG_CASES = [
    pytest.param(*c, id="n{}-blk{}-d{}-dv{}-r{}".format(*c))
    for c in ((64, 16, 64, 64, 4), (300, 256, 64, 64, 4),
              (512, 256, 128, 128, 8), (300, 64, 128, 128, 1),
              (512, 64, 64, 64, 1), (64, 64, 128, 128, 8),
              (300, 16, 64, 64, 8), (300, 256, 64, 128, 4),
              (512, 16, 128, 128, 4), (512, 256, 128, 128, 5),
              (300, 64, 128, 128, 5), (512, 256, 128, 128, 16),
              (300, 64, 64, 64, 16))]


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


def _decode_inputs(dev, seed, r, t, d, dv, vdtype):
    """Kernel-layout decode inputs, 2 kv heads: qs, ks, v (``vdtype``), a
    carried (s, z) and a rescale factor in (0.1, 1] per query head."""
    qs, ks, v = _kernel_inputs(seed, 2 * r, 2, t, d, dv)
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(2 * r, d, dv)).astype(np.float32)
    z = rng.uniform(0.5, 3.0, (2 * r, 1, d)).astype(np.float32)
    f = np.exp(-rng.uniform(0.0, 2.3, 2 * r)).astype(np.float32)
    qs, ks, s, z, f = _on(dev, qs, ks, s, z, f)
    (v,) = _on(dev, v, dtype=vdtype)
    return qs, ks, v, s, z, f


# (d, dv): the serve width, a narrower v, and D off the 32-row warps with
# Dv off the 16-byte loads.
DECODE_WIDTHS = [pytest.param(*w, id="d{}-dv{}".format(*w))
                 for w in ((128, 128), (128, 64), (112, 66))]


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 16, 20, 64])
@pytest.mark.parametrize("d,dv", DECODE_WIDTHS)
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 4, 5, 8, 16])
@pytest.mark.parametrize("scaled", [False, True], ids=["noscale", "scale"])
def test_cuda_lln_decode_matches_plain(cuda, t, d, dv, vdtype, r, scaled):
    """The decode kernel (its rescale folded in with ``scale``) against its
    plain version: out within one bf16 step (fp32: ATOL), s1 and z1 within
    1e-5 of the largest entry; two runs bitwise equal."""
    qs, ks, v, s, z, f = _decode_inputs(cuda, t + d + r, r, t, d, dv, vdtype)
    scale = f if scaled else None
    before = lln_decode.launches
    got = lln_decode(qs, ks, v, s, z, r=r, scale=scale)
    again = lln_decode(qs, ks, v, s, z, r=r, scale=scale)
    want = lln_decode_plain(qs, ks, v, s, z, r=r, scale=scale)
    torch.cuda.synchronize()
    assert lln_decode.launches == before + 2
    _close(got[0], want[0], ATOL if vdtype == torch.float32 else BF16)
    _close(got[1], want[1], TRAIN)
    _close(got[2], want[2], TRAIN)
    for gt, ag in zip(got, again):
        assert torch.equal(gt, ag)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 64])
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_lln_decode_folded_rescale_is_bitwise_torch_rescale(cuda, t,
                                                                 vdtype):
    """``scale`` inside the kernel gives the bits of ``s * scale`` and ``z *
    scale`` in torch followed by a launch with ``scale=None`` (the kernel's
    multiply is rounded on its own, never fused into an FMA)."""
    qs, ks, v, s, z, f = _decode_inputs(cuda, 70 + t, 8, t, 128, 128, vdtype)
    folded = lln_decode(qs, ks, v, s, z, r=8, scale=f)
    torch_first = lln_decode(qs, ks, v, s * f[:, None, None],
                             z * f[:, None, None], r=8)
    torch.cuda.synchronize()
    for a, b in zip(folded, torch_first):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 20])
@pytest.mark.parametrize("d,dv", DECODE_WIDTHS)
def test_cuda_lln_decode_column_blocks_match_plain(cuda, monkeypatch, cols,
                                                   t, d, dv):
    """Every column block the kernel takes (value columns per CTA),
    whatever :func:`_decode_columns` picks for the shape; t > 64 is
    refused."""
    lla = importlib.import_module("repro_torch.kernels.lln_attention")
    monkeypatch.setattr(lla, "_decode_columns", lambda t, d: cols)
    qs, ks, v, s, z, f = _decode_inputs(cuda, 90 + t, 4, t, d, dv,
                                        torch.bfloat16)
    got = lln_decode(qs, ks, v, s, z, r=4, scale=f)
    want = lln_decode_plain(qs, ks, v, s, z, r=4, scale=f)
    torch.cuda.synchronize()
    _close(got[0], want[0], BF16)
    _close(got[1], want[1], TRAIN)
    _close(got[2], want[2], TRAIN)
    long = _decode_inputs(cuda, 1, 4, 65, d, dv, torch.bfloat16)
    with pytest.raises(ValueError, match="at most 64"):
        lln_decode(*long[:5], r=4)


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
    # bf16 with D above 128 runs (the CUDA-core kernels), counted once.
    wide = torch.zeros(2, 32, 256, dtype=torch.bfloat16, device=cuda)
    before = block_diag_bwd.launches
    grads = block_diag_bwd(wide, wide, wide, wide, r=1, blk=16)
    torch.cuda.synchronize()
    assert block_diag_bwd.launches == before + 1
    assert all(g.dtype == torch.float32 and not bool(g.any()) for g in grads)
    before = (block_diag.launches, block_diag.noncausal_launches)
    block_diag(qs, ks, v, r=2, blk=16, causal=True)
    block_diag(qs, ks, v, r=2, blk=16, causal=False)
    assert (block_diag.launches, block_diag.noncausal_launches) == \
        (before[0] + 2, before[1] + 1)


# The kernels at the model families' wide heads (D or Dv above 128): MLA's
# assembled q/k (deepseek-v2: H = G, D = nope + rope = 192, Dv = 128),
# paligemma's MQA (r = 8, D = Dv = 256), and widths that are no multiple of
# the tensor-core routes' 64-column tiles (D = 160, Dv = 96), which those
# routes pad with zeros.  block_diag (forward), lln_diag_fused,
# lln_causal_bwd and lln_diag_fused_bwd take their tensor cores there in
# bf16; lln_causal, lln_decode and block_diag_bwd their CUDA cores.
WIDE_HEADS = [pytest.param(1, 192, 128, id="mla-r1-d192-dv128"),
              pytest.param(8, 256, 256, id="paligemma-r8-d256"),
              pytest.param(2, 160, 96, id="r2-d160-dv96")]


def _kernel_names(fn):
    """The names of the CUDA kernels ``fn()`` launches, from
    ``torch.profiler``'s device trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("r,d,dv", WIDE_HEADS)
@pytest.mark.parametrize("n", [512, 300])
@pytest.mark.parametrize("blk", [256, 64])
def test_cuda_serve_kernels_at_wide_heads(cuda, r, d, dv, n, blk):
    """bf16 v: lln_causal with the final state, causal block_diag (on its
    tensor cores) and lln_decode at T = 1 and 4 from that state with a
    rescale, each within one bf16 step of its plain version (s, z, s1, z1
    within 1e-5 of the largest plain entry), two runs of each bitwise
    equal."""
    qs, ks, v = _kernel_inputs(d + n + r, 2 * r, 2, n, d, dv)
    qs, ks = _on(cuda, qs, ks)
    (v,) = _on(cuda, v, dtype=torch.bfloat16)
    runs = [lln_causal(qs, ks, v, r=r, blk=blk) for _ in range(2)]
    want = lln_causal_plain(qs, ks, v, r=r, blk=blk)
    torch.cuda.synchronize()
    _close(runs[0][0], want[0], BF16)
    _close(runs[0][1], want[1], TRAIN)
    _close(runs[0][2], want[2], TRAIN)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    q, k = qs.bfloat16(), ks.bfloat16()
    runs = [block_diag(q, k, v, r=r, blk=blk, causal=True) for _ in range(2)]
    bd = block_diag_plain(q, k, v, r=r, blk=blk, causal=True)
    torch.cuda.synchronize()
    _close(runs[0], bd, BF16)
    assert torch.equal(runs[0], runs[1])
    s0, z0 = want[1].contiguous(), want[2].contiguous()
    for t in (1, 4):
        q1, k1, v1 = _kernel_inputs(t + d, 2 * r, 2, t, d, dv)
        q1, k1 = _on(cuda, q1, k1)
        (v1,) = _on(cuda, v1, dtype=torch.bfloat16)
        scale = torch.linspace(0.2, 1.0, 2 * r, device=cuda)
        runs = [lln_decode(q1, k1, v1, s0, z0, r=r, scale=scale)
                for _ in range(2)]
        dec = lln_decode_plain(q1, k1, v1, s0, z0, r=r, scale=scale)
        torch.cuda.synchronize()
        _close(runs[0][0], dec[0], BF16)
        _close(runs[0][1], dec[1], TRAIN)
        _close(runs[0][2], dec[2], TRAIN)
        assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("r,d,dv", WIDE_HEADS)
@pytest.mark.parametrize("n", [512, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_block_diag_bwd_bf16_at_wide_heads(cuda, r, d, dv, n, causal):
    """block_diag_bwd on bf16 inputs above D = 128 (the CUDA-core kernels,
    whose shared memory at D = Dv = 256 and blk 256 is 197 KB and 206 KB):
    dq, dk and dv within 1e-5 of the largest plain entry, two runs bitwise
    equal."""
    rng = np.random.default_rng(7 * d + n + r + causal)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(cuda).bfloat16()
    q, k, v, g = f(2 * r, n, d), f(2, n, d), f(2, n, dv), f(2 * r, n, dv)
    runs = [block_diag_bwd(q, k, v, g, r=r, blk=256, causal=causal)
            for _ in range(2)]
    want = block_diag_bwd_plain(q, k, v, g, r=r, blk=256, causal=causal)
    torch.cuda.synchronize()
    for gt, wt, ag in zip(runs[0], want, runs[1]):
        _close(gt, wt, TRAIN)
        assert torch.equal(gt, ag)


@pytest.mark.cuda
@pytest.mark.parametrize("r,d,dv", WIDE_HEADS)
@pytest.mark.parametrize("n,blk", [(512, 256), (512, 64), (300, 60)])
def test_cuda_training_kernels_at_wide_heads(cuda, r, d, dv, n, blk):
    """The training pairs on bf16 v at the families' wide heads:
    lln_diag_fused and lln_diag_fused_bwd (rows 4 and 9, on their tensor
    cores), lln_causal with den and lln_causal_bwd (rows 1 and 6; row 6 on
    its tensor cores).
    out within one bf16 step; den and every fp32 gradient within 1e-5 of
    the largest plain entry; two runs of each bitwise equal."""
    rng = np.random.default_rng(1000 * r + n + d + dv)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(cuda)
    qs, ks = f(2 * r, n, d) - 0.5, f(2, n, d) - 0.5
    q, k = f(2 * r, n, d).bfloat16(), f(2, n, d).bfloat16()
    v, g = f(2, n, dv).bfloat16(), f(2 * r, n, dv).bfloat16()
    pairs = (
        (lambda: lln_diag_fused(qs, ks, q, k, v, r=r, blk=blk,
                                return_res=True),
         lln_diag_fused_plain(qs, ks, q, k, v, r=r, blk=blk,
                              return_res=True),
         lambda o, den: lln_diag_fused_bwd(qs, ks, q, k, v, g, o, den, r=r,
                                           blk=blk),
         lambda o, den: lln_diag_fused_bwd_plain(qs, ks, q, k, v, g, o, den,
                                                 r=r, blk=blk)),
        (lambda: lln_causal(qs, ks, v, r=r, blk=blk, return_res=True,
                            return_state=False),
         lln_causal_plain(qs, ks, v, r=r, blk=blk, return_res=True,
                          return_state=False),
         lambda o, den: lln_causal_bwd(qs, ks, v, g, o, den, r=r, blk=blk),
         lambda o, den: lln_causal_bwd_plain(qs, ks, v, g, o, den, r=r,
                                             blk=blk)))
    for fwd, want, bwd, bwd_plain in pairs:
        runs = [fwd() for _ in range(2)]
        torch.cuda.synchronize()
        _close(runs[0][0], want[0], BF16)
        _close(runs[0][1], want[1], TRAIN)
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        runs = [bwd(*want) for _ in range(2)]
        grads = bwd_plain(*want)
        torch.cuda.synchronize()
        for gt, wt, ag in zip(runs[0], grads, runs[1]):
            _close(gt, wt, TRAIN)
            assert torch.equal(gt, ag)


def _wide_calls(cuda, r, d, dv, n, blk, dt, seed):
    """{wrapper: call} for block_diag (causal), lln_diag_fused (with den),
    lln_causal_bwd and lln_diag_fused_bwd on seeded inputs in ``dt``, the
    backwards from their plain forwards' outputs."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(cuda)
    qs, ks = f(2 * r, n, d) - 0.5, f(2, n, d) - 0.5
    q, k, v, g = (t.to(dt) for t in (f(2 * r, n, d), f(2, n, d),
                                     f(2, n, dv), f(2 * r, n, dv)))
    o, den = lln_diag_fused_plain(qs, ks, q, k, v, r=r, blk=blk,
                                  return_res=True)
    lo, lden = lln_causal_plain(qs, ks, v, r=r, blk=blk, return_res=True,
                                return_state=False)
    return {
        "block_diag": lambda: block_diag(q, k, v, r=r, blk=blk, causal=True),
        "lln_diag_fused": lambda: lln_diag_fused(qs, ks, q, k, v, r=r,
                                                 blk=blk, return_res=True),
        "lln_causal_bwd": lambda: lln_causal_bwd(qs, ks, v, g, lo, lden,
                                                 r=r, blk=blk),
        "lln_diag_fused_bwd": lambda: lln_diag_fused_bwd(
            qs, ks, q, k, v, g, o, den, r=r, blk=blk)}


# Each wrapper's tensor-core kernels and its CUDA-core kernels (fp32), by
# the profiler's names.  lln_causal_bwd and lln_diag_fused_bwd name theirs
# alike, so each call is profiled on its own.
WIDE_KERNELS = {
    "block_diag": (("block_diag_tc_kernel",), ("block_diag_kernel<float>",)),
    "lln_diag_fused": (("fused_tc_kernel",),
                       ("lln_diag_fused_kernel<float>",)),
    "lln_causal_bwd": (("dq_tc_kernel", "dkv_tc_kernel"),
                       ("dq_kernel<float>", "dkv_kernel<float>")),
    "lln_diag_fused_bwd": (("dq_tc_kernel", "dkv_tc_kernel"),
                           ("dq_kernel<float>", "dkv_kernel<float>"))}


@pytest.mark.cuda
@pytest.mark.parametrize("r,d,dv", WIDE_HEADS)
def test_cuda_wide_heads_take_the_tensor_cores_in_bf16(cuda, r, d, dv):
    """At the wide heads, bf16 block_diag runs block_diag_tc_kernel, bf16
    lln_diag_fused its fused_tc_kernel, and bf16 lln_causal_bwd and
    lln_diag_fused_bwd their dq_tc_kernel and dkv_tc_kernel, by the
    profiler's kernel names (each call profiled on its own); fp32 inputs
    run the CUDA-core kernels (block_diag_kernel<float>,
    lln_diag_fused_kernel<float>, dq_kernel<float>, dkv_kernel<float>) and
    no tensor-core one.  The CUDA runtime reports each tensor-core
    kernel's registers (at most 255), spills (none), CTAs per SM (at least
    one) and shared memory (within the block's 232,448 bytes) for the
    widths (build.tc_attrs)."""
    from repro_torch.kernels import build
    for dt in (torch.bfloat16, torch.float32):
        tc = dt == torch.bfloat16
        calls = _wide_calls(cuda, r, d, dv, 128, 64, dt, d + dv + r)
        for name, fn in calls.items():
            names = _kernel_names(fn)
            tc_names, core_names = WIDE_KERNELS[name]
            for kern in tc_names:
                assert any(kern in nm for nm in names) is tc, (name, kern)
            for kern in core_names:
                assert any(kern in nm for nm in names) is not tc, (name, kern)
    for name, want in (("block_diag", 1), ("lln_diag_fused", 1),
                       ("lln_causal_bwd", 2), ("lln_diag_fused_bwd", 2)):
        attrs = build.tc_attrs(name, d, dv)
        assert len(attrs) == want
        for a in attrs:
            assert 0 < a["registers"] <= 255 and a["ctas_per_sm"] >= 1, a
            assert a["local_bytes"] == 0 and a["smem_bytes"] <= 232448, a


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(320, 96), (96, 288)],
                         ids=["d320-dv96", "d96-dv288"])
def test_cuda_heads_past_256_take_the_cuda_cores(cuda, d, dv):
    """bf16 with D or Dv above 256: lln_diag_fused, lln_causal_bwd and
    lln_diag_fused_bwd run their CUDA-core kernels and no tensor-core one
    (by the profiler's names), within one bf16 step (out) and 1e-5 of the
    largest plain entry (den, gradients) of their plain versions."""
    r, n, blk = 2, 128, 32
    calls = _wide_calls(cuda, r, d, dv, n, blk, torch.bfloat16, d + dv)
    for name in ("lln_diag_fused", "lln_causal_bwd", "lln_diag_fused_bwd"):
        names = _kernel_names(calls[name])
        _, core_names = WIDE_KERNELS[name]
        assert not any("tc_kernel" in nm for nm in names), (name, names)
        for kern in core_names:
            stem = kern.split("<")[0] + "<"
            assert any(stem in nm for nm in names), (name, kern)
    rng = np.random.default_rng(d + dv)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(cuda)
    qs, ks = f(2 * r, n, d) - 0.5, f(2, n, d) - 0.5
    q, k, v, g = (t.bfloat16() for t in (f(2 * r, n, d), f(2, n, d),
                                         f(2, n, dv), f(2 * r, n, dv)))
    got = lln_diag_fused(qs, ks, q, k, v, r=r, blk=blk, return_res=True)
    want = lln_diag_fused_plain(qs, ks, q, k, v, r=r, blk=blk,
                                return_res=True)
    _close(got[0], want[0], BF16)
    _close(got[1], want[1], TRAIN)
    lo, lden = lln_causal_plain(qs, ks, v, r=r, blk=blk, return_res=True,
                                return_state=False)
    pairs = ((lln_causal_bwd(qs, ks, v, g, lo, lden, r=r, blk=blk),
              lln_causal_bwd_plain(qs, ks, v, g, lo, lden, r=r, blk=blk)),
             (lln_diag_fused_bwd(qs, ks, q, k, v, g, *want, r=r, blk=blk),
              lln_diag_fused_bwd_plain(qs, ks, q, k, v, g, *want, r=r,
                                       blk=blk)))
    torch.cuda.synchronize()
    for grads, plain in pairs:
        for gt, wt in zip(grads, plain):
            _close(gt, wt, TRAIN)


@pytest.mark.cuda
@pytest.mark.parametrize("n,blk", [(512, 256), (256, 64)])
def test_cuda_fused_pair_at_r16(cuda, n, blk):
    """The fused pair (rows 4 and 9) at qwen3-moe's r = 16 (H = 64, G = 4)
    on the tensor cores, 16 query heads per kv group walked in a fixed
    order: out within one bf16 step, den and the five gradients within
    1e-5 of the largest plain entry, two runs of each bitwise equal."""
    r, d = 16, 128
    rng = np.random.default_rng(16 * n + blk)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(cuda)
    qs, ks = f(2 * r, n, d) - 0.5, f(2, n, d) - 0.5
    q, k = f(2 * r, n, d).bfloat16(), f(2, n, d).bfloat16()
    v, g = f(2, n, d).bfloat16(), f(2 * r, n, d).bfloat16()
    runs = [lln_diag_fused(qs, ks, q, k, v, r=r, blk=blk, return_res=True)
            for _ in range(2)]
    o, den = lln_diag_fused_plain(qs, ks, q, k, v, r=r, blk=blk,
                                  return_res=True)
    torch.cuda.synchronize()
    _close(runs[0][0], o, BF16)
    _close(runs[0][1], den, TRAIN)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    runs = [lln_diag_fused_bwd(qs, ks, q, k, v, g, o, den, r=r, blk=blk)
            for _ in range(2)]
    want = lln_diag_fused_bwd_plain(qs, ks, q, k, v, g, o, den, r=r, blk=blk)
    torch.cuda.synchronize()
    for gt, wt, ag in zip(runs[0], want, runs[1]):
        _close(gt, wt, TRAIN)
        assert torch.equal(gt, ag)


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
def test_cuda_log_linear_gradient_only_off_the_kernel(cuda):
    """``multi_head_attention(impl="log_linear", use_kernel=True)`` refuses
    a gradient on the ``kernel`` kind (``auto`` on CUDA too): its output has
    no autograd Function.  The ``plain`` kind on CUDA tensors gives one."""
    from repro_torch.core.attention import AttnConfig, multi_head_attention
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * 0.5).astype(np.float32)).to(cuda)
    q, k, v = (t.requires_grad_() for t in (f(2, 64, 8, 64), f(2, 64, 2, 64),
                                            f(2, 64, 2, 64)))
    kw = dict(impl="log_linear", lln_chunk=16, num_scales=3, use_kernel=True)
    for backend in ("kernel", "auto"):
        with pytest.raises(NotImplementedError, match="forward only"):
            multi_head_attention(q, k, v, AttnConfig(backend=backend, **kw))
    multi_head_attention(q, k, v, AttnConfig(backend="plain", **kw)) \
        .sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
    with torch.no_grad():
        out = multi_head_attention(q, k, v, AttnConfig(backend="kernel", **kw))
    assert bool(torch.isfinite(out).all())


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
    for r in (1, 4, 5, 8, 16) for i, n in enumerate((64, 512, 300))
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


def _serve_kernel_case(dev, kernel, b, h, g, d, n=512, seed=112):
    """One serving kernel at a model's serving shape (``b`` rows, ``h``
    query and ``g`` kv heads, N = ``n``, D = Dv = ``d``, blk 256, bf16 v)
    against its plain twin: ``lln_causal`` with the final state, causal
    ``block_diag``, or ``lln_decode`` at T = 1 or 16 from that state with a
    rescale.  out within one bf16 step; s, z, s1 and z1 within 1e-5 of the
    largest plain entry; two runs bitwise equal."""
    bh, bg, r = b * h, b * g, h // g
    qs, ks, v = _kernel_inputs(seed, bh, bg, n, d, d)
    qs, ks = _on(dev, qs, ks)
    (vb,) = _on(dev, v, dtype=torch.bfloat16)
    if kernel == "lln_causal_state":
        fn, plain = lln_causal, lln_causal_plain
        args, kw = (qs, ks, vb), dict(r=r, blk=256)
        tols = (BF16, TRAIN, TRAIN)
    elif kernel == "block_diag_causal":
        q, k = (t.bfloat16() for t in (qs, ks))
        fn, plain = block_diag, block_diag_plain
        args, kw = (q, k, vb), dict(r=r, blk=256, causal=True)
        tols = (BF16,)
    else:
        t = int(kernel.rsplit("t", 1)[1])
        _, s, z = lln_causal_plain(qs, ks, vb, r=r, blk=256)
        f = torch.exp(-2.3 * torch.rand(bh, device=dev,
                                        generator=torch.Generator(
                                            dev).manual_seed(3)))
        fn, plain = lln_decode, lln_decode_plain
        args = (qs[:, -t:].contiguous(), ks[:, -t:].contiguous(),
                vb[:, -t:].contiguous(), s, z)
        kw = dict(r=r, scale=f)
        tols = (BF16, TRAIN, TRAIN)
    got, again, want = fn(*args, **kw), fn(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    if len(tols) == 1:
        got, again, want = (got,), (again,), (want,)
    for gt, ag, wt, tol in zip(got, again, want, tols):
        _close(gt, wt, tol)
        assert torch.equal(gt, ag)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lln_causal_state", "block_diag_causal",
                                    "lln_decode_t1"])
def test_cuda_serve_kernels_match_plain_at_the_zamba2_serving_shape(cuda,
                                                                   kernel):
    """The three kernels of zamba2-7b's ``lln_diag`` serving path at its
    shape (B = 4, H = G = 32 so r = 1, N = 512, D = Dv = 112, blk 256, bf16
    v) against their plain twins (:func:`_serve_kernel_case`)."""
    _serve_kernel_case(cuda, kernel, 4, 32, 32, 112)


# (B, H, G, D) of the dense configs' serving paths: qwen3-14b (r = 5),
# chatglm3-6b (r = 16) and stablelm-1.6b (r = 1, D = 64).
DENSE_SERVING = [pytest.param(4, 40, 8, 128, id="qwen3-14b"),
                 pytest.param(4, 32, 2, 128, id="chatglm3-6b"),
                 pytest.param(4, 32, 32, 64, id="stablelm-1.6b")]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lln_causal_state", "block_diag_causal",
                                    "lln_decode_t1", "lln_decode_t16"])
@pytest.mark.parametrize("b,h,g,d", DENSE_SERVING)
def test_cuda_serve_kernels_match_plain_at_the_dense_serving_shapes(
        cuda, b, h, g, d, kernel):
    """Rows 1-3 at the GQA ratios and head dim of the three dense configs'
    serving shapes (N = 512) against their plain twins, decode at T = 1
    and 16 (:func:`_serve_kernel_case`)."""
    _serve_kernel_case(cuda, kernel, b, h, g, d, seed=h + g + d)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_cuda_decode_contract_through_the_kernel(cuda, impl):
    """The decode contract through ``lln_decode`` (the engine, backend
    kernel against plain, B = 4, H = 8, G = 2, D = 128, bf16 q/k/v, a
    prompt of 300, a chunk of 16): with ``row_mask`` (True, False, True,
    False) the masked rows keep every leaf bitwise; with ``commit_len``
    (0, 5, 16, 11) and a renorm below the prompt's smallest max_d z, out
    within one bf16 step and the states within 1e-5 of the largest plain
    entry, the uncommitted row bitwise, the renorm fired."""
    from repro_torch.core.engine import AttentionEngine
    from repro_torch.kernels.registry import AttnSpec
    gen = torch.Generator(cuda).manual_seed(24)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).bfloat16()

    engines = {kind: AttentionEngine(
        spec=AttnSpec(impl=impl, r=4, backend=kind, diag_block=256,
                      precision="bfloat16"),
        heads=8, kv_heads=2, head_dim=128, v_dim=128)
        for kind in ("kernel", "plain")}
    q, k, v = rnd(4, 300, 8, 128), rnd(4, 300, 2, 128), rnd(4, 300, 2, 128)
    _, st = engines["kernel"].prefill(q, k, v)
    thresh = 0.5 * float(st.z.amax(-1).min())
    engines = {kind: AttentionEngine(
        spec=AttnSpec(impl=impl, r=4, backend=kind, diag_block=256,
                      precision="bfloat16", renorm=thresh),
        heads=8, kv_heads=2, head_dim=128, v_dim=128)
        for kind in ("kernel", "plain")}
    q, k, v = rnd(4, 16, 8, 128), rnd(4, 16, 2, 128), rnd(4, 16, 2, 128)
    fields = ("s", "z", "c_k", "log_scale", "tail_k", "tail_v", "pos")
    before = lln_decode.launches
    for kw, still in (
            ({"row_mask": torch.tensor([True, False, True, False],
                                       device=cuda)}, (1, 3)),
            ({"commit_len": torch.tensor([0, 5, 16, 11], dtype=torch.int32,
                                         device=cuda)}, (0,))):
        got, gst = engines["kernel"].decode(st, q, k, v, **kw)
        want, wst = engines["plain"].decode(st, q, k, v, **kw)
        torch.cuda.synchronize()
        keep = [i for i in range(4) if i not in still]
        _close(got[keep], want[keep], BF16)
        for name in fields:
            for row in still:
                assert torch.equal(getattr(gst, name)[row],
                                   getattr(st, name)[row]), (name, row)
            _close(getattr(gst, name), getattr(wst, name), TRAIN)
        assert float(gst.log_scale[keep].min()) > 0.0
    assert lln_decode.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("n,chunk", [(512, 512), (300, 128)],
                         ids=["n512-one-chunk", "n300-ragged-chunks"])
def test_cuda_flash_softmax_bf16_matches_naive(cuda, causal, r, n, chunk):
    """The softmax impl's online softmax (plain PyTorch: the reference has
    no kernel for it) on bf16 CUDA tensors against the fp32 naive softmax,
    rounded once, on the same inputs: bf16 out within one bf16 step.  As
    in the reference, the online softmax scales q in bf16 before its
    product, so the naive one gets that scaled q (and scale 1)."""
    from repro_torch.core.attention import flash_softmax, naive_softmax
    rng = np.random.default_rng(n + r)
    q = rng.normal(size=(2, n, 4 * r, 112)).astype(np.float32)
    k = rng.normal(size=(2, n, 4, 112)).astype(np.float32)
    v = rng.normal(size=(2, n, 4, 112)).astype(np.float32)
    q, k, v = _on(cuda, q, k, v, dtype=torch.bfloat16)
    got = flash_softmax(q, k, v, causal=causal, chunk=chunk)
    qs = q * torch.tensor(112 ** -0.5, dtype=q.dtype, device=cuda)
    want = naive_softmax(qs, k, v, causal=causal, scale=1.0)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_cuda_pool_matches_solo_runs(cuda, impl):
    """A 2-slot continuous-batching pool of yi-9b SMOKE (fp32) on the
    serving kernels: mixed traffic (prompts 8 and 11, budgets 14 and 9,
    segment 3) gives every request the tokens of the same request served
    alone through ``make_serve_setup``, token for token, and the pool
    launches ``lln_causal`` and ``lln_decode`` (``block_diag`` with
    ``lln_diag``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.batcher import ContinuousBatcher, synthetic_traffic
    from repro_torch.launch.steps import make_pool_setup, make_serve_setup
    cfg = get_config("yi-9b", smoke=True, attn_impl=impl,
                     compute_dtype="float32")
    setup = make_pool_setup(cfg, cuda, slots=2, max_len=32, segment=3)
    params = setup.model.init(0)
    reqs = synthetic_traffic(4, cfg.vocab, prompt_lens=[8, 11],
                             gen_lens=[14, 9], seed=0)
    kernels = [lln_causal, lln_decode] + ([block_diag]
                                          if impl == "lln_diag" else [])
    before = [f.launches for f in kernels]
    stats = ContinuousBatcher(setup, params).run(reqs)
    assert all(f.launches > b for f, b in zip(kernels, before))
    solo = make_serve_setup(setup.cfg, ShapeSpec("solo", 32, 1, "decode"),
                            device=cuda)
    for req in reqs:
        prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                 device=cuda)[None]
        logits, caches = solo.prefill_fn(params, {"inputs": prompt})
        tok = torch.argmax(logits[:, -1], -1)
        toks, _ = solo.make_generate(req.gen_len - 1)(params, caches, tok,
                                                      len(req.prompt))
        want = [int(tok)] + toks[0].tolist()
        assert stats.outputs[req.rid].tolist() == want, req.rid


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["lln", "lln_diag", "log_linear", "softmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_verify_and_commit_on_the_kernel_route(cuda, impl, dtype):
    """The speculative verify on the kernel route (B = 4, H = 8, G = 2,
    D = 128, a prompt of 300, a chunk of 4): a ``commit_len = 0`` verify
    leaves every state leaf bitwise as it was; ``commit`` of (4, 0, 1, 3)
    after it equals ``decode`` with that ``commit_len`` bit for bit; the
    verify outputs and the committed state against the plain kind, out
    within one bf16 step (fp32: ATOL), states within 1e-5 of the largest
    plain entry.  The commit launches no kernel."""
    from repro_torch.core.engine import AttentionEngine
    from repro_torch.kernels.registry import AttnSpec
    from repro_torch.tree import leaves_with_path
    gen = torch.Generator(cuda).manual_seed(26)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    engines = {kind: AttentionEngine(
        spec=AttnSpec(impl=impl, r=4, backend=kind, diag_block=256,
                      lln_chunk=256, precision=str(dtype)[6:]),
        heads=8, kv_heads=2, head_dim=128, v_dim=128)
        for kind in ("kernel", "plain")}
    q, k, v = rnd(4, 300, 8, 128), rnd(4, 300, 2, 128), rnd(4, 300, 2, 128)
    _, st = engines["kernel"].prefill(q, k, v, max_len=310)
    q, k, v = rnd(4, 4, 8, 128), rnd(4, 4, 2, 128), rnd(4, 4, 2, 128)
    zero = torch.zeros(4, dtype=torch.int32, device=cuda)
    cl = torch.tensor([4, 0, 1, 3], dtype=torch.int32, device=cuda)
    out, st0, resid = engines["kernel"].verify(st, q, k, v, commit_len=zero,
                                               return_residuals=True)
    for (path, a), (_, b) in zip(leaves_with_path(st0),
                                 leaves_with_path(st)):
        assert torch.equal(a, b), path
    before = lln_decode.launches
    got = engines["kernel"].commit(st0, resid, commit_len=cl)
    assert lln_decode.launches == before
    _, want = engines["kernel"].decode(st, q, k, v, commit_len=cl)
    for (path, a), (_, b) in zip(leaves_with_path(got),
                                 leaves_with_path(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    pout, _, presid = engines["plain"].verify(st, q, k, v, commit_len=zero,
                                              return_residuals=True)
    pst = engines["plain"].commit(st, presid, commit_len=cl)
    torch.cuda.synchronize()
    _close(out, pout, ATOL if dtype == torch.float32 else BF16)
    for (path, a), (_, b) in zip(leaves_with_path(got),
                                 leaves_with_path(pst)):
        if a.is_floating_point():
            _close(a, b, TRAIN)
        else:
            assert torch.equal(a, b), path


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["lln_diag", "log_linear"])
def test_cuda_speculative_greedy_matches_the_plain_loop(cuda, impl):
    """yi-9b SMOKE (fp32) on the serving kernels: greedy speculative
    decoding (k = 3, a 1-layer draft) gives the plain greedy loop's 20
    tokens per row, and a 2-slot speculative pool (k = 2) gives every
    request the tokens of the same request decoded speculatively alone."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.batcher import ContinuousBatcher, synthetic_traffic
    from repro_torch.launch.steps import (flatten_spec_tokens,
                                          make_pool_setup, make_serve_setup,
                                          make_spec_setup)
    cfg = get_config("yi-9b", smoke=True, attn_impl=impl,
                     compute_dtype="float32")
    plen, steps = 14, 20
    sp = make_spec_setup(cfg, ShapeSpec("s", plen + steps + 5, 2, "decode"),
                         cuda, spec_k=3, draft_layers=1)
    params = sp.model.init(0)
    toks = torch.randint(0, cfg.vocab, (2, plen), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(3))
    logits, tc, dc = sp.prefill_fn(params, {"inputs": toks})
    tok = torch.argmax(logits[:, -1], -1)
    out, n_emit, *_ = sp.make_generate(steps)(params, tc, dc, tok, plen)
    ss = make_serve_setup(cfg, ShapeSpec("p", plen + steps + 1, 2, "decode"),
                          cuda)
    logits, caches = ss.prefill_fn(params, {"inputs": toks})
    plain, _ = ss.make_generate(steps)(params, caches, tok, plen)
    np.testing.assert_array_equal(flatten_spec_tokens(out, n_emit, steps),
                                  plain.cpu().numpy())
    pool = make_pool_setup(cfg, cuda, slots=2, max_len=40, segment=3,
                           spec_k=2, draft_layers=1)
    reqs = synthetic_traffic(3, cfg.vocab, prompt_lens=[8, 11],
                             gen_lens=[12, 7], seed=5)
    stats = ContinuousBatcher(pool, params).run(reqs)
    solo = make_spec_setup(pool.cfg, ShapeSpec("solo", 40, 1, "decode"),
                           cuda, spec_k=2, draft_layers=1)
    for req in reqs:
        prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                 device=cuda)[None]
        lg, tc, dc = solo.prefill_fn(params, {"inputs": prompt})
        t0 = torch.argmax(lg[:, -1], -1)
        o, ne, *_ = solo.make_generate(req.budget - 1)(params, tc, dc, t0,
                                                       len(req.prompt))
        want = [int(t0)] + flatten_spec_tokens(o, ne,
                                               req.budget - 1)[0].tolist()
        assert stats.outputs[req.rid].tolist() == want, req.rid


def _adamw_formula(grads, state, params, lr, cfg):
    """AdamW as the reference writes it, a whole-tree clipped copy of the
    gradients first, each leaf's update as one expression."""
    norm = torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.float())) for g in grads.values()])))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(norm, min=1e-9),
                        max=1.0)
    clipped = {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}
    t = (state["step"] + 1).float()
    bc1, bc2 = 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t
    for name, p in params.items():
        gf = clipped[name].float()
        m, v = state["m"][name], state["v"][name]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * gf)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(gf))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = state["step"] + 1
    return norm


def _adamw_matches_the_formula(device):
    """Four steps of ``adamw_update`` and of the formula from the same
    fp32 and bf16 leaves, with the clip inactive and active: params,
    moments and the returned norm bitwise equal."""
    cfg = AdamWConfig()
    gen = torch.Generator(device=device).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for size in (0.01, 100.0):      # gradient norm below / above clip
            params = {f"w{i}": torch.randn(
                67, 33, generator=gen, device=device).to(dtype)
                for i in range(3)}
            params["b"] = torch.randn(5, generator=gen,
                                      device=device).to(dtype)
            ref = {n: p.clone() for n, p in params.items()}
            state, ref_state = adamw_init(params), adamw_init(ref)
            for step in range(4):
                grads = {n: (size * torch.randn(
                    p.shape, generator=gen, device=device)).to(dtype)
                    for n, p in params.items()}
                lr = torch.tensor(1e-3 * (step + 1), device=device)
                _, state, m = adamw_update(grads, state, params, lr, cfg)
                norm = _adamw_formula(grads, ref_state, ref, lr, cfg)
                assert torch.equal(m["grad_norm"], norm)
                for n in params:
                    assert torch.equal(params[n], ref[n]), (dtype, n)
                    assert torch.equal(state["m"][n], ref_state["m"][n])
                    assert torch.equal(state["v"][n], ref_state["v"][n])


@pytest.mark.cuda
def test_cuda_adamw_update_is_the_formula_bit_for_bit(cuda):
    """``adamw_update`` on the card (leaf by leaf, in place) gives the
    formula's params, moments and norm bit for bit."""
    _adamw_matches_the_formula(cuda)


@pytest.fixture
def one_rank_mesh(cuda):
    """A one-rank NCCL group (a local port) and a 1 x 1 DeviceMesh on the
    card, destroyed after the test: the only mesh with real collectives
    that one card runs."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    assert not dist.is_initialized()
    mesh = make_smoke_mesh(1, 1)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _launch_counts():
    kernels = {"lln_causal": lln_causal, "block_diag": block_diag,
               "lln_decode": lln_decode, "lln_diag_fused": lln_diag_fused,
               "lln_causal_bwd": lln_causal_bwd,
               "lln_diag_fused_bwd": lln_diag_fused_bwd,
               "lln_bidir": lln_bidir, "lln_bidir_bwd": lln_bidir_bwd,
               "block_diag_bwd": block_diag_bwd,
               "loglin_causal": loglin_causal, "ssd": ssd}
    return {name: fn.launches for name, fn in kernels.items()}


def _diff(after, before):
    return {k: after[k] - before[k] for k in after}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,impl", [("yi-9b", "lln_diag"),
                                       ("yi-9b", "softmax"),
                                       ("qwen3-moe-235b-a22b", "lln")])
def test_cuda_one_rank_mesh_serves_like_meshless(one_rank_mesh, arch, impl):
    """SMOKE serving (fp32, prompt 24, 8 greedy steps) through
    ``make_serve_setup(mesh=...)`` on the 1 x 1 mesh: the meshless run's
    tokens from the same weights, and the same kernel launches (the MoE
    block through the expert-parallel path)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import synthetic_batch
    cfg = get_config(arch, smoke=True, attn_impl=impl,
                     compute_dtype="float32")
    shape = ShapeSpec("s", 33, 2, "decode")
    runs = []
    params = None
    for mesh in (None, one_rank_mesh):
        setup = make_serve_setup(cfg, shape, "cuda", mesh=mesh)
        params = setup.model.init(0) if params is None else params
        params = setup.shard_params(params)
        batch = synthetic_batch(cfg, 2, 33, seed=1, text_seq=24,
                                device="cuda")
        before = _launch_counts()
        logits, caches = setup.prefill_fn(params, batch)
        tok = torch.argmax(logits[:, -1], -1)
        toks, caches = setup.make_generate(8)(params, caches, tok, 24)
        torch.cuda.synchronize()
        runs.append((torch.cat([tok[:, None], toks], 1),
                     _diff(_launch_counts(), before)))
    (t0, c0), (t1, c1) = runs
    assert torch.equal(t0, t1)
    assert c0 == c1
    if impl != "softmax":
        assert c1["lln_causal"] == cfg.n_layers
        assert c1["lln_decode"] == 8 * cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_cuda_one_rank_mesh_trains_like_meshless(one_rank_mesh, impl):
    """yi-9b SMOKE training (fp32, use_kernel=True, 2 steps of 2 x 32) on
    the 1 x 1 mesh: the meshless run's losses within 1e-5 relative and the
    same training-kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import torch_placer
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.steps import make_train_setup
    cfg = get_config("yi-9b", smoke=True, attn_impl=impl,
                     compute_dtype="float32", use_kernel=True)
    shape = ShapeSpec("t", 32, 2, "train")
    gen = lm_batches(cfg.vocab, 2, 32, seed=0)
    place = torch_placer("cuda")
    batches = [place(next(gen)) for _ in range(2)]
    runs = []
    for mesh in (None, one_rank_mesh):
        setup = make_train_setup(cfg, shape, "cuda", mesh=mesh,
                                 peak_lr=1e-3, total_steps=10)
        state = setup.init_state(0)
        before = _launch_counts()
        losses = []
        for b in batches:
            state, m = setup.step_fn(state, b)
            losses.append(float(m["loss"]))
        runs.append((losses, _diff(_launch_counts(), before)))
    (l0, c0), (l1, c1) = runs
    assert c0 == c1 and (c1["lln_causal"] or c1["lln_diag_fused"])
    for a, b in zip(l1, l0):
        assert abs(a - b) <= 1e-5 * abs(b), (l1, l0)


# Item 12b's families: (arch, impl, the kernels their path must launch).
MESH_FAMILY_SERVE = (("mamba2-130m", "softmax", ()),
                     ("zamba2-7b", "lln_diag", ("lln_causal", "lln_decode")),
                     ("deepseek-v2-236b", "lln_diag",
                      ("lln_causal", "lln_decode")),
                     ("deepseek-v2-236b", "softmax", ()),
                     ("seamless-m4t-medium", "lln_diag",
                      ("lln_bidir", "lln_causal", "lln_decode")),
                     ("paligemma-3b", "softmax", ()),
                     ("paligemma-3b", "lln_diag",
                      ("lln_causal", "lln_decode")),
                     ("yi-9b", "log_linear", ("loglin_causal",)))
MESH_FAMILY_TRAIN = (("mamba2-130m", "softmax", ("ssd",)),
                     ("zamba2-7b", "lln_diag", ("ssd", "lln_diag_fused")),
                     ("deepseek-v2-236b", "lln_diag", ("lln_diag_fused",)),
                     ("seamless-m4t-medium", "lln_diag",
                      ("lln_bidir", "lln_diag_fused")),
                     ("paligemma-3b", "lln_diag", ("lln_diag_fused",)),
                     ("roberta-lln", "lln_diag", ("lln_bidir",)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,impl,want", MESH_FAMILY_SERVE)
def test_cuda_one_rank_mesh_serves_families_like_meshless(one_rank_mesh,
                                                          arch, impl, want):
    """Item 12b: each family's SMOKE serving (fp32, use_kernel=True, 8
    greedy steps) on the 1 x 1 mesh gives the meshless run's tokens from
    the same weights and the same kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import synthetic_batch
    cfg = get_config(arch, smoke=True, attn_impl=impl,
                     compute_dtype="float32", use_kernel=True,
                     capacity_factor=8.0)
    pos0 = 24 + (cfg.num_prefix_tokens if cfg.family == "vlm" else 0)
    shape = ShapeSpec("s", pos0 + 9, 2, "decode")
    runs, params = [], None
    for mesh in (None, one_rank_mesh):
        setup = make_serve_setup(cfg, shape, "cuda", mesh=mesh)
        params = setup.model.init(0) if params is None else params
        params = setup.shard_params(params)
        batch = synthetic_batch(cfg, 2, pos0 + 9, seed=1, text_seq=24,
                                device="cuda")
        batch = {k: v for k, v in batch.items()
                 if k in ("inputs", "src", "patches")}
        before = _launch_counts()
        logits, caches = setup.prefill_fn(params, batch)
        tok = torch.argmax(logits[:, -1], -1)
        toks, caches = setup.make_generate(8)(params, caches, tok, pos0)
        torch.cuda.synchronize()
        runs.append((torch.cat([tok[:, None], toks], 1),
                     _diff(_launch_counts(), before)))
    (t0, c0), (t1, c1) = runs
    assert torch.equal(t0, t1)
    assert c0 == c1 and all(c1[k] for k in want), c1


@pytest.mark.cuda
@pytest.mark.parametrize("arch,impl,want", MESH_FAMILY_TRAIN)
def test_cuda_one_rank_mesh_trains_families_like_meshless(one_rank_mesh,
                                                          arch, impl, want):
    """Item 12b: each family's SMOKE training (fp32, use_kernel=True, one
    microbatch, 2 steps of 2 x 32) on the 1 x 1 mesh: the meshless run's
    losses within 1e-5 relative and the same kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_train_setup
    from repro_torch.models import synthetic_batch
    cfg = get_config(arch, smoke=True, attn_impl=impl,
                     compute_dtype="float32", use_kernel=True, grad_accum=1,
                     capacity_factor=8.0)
    shape = ShapeSpec("t", 32, 2, "train")
    batches = [synthetic_batch(cfg, 2, 32, seed=s, device="cuda")
               for s in range(2)]
    runs = []
    for mesh in (None, one_rank_mesh):
        setup = make_train_setup(cfg, shape, "cuda", mesh=mesh,
                                 peak_lr=1e-3, total_steps=10)
        state = setup.init_state(0)
        before = _launch_counts()
        losses = []
        for b in batches:
            state, m = setup.step_fn(state, b)
            losses.append(float(m["loss"]))
        runs.append((losses, _diff(_launch_counts(), before)))
    (l0, c0), (l1, c1) = runs
    assert c0 == c1 and all(c1[k] for k in want), c1
    for a, b in zip(l1, l0):
        assert abs(a - b) <= 1e-5 * abs(b), (l1, l0)


def _op_args(name, dev):
    """One small set of arguments of each kernel's custom op (the
    ``repro_torch::<wrapper>`` schema), on the card, in bf16 v (the
    tensor-core paths)."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def t(*shape, dtype=torch.float32, neg=True):
        x = torch.rand(shape, generator=g) * (-1.0 if neg else 1.0)
        return x.to(device=dev, dtype=dtype)
    bf = torch.bfloat16
    bh, bg, n, d, dv = 4, 2, 64, 64, 64
    lln = (t(bh, n, d), t(bg, n, d), t(bg, n, dv, dtype=bf, neg=False))
    raw = (t(bh, n, d, dtype=bf, neg=False), t(bg, n, d, dtype=bf, neg=False))
    res = (t(bh, n, dv, dtype=bf, neg=False), t(bh, n, dv, dtype=bf,
                                                neg=False),
           t(bh, n, neg=False) + 1.0)
    qs, ks, v = lln
    return {
        "lln_causal": (*lln, 2, True, True),
        "lln_diag_fused": (qs, ks, *raw, v, 2, 16, 0.125, True),
        "lln_decode": (qs[:, :4].contiguous(), ks[:, :4].contiguous(),
                       v[:, :4].contiguous(), t(bh, d, dv, neg=False),
                       t(bh, 1, d, neg=False), t(bh, neg=False), 2),
        "lln_bidir": (*lln, 2, True),
        "block_diag": (*raw, v, 2, 16, True),
        "block_diag_bwd": (*raw, v, res[0], 2, 16, True),
        "lln_causal_bwd": (*lln, *res, 2, 16),
        "lln_diag_fused_bwd": (qs, ks, *raw, v, *res, 2, 16, 0.125),
        "lln_bidir_bwd": (*lln, *res, t(bg, d, dv, neg=False),
                          t(bg, 1, d, neg=False), 2),
        "loglin_causal": (*lln, 2, 16, 3, 0.5, True),
        "ssd": (t(bh, n), t(bh, n, dv, neg=False), t(bg, n, 16, dtype=bf,
                                                     neg=False),
                t(bg, n, 16, dtype=bf, neg=False), 2, 16),
    }[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "lln_causal", "lln_diag_fused", "lln_decode", "lln_bidir", "block_diag",
    "block_diag_bwd", "lln_causal_bwd", "lln_diag_fused_bwd",
    "lln_bidir_bwd", "loglin_causal", "ssd"])
def test_cuda_custom_op_passes_opcheck(cuda, name):
    """``torch.library.opcheck`` of each kernel's custom op at one small
    shape: its schema, its autograd registration (none: the autograd
    Functions call the ops), its fake implementation against the real op,
    and AOT dispatch."""
    importlib.import_module("repro_torch.kernels.lln_attention")
    torch.library.opcheck(getattr(torch.ops.repro_torch, name).default,
                          _op_args(name, cuda))
