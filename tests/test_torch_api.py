"""The port's public names and small core functions, held against the JAX
reference.

Every name of ``repro.kernels.__all__`` is exported by
``repro_torch.kernels``; the feature maps, ``lln_causal``, ``lln_grads``,
``decode_step``, the deprecated ``decode_lln`` and the config registry's
``SHAPES`` / ``list_archs`` / ``ASSIGNED_ARCHS`` match the reference on
the same numpy inputs at smoke size.  Tolerance: fp32 1e-5 relative to the
largest entry (both sides evaluate the same expressions, summed in another
order); ``lln_grads`` is also held to ``torch.autograd`` of the port's own
``lln_causal`` at 1e-4 (the autograd path goes through the chunked scan
and the stabilization constants, the analytic form through the quadratic
one).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.kernels as jkernels
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
import repro_torch.kernels as tkernels
from repro.core import attention as jattn
from repro.core import lln as jlln
from repro_torch.core import attention as tattn
from repro_torch.core import lln as tlln
from repro_torch.kernels import registry as treg

TOL = 1e-5


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float32)
    atol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol,
                               rtol=0)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _qkv(seed, b=2, n=24, h=3, d=8, dv=6):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n, h, d)).astype(np.float32)
    k = rng.normal(size=(b, n, h, d)).astype(np.float32)
    v = rng.normal(size=(b, n, h, dv)).astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, h).astype(np.float32)
    beta = rng.uniform(0.5, 1.5, h).astype(np.float32)
    return q, k, v, alpha, beta


@pytest.mark.parametrize("name", jkernels.__all__)
def test_kernels_export_every_reference_name(name):
    assert name in tkernels.__all__
    assert hasattr(tkernels, name)


@pytest.mark.parametrize("name", ["lln_causal", "decode_lln"])
def test_core_exports(name):
    assert name in tcore.__all__ and hasattr(tcore, name)


@pytest.mark.parametrize("which", ["q", "k"])
@pytest.mark.parametrize("param", ["scalar", "heads", "rows"])
def test_feature_maps(which, param):
    q, _, _, alpha, _ = _qkv(1)
    p = {"scalar": np.float32(0.8), "heads": alpha,
         "rows": np.stack([alpha, alpha[::-1]])}[param]
    jfn = jlln.feature_map_q if which == "q" else jlln.feature_map_k
    tfn = tlln.feature_map_q if which == "q" else tlln.feature_map_k
    want = jfn(jnp.asarray(q), jnp.asarray(p))
    got = tfn(torch.from_numpy(q), torch.as_tensor(p))
    _close(got.numpy(), want)


@pytest.mark.parametrize("n,chunk", [(24, 8), (21, 8), (16, 16)])
def test_lln_causal(n, chunk):
    q, k, v, alpha, beta = _qkv(2, n=n)
    want = jlln.lln_causal(*_j(q, k, v, alpha, beta), chunk=chunk)
    got = tlln.lln_causal(*_t(q, k, v, alpha, beta), chunk=chunk)
    _close(got.numpy(), want)


@pytest.mark.parametrize("causal", [True, False])
def test_lln_grads_match_reference(causal):
    q, k, v, alpha, beta = _qkv(3, n=16)
    g = np.random.default_rng(4).normal(size=v.shape).astype(np.float32)
    want = jlln.lln_grads(*_j(q, k, v, alpha, beta, g), causal=causal)
    got = tlln.lln_grads(*_t(q, k, v, alpha, beta, g), causal=causal)
    for gt, wt in zip(got, want):
        _close(gt.numpy(), wt)


def test_lln_grads_match_autograd_of_lln_causal():
    q, k, v, alpha, beta = _qkv(5, n=16)
    g = np.random.default_rng(6).normal(size=v.shape).astype(np.float32)
    qt, kt, vt = (t.clone().requires_grad_() for t in _t(q, k, v))
    out = tlln.lln_causal(qt, kt, vt, torch.from_numpy(alpha),
                          torch.from_numpy(beta), chunk=8)
    auto = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    got = tlln.lln_grads(*_t(q, k, v, alpha, beta, g), causal=True)
    for gt, at in zip(got, auto):
        _close(gt.numpy(), at.numpy(), 1e-4)


def _lln_state(seed, b, h, d, dv):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(b, h, d, dv)).astype(np.float32)
    z = rng.uniform(0.5, 3.0, (b, h, d)).astype(np.float32)
    c_k = rng.uniform(-0.5, 0.5, (b, 1, h, 1)).astype(np.float32)
    ls = np.zeros((b, h), np.float32)
    return s, z, c_k, ls


def test_decode_step():
    q, k, v, alpha, beta = _qkv(7, n=1)
    s, z, c_k, ls = _lln_state(8, 2, 3, 8, 6)
    want_out, want_st = jlln.decode_step(
        jlln.LLNState(*_j(s, z, c_k, ls)), *_j(q, k, v, alpha, beta))
    got_out, got_st = tlln.decode_step(
        tlln.LLNState(*_t(s, z, c_k, ls)), *_t(q, k, v, alpha, beta))
    _close(got_out.numpy(), want_out)
    for name in ("s", "z", "c_k"):
        _close(getattr(got_st, name).numpy(), getattr(want_st, name))


@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_decode_lln_warns_once_and_matches_reference(impl):
    b, h, g, d, blk = 2, 4, 2, 8, 8
    q, _, _, alpha, beta = _qkv(9, b=b, n=1, h=h, d=d)
    rng = np.random.default_rng(10)
    k = rng.normal(size=(b, 1, g, d)).astype(np.float32)
    v = rng.normal(size=(b, 1, g, d)).astype(np.float32)
    s, z, c_k, ls = _lln_state(11, b, h, d, d)
    tail_k = rng.normal(size=(b, blk, g, d)).astype(np.float32)
    tail_v = rng.normal(size=(b, blk, g, d)).astype(np.float32)
    pos = np.array([13, 5], np.int32)
    beta = beta[:g]
    jst = jattn.LLNDecodeState(jlln.LLNState(*_j(s, z, c_k, ls)),
                               *_j(tail_k, tail_v, pos))
    want_out, want_st = jattn.decode_lln(jst, *_j(q, k, v, alpha, beta),
                                         impl=impl)
    tst = tattn.LLNDecodeState(tlln.LLNState(*_t(s, z, c_k, ls)),
                               *_t(tail_k, tail_v, pos))
    treg.reset_deprecations()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got_out, got_st = tattn.decode_lln(tst, *_t(q, k, v, alpha, beta),
                                           impl=impl)
        tattn.decode_lln(tst, *_t(q, k, v, alpha, beta), impl=impl)
    assert [w.category for w in caught] == [DeprecationWarning]
    _close(got_out.numpy(), want_out)
    _close(got_st.lln.s.numpy(), want_st.lln.s)
    _close(got_st.lln.z.numpy(), want_st.lln.z)
    _close(got_st.tail_k.numpy(), want_st.tail_k)
    assert got_st.pos.tolist() == np.asarray(want_st.pos).tolist()


def test_shapes_match_reference():
    assert [tuple(vars(s).values()) for s in tconfigs.SHAPES] == \
        [tuple(vars(s).values()) for s in jconfigs.SHAPES]
    assert sorted(tconfigs.SHAPES_BY_NAME) == sorted(jconfigs.SHAPES_BY_NAME)


def test_arch_registry():
    assert set(tconfigs.list_archs()) <= set(jconfigs.list_archs())
    assert "roberta-lln" in tconfigs.list_archs()
    assert set(tconfigs.ASSIGNED_ARCHS) == \
        set(tconfigs.list_archs()) - {"roberta-lln"}
    assert set(tconfigs.ASSIGNED_ARCHS) <= set(jconfigs.ASSIGNED_ARCHS)
    for name in tconfigs.list_archs():
        assert tconfigs.get_config(name, smoke=True).name
