"""The port's log-linear (Fenwick multi-scale) LLN against the JAX reference.

``repro_torch.core.loglinear`` against ``repro.core.loglinear`` (layout,
quadratic oracle, prefill, chunked decode with rows at different depths),
``repro_torch.kernels.ops``' log-linear entries (plain kind) against the
reference's CPU paths, the reductions to plain LLN, and the
``multi_head_attention`` branch with its q/k/v gradients under
``use_kernel`` (``plain`` and ``ref`` kinds) against ``jax.grad``.  Inputs
are made with numpy from a seed and fed to both sides.  Tolerances: fp32
outputs 2e-4 absolute (the port's CPU suite), fp32 states 2e-4 of their
largest entry (sums over the prompt), gradients 1e-5 of their largest
entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.core import loglinear as jl
from repro.core.attention import AttnConfig as JAttnConfig
from repro.core.attention import multi_head_attention as j_mha
from repro.kernels import ops as jops
from repro_torch.core import lln as core_lln
from repro_torch.core import loglinear as tl
from repro_torch.core.attention import AttnConfig, multi_head_attention
from repro_torch.kernels import ops as tops

ATOL = 2e-4
B, H, G, D = 2, 4, 2, 8
CH, L = 8, 3            # granule, num_scales
DECAY = 0.5
FIELDS = ("s", "z", "c_k", "sl", "zl", "cl")


def _close(got, want, atol=ATOL, rel=False):
    want = np.asarray(want, np.float32)
    if rel:
        atol = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=atol, rtol=0)


def _qkv(rng, n, kv=G):
    q = (rng.normal(size=(B, n, H, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, n, kv, D)) * 0.5).astype(np.float32)
    v = rng.normal(size=(B, n, kv, D)).astype(np.float32)
    return q, k, v


def _calib(rng, kv=G):
    return (rng.uniform(0.8, 1.2, H).astype(np.float32),
            rng.uniform(0.8, 1.2, kv).astype(np.float32))


def _rep(x, axis=2):
    return np.repeat(x, H // x.shape[axis], axis=axis)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _state_close(got, want):
    for name in FIELDS:
        _close(getattr(got, name), np.asarray(getattr(want, name)),
               rel=True)


@pytest.mark.parametrize("num_scales", [1, 3, 4])
def test_occupancy_and_level_matrix_match_reference(num_scales):
    n = np.arange(40, dtype=np.int32)
    np.testing.assert_array_equal(
        tl.occupancy(torch.from_numpy(n), num_scales).numpy(),
        np.asarray(jl.occupancy(jnp.asarray(n), num_scales)))
    np.testing.assert_array_equal(
        tl.level_matrix(70, granule=4, num_scales=num_scales).numpy(),
        np.asarray(jl.level_matrix(70, granule=4, num_scales=num_scales)))
    np.testing.assert_array_equal(
        tl.level_weights(num_scales, DECAY).numpy(),
        np.asarray(jl.level_weights(num_scales, DECAY)))


@pytest.mark.parametrize("n", [9 * CH, 9 * CH + 5], ids=["aligned",
                                                          "ragged"])
def test_oracle_and_prefill_match_reference(n):
    rng = np.random.default_rng(n)
    q, k, v = _qkv(rng, n, kv=H)
    alpha, beta = _calib(rng, kv=H)
    kw = dict(granule=CH, num_scales=L, scale_decay=DECAY)
    want = jl.loglin_attention_ref(*_j(q, k, v, alpha, beta), **kw)
    _close(tl.loglin_attention_ref(*_t(q, k, v, alpha, beta), **kw), want)
    j_out, j_st = jl.prefill(*_j(q, k, v, alpha, beta), **kw)
    t_out, t_st = tl.prefill(*_t(q, k, v, alpha, beta), **kw)
    _close(t_out, j_out)
    _close(t_out, want)
    _state_close(t_st, j_st)
    _close(t_st.log_scale, j_st.log_scale)


def _per_row_state(rng, n0, n1, alpha, beta):
    """A reference core state whose row 0 holds an ``n0``-token prompt and
    row 1 an ``n1``-token one (rows at different depths)."""
    q, k, v = _qkv(rng, max(n0, n1), kv=H)
    kw = dict(granule=CH, num_scales=L, scale_decay=DECAY)
    _, st0 = jl.prefill(*_j(q[:, :n0], k[:, :n0], v[:, :n0], alpha,
                            _rep(beta, 0)), **kw)
    _, st1 = jl.prefill(*_j(q[:, :n1], k[:, :n1], v[:, :n1], alpha,
                            _rep(beta, 0)), **kw)
    fields = {f: np.concatenate([np.asarray(getattr(st0, f))[:1],
                                 np.asarray(getattr(st1, f))[1:]], 0)
              for f in FIELDS + ("log_scale",)}
    return (jl.LogLinState(**dict(zip(fields, _j(*fields.values())))),
            tl.LogLinState(**dict(zip(fields, _t(*fields.values())))))


@pytest.mark.parametrize("path", ["core", "ops"])
def test_decode_chunks_match_reference(path):
    """A run of chunks T = 1, 5, 16, 37 (the longer ones in granule-sized
    sub-chunks) from rows at depths 36 and 45: the granule boundaries fall
    at different chunk positions per row, and the run carries through
    every level into the saturated top (n = 7 -> 8).  ``core``: the port's
    core against the reference's, on repeated KV; ``ops``: the port's
    two-pass plain kind against the reference's CPU path, at G kv heads."""
    rng = np.random.default_rng(21)
    alpha, beta = _calib(rng)
    j_st, t_st = _per_row_state(rng, 36, 45, alpha, beta)
    pos = np.array([36, 45], np.int32)
    kw = dict(granule=CH, num_scales=L, scale_decay=DECAY)
    for t in (1, 5, 16, 37):
        q, k, v = _qkv(rng, t)
        if path == "core":
            j_out, j_st = jl.decode_chunk(
                j_st, *_j(q, _rep(k), _rep(v), alpha, _rep(beta, 0)),
                pos=jnp.asarray(pos), **kw)
            t_out, t_st = tl.decode_chunk(
                t_st, *_t(q, _rep(k), _rep(v), alpha, _rep(beta, 0)),
                pos=torch.from_numpy(pos), **kw)
        else:
            j_out, j_st = jops.loglin_decode_chunk(
                j_st, *_j(q, k, v, alpha, beta), pos=jnp.asarray(pos), **kw)
            t_out, t_st = tops.loglin_decode_chunk(
                t_st, *_t(q, k, v, alpha, beta), pos=torch.from_numpy(pos),
                backend="plain", **kw)
        _close(t_out, j_out)
        pos = pos + t
        _state_close(t_st, j_st)
    assert (pos // CH).tolist() == [11, 13]


@pytest.mark.parametrize("num_scales,decay", [(L, 1.0), (1, DECAY)],
                         ids=["decay1", "scales1"])
def test_reduces_to_lln(num_scales, decay):
    """``scale_decay=1`` or ``num_scales=1`` is plain causal LLN, as the
    reference pins for itself: the oracle against the port's core LLN scan,
    and the ops' plain kind against ``ops.lln_attention``'s (fp32, 2e-5 as
    the reference's test)."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 48)
    alpha, beta = _calib(rng)
    want, _ = core_lln.lln_causal_scan(*_t(q, _rep(k), _rep(v), alpha,
                                           _rep(beta, 0)), chunk=CH)
    got = tl.loglin_attention_ref(*_t(q, _rep(k), _rep(v), alpha,
                                      _rep(beta, 0)), granule=CH,
                                  num_scales=num_scales, scale_decay=decay)
    _close(got, want.numpy(), 2e-5)
    want = tops.lln_attention(*_t(q, k, v, alpha, beta), chunk=CH,
                              backend="plain")
    got = tops.loglin_attention(*_t(q, k, v, alpha, beta), chunk=CH,
                                num_scales=num_scales, scale_decay=decay,
                                backend="plain")
    _close(got, want.detach().numpy(), 2e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_multi_head_attention_matches_reference(use_kernel):
    """The ``log_linear`` branch: core prefill on repeated KV, or the
    kernel's plain version through the registry (forward only), against
    the reference's (its CPU path for use_kernel=True) on a ragged N."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 5 * CH + 3)
    kw = dict(impl="log_linear", lln_chunk=CH, num_scales=L,
              scale_decay=DECAY, use_kernel=use_kernel)
    want = j_mha(*_j(q, k, v), JAttnConfig(**kw))
    with torch.no_grad():
        got = multi_head_attention(*_t(q, k, v), AttnConfig(**kw))
    _close(got, want)


def test_log_linear_kernel_path_gives_a_gradient_on_the_cpu():
    """use_kernel=True under ``auto`` resolves to ``plain`` on the CPU,
    which autograd differentiates; the ``kernel`` kind needs CUDA tensors
    (on the card it refuses a gradient, ``tests/test_torch_cuda.py``)."""
    rng = np.random.default_rng(6)
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(rng, 2 * CH)))
    cfg = AttnConfig(impl="log_linear", lln_chunk=CH, use_kernel=True)
    multi_head_attention(q, k, v, cfg).sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    with pytest.raises(RuntimeError, match="CUDA"):
        multi_head_attention(q, k, v, AttnConfig(
            impl="log_linear", lln_chunk=CH, use_kernel=True,
            backend="kernel"))
    q.grad = None
    out = multi_head_attention(q, k, v, AttnConfig(impl="log_linear",
                                                   lln_chunk=CH))
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    with pytest.raises(ValueError, match="causal-only"):
        multi_head_attention(q, k, v, AttnConfig(impl="log_linear",
                                                 causal=False))


@pytest.mark.parametrize("backend", ["plain", "ref"])
@pytest.mark.parametrize("n", [4 * CH, 4 * CH + 3], ids=["whole", "ragged"])
def test_log_linear_kernel_path_gradients_match_reference(backend, n):
    """q/k/v gradients of ``multi_head_attention(impl="log_linear",
    use_kernel=True)`` on the ``plain`` (the kernel's plain version) and
    ``ref`` (the quadratic oracle) kinds against ``jax.grad`` of the
    reference's (its scan twin for a granule multiple, its oracle for a
    ragged N) at the same fixed alpha/beta, within 1e-5 of the largest
    entry (the port's training-gradient tolerance; fp32 sums in another
    order)."""
    rng = np.random.default_rng(40 + n)
    q, k, v = _qkv(rng, n)
    alpha, beta = _calib(rng)
    cot = rng.normal(size=(B, n, H, D)).astype(np.float32)
    kw = dict(impl="log_linear", lln_chunk=CH, num_scales=L,
              scale_decay=DECAY, use_kernel=True)

    def loss(q, k, v):
        out = j_mha(q, k, v, JAttnConfig(**kw), alpha=jnp.asarray(alpha),
                    beta=jnp.asarray(beta))
        return jnp.sum(out * cot)
    want = jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = multi_head_attention(tq, tk, tv, AttnConfig(backend=backend, **kw),
                               alpha=torch.from_numpy(alpha),
                               beta=torch.from_numpy(beta))
    (out * torch.from_numpy(cot)).sum().backward()
    for got, w in zip((tq, tk, tv), want):
        _close(got.grad, w, 1e-5, rel=True)


@pytest.mark.parametrize("arg", ["row_mask", "commit_len", "renorm"])
@pytest.mark.parametrize("backend", ["plain", "ref"])
def test_contract_arguments_raise(arg, backend):
    """The serving-contract arguments, which ``loglin_decode_chunk``
    refused until the contract was ported, are taken and match the
    reference: a chunk of 5 from rows at depths 36 and 45 (both cross a
    granule boundary) with row 1 masked, with ``commit_len`` (5, 2) (row 0
    commits across its boundary, row 1 stops before its), or with a
    renorm threshold at half the largest carried z.  Outputs and every
    state leaf against the reference's CPU path at the suite's
    tolerances; a masked row keeps its state bitwise."""
    rng = np.random.default_rng(7)
    alpha, beta = _calib(rng)
    j_st, t_st = _per_row_state(rng, 36, 45, alpha, beta)
    q, k, v = _qkv(rng, 5)
    pos = np.array([36, 45], np.int32)
    val = {"row_mask": np.array([True, False]),
           "commit_len": np.array([5, 2], np.int32),
           "renorm": 0.5 * float(np.max(np.asarray(j_st.z)))}[arg]
    kw = dict(granule=CH, num_scales=L, scale_decay=DECAY)
    j_out, j_new = jops.loglin_decode_chunk(
        j_st, *_j(q, k, v, alpha, beta), pos=jnp.asarray(pos),
        **{arg: val if arg == "renorm" else jnp.asarray(val)}, **kw)
    t_out, t_new = tops.loglin_decode_chunk(
        t_st, *_t(q, k, v, alpha, beta), pos=torch.from_numpy(pos),
        backend=backend,
        **{arg: val if arg == "renorm" else torch.from_numpy(val)}, **kw)
    _close(t_out, j_out)
    _state_close(t_new, j_new)
    _close(t_new.log_scale, j_new.log_scale, rel=True)
    if arg == "row_mask":
        for name in FIELDS + ("log_scale",):
            assert torch.equal(getattr(t_new, name)[1],
                               getattr(t_st, name)[1]), name
    if arg == "renorm":
        assert float(t_new.log_scale.max()) > 0.0


@pytest.mark.parametrize("renorm", [None, 0.5])
@pytest.mark.parametrize("backend", ["plain", "ref"])
def test_full_commit_equals_the_plain_decode_bitwise(backend, renorm):
    """``commit_len = T`` on every row is the plain decode, bit for bit: a
    chunk of 3 from depths 36 and 45, so row 0 stays inside its granule
    (the open bucket's fold) and row 1 crosses its boundary (the close and
    a new open bucket), with the renorm off and on."""
    rng = np.random.default_rng(11)
    alpha, beta = _calib(rng)
    _, t_st = _per_row_state(rng, 36, 45, alpha, beta)
    q, k, v = _t(*_qkv(rng, 3))
    kw = dict(granule=CH, num_scales=L, scale_decay=DECAY, backend=backend,
              pos=torch.tensor([36, 45], dtype=torch.int32), renorm=renorm)
    a_out, a_st = tops.loglin_decode_chunk(t_st, q, k, v, *_t(alpha, beta),
                                           **kw)
    b_out, b_st = tops.loglin_decode_chunk(
        t_st, q, k, v, *_t(alpha, beta),
        commit_len=torch.tensor([3, 3], dtype=torch.int32), **kw)
    assert torch.equal(a_out, b_out)
    for name in FIELDS + ("log_scale",):
        assert torch.equal(getattr(a_st, name), getattr(b_st, name)), name


def test_spec_carries_the_pyramid_and_refuses_bidirectional():
    from repro_torch.configs import get_config
    from repro_torch.kernels import registry

    cfg = get_config("yi-9b", attn_impl="log_linear", lln_num_scales=3,
                     lln_scale_decay=0.25)
    spec = registry.AttnSpec.from_cfg(cfg)
    assert (spec.impl, spec.num_scales, spec.scale_decay) == (
        "log_linear", 3, 0.25)
    with pytest.raises(ValueError, match="causal-only"):
        registry.AttnSpec(impl="log_linear", causal=False)
    with pytest.raises(ValueError, match="num_scales"):
        registry.AttnSpec(impl="log_linear", num_scales=0)
    with pytest.raises(ValueError, match="decode_lln_chunk"):
        registry.decode_chunk(registry.AttnSpec(impl="lln"), None, None,
                              None, None, None, None, pos=None)
