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

import _torch_threads  # noqa: F401  (one torch thread per test worker)

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


@pytest.mark.parametrize("name", ["lln_causal", "decode_lln", "KVCache",
                                  "flash_softmax", "naive_softmax",
                                  "decode_softmax", "commit_softmax",
                                  "fit_lln_constants"])
def test_core_exports(name):
    assert name in tcore.__all__ and hasattr(tcore, name)


@pytest.mark.parametrize("module,name", [
    ("repro_torch.launch.batcher", "ContinuousBatcher"),
    ("repro_torch.launch.batcher", "synthetic_traffic"),
    ("repro_torch.launch.steps", "make_pool_setup"),
    ("repro_torch.launch.steps", "PoolSetup"),
    ("repro_torch.core.health", "HealthConfig"),
    ("repro_torch.checkpoint", "CheckpointManager"),
    ("repro_torch.optim", "bf16_allreduce_cast"),
    ("repro_torch.optim", "ef_init"),
    ("repro_torch.optim", "ef_compress"),
    ("repro_torch.optim", "ef_decompress")])
def test_serving_and_training_exports(module, name):
    """The pool, the sentinel, the checkpoints and the gradient
    compression, under the reference's module names."""
    import importlib
    mod = importlib.import_module(module)
    assert hasattr(mod, name)
    if hasattr(mod, "__all__"):
        assert name in mod.__all__


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


# --- F5: the engine's stateless call, the state's dict read and the shims --

def _engine_pair(impl, backend="plain", **spec):
    from repro.core.engine import AttentionEngine as JEngine
    from repro.kernels.registry import AttnSpec as JSpec
    kw = dict(impl=impl, r=2, lln_chunk=8, diag_block=8, **spec)
    heads = dict(heads=4, kv_heads=2, head_dim=8, v_dim=8)
    jback = {"plain": "auto", "ref": "ref"}[backend]
    return (JEngine(spec=JSpec(backend=jback, **kw), **heads),
            tcore.AttentionEngine(spec=treg.AttnSpec(backend=backend, **kw),
                                  **heads))


@pytest.mark.parametrize("impl,backend,calibration", [
    ("lln", "plain", "batch"), ("lln_diag", "plain", "per_row"),
    ("lln_diag", "ref", "batch"), ("log_linear", "plain", "batch"),
    ("softmax", "plain", "batch"), ("softmax", "ref", "batch")])
def test_engine_attention_matches_reference(impl, backend, calibration):
    """``AttentionEngine.attention`` (stateless, causal, calibrated inside
    per ``spec.calibration``) equals the reference's on the same inputs,
    and with the engine's own ``calibrate`` passed in."""
    rng = np.random.default_rng(21)
    q = rng.normal(size=(2, 24, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 8)).astype(np.float32)
    jeng, teng = _engine_pair(impl, backend, calibration=calibration)
    want = jeng.attention(*_j(q, k, v))
    got = teng.attention(*_t(q, k, v))
    _close(got.numpy(), want, 1e-4)
    if impl != "softmax":
        alpha, beta = teng.calibrate(*_t(q, k))
        again = teng.attention(*_t(q, k, v), alpha=alpha, beta=beta)
        _close(again.numpy(), got.numpy(), 1e-6)


def test_engine_attention_length_gain_and_refusals():
    """The beta(n) gain applies at N, as in the reference; ``mask`` and
    ``prefix_len`` reach the attention as the reference's do (a key mask
    on the core path of the causal LLN changes nothing there, as in the
    reference; the softmax masks by both)."""
    rng = np.random.default_rng(22)
    q = rng.normal(size=(1, 40, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, 40, 2, 8)).astype(np.float32)
    v = rng.normal(size=(1, 40, 2, 8)).astype(np.float32)
    mask = rng.random((1, 40)) > 0.2
    jeng, teng = _engine_pair("lln", beta_n=0.5, calib_len=16)
    _close(teng.attention(*_t(q, k, v)).numpy(),
           jeng.attention(*_j(q, k, v)), 1e-4)
    _close(teng.attention(*_t(q, k, v), mask=torch.from_numpy(mask),
                          prefix_len=4).numpy(),
           jeng.attention(*_j(q, k, v), mask=jnp.asarray(mask),
                          prefix_len=4), 1e-4)
    jeng, teng = _engine_pair("softmax")
    for kw in ({"prefix_len": 4}, {"mask": mask}):
        tkw = {n: torch.from_numpy(a) if n == "mask" else a
               for n, a in kw.items()}
        jkw = {n: jnp.asarray(a) if n == "mask" else a
               for n, a in kw.items()}
        _close(teng.attention(*_t(q, k, v), **tkw).numpy(),
               jeng.attention(*_j(q, k, v), **jkw), 1e-5)


# --- F6: AttentionEngine.from_cfg with the reference's signature ---------

def test_engine_from_cfg_takes_causal_and_the_head_geometry():
    """``from_cfg(cfg, causal, heads=, kv_heads=, head_dim=, v_dim=)``: the
    spec's ``causal`` and GQA ratio and the state shapes with ``v_dim !=
    head_dim`` are the reference's."""
    from repro.configs import get_config as j_get_config
    from repro.core.engine import AttentionEngine as JEngine
    over = dict(attn_impl="lln_diag", compute_dtype="float32")
    cfg = tconfigs.get_config("yi-9b", smoke=True, **over)
    jcfg = j_get_config("yi-9b", smoke=True, **over)
    for causal in (True, False):
        for geo in ({}, dict(heads=4, kv_heads=4, head_dim=24, v_dim=16)):
            got = tcore.AttentionEngine.from_cfg(cfg, causal, **geo)
            want = JEngine.from_cfg(jcfg, causal, **geo)
            assert (got.heads, got.kv_heads, got.head_dim, got.v_dim) == \
                (want.heads, want.kv_heads, want.head_dim, want.v_dim)
            assert (got.spec.causal, got.spec.r) == (want.spec.causal,
                                                     want.spec.r)
    geo = dict(heads=4, kv_heads=4, head_dim=24, v_dim=16)
    for impl in ("lln_diag", "softmax", "log_linear"):
        got = tcore.AttentionEngine.from_cfg(
            cfg.replace(attn_impl=impl), **geo).init_state(2, "cpu", 12)
        want = JEngine.from_cfg(jcfg.replace(attn_impl=impl),
                                **geo).init_state(2, 12)
        for name in ("k", "v", "s", "z", "c_k", "tail_k", "tail_v", "sl",
                     "zl", "alpha"):
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None) == (b is None), (impl, name)
            if a is not None:
                assert tuple(a.shape) == tuple(b.shape), (impl, name)


@pytest.mark.parametrize("impl", ["lln", "lln_diag", "softmax"])
def test_engine_from_cfg_prefill_and_decode_at_g_eq_h_and_dv_ne_d(impl):
    """A prefill of 20 tokens and a 3-token decode at G = H = 4, D = 24,
    Dv = 16 (MLA's geometry at SMOKE size) through engines bound by
    ``from_cfg``: the outputs and the state against the reference's."""
    from repro.configs import get_config as j_get_config
    from repro.core.engine import AttentionEngine as JEngine
    over = dict(attn_impl=impl, compute_dtype="float32", diag_block=8,
                lln_chunk=8)
    cfg = tconfigs.get_config("yi-9b", smoke=True, **over)
    jcfg = j_get_config("yi-9b", smoke=True, **over)
    geo = dict(heads=4, kv_heads=4, head_dim=24, v_dim=16)
    teng = tcore.AttentionEngine.from_cfg(cfg, **geo)
    jeng = JEngine.from_cfg(jcfg, **geo)
    rng = np.random.default_rng(24)
    q, k = (rng.normal(size=(2, 23, 4, 24)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(2, 23, 4, 16)).astype(np.float32)
    out, st = teng.prefill(*_t(q[:, :20], k[:, :20], v[:, :20]), max_len=24)
    jout, jst = jeng.prefill(*_j(q[:, :20], k[:, :20], v[:, :20]),
                             max_len=24)
    _close(out.numpy(), jout)
    out, st = teng.decode(st, *_t(q[:, 20:], k[:, 20:], v[:, 20:]))
    jout, jst = jeng.decode(jst, *_j(q[:, 20:], k[:, 20:], v[:, 20:]))
    _close(out.numpy(), jout)
    for name in (("k", "v", "len") if impl == "softmax"
                 else ("s", "z", "tail_v", "pos")):
        _close(getattr(st, name).numpy(), getattr(jst, name))


def test_attention_state_getitem():
    """``state["pos"]`` reads the field; an unknown name is a KeyError,
    as in the reference."""
    st = tcore.AttentionEngine(spec=treg.AttnSpec(impl="lln", r=2),
                               heads=4, kv_heads=2, head_dim=8,
                               v_dim=8).init_state(2, "cpu", 8)
    assert st["pos"] is st.pos and st["k"] is None
    with pytest.raises(KeyError):
        st["nope"]


def test_deprecated_shim_warns_once_and_delegates():
    calls = []

    @treg.deprecated_shim("test.old_fn", "test.new_fn")
    def old_fn(x, *, y=1):
        """Doc kept."""
        calls.append((x, y))
        return x + y

    treg.reset_deprecations()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert old_fn(2, y=3) == 5 and old_fn(4) == 5
    assert [w.category for w in caught] == [DeprecationWarning]
    assert "test.new_fn" in str(caught[0].message)
    assert calls == [(2, 3), (4, 1)]
    assert old_fn.__doc__ == "Doc kept."
    assert old_fn.__deprecated_shim__ == ("test.old_fn", "test.new_fn")


def test_attention_block_shims_warn_once_and_match_the_canonical_calls():
    """``attn_cache_init`` / ``attn_prefill`` / ``attn_decode`` warn once
    each and give what ``serve_state_init`` / ``serve_prefill`` /
    ``serve_decode`` give; the prefill and decode outputs equal the
    reference's shims' from converted weights."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models import attention_block as jab
    from repro.models import build_model as j_build_model
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import attention_block as ab
    from repro_torch.models import build_model

    over = dict(attn_impl="lln_diag", compute_dtype="float32")
    cfg = get_config("yi-9b", smoke=True, **over)
    jcfg = j_get_config("yi-9b", smoke=True, **over)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, "cpu")
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])["attn"]
    p = params.layers[0].attn
    rng = np.random.default_rng(23)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    pos = np.arange(12)
    treg.reset_deprecations()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            st0 = ab.attn_cache_init(cfg, 2, 16, device="cpu")
            out, st = ab.attn_prefill(p, torch.from_numpy(x), cfg,
                                      torch.from_numpy(pos), max_len=16)
            out1, st1 = ab.attn_decode(p, torch.from_numpy(x1), st, cfg, 12)
    assert [w.category for w in caught] == [DeprecationWarning] * 3
    ref0 = ab.serve_state_init(cfg, 2, 16, torch.device("cpu"))
    assert all(torch.equal(getattr(st0, f), getattr(ref0, f))
               for f in ("s", "z", "pos", "alpha", "tail_k"))
    ref_out, ref_st = ab.serve_prefill(p, torch.from_numpy(x), cfg,
                                       torch.from_numpy(pos), max_len=16)
    assert torch.equal(out, ref_out) and torch.equal(st.s, ref_st.s)
    assert torch.equal(out1, ab.serve_decode(p, torch.from_numpy(x1), st,
                                             cfg, 12)[0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jout, jst = jab.attn_prefill(jp, jnp.asarray(x), jcfg,
                                     jnp.asarray(pos), max_len=16)
        jout1, _ = jab.attn_decode(jp, jnp.asarray(x1), jst, jcfg, 12)
    _close(out.detach().numpy(), jout, 1e-4)
    _close(out1.detach().numpy(), jout1, 1e-4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pre, _ = ab.attn_prefill(p, torch.from_numpy(x), cfg,
                                 torch.from_numpy(pos), prefix_len=2,
                                 max_len=16)
        jpre, _ = jab.attn_prefill(jp, jnp.asarray(x), jcfg,
                                   jnp.asarray(pos), prefix_len=2,
                                   max_len=16)
    _close(pre.detach().numpy(), jpre, 1e-4)
