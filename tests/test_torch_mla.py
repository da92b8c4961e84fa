"""Multi-head Latent Attention and deepseek-v2-236b in the port, held
against the JAX reference.

* The config is the reference's copy; MLA's engine binds G = H, D = nope +
  rope and its own Dv (F6's ``from_cfg``), and its state has the
  reference's shapes.
* deepseek-v2 SMOKE (one dense first layer, then MoE layers with a shared
  expert), with ``lln_diag`` (the engine at D = 24, Dv = 16) and
  ``softmax`` (the absorbed decode over the latent ``(ckv, kr)`` cache):
  ``Model.hidden``, ``Model.loss``, the prefill logits and 8 teacher-forced
  decode steps against the reference's ``build_model`` within 1e-5 of the
  largest entry (fp32), greedy tokens equal (``_torch_families.py``).
* The absorbed decode over a (B, T = 3) chunk at per-row cache lengths,
  against the reference's ``_mla_absorbed_decode``, cache included.
* MLA refuses ``row_mask`` / ``commit_len`` and the single-pass verify, as
  the reference does; ``Model.score`` / ``commit`` are None; the
  deprecated ``mla_cache_init`` warns once and gives ``mla_state_init``.
* The serve CLI for the arch.
* Training: deepseek-v2 SMOKE (its dense first layer in ``first_layers``
  beside the MoE layers with a shared expert) from the reference's
  initial state, the first-step gradient of every leaf against
  ``jax.grad`` and 3 ``make_train_setup`` steps
  (``_torch_families.trains_like_the_reference``): ``lln_diag`` with
  ``use_kernel`` False and True (the fused pair's plain versions at D =
  24, Dv = 16), and ``lln`` with ``use_kernel=True`` (the causal pair,
  ``return_res`` and its backward, at D != Dv, r = 1).

Every JAX run is made once per module (module-scoped fixtures).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)
import _torch_families as fam

from repro.configs import get_config as j_get_config
from repro.core.engine import AttentionState as JState
from repro.models import mla as jmla
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.kernels import registry as treg
from repro_torch.launch import serve
from repro_torch.models import build_model, mla
from repro_torch.models import transformer as tr

ARCH = "deepseek-v2-236b"


def test_config_and_engine_geometry():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
            dataclasses.asdict(j_get_config(ARCH, smoke=smoke))
    cfg = get_config(ARCH, attn_impl="lln_diag")
    eng = mla.mla_engine(cfg)
    assert (eng.heads, eng.kv_heads, eng.head_dim, eng.v_dim) == \
        (128, 128, 192, 128)
    assert eng.spec.r == 1 and eng.spec.causal
    jcfg = j_get_config(ARCH, smoke=True, attn_impl="lln_diag")
    scfg = get_config(ARCH, smoke=True, attn_impl="lln_diag")
    for impl in ("lln_diag", "softmax"):
        want = jmla.mla_state_init(jcfg.replace(attn_impl=impl), 2, 12)
        got = mla.mla_state_init(scfg.replace(attn_impl=impl), 2, 12, "cpu")
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert tuple(a.shape) == tuple(b.shape), f.name


@pytest.fixture(scope="module", params=["lln_diag", "softmax"])
def reference(request):
    return request.param, fam.reference_run(ARCH, request.param)


def test_serves_like_the_reference(reference):
    impl, ref = reference
    cfg, model, params, caches = fam.port_matches(ARCH, impl, ref)
    assert len(caches["first_layers"]) == 1 and len(caches["layers"]) == 2
    st = caches["layers"][0]
    if impl == "softmax":
        assert st.ckv.shape == (2, ref["max_len"], cfg.kv_lora)
        assert st.s is None
    else:
        assert st.s.shape == (2, cfg.n_heads, 24, 16) and st.ckv is None


def test_absorbed_decode_chunk_matches_the_reference():
    """A 3-token chunk at cache lengths 5 and 9, from the reference's MLA
    weights: the outputs and the written latent cache."""
    over = dict(attn_impl="softmax", compute_dtype="float32")
    jcfg = j_get_config(ARCH, smoke=True, **over)
    cfg = get_config(ARCH, smoke=True, **over)
    jp = jmla.mla_init(jax.random.PRNGKey(5), jcfg)
    p = mla.mla_init(cfg, "cpu")
    with torch.no_grad():
        for name, a in jp.items():
            getattr(p, name).copy_(torch.from_numpy(np.array(a)))
    rng = np.random.default_rng(7)
    s = 16
    ckv = rng.normal(size=(2, s, cfg.kv_lora)).astype(np.float32)
    kr = rng.normal(size=(2, s, cfg.rope_head_dim)).astype(np.float32)
    lens = np.array([5, 9], np.int32)
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    jst = JState(ckv=jnp.asarray(ckv), kr=jnp.asarray(kr),
                 len=jnp.asarray(lens))
    jout, jst2 = jmla.mla_decode(jp, jnp.asarray(x), jst, jcfg,
                                 jnp.asarray(lens))
    st = state_from_numpy({"ckv": ckv, "kr": kr, "len": lens}, "cpu")
    out, st2 = mla.mla_decode(p, torch.from_numpy(x), st, cfg,
                              torch.from_numpy(lens))
    fam.close(out, jout)
    fam.close(st2.ckv, jst2.ckv)
    fam.close(st2.kr, jst2.kr)
    assert st2.len.tolist() == np.asarray(jst2.len).tolist()


def test_mla_refusals_and_the_cache_shim():
    cfg = get_config(ARCH, smoke=True, attn_impl="lln_diag",
                     compute_dtype="float32")
    model = build_model(cfg, "cpu")
    assert model.score is None and model.commit is None
    params = model.init(0)
    caches = model.cache_init(params, 2, 16)
    tok = torch.zeros(2, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="not wired for MLA"):
        model.decode(params, caches, tok, 4,
                     row_mask=torch.ones(2, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="not wired for MLA"):
        tr.lm_commit(caches, caches, cfg, torch.zeros(2, dtype=torch.int32))
    treg.reset_deprecations()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a = mla.mla_cache_init(cfg, 2, 16, device="cpu")
        mla.mla_cache_init(cfg, 2, 16, device="cpu")
    assert [w.category for w in caught] == [DeprecationWarning]
    b = mla.mla_state_init(cfg, 2, 16, "cpu")
    assert all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("s", "z", "tail_k", "tail_v", "pos", "alpha"))


def test_serve_cli():
    for impl in ("lln_diag", "softmax"):
        toks = serve.main(["--arch", ARCH, "--smoke", "--attn-impl", impl,
                           "--device", "cpu", "--batch", "2",
                           "--prompt-len", "12", "--gen", "5"])
        assert toks.shape == (2, 5)


@pytest.mark.parametrize("impl,use_kernel", [
    ("lln_diag", False), ("lln_diag", True), ("lln", True)],
    ids=["lln_diag-core", "lln_diag-kernel", "lln-kernel"])
def test_trains_like_the_reference(impl, use_kernel):
    setup = fam.trains_like_the_reference(ARCH, impl, use_kernel)
    names = dict(setup.model.init(0).named_parameters())
    assert any(n.startswith("first_layers.0.") for n in names)
    assert setup.model.cfg.first_dense_layers == 1
