"""The VLM family (paligemma-3b) and the prefix-LM mask in the port, held
against the JAX reference.

* The config is the reference's copy.
* paligemma SMOKE (MQA kv = 1, GeGLU, embedding scaling, tied head, a
  patch prefix through ``patch_proj``) with ``lln_diag`` (the prefix taken
  causally, as the reference does) and ``softmax`` (the prefix attended
  bidirectionally): ``Model.hidden`` (the text positions only),
  ``Model.loss``, the prefill logits and 8 teacher-forced decode steps,
  positions after the prefix, against the reference's ``build_model``
  within 1e-5 of the largest entry (fp32), greedy tokens equal
  (``_torch_families.py``).
* ``prefix_len`` through ``multi_head_attention``,
  ``AttentionEngine.attention`` and ``prefill`` and ``serve_prefill``
  against the reference's, for ``softmax`` (which masks by it) and
  ``lln`` / ``lln_diag`` (which ignore it).
* The serve CLI for the arch.
* Training: paligemma SMOKE (8 patches + 24 text tokens) from the
  reference's initial state, the first-step gradient of every leaf
  (``patch_proj`` included) against ``jax.grad`` and 3
  ``make_train_setup`` steps (``_torch_families.trains_like_the_reference``):
  ``lln_diag`` with ``use_kernel`` False and True, and ``lln`` with
  ``use_kernel=True`` (the causal pair at r = 4).  Under ``use_kernel``
  the reference's kernel route drops ``mask`` and ``prefix_len`` for the
  LLN impls (its core route ignores ``prefix_len`` too), so the patches
  are taken causally on both routes, in the port as in the reference.

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
from repro.core import attention as jca
from repro.core.engine import AttentionEngine as JEngine
from repro.models import attention_block as jab
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import attention as ca
from repro_torch.core.engine import AttentionEngine
from repro_torch.kernels import registry as treg
from repro_torch.launch import serve
from repro_torch.models import attention_block as ab

ARCH = "paligemma-3b"


def test_config_copies_the_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
            dataclasses.asdict(j_get_config(ARCH, smoke=smoke))
    cfg = get_config(ARCH)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.num_prefix_tokens) == \
        (8, 1, 256, 256)


@pytest.fixture(scope="module", params=["lln_diag", "softmax"])
def reference(request):
    return request.param, fam.reference_run(ARCH, request.param)


def test_serves_like_the_reference(reference):
    impl, ref = reference
    cfg, model, params, _ = fam.port_matches(ARCH, impl, ref)
    assert ref["pos0"] == ref["batch"]["inputs"].shape[1] + \
        cfg.num_prefix_tokens
    assert not hasattr(params, "lm_head") and params.patch_proj.shape == (
        cfg.frontend_dim, cfg.d_model)


@pytest.mark.parametrize("impl", ["softmax", "lln", "lln_diag"])
def test_prefix_len_through_attention_and_the_engine(impl):
    """Causal attention over 24 positions with an 8-position prefix-LM
    prefix: ``multi_head_attention`` (core path), the engine's
    ``attention`` and ``prefill`` (backend ``plain`` against the
    reference's ``auto``, the kernels' twins; for softmax the online
    softmax both) and, for ``softmax``, a different result from no prefix."""
    over = dict(attn_impl=impl, compute_dtype="float32", diag_block=8,
                lln_chunk=8)
    cfg = get_config(ARCH, smoke=True, **over)
    jcfg = j_get_config(ARCH, smoke=True, **over)
    rng = np.random.default_rng(21)
    q = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 24, 1, 16)).astype(np.float32)
            for _ in range(2))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    j = [jnp.asarray(a) for a in (q, k, v)]
    got = ca.multi_head_attention(*t, ab.attn_cfg_of(cfg), prefix_len=8)
    fam.close(got, jca.multi_head_attention(*j, jab.attn_cfg_of(jcfg),
                                            prefix_len=8))
    plain = ca.multi_head_attention(*t, ab.attn_cfg_of(cfg))
    assert (impl == "softmax") != torch.equal(got, plain)
    eng = AttentionEngine.from_cfg(cfg.replace(attn_backend="plain"))
    jeng = JEngine.from_cfg(jcfg)
    fam.close(eng.attention(*t, prefix_len=8),
              jeng.attention(*j, prefix_len=8))
    out, st = eng.prefill(*t, max_len=30, prefix_len=8)
    jout, jst = jeng.prefill(*j, max_len=30, prefix_len=8)
    fam.close(out, jout)
    if impl == "softmax":
        fam.close(st.k, jst.k)
    else:
        fam.close(st.s, jst.s)


def test_serve_prefill_and_the_shim_take_prefix_len(reference):
    """``serve_prefill`` and the deprecated ``attn_prefill`` with
    ``prefix_len`` give the reference's ``serve_prefill``."""
    impl, ref = reference
    over = dict(attn_impl=impl, compute_dtype="float32")
    cfg = get_config(ARCH, smoke=True, **over)
    jcfg = j_get_config(ARCH, smoke=True, **over)
    params = params_from_numpy(ref["params"], cfg, "cpu")
    jp = jax.tree_util.tree_map(lambda a: a[0], ref["params"]["layers"])
    x = np.random.default_rng(22).normal(
        size=(2, 20, cfg.d_model)).astype(np.float32)
    pos = np.arange(20)
    out, _ = ab.serve_prefill(params.layers[0].attn, torch.from_numpy(x),
                              cfg, torch.from_numpy(pos), prefix_len=6,
                              max_len=24)
    jout, _ = jab.serve_prefill(jp["attn"], jnp.asarray(x), jcfg,
                                jnp.asarray(pos), prefix_len=6, max_len=24)
    fam.close(out, jout)
    treg.reset_deprecations()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        shim, _ = ab.attn_prefill(params.layers[0].attn, torch.from_numpy(x),
                                  cfg, torch.from_numpy(pos), prefix_len=6,
                                  max_len=24)
    assert torch.equal(shim, out)


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
    fam.trains_like_the_reference(ARCH, impl, use_kernel)
