"""The encoder-decoder family (seamless-m4t-medium) in the port, held
against the JAX reference.

* The config is the reference's copy.
* seamless SMOKE with ``lln_diag`` (a bidirectional LLN + non-causal
  block-diagonal encoder, a causal decoder through the engine, softmax
  cross-attention over the ``ck`` / ``cv`` cache) and ``softmax``:
  ``Model.hidden``, ``Model.loss``, the prefill logits and 8
  teacher-forced decode steps against the reference's ``build_model``
  within 1e-5 of the largest entry (fp32), greedy tokens equal
  (``_torch_families.py``).  The encoder on the kernel route
  (``use_kernel=True``: the plain versions of ``lln_bidir`` and the
  non-causal ``block_diag`` here) gives the reference's core form.
* A key ``mask`` through ``multi_head_attention`` and
  ``AttentionEngine.attention`` (bidirectional ``lln``, ``lln_diag`` and
  ``softmax`` on the core path, as the reference's) and through
  ``attn_apply``'s cross-attention (``kv=``), against the reference.
* ``encdec_decode`` refuses a (B, T) chunk, as the reference does.
* The serve CLI for the arch.
* Training: seamless SMOKE ``lln_diag`` with ``use_kernel`` False and
  True (the bidirectional encoder through ``lln_bidir`` and the
  non-causal ``block_diag`` and their backwards, the causal decoder
  through the fused pair, the softmax cross-attention in plain torch),
  48 source frames under 32 target tokens, from the reference's initial
  state: the first-step gradient of every leaf against ``jax.grad`` and 3
  ``make_train_setup`` steps (``_torch_families.trains_like_the_reference``).

Every JAX run is made once per module (module-scoped fixtures).
"""
import dataclasses

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
from repro.models import encdec as jed
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import attention as ca
from repro_torch.core.engine import AttentionEngine
from repro_torch.launch import serve
from repro_torch.models import attention_block as ab
from repro_torch.models import encdec as ed

ARCH = "seamless-m4t-medium"


def test_config_copies_the_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
            dataclasses.asdict(j_get_config(ARCH, smoke=smoke))
    cfg = get_config(ARCH)
    assert (cfg.enc_layers, cfg.n_layers, cfg.hd, cfg.frontend_dim) == \
        (12, 12, 64, 1024)


@pytest.fixture(scope="module", params=["lln_diag", "softmax"])
def reference(request):
    return request.param, fam.reference_run(ARCH, request.param)


def test_serves_like_the_reference(reference):
    impl, ref = reference
    cfg, model, params, caches = fam.port_matches(ARCH, impl, ref)
    m = ref["batch"]["src"].shape[1]
    assert caches["layers"][0]["ck"].shape == (2, m, cfg.n_kv_heads, cfg.hd)
    with pytest.raises(NotImplementedError, match="chunked"):
        model.decode(params, caches, torch.zeros(2, 3, dtype=torch.long),
                     ref["pos0"])


def test_encoder_kernel_route_gives_the_core_form():
    """``use_kernel=True`` runs the encoder's bidirectional LLN and its
    non-causal diag part through ``kernels/ops.py`` (plain versions on the
    CPU), which the reference's core form equals in the forward."""
    over = dict(attn_impl="lln_diag", compute_dtype="float32")
    cfg = get_config(ARCH, smoke=True, use_kernel=True, **over)
    jcfg = j_get_config(ARCH, smoke=True, **over)
    jparams = jed.encdec_init(jax.random.PRNGKey(2), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, "cpu")
    src = np.random.default_rng(3).normal(
        size=(2, 40, cfg.frontend_dim)).astype(np.float32)
    with torch.no_grad():
        got = ed.encode(params, torch.from_numpy(src), cfg)
    fam.close(got, jed.encode(jparams, jnp.asarray(src), jcfg))


@pytest.mark.parametrize("impl", ["lln", "lln_diag", "softmax"])
def test_key_mask_through_attention_and_engine(impl):
    """Bidirectional attention with a (B, N) key mask, core path: the
    reference's ``multi_head_attention`` and engine ``attention``."""
    cfg = get_config(ARCH, smoke=True, attn_impl=impl,
                     compute_dtype="float32", diag_block=8)
    jcfg = j_get_config(ARCH, smoke=True, attn_impl=impl,
                        compute_dtype="float32", diag_block=8)
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(2, 20, 4, 16)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((2, 20)) > 0.3
    t = [torch.from_numpy(a) for a in (q, k, v)]
    j = [jnp.asarray(a) for a in (q, k, v)]
    got = ca.multi_head_attention(*t, ab.attn_cfg_of(cfg, False),
                                  mask=torch.from_numpy(mask))
    want = jca.multi_head_attention(*j, jab.attn_cfg_of(jcfg, False),
                                    mask=jnp.asarray(mask))
    fam.close(got, want)
    eng = AttentionEngine.from_cfg(cfg.replace(attn_backend="ref"),
                                   causal=False)
    jeng = JEngine.from_cfg(jcfg.replace(attn_backend="ref"), causal=False)
    got = eng.attention(*t, mask=torch.from_numpy(mask))
    fam.close(got, jeng.attention(*j, mask=jnp.asarray(mask)))


def test_cross_attention_with_a_key_mask(reference):
    """``attn_apply(kv=...)``: softmax over the memory, no RoPE on it, a
    (B, M) key mask."""
    _, ref = reference
    cfg = get_config(ARCH, smoke=True, compute_dtype="float32")
    jcfg = j_get_config(ARCH, smoke=True, compute_dtype="float32")
    params = params_from_numpy(ref["params"], cfg, "cpu")
    jp = jax.tree_util.tree_map(lambda a: a[0], ref["params"]["layers"])
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    mask = rng.random((2, 9)) > 0.3
    got = ab.attn_apply(params.layers[0].cross, torch.from_numpy(x), cfg,
                        torch.arange(6), kv=torch.from_numpy(mem),
                        mask=torch.from_numpy(mask))
    want = jab.attn_apply(jp["cross"], jnp.asarray(x), jcfg, jnp.arange(6),
                          kv=jnp.asarray(mem), mask=jnp.asarray(mask))
    fam.close(got, want)


def test_serve_cli():
    toks = serve.main(["--arch", ARCH, "--smoke", "--attn-impl", "lln_diag",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "12", "--gen", "5"])
    assert toks.shape == (2, 5)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["lln_diag-core", "lln_diag-kernel"])
def test_trains_like_the_reference(use_kernel):
    fam.trains_like_the_reference(ARCH, "lln_diag", use_kernel)
