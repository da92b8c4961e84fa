"""The three dense configs of the reference the port adds: qwen3-14b (GQA
40/8 with qk-norm, rope_theta 1e6), stablelm-1.6b (MHA, LayerNorm, RoPE on
a quarter of the head) and chatglm3-6b (GQA 32/2, RoPE on half the head),
held against the JAX reference.

The configs are the reference's copies; qk-norm (``rms_head_norm``) and the
partial RoPE at 0.25 and 0.5 match the reference's functions; each SMOKE
config serves with ``lln``, ``lln_diag`` and ``softmax`` from the
reference's converted weights (fp32, prompt 20, 4 teacher-forced decode
steps: greedy tokens equal, logits within 2e-4 of the largest entry, the
tolerance of ``tests/test_torch_serve.py``); and one AdamW step of
qwen3-14b SMOKE (``lln_diag``, ``use_kernel`` True and False) gives the
reference's loss, grad norm and first gradient of every leaf, the qk-norm
scales included (1e-4 relative, as ``tests/test_torch_train.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.launch.mesh import compat_mesh
from repro.launch.steps import make_serve_setup as j_make_serve_setup
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.models import synthetic_batch as j_synthetic_batch
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import (leaves_from_numpy, params_from_numpy,
                                 train_state_from_numpy)
from repro_torch.data import torch_placer
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import serve
from repro_torch.launch.steps import make_serve_setup, make_train_setup
from repro_torch.models import layers

ARCHS = ["qwen3-14b", "stablelm-1.6b", "chatglm3-6b"]
ATOL = 2e-4
REL = 1e-4
BATCH, PROMPT, STEPS = 2, 20, 4


def _close(got, want, rel=ATOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference(arch):
    """CONFIG and SMOKE field for field as the reference's (the port's
    dtypes are names, as the reference's)."""
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(j_get_config(arch, smoke=smoke))
    cfg = get_config(arch)
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.hd) == {
        "qwen3-14b": (5, 128), "stablelm-1.6b": (1, 64),
        "chatglm3-6b": (16, 128)}[arch]


@pytest.mark.parametrize("rotary_pct", [0.25, 0.5, 1.0])
def test_partial_rope_and_qk_norm_match_the_reference(rotary_pct):
    """RoPE on the first quarter (stablelm) or half (chatglm3) of the head
    dim, the rest passed through, and the qk-norm of qwen3 (fp32 inside,
    the input dtype out), on per-row positions."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    want = j_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6, rotary_pct)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                      rotary_pct)
    _close(got, want, 1e-6)
    rd = int(16 * rotary_pct)
    np.testing.assert_array_equal(got[..., rd:].numpy(), x[..., rd:])
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = layers.rms_head_norm(torch.from_numpy(scale),
                                   torch.from_numpy(x).to(dtype))
        want = j_layers.rms_head_norm(jnp.asarray(scale),
                                      jnp.asarray(x).astype(jdtype))
        assert got.dtype == dtype
        _close(got, np.asarray(want.astype(jnp.float32)), 1e-6 if
               dtype == torch.float32 else 2.0 ** -8)


@pytest.mark.parametrize("impl", ["lln", "lln_diag", "softmax"])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_serves_like_the_reference(arch, impl):
    over = dict(attn_impl=impl, compute_dtype="float32")
    jcfg = j_get_config(arch, smoke=True, **over)
    cfg = get_config(arch, smoke=True, **over)
    max_len = PROMPT + STEPS + 1
    mesh = compat_mesh((1, 1), ("data", "model"))
    with mesh:
        jsetup = j_make_serve_setup(jcfg, JShape("t", max_len, BATCH,
                                                 "decode"), mesh,
                                    multi_pod=False)
        jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
        jbatch = j_synthetic_batch(jcfg, BATCH, max_len, text_seq=PROMPT)
        jlogits, jcaches = jsetup.prefill_fn(jparams, jbatch)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, "cpu")
    if cfg.qk_norm:
        assert params.layers[0].attn.q_norm_scale.shape == (cfg.hd,)
    setup = make_serve_setup(cfg, ShapeSpec("t", max_len, BATCH, "decode"),
                             device="cpu")
    tokens = torch.from_numpy(np.asarray(jbatch["inputs"]).astype(np.int64))
    logits, caches = setup.prefill_fn(params, {"inputs": tokens})
    _close(logits, jlogits)
    tok_j = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)
    tok_t = torch.argmax(logits[:, -1], -1)
    with mesh:
        for step in range(STEPS):
            np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
            jlogits, jcaches = jsetup.decode_fn(
                jparams, jcaches, tok_j, jnp.asarray(PROMPT + step,
                                                     jnp.int32))
            logits, caches = setup.decode_fn(params, caches, tok_t,
                                             PROMPT + step)
            _close(logits, jlogits)
            tok_j = jnp.argmax(jlogits, -1).astype(jnp.int32)
            tok_t = torch.argmax(logits, -1)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["core", "kernel"])
def test_qwen3_trains_like_the_reference(use_kernel):
    """One AdamW step of qwen3-14b SMOKE with ``lln_diag`` from the
    reference's converted train state: the gradient of every leaf (the
    qk-norm scales included) within 1e-4 of its largest entry against
    ``jax.grad`` of the reference's loss, and the step's loss and grad norm
    (the global norm before clipping) within 1e-4 relative."""
    over = dict(attn_impl="lln_diag", compute_dtype="float32",
                use_kernel=use_kernel)
    jcfg = j_get_config("qwen3-14b", smoke=True, **over)
    cfg = get_config("qwen3-14b", smoke=True, **over)
    batch = next(lm_batches(jcfg.vocab, BATCH, 32, seed=0))
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    state0 = jax.tree_util.tree_map(
        np.asarray, {"params": jparams, "opt": j_adamw_init(jparams)})
    jloss, grads0 = jax.value_and_grad(jmodel.loss)(jparams, batch)
    grads0 = jax.tree_util.tree_map(np.asarray, grads0)
    jm = {"loss": float(jloss), "grad_norm": float(np.sqrt(sum(
        np.sum(np.square(g, dtype=np.float64))
        for g in jax.tree_util.tree_leaves(grads0))))}
    state = train_state_from_numpy(state0, cfg, "cpu")
    setup = make_train_setup(cfg, ShapeSpec("t", 32, BATCH, "train"),
                             device="cpu", peak_lr=1e-3, total_steps=3)
    tbatch = torch_placer("cpu")(batch)
    params = dict(state["params"].named_parameters())
    assert "layers.0.attn.q_norm_scale" in params
    loss = setup.model.loss(state["params"], tbatch)
    grads = torch.autograd.grad(loss, list(params.values()))
    want = leaves_from_numpy(grads0, cfg)
    assert set(want) == set(params)
    for name, g in zip(params, grads):
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=REL * max(float(np.abs(w).max()),
                                                  1e-30), err_msg=name)
    _, m = setup.step_fn(state, tbatch)
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= \
            REL * abs(float(jm[key])), key


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--smoke", "--attn-impl", "lln_diag",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "20", "--gen", "4"])
    assert toks.shape == (2, 4)
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
    assert "sample tokens:" in capsys.readouterr().out
