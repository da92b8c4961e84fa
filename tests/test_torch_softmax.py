"""The port's softmax impl against the JAX reference.

The same numpy inputs, made from a seed, go through
``repro.core.attention`` and ``repro_torch.core.attention`` in fp32 on the
CPU: ``flash_softmax`` (causal and not, GQA r in {1, 4}, a ragged N against
``chunk``, a key ``mask``, ``prefix_len``, ``q_start`` as a scalar and per
row), ``naive_softmax``, ``decode_softmax`` at T in {1, 4} (scalar and
per-row length, ``row_mask``, ``commit_len``), ``commit_softmax`` and the
engine's softmax prefill and decode; then yi-9b SMOKE served with
``softmax`` from converted weights, and one softmax train step of yi-9b,
roberta-lln (the paper's SA row) and zamba2-7b (its default impl) SMOKE.

Tolerances: outputs and logits 2e-4 of the largest reference entry (the
serve tests' ``ATOL``: fp32 sums taken in another order); KV caches and
lengths exactly (they are copies of the inputs); the train step's loss and
every gradient 1e-5 of the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.core import attention as ja
from repro.core.engine import AttentionEngine as JEngine
from repro.kernels.registry import AttnSpec as JSpec
from repro.launch.mesh import compat_mesh
from repro.launch.steps import make_serve_setup as j_make_serve_setup
from repro.models import build_model as j_build_model
from repro.models import synthetic_batch as j_synthetic_batch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import (leaves_from_numpy, params_from_numpy,
                                 state_from_numpy)
from repro_torch.core import attention as ta
from repro_torch.core.engine import AttentionEngine
from repro_torch.data import torch_placer
from repro_torch.data.synthetic import lm_batches, mlm_batches
from repro_torch.kernels.registry import AttnSpec
from repro_torch.launch.steps import make_serve_setup
from repro_torch.models import build_model

ATOL = 2e-4
TRAIN = 1e-5


def _close(got, want, rel=ATOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _equal(got, want):
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _qkv(seed, b, nq, nk, h, g, d=8, dv=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, nq, h, d)).astype(np.float32),
            rng.normal(size=(b, nk, g, d)).astype(np.float32),
            rng.normal(size=(b, nk, g, dv)).astype(np.float32))


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.asarray(a)) for a in arrays])


# (causal, r, nq, nk, chunk, mask, prefix_len, q_start): whole and ragged N
# against the chunk, both GQA ratios, then each optional argument.
FLASH_CASES = [
    pytest.param(True, 1, 40, 40, 16, False, 0, None, id="causal-r1-ragged"),
    pytest.param(True, 4, 32, 32, 16, False, 0, None, id="causal-r4-whole"),
    pytest.param(False, 4, 40, 40, 16, False, 0, None,
                 id="bidir-r4-ragged"),
    pytest.param(False, 1, 24, 24, 32, False, 0, None, id="bidir-r1-one"),
    pytest.param(True, 4, 40, 40, 16, True, 0, None, id="causal-mask"),
    pytest.param(False, 1, 40, 40, 16, True, 0, None, id="bidir-mask"),
    pytest.param(True, 1, 40, 40, 16, False, 12, None, id="prefix-len"),
    pytest.param(True, 4, 3, 37, 16, True, 0, 20, id="q-start-scalar"),
    pytest.param(True, 4, 3, 37, 16, True, 0, "rows", id="q-start-rows"),
]


@pytest.mark.parametrize("causal,r,nq,nk,chunk,use_mask,prefix,q_start",
                         FLASH_CASES)
def test_flash_softmax_matches_the_reference(causal, r, nq, nk, chunk,
                                             use_mask, prefix, q_start):
    b, g = 2, 2
    q, k, v = _qkv(nq + nk + r, b, nq, nk, g * r, g)
    rng = np.random.default_rng(5)
    mask = rng.uniform(size=(b, nk)) > 0.25 if use_mask else None
    if mask is not None:
        mask[:, 0] = True
    qs = {None: None, 20: np.int32(20),
          "rows": np.array([20, 33], np.int32)}[q_start]
    kw = dict(causal=causal, chunk=chunk, prefix_len=prefix)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    extra = [a for a in (mask, qs) if a is not None]
    jx, tx = _both(*extra) if extra else ([], [])
    jm = jx.pop(0) if mask is not None else None
    tm = tx.pop(0) if mask is not None else None
    jqs = jx.pop(0) if qs is not None else None
    tqs = tx.pop(0) if qs is not None else None
    want = ja.flash_softmax(jq, jk, jv, mask=jm, q_start=jqs, **kw)
    got = ta.flash_softmax(tq, tk, tv, mask=tm, q_start=tqs, **kw)
    _close(got, want)
    if q_start is None:
        del kw["chunk"]
        _close(ta.naive_softmax(tq, tk, tv, mask=tm, **kw),
               ja.naive_softmax(jq, jk, jv, mask=jm, **kw))


def test_flash_softmax_keeps_bf16_inputs_and_matches_naive():
    """bf16 q/k/v: the output is bf16 and within one bf16 step of the
    port's naive fp32 softmax on the same inputs.  The online softmax
    scales q in bf16 before its product and rounds p to bf16 before p v,
    as the reference does, so the naive one gets that scaled q."""
    q, k, v = _qkv(3, 2, 40, 40, 8, 2)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = ta.flash_softmax(tq, tk, tv, chunk=16)
    qs = tq * torch.tensor(8 ** -0.5, dtype=torch.bfloat16)
    want = ta.naive_softmax(qs, tk, tv, scale=1.0)
    assert got.dtype == torch.bfloat16
    _close(got, want.float().numpy(), 2.0 ** -7)


def _cache(seed, b, s, g, d, dv, length):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(b, s, g, d)).astype(np.float32)
    v = rng.normal(size=(b, s, g, dv)).astype(np.float32)
    return k, v, np.asarray(length, np.int32)


# (t, per-row length, row_mask, commit_len).
DECODE_CASES = [
    pytest.param(1, False, None, None, id="t1-scalar"),
    pytest.param(4, False, None, None, id="t4-scalar"),
    pytest.param(1, True, None, None, id="t1-rows"),
    pytest.param(4, True, None, None, id="t4-rows"),
    pytest.param(4, True, [True, False, True], None, id="t4-row-mask"),
    pytest.param(4, True, None, [0, 2, 4], id="t4-commit"),
    pytest.param(4, True, [True, True, False], [1, 5, 3],
                 id="t4-commit-masked"),
]


@pytest.mark.parametrize("t,rows,row_mask,commit_len", DECODE_CASES)
def test_decode_softmax_matches_the_reference(t, rows, row_mask, commit_len):
    b, s, g, r = 3, 24, 2, 4
    length = [5, 11, 17] if rows else 9
    kc, vc, ln = _cache(t, b, s, g, 8, 6, length)
    q, k, v = _qkv(t + 7, b, t, t, g * r, g)
    extra = {}
    if row_mask is not None:
        extra["row_mask"] = np.array(row_mask)
    if commit_len is not None:
        extra["commit_len"] = np.array(commit_len, np.int32)
    jargs, targs = _both(kc, vc, ln, q, k, v)
    jx = {n: jnp.asarray(a) for n, a in extra.items()}
    tx = {n: torch.from_numpy(a) for n, a in extra.items()}
    jout, jc = ja.decode_softmax(ja.KVCache(*jargs[:3]), *jargs[3:],
                                 chunk=16, **jx)
    tout, tc = ta.decode_softmax(ta.KVCache(*targs[:3]), *targs[3:],
                                 chunk=16, **tx)
    _close(tout, jout)
    _equal(tc.k, jc.k)
    _equal(tc.v, jc.v)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    _equal(targs[0], kc)                 # the cache passed in is unchanged


@pytest.mark.parametrize("commit_len,row_mask", [
    ([0, 2, 4], None), ([3, 3, 1], [True, False, True])],
    ids=["commit", "commit-masked"])
def test_commit_softmax_matches_the_reference(commit_len, row_mask):
    b, s, g, t = 3, 24, 2, 4
    kc, vc, ln = _cache(11, b, s, g, 8, 6, [2, 9, 20])
    _, k, v = _qkv(12, b, t, t, g, g)
    extra = {"commit_len": np.array(commit_len, np.int32)}
    if row_mask is not None:
        extra["row_mask"] = np.array(row_mask)
    jargs, targs = _both(kc, vc, ln, k, v)
    jc = ja.commit_softmax(ja.KVCache(*jargs[:3]), *jargs[3:],
                           **{n: jnp.asarray(a) for n, a in extra.items()})
    tc = ta.commit_softmax(ta.KVCache(*targs[:3]), *targs[3:],
                           **{n: torch.from_numpy(a)
                              for n, a in extra.items()})
    _equal(tc.k, jc.k)
    _equal(tc.v, jc.v)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


@pytest.mark.parametrize("backend", ["auto", "ref"])
@pytest.mark.parametrize("r", [1, 4])
def test_engine_softmax_prefill_and_decode_match_the_reference(backend, r):
    """Prefill pads the KV cache to max_len (``ref``: the naive softmax,
    any other backend the online one), then decode steps of T = 1 and 3."""
    b, n, g, d, max_len = 2, 21, 2, 8, 32
    h = g * r
    kw = dict(impl="softmax", r=r, softmax_chunk=8, backend=backend)
    jeng = JEngine(spec=JSpec(**kw), heads=h, kv_heads=g, head_dim=d,
                   v_dim=d)
    teng = AttentionEngine(spec=AttnSpec(**kw), heads=h, kv_heads=g,
                           head_dim=d, v_dim=d)
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(r, b, n, n, h, g, d, d))
    jout, jst = jeng.prefill(jq, jk, jv, max_len=max_len)
    tout, tst = teng.prefill(tq, tk, tv, max_len=max_len)
    _close(tout, jout)
    for t in (1, 3):
        (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(r + t, b, t, t, h, g, d, d))
        jout, jst = jeng.decode(jst, jq, jk, jv)
        tout, tst = teng.decode(tst, tq, tk, tv)
        _close(tout, jout)
    for name in ("k", "v", "len"):
        _equal(getattr(tst, name), jst[name])
    assert tst.s is None and tst.tail_k is None
    conv = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    assert conv.k.shape == (b, max_len, g, d) and conv.s is None
    _equal(conv.len, jst["len"])


def test_engine_softmax_state_layout_matches_the_reference():
    jeng = JEngine(spec=JSpec(impl="softmax", r=2), heads=4, kv_heads=2,
                   head_dim=8, v_dim=6)
    teng = AttentionEngine(spec=AttnSpec(impl="softmax", r=2), heads=4,
                           kv_heads=2, head_dim=8, v_dim=6)
    jst = jeng.init_state(3, 40)
    tst = teng.init_state(3, "cpu", 40)
    for name in ("k", "v", "len"):
        got, want = getattr(tst, name), np.asarray(jst[name])
        assert tuple(got.shape) == want.shape, name
        _equal(got, want)
    assert tst.k.dtype == torch.float32 and tst.len.dtype == torch.int32


@pytest.fixture(scope="module")
def yi_softmax_reference():
    """yi-9b SMOKE softmax served by the reference: params, prompt, prefill
    logits and caches, then 6 greedy steps' logits."""
    batch, prompt, steps = 2, 32, 6
    jcfg = j_get_config("yi-9b", smoke=True, attn_impl="softmax",
                        compute_dtype="float32")
    max_len = prompt + steps + 1
    mesh = compat_mesh((1, 1), ("data", "model"))
    with mesh:
        jsetup = j_make_serve_setup(jcfg, JShape("t", max_len, batch,
                                                 "decode"), mesh,
                                    multi_pod=False)
        jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
        jbatch = j_synthetic_batch(jcfg, batch, max_len, text_seq=prompt)
        logits, caches = jsetup.prefill_fn(jparams, jbatch)
        pre = (np.asarray(logits),
               jax.tree_util.tree_map(np.asarray, caches["layers"]))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        toks, step_logits = [np.asarray(tok)], []
        for i in range(steps):
            logits, caches = jsetup.decode_fn(jparams, caches, tok,
                                              jnp.asarray(prompt + i,
                                                          jnp.int32))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            step_logits.append(np.asarray(logits))
            toks.append(np.asarray(tok))
    return dict(params=jax.tree_util.tree_map(np.asarray, jparams),
                inputs=np.asarray(jbatch["inputs"]), pre=pre,
                steps=step_logits, toks=np.stack(toks, 1), prompt=prompt,
                max_len=max_len)


def test_port_serves_softmax_like_the_reference(yi_softmax_reference):
    ref = yi_softmax_reference
    cfg = get_config("yi-9b", smoke=True, attn_impl="softmax",
                     compute_dtype="float32")
    params = params_from_numpy(ref["params"], cfg, "cpu")
    setup = make_serve_setup(cfg, ShapeSpec("t", ref["max_len"], 2,
                                            "decode"), device="cpu")
    logits, caches = setup.prefill_fn(
        params, {"inputs": torch.from_numpy(ref["inputs"].astype(np.int64))})
    _close(logits, ref["pre"][0])
    for i, layer in enumerate(caches["layers"]):
        for name in ("k", "v", "len"):
            _close(getattr(layer, name), ref["pre"][1][name][i])
        assert layer.k.shape[1] == ref["max_len"]
    tok = torch.argmax(logits[:, -1], -1)
    toks = [tok]
    for i, want in enumerate(ref["steps"]):
        logits, caches = setup.decode_fn(params, caches, tok,
                                         ref["prompt"] + i)
        _close(logits, want)
        tok = torch.argmax(logits, -1)
        toks.append(tok)
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), ref["toks"])


def test_softmax_cache_init_matches_the_reference_layout():
    from repro.models.transformer import lm_cache_init as j_cache_init
    over = dict(attn_impl="softmax", compute_dtype="float32")
    jcaches = j_cache_init(None, j_get_config("yi-9b", smoke=True, **over),
                           3, 24)["layers"]
    cfg = get_config("yi-9b", smoke=True, **over)
    model = build_model(cfg, "cpu")
    caches = model.cache_init(model.init(0), 3, 24)["layers"]
    assert len(caches) == cfg.n_layers
    for name in ("k", "v", "len"):
        want = np.asarray(jcaches[name])[0]
        assert tuple(getattr(caches[0], name).shape) == want.shape
        _equal(getattr(caches[0], name), want)


def _batches(arch, vocab):
    """The batch both packages train on (the port's generators are
    bit-equal to the reference's)."""
    gen = mlm_batches if arch == "roberta-lln" else lm_batches
    return next(gen(vocab, 2, 32, seed=3))


@pytest.mark.parametrize("arch", ["yi-9b", "roberta-lln", "zamba2-7b"])
def test_softmax_train_step_matches_the_reference(arch):
    """The loss and every leaf's gradient of one softmax step (zamba2-7b's
    and the configs' default impl; roberta-lln's is the paper's SA row)
    against ``jax.grad`` of the reference, 1e-5 of the largest entry."""
    over = dict(attn_impl="softmax", compute_dtype="float32")
    jcfg = j_get_config(arch, smoke=True, **over)
    cfg = get_config(arch, smoke=True, **over)
    batch = _batches(arch, jcfg.vocab)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(4))
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, batch)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, "cpu")
    named = dict(params.named_parameters())
    loss = build_model(cfg, "cpu").loss(params, torch_placer("cpu")(batch))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    _close(loss, np.asarray(jloss), TRAIN)
    want = leaves_from_numpy(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(want) == set(grads)
    for name, g in grads.items():
        _close(g, want[name], TRAIN)
