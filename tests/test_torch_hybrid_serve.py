"""ssm / hybrid serving: mamba2-130m and zamba2-7b SMOKE served by the port
against the JAX reference.

The reference's params are converted through numpy; both packages run
their own ``make_serve_setup`` on the CPU in fp32 over the same prompt,
zamba2-7b with its default ``softmax`` shared block and with ``lln_diag``.
Held: the prefill logits; every cache, the reference's converted by
``convert.hybrid_cache_from_numpy`` (the Mamba2 layers' ``{"state",
"conv"}``, and the shared block's per-application states); decode logits
and equal greedy tokens over 4 steps; decode (one token and a chunk of 3)
started from the reference's converted caches; ``ssm_decode`` and
``ssm_decode_chunk`` (T in {1, 3}) of one Mamba2 block from the same
cache; the ``cache_init`` layout.
Tolerance: 2e-4 of the largest reference entry (the serve tests' ``ATOL``:
fp32 sums in another order through a few layers); positions and lengths
exactly.
"""
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
from repro.models import hybrid as j_hy
from repro.models import ssm as j_ssm
from repro.models import synthetic_batch as j_synthetic_batch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import hybrid_cache_from_numpy, params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.steps import make_serve_setup
from repro_torch.models import build_model
from repro_torch.models import ssm

ATOL = 2e-4
BATCH, PROMPT, STEPS = 2, 20, 4
CELLS = [pytest.param("mamba2-130m", None, id="mamba2-130m"),
         pytest.param("zamba2-7b", "softmax", id="zamba2-7b-softmax"),
         pytest.param("zamba2-7b", "lln_diag", id="zamba2-7b-lln_diag")]
# The shared block's state fields per impl; counters are held exactly.
SHARED_FIELDS = {"softmax": ("k", "v", "len"),
                 "lln_diag": ("s", "z", "c_k", "tail_k", "tail_v", "pos",
                              "alpha", "beta")}
EXACT = ("len", "pos")


def _close(got, want, rel=ATOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _cfgs(arch, impl):
    over = dict(compute_dtype="float32")
    if impl:
        over["attn_impl"] = impl
    return (j_get_config(arch, smoke=True, **over),
            get_config(arch, smoke=True, **over))


def _caches_close(got, want, impl):
    """Port caches against the reference's converted ones."""
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        _close(g["state"], w["state"].numpy())
        _close(g["conv"], w["conv"].numpy())
    assert ("shared" in got) == (impl is not None)
    for g, w in zip(got.get("shared", ()), want.get("shared", ())):
        for name in SHARED_FIELDS[impl]:
            a, b = getattr(g, name), getattr(w, name)
            if name in EXACT:
                assert torch.equal(a, b), name
            else:
                _close(a, b.numpy())


def _reference_run(arch, impl):
    jcfg, _ = _cfgs(arch, impl)
    max_len = PROMPT + STEPS + 1
    mesh = compat_mesh((1, 1), ("data", "model"))
    with mesh:
        jsetup = j_make_serve_setup(jcfg, JShape("t", max_len, BATCH,
                                                 "decode"), mesh,
                                    multi_pod=False)
        jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
        jbatch = j_synthetic_batch(jcfg, BATCH, max_len, text_seq=PROMPT)
        logits, caches = jsetup.prefill_fn(jparams, jbatch)
        pre = (np.asarray(logits),
               jax.tree_util.tree_map(np.asarray, caches))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        toks, steps, after = [np.asarray(tok)], [], None
        for i in range(STEPS):
            logits, caches = jsetup.decode_fn(
                jparams, caches, tok, jnp.asarray(PROMPT + i, jnp.int32))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            steps.append(np.asarray(logits))
            toks.append(np.asarray(tok))
            if i == 0:
                after = jax.tree_util.tree_map(np.asarray, caches)
        toks = np.stack(toks, 1)
        chunk, _ = j_hy.hybrid_decode(
            jparams, jax.tree_util.tree_map(jnp.asarray, pre[1]),
            jnp.asarray(toks[:, :3]), jcfg, jnp.asarray(PROMPT, jnp.int32))
    return dict(params=jax.tree_util.tree_map(np.asarray, jparams),
                inputs=np.asarray(jbatch["inputs"]), pre=pre, steps=steps,
                toks=toks, after_one=after, chunk=np.asarray(chunk),
                max_len=max_len)


@pytest.fixture(scope="module")
def reference():
    """The reference's serving runs, computed once per cell."""
    runs = {}

    def get(arch, impl):
        if (arch, impl) not in runs:
            runs[arch, impl] = _reference_run(arch, impl)
        return runs[arch, impl]
    return get


def _port(ref, arch, impl):
    _, cfg = _cfgs(arch, impl)
    params = params_from_numpy(ref["params"], cfg, "cpu")
    setup = make_serve_setup(cfg, ShapeSpec("t", ref["max_len"], BATCH,
                                            "decode"), device="cpu")
    return params, setup


@pytest.mark.parametrize("arch,impl", CELLS)
def test_port_serves_like_the_reference(reference, arch, impl):
    ref = reference(arch, impl)
    params, setup = _port(ref, arch, impl)
    tokens = torch.from_numpy(ref["inputs"].astype(np.int64))
    logits, caches = setup.prefill_fn(params, {"inputs": tokens})
    _close(logits, ref["pre"][0])
    _caches_close(caches, hybrid_cache_from_numpy(ref["pre"][1], "cpu"),
                  impl)
    tok = torch.argmax(logits[:, -1], -1)
    toks = [tok]
    for i, want in enumerate(ref["steps"]):
        logits, caches = setup.decode_fn(params, caches, tok, PROMPT + i)
        _close(logits, want)
        tok = torch.argmax(logits, -1)
        toks.append(tok)
        if i == 0:
            _caches_close(caches, hybrid_cache_from_numpy(
                ref["after_one"], "cpu"), impl)
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), ref["toks"])


@pytest.mark.parametrize("arch,impl", CELLS)
def test_port_decodes_from_the_reference_caches(reference, arch, impl):
    """Decode started from the reference's prefill caches, converted, gives
    the reference's first decode logits."""
    ref = reference(arch, impl)
    params, setup = _port(ref, arch, impl)
    caches = hybrid_cache_from_numpy(ref["pre"][1], "cpu")
    tok = torch.from_numpy(ref["toks"][:, 0].astype(np.int64))
    logits, _ = setup.decode_fn(params, caches, tok, PROMPT)
    _close(logits, ref["steps"][0])


@pytest.mark.parametrize("arch,impl", CELLS)
def test_port_decodes_a_chunk_like_the_reference(reference, arch, impl):
    """A (B, 3) token chunk from the prefill caches (``ssm_decode_chunk``
    in the Mamba2 layers, a T = 3 engine decode in the shared block): the
    reference's (B, 3, V) logits."""
    ref = reference(arch, impl)
    params, setup = _port(ref, arch, impl)
    caches = hybrid_cache_from_numpy(ref["pre"][1], "cpu")
    chunk = torch.from_numpy(ref["toks"][:, :3].astype(np.int64))
    logits, _ = setup.decode_fn(params, caches, chunk, PROMPT)
    _close(logits, ref["chunk"])


@pytest.mark.parametrize("t", [1, 3])
def test_ssm_decode_steps_match_the_reference(t):
    """One Mamba2 block of mamba2-130m SMOKE from a carried state and conv
    window: ``ssm_decode`` (T = 1) and ``ssm_decode_chunk`` (T = 1 and 3),
    the output and the new cache."""
    jcfg, cfg = _cfgs("mamba2-130m", None)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(5))
    block = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, "cpu").layers[0].ssm
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["ssm"])
    rng = np.random.default_rng(t)
    x = rng.normal(size=(BATCH, t, jcfg.d_model)).astype(np.float32)
    zero = j_ssm.ssm_cache_init(jcfg, BATCH)
    cache = {n: (rng.normal(size=a.shape) * 0.5).astype(np.float32)
             for n, a in zero.items()}
    jcache = {n: jnp.asarray(a) for n, a in cache.items()}
    tcache = {n: torch.from_numpy(a) for n, a in cache.items()}
    steps = [(j_ssm.ssm_decode_chunk, ssm.ssm_decode_chunk)]
    if t == 1:
        steps.append((j_ssm.ssm_decode, ssm.ssm_decode))
    for jfn, tfn in steps:
        want, wc = jfn(jp, jnp.asarray(x), jcache, jcfg)
        with torch.no_grad():
            got, gc = tfn(block, torch.from_numpy(x), tcache, cfg)
        _close(got, want)
        for name in ("state", "conv"):
            _close(gc[name], wc[name])
    np.testing.assert_array_equal(tcache["state"].numpy(), cache["state"])


def test_ssm_decode_chunk_takes_the_contract_arguments_only_as_none():
    """The contract arguments, which ``ssm_decode_chunk`` took only as None
    until the contract was ported, match the reference's: a chunk of 3
    from a carried state and conv window with ``row_mask`` (True, False)
    and with ``commit_len`` (2, 0); the masked and the uncommitted row keep
    their cache bitwise."""
    jcfg, cfg = _cfgs("mamba2-130m", None)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(6))
    block = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, "cpu").layers[0].ssm
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["ssm"])
    rng = np.random.default_rng(8)
    x = rng.normal(size=(BATCH, 3, jcfg.d_model)).astype(np.float32)
    cache = {n: (rng.normal(size=a.shape) * 0.5).astype(np.float32)
             for n, a in j_ssm.ssm_cache_init(jcfg, BATCH).items()}
    for kw in ({"row_mask": np.array([True, False])},
               {"commit_len": np.array([2, 0], np.int32)}):
        want, wc = j_ssm.ssm_decode_chunk(
            jp, jnp.asarray(x), {n: jnp.asarray(a) for n, a in cache.items()},
            jcfg, **{n: jnp.asarray(a) for n, a in kw.items()})
        with torch.no_grad():
            got, gc = ssm.ssm_decode_chunk(
                block, torch.from_numpy(x),
                {n: torch.from_numpy(a) for n, a in cache.items()}, cfg,
                **{n: torch.from_numpy(a) for n, a in kw.items()})
        _close(got, want)
        for name in ("state", "conv"):
            _close(gc[name], wc[name])
            np.testing.assert_array_equal(gc[name][1].numpy(),
                                          cache[name][1])


@pytest.mark.parametrize("arch,impl", CELLS)
def test_cache_init_matches_the_reference_layout(arch, impl):
    jcfg, cfg = _cfgs(arch, impl)
    jcaches = j_hy.hybrid_cache_init(None, jcfg, 3, 24)
    model = build_model(cfg, "cpu")
    caches = model.cache_init(model.init(0), 3, 24)
    want = hybrid_cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcaches), "cpu")
    assert len(caches["layers"]) == cfg.n_layers
    for g, w in zip(caches["layers"], want["layers"]):
        for name in ("state", "conv"):
            assert g[name].shape == w[name].shape and g[name].dtype == \
                w[name].dtype
            assert torch.equal(g[name], w[name])
    assert len(caches.get("shared", ())) == len(want.get("shared", ())) == \
        (cfg.n_layers // cfg.shared_attn_period if impl else 0)
    for g, w in zip(caches.get("shared", ()), want.get("shared", ())):
        for name in SHARED_FIELDS[impl] + (("log_scale",) if impl !=
                                           "softmax" else ()):
            a, b = getattr(g, name), getattr(w, name)
            assert a.shape == b.shape and torch.equal(a.float(), b.float())


@pytest.mark.parametrize("argv", [["--arch", "mamba2-130m"],
                                  ["--arch", "zamba2-7b"],
                                  ["--arch", "zamba2-7b", "--attn-impl",
                                   "lln_diag"]],
                         ids=["mamba2-130m", "zamba2-7b-default",
                              "zamba2-7b-lln_diag"])
def test_serve_cli_on_cpu(argv, capsys):
    toks = serve.main(argv + ["--smoke", "--device", "cpu", "--batch", "2",
                              "--prompt-len", "20", "--gen", "5"])
    assert toks.shape == (2, 5)
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
    assert "sample tokens:" in capsys.readouterr().out
