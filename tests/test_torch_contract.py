"""The decode contract (``row_mask``, ``commit_len``), the drift renorm and
per-row calibration, held against the JAX reference.

The rules, as the reference states them (``core/lln.py:decode_chunk``):
masked rows and ``commit_len = 0`` rows keep every state leaf bitwise;
``commit_len = T`` is a plain decode; a renorm that fires leaves the
outputs and the continuation where the renorm-off run puts them (2e-5, as
``tests/test_longctx.py``'s ``TestRenormSemantics``); every backend kind
(``plain``: the kernel's plain version, ``ref``: the core reference) gives
the reference's result.  Then the same arguments through the engine,
``lm_decode`` (yi-9b SMOKE), ``hybrid_decode`` (zamba2-7b SMOKE,
``lln_diag``) and the per-row calibration.  Inputs are numpy-made from a
seed and fed to both sides.  Tolerances: fp32 outputs and states 2e-4 of
the largest entry (sums in another order), logits 2e-4 as
``tests/test_torch_serve.py``.  The ``plain`` kind carries one reference
constant per kv group where the reference's CPU path keeps one per query
head, so its states are compared at the reference's constants, or through
the constant-free log key mass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.configs import get_config as j_get_config
from repro.core import attention as jattn
from repro.core import lln as jlln
from repro.core.engine import AttentionEngine as JEngine
from repro.kernels import ops as jops
from repro.kernels.registry import AttnSpec as JSpec
from repro.models import build_model as j_build_model
from repro.models import synthetic_batch as j_synthetic_batch
from repro_torch.configs import get_config
from repro_torch.convert import (hybrid_cache_from_numpy, params_from_numpy,
                                 state_from_numpy)
from repro_torch.core import attention as tattn
from repro_torch.core import lln as tlln
from repro_torch.core.engine import AttentionEngine
from repro_torch.core.metrics import streaming_concentration
from repro_torch.kernels import ops as tops
from repro_torch.kernels.registry import AttnSpec
from repro_torch.models import build_model

B, H, D, DV, T = 2, 4, 8, 8, 12
TOL = 2e-4
KINDS = ("plain", "ref")


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _qkv(rng, t=T, g=H, b=B):
    return (rng.normal(size=(b, t, H, D)).astype(np.float32),
            rng.normal(size=(b, t, g, D)).astype(np.float32),
            rng.normal(size=(b, t, g, DV)).astype(np.float32))


def _rep(x):
    return np.repeat(x, H // x.shape[2], axis=2)


def _warm(seed, b=B, steps=3):
    """A reference core state that has folded a few chunks (c_k bound, z
    populated), as numpy arrays, and its two copies."""
    rng = np.random.default_rng(seed)
    st = jlln.LLNState.init(b, H, D, DV)
    for _ in range(steps):
        q, k, v = _qkv(rng, b=b)
        _, st = jlln.decode_chunk(st, *_j(q, k, v), 0.6, 0.6)
    arrays = [np.asarray(getattr(st, n)) for n in ("s", "z", "c_k",
                                                   "log_scale")]
    return arrays, jlln.LLNState(*_j(*arrays)), tlln.LLNState(*_t(*arrays))


def _state_close(got, want, gauge=False):
    """(s, z, log_scale) of a port state against the reference's; with
    ``gauge`` at the reference's constants (s and z times exp(c_port -
    c_ref)), since a group-level constant is another gauge."""
    c_ref = torch.from_numpy(np.array(want.c_k))
    shift = torch.exp(got.c_k - c_ref)[:, 0, :, 0] if gauge else None
    _close(got.s * (shift[..., None, None] if gauge else 1.0), want.s)
    _close(got.z * (shift[..., None] if gauge else 1.0), want.z)
    if not gauge:
        _close(got.c_k, want.c_k)
        _close(got.log_scale, want.log_scale)


def _layer_close(st, jl, kind, fields=("s", "z", "tail_k", "tail_v")):
    """One layer's decode state against the reference's: the plain kind's
    (s, z) at the reference's constants, the ref kind's also c_k and
    log_scale; the diag tails and pos exactly as the reference's."""
    shift = torch.exp(st.c_k - torch.from_numpy(np.asarray(
        jl["c_k"], np.float32)))[:, 0, :, 0]
    for name in fields:
        a = getattr(st, name).float()
        if kind == "plain" and name == "s":
            a = a * shift[..., None, None]
        if kind == "plain" and name == "z":
            a = a * shift[..., None]
        _close(a, np.asarray(jl[name], np.float32))
    if kind == "ref":
        _close(st.c_k, jl["c_k"])
        _close(st.log_scale, jl["log_scale"])
    assert st.pos.tolist() == np.asarray(jl["pos"]).tolist()


def _mass(st):
    """The constant-free log key mass of a port or a reference state."""
    c, z = (x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
            for x in (st.c_k, st.z))
    return streaming_concentration(z, c=c[:, 0, :, 0])["log_mass"]


class TestRenormSemantics:
    def test_outputs_invariant_and_continuation_matches(self):
        """A threshold at half the largest z fires: the outputs match the
        renorm-off run and the reference's renorm-on run, z ends under the
        threshold, log_scale grows, and the continuation from the
        renormalized state matches the one from the raw state."""
        _, jst, st = _warm(0)
        thresh = 0.5 * float(st.z.max())
        rng = np.random.default_rng(100)
        q, k, v = _qkv(rng)
        out_off, st_off = tlln.decode_chunk(st, *_t(q, k, v), 0.6, 0.6)
        out_on, st_on = tlln.decode_chunk(st, *_t(q, k, v), 0.6, 0.6,
                                          renorm=thresh)
        want, jst_on = jlln.decode_chunk(jst, *_j(q, k, v), 0.6, 0.6,
                                         renorm=thresh)
        np.testing.assert_allclose(out_on.numpy(), out_off.numpy(),
                                   rtol=2e-5, atol=2e-5)
        _close(out_on, want)
        _state_close(st_on, jst_on)
        assert float(st_on.z.max()) <= thresh * (1 + 1e-5)
        assert float(st_on.log_scale.max()) > 0.0
        q2, k2, v2 = _qkv(rng)
        cont_off, _ = tlln.decode_chunk(st_off, *_t(q2, k2, v2), 0.6, 0.6)
        cont_on, _ = tlln.decode_chunk(st_on, *_t(q2, k2, v2), 0.6, 0.6)
        np.testing.assert_allclose(cont_on.numpy(), cont_off.numpy(),
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("r", [1, 2, 4])
    @pytest.mark.parametrize("kind", KINDS)
    def test_backend_uniform(self, kind, r):
        """``ops.lln_decode_chunk`` with the renorm on every kind and GQA
        ratio against the reference's (its CPU path, the core on repeated
        KV): outputs at the suite's tolerance, z under the threshold, and
        the constant-free log key mass equal."""
        g = H // r
        _, jst, st = _warm(1)
        thresh = 0.5 * float(st.z.max())
        q, k, v = _qkv(np.random.default_rng(200), g=g)
        want, jst2 = jops.lln_decode_chunk(jst, *_j(q, k, v), 0.6, 0.6,
                                           renorm=thresh)
        got, st2 = tops.lln_decode_chunk(st, *_t(q, k, v), 0.6, 0.6,
                                         backend=kind, renorm=thresh)
        _close(got, want)
        assert float(st2.z.max()) <= thresh * (1 + 1e-4)
        _close(_mass(st2), _mass(jst2))
        if kind == "ref":
            _state_close(st2, jst2)

    @pytest.mark.parametrize("kind", KINDS)
    def test_bitwise_inert_for_masked_and_uncommitted_rows(self, kind):
        """The renorm never touches a row that folds nothing: row_mask
        False and commit_len 0 rows keep every leaf bitwise (the state
        comes from a prefill, so its constants are the kernel path's group
        ones), while the folding row renormalizes and matches the
        reference."""
        rng = np.random.default_rng(2)
        q, k, v = _qkv(rng, t=24, g=2)
        beta = np.full(2, 0.6, np.float32)
        _, s, z, c_k = tops.lln_prefill(*_t(q, k, v), 0.6,
                                        torch.from_numpy(beta), chunk=8,
                                        backend="plain")
        st = tlln.LLNState(s=s, z=z, c_k=c_k, log_scale=torch.zeros(B, H))
        jst = jlln.LLNState(*_j(s.numpy(), z.numpy(), c_k.numpy(),
                                np.zeros((B, H), np.float32)))
        thresh = 0.5 * float(z.max())
        q, k, v = _qkv(rng, g=2)
        for kw in ({"row_mask": np.array([True, False])},
                   {"commit_len": np.array([T, 0], np.int32)}):
            want, jst2 = jops.lln_decode_chunk(
                jst, *_j(q, k, v), 0.6, beta, renorm=thresh,
                **{n: jnp.asarray(a) for n, a in kw.items()})
            got, st2 = tops.lln_decode_chunk(
                st, *_t(q, k, v), 0.6, torch.from_numpy(beta), backend=kind,
                renorm=thresh, **{n: torch.from_numpy(a)
                                  for n, a in kw.items()})
            for name in ("s", "z", "c_k", "log_scale"):
                assert torch.equal(getattr(st2, name)[1],
                                   getattr(st, name)[1]), (name, kw)
            assert float(st2.z[0].max()) <= thresh * (1 + 1e-5)
            _close(got[0], np.asarray(want)[0])
            _close(_mass(st2), _mass(jst2))


@pytest.mark.parametrize("kind", KINDS)
def test_lln_decode_chunk_partial_commit(kind):
    """``commit_len`` = (0, 5, 16, 11) over a chunk of 16 from a prefill
    state: every position scored as the reference scores it, the state
    folding the accepted prefix, with the row that commits 0 bitwise
    unchanged; a second call with ``commit_len`` = T equals a plain
    decode."""
    rng = np.random.default_rng(3)
    b, t, g = 4, 16, 2
    q, k, v = _qkv(rng, t=24, g=g, b=b)
    beta = np.full(g, 0.7, np.float32)
    _, s, z, c_k = tops.lln_prefill(*_t(q, k, v), 0.6,
                                    torch.from_numpy(beta), chunk=8,
                                    backend="plain")
    st = tlln.LLNState(s=s, z=z, c_k=c_k, log_scale=torch.zeros(b, H))
    jst = jlln.LLNState(*_j(s.numpy(), z.numpy(), c_k.numpy(),
                            np.zeros((b, H), np.float32)))
    q, k, v = _qkv(rng, t=t, g=g, b=b)
    cl = np.array([0, 5, 16, 11], np.int32)
    want, jst2 = jops.lln_decode_chunk(jst, *_j(q, k, v), 0.6, beta,
                                       commit_len=jnp.asarray(cl))
    got, st2 = tops.lln_decode_chunk(st, *_t(q, k, v), 0.6,
                                     torch.from_numpy(beta), backend=kind,
                                     commit_len=torch.from_numpy(cl))
    _close(got, want)
    _state_close(st2, jst2, gauge=kind == "plain")
    for name in ("s", "z", "c_k", "log_scale"):
        assert torch.equal(getattr(st2, name)[0], getattr(st, name)[0])
    full, st_full = tops.lln_decode_chunk(
        st, *_t(q, k, v), 0.6, torch.from_numpy(beta), backend=kind,
        commit_len=torch.full((b,), t, dtype=torch.int32))
    plain_out, st_plain = tops.lln_decode_chunk(
        st, *_t(q, k, v), 0.6, torch.from_numpy(beta), backend=kind)
    assert torch.equal(full, plain_out)
    for name in ("s", "z", "c_k"):
        _close(getattr(st_full, name), getattr(st_plain, name).numpy(),
               1e-5)


def _engines(impl, kind, **spec):
    kw = dict(impl=impl, r=2, lln_chunk=8, diag_block=8, **spec)
    heads = dict(heads=H, kv_heads=2, head_dim=D, v_dim=DV)
    return (JEngine(spec=JSpec(backend="auto", **kw), **heads),
            AttentionEngine(spec=AttnSpec(backend=kind, **kw), **heads))


ENGINE_CELLS = [("lln", "plain"), ("lln_diag", "plain"), ("lln_diag", "ref"),
                ("log_linear", "plain"), ("log_linear", "ref"),
                ("softmax", "auto")]


@pytest.mark.parametrize("impl,kind", ENGINE_CELLS)
def test_engine_decode_takes_the_contract(impl, kind):
    """``AttentionEngine.decode`` with ``row_mask`` (True, False, True) and
    then ``commit_len`` (3, 0, 1) on rows prefilled with 21 tokens (a
    ragged block: the diag tail and the log_linear open granule are part
    full), against the reference engine: outputs, every state leaf (the
    group-level constants of the ``plain`` kind at the reference's), and
    the masked / uncommitted row bitwise unchanged."""
    rng = np.random.default_rng(4)
    b = 3
    jeng, teng = _engines(impl, kind)
    q, k, v = _qkv(rng, t=21, g=2, b=b)
    _, jst = jeng.prefill(*_j(q, k, v), max_len=40)
    st = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    for kw in ({"row_mask": np.array([True, False, True])},
               {"commit_len": np.array([3, 0, 1], np.int32)}):
        q, k, v = _qkv(rng, t=3, g=2, b=b)
        want, jst2 = jeng.decode(jst, *_j(q, k, v),
                                 **{n: jnp.asarray(a) for n, a in kw.items()})
        got, st2 = teng.decode(st, *_t(q, k, v),
                               **{n: torch.from_numpy(a)
                                  for n, a in kw.items()})
        _close(got, want)
        for name in ("len", "pos"):
            if getattr(st2, name) is not None:
                assert getattr(st2, name).tolist() == \
                    np.asarray(jst2[name]).tolist()
        for f in ("k", "v", "tail_k", "tail_v", "s", "z", "sl", "zl"):
            a = getattr(st2, f)
            if a is None:
                continue
            if kind == "plain" and f in ("s", "z"):
                shift = torch.exp(st2.c_k - torch.from_numpy(
                    np.array(jst2["c_k"])))[:, 0, :, 0]
                a = a * (shift[..., None, None] if f == "s"
                         else shift[..., None])
            if kind == "plain" and f in ("sl", "zl"):
                shift = torch.exp(st2.cl - torch.from_numpy(
                    np.array(jst2["cl"])))
                a = a * (shift[..., None, None] if f == "sl"
                         else shift[..., None])
            _close(a, jst2[f])
            assert torch.equal(getattr(st2, f)[1], getattr(st, f)[1]), f
        st, jst = st2, jst2


@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_per_row_calibration_matches_reference(impl):
    """``lln_per_row_calib``: the spec's ``per_row`` calibration measures
    each row alone, so the engine's prefill stores (B, H) alpha and beta
    and decodes with them: prefill outputs, the calibration and two decode
    steps against the reference's, and row 0 equal to its prefill alone."""
    rng = np.random.default_rng(5)
    jcfg = j_get_config("yi-9b", smoke=True, attn_impl=impl,
                        lln_per_row_calib=True)
    cfg = get_config("yi-9b", smoke=True, attn_impl=impl,
                     lln_per_row_calib=True)
    assert AttnSpec.from_cfg(cfg).calibration == "per_row" == \
        JSpec.from_cfg(jcfg).calibration
    jeng, teng = _engines(impl, "plain", calibration="per_row")
    q, k, v = _qkv(rng, t=20, g=2)
    q[1] *= 3.0                        # rows with different statistics
    want, jst = jeng.prefill(*_j(q, k, v), max_len=30)
    got, st = teng.prefill(*_t(q, k, v))
    _close(got, want)
    assert st.alpha.shape == (B, H) and st.beta.shape == (B, H)
    _close(st.alpha, jst["alpha"], 1e-5)
    _close(st.beta, jst["beta"], 1e-5)
    alone, _ = teng.prefill(*_t(q[:1], k[:1], v[:1]))
    _close(got[:1], alone.numpy(), 1e-5)
    for _ in range(2):
        q, k, v = _qkv(rng, t=1, g=2)
        want, jst = jeng.decode(jst, *_j(q, k, v))
        got, st = teng.decode(st, *_t(q, k, v))
        _close(got, want)
    a_j, b_j = jattn.batch_alpha_beta(*_j(q, k), jeng.spec, per_row=True)
    a_t, b_t = tattn.batch_alpha_beta(*_t(q, k), teng.spec, per_row=True)
    _close(a_t, a_j, 1e-5)
    _close(b_t, b_j, 1e-5)


def test_spec_maps_the_renorm_and_calibration_switches():
    """``AttnSpec.from_cfg`` takes ``lln_renorm`` and ``lln_per_row_calib``
    as the reference's does, instead of raising."""
    jcfg = j_get_config("yi-9b", attn_impl="lln", lln_renorm=4.0,
                        lln_per_row_calib=True)
    cfg = get_config("yi-9b", attn_impl="lln", lln_renorm=4.0,
                     lln_per_row_calib=True)
    js, ts = JSpec.from_cfg(jcfg), AttnSpec.from_cfg(cfg)
    assert (ts.renorm, ts.calibration) == (js.renorm, js.calibration) == \
        (4.0, "per_row")
    with pytest.raises(ValueError, match="calibration"):
        AttnSpec(calibration="per_token")
    with pytest.raises(ValueError, match="renorm"):
        AttnSpec(renorm=-1.0)


def _served(arch, impl, prompt, **over):
    """Both packages' SMOKE model (fp32) from the reference's weights, and
    the reference's prefill caches with their port conversion."""
    over = dict(attn_impl=impl, compute_dtype="float32", **over)
    cfg = get_config(arch, smoke=True, **over)
    if over.get("attn_backend") == "plain":     # the reference's CPU path
        over["attn_backend"] = "auto"
    jcfg = j_get_config(arch, smoke=True, **over)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, "cpu")
    batch = j_synthetic_batch(jcfg, 3, prompt + 8, text_seq=prompt)
    _, jcaches = jmodel.prefill(jparams, batch, prompt + 8)
    return jmodel, jparams, jcaches, build_model(cfg, "cpu"), params


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_lm_decode_takes_the_contract(impl, kind):
    """yi-9b SMOKE with the renorm on: ``lm_decode`` of a chunk of 3 with
    ``row_mask`` (True, False, True), then with ``commit_len`` (3, 0, 2),
    from the reference's prefill caches: the logits and every layer's
    state against the reference's, the masked and uncommitted rows'
    states bitwise unchanged, and the renorm fired."""
    prompt = 21
    jmodel, jparams, jcaches, model, params = _served(
        "yi-9b", impl, prompt, lln_renorm=1.0, attn_backend=kind)
    caches = {"layers": [state_from_numpy(jax.tree_util.tree_map(
        lambda a, i=i: np.asarray(a)[i], jcaches["layers"]), "cpu")
        for i in range(2)]}
    rng = np.random.default_rng(6)
    for kw in ({"row_mask": np.array([True, False, True])},
               {"commit_len": np.array([3, 0, 2], np.int32)}):
        toks = rng.integers(0, 512, (3, 3)).astype(np.int32)
        want, jcaches = jmodel.decode(jparams, jcaches, jnp.asarray(toks),
                                      jnp.asarray(prompt, jnp.int32),
                                      **{n: jnp.asarray(a)
                                         for n, a in kw.items()})
        got, new = model.decode(params, caches, torch.from_numpy(
            toks.astype(np.int64)), prompt, **{n: torch.from_numpy(a)
                                               for n, a in kw.items()})
        _close(got, want)
        for i, (old, st) in enumerate(zip(caches["layers"], new["layers"])):
            _layer_close(st, jax.tree_util.tree_map(
                lambda a, i=i: np.asarray(a)[i], jcaches["layers"]), kind)
            for name in ("s", "z", "c_k", "tail_k", "log_scale"):
                assert torch.equal(getattr(st, name)[1],
                                   getattr(old, name)[1])
        caches = new
    assert float(caches["layers"][0].log_scale.max()) > 0.0


def test_hybrid_decode_takes_the_contract():
    """zamba2-7b SMOKE with ``lln_diag``: ``hybrid_decode`` of a chunk of 3
    with ``row_mask`` and then ``commit_len`` from the reference's prefill
    caches, against the reference: logits, the Mamba2 layers' states and
    conv windows and the shared block's states; the masked and the
    uncommitted row's caches bitwise unchanged."""
    prompt = 20
    jmodel, jparams, jcaches, model, params = _served(
        "zamba2-7b", "lln_diag", prompt)
    caches = hybrid_cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcaches), "cpu")
    rng = np.random.default_rng(7)
    for kw in ({"row_mask": np.array([True, False, True])},
               {"commit_len": np.array([3, 0, 1], np.int32)}):
        toks = rng.integers(0, 512, (3, 3)).astype(np.int32)
        want, jcaches = jmodel.decode(jparams, jcaches, jnp.asarray(toks),
                                      jnp.asarray(prompt, jnp.int32),
                                      **{n: jnp.asarray(a)
                                         for n, a in kw.items()})
        got, new = model.decode(params, caches, torch.from_numpy(
            toks.astype(np.int64)), prompt, **{n: torch.from_numpy(a)
                                               for n, a in kw.items()})
        _close(got, want)
        ref = jax.tree_util.tree_map(np.asarray, jcaches)
        for i, (old, g) in enumerate(zip(caches["layers"], new["layers"])):
            for name in ("state", "conv"):
                _close(g[name], ref["layers"][name][i])
                assert torch.equal(g[name][1], old[name][1])
        for i, (old, g) in enumerate(zip(caches["shared"], new["shared"])):
            _layer_close(g, jax.tree_util.tree_map(
                lambda a, i=i: a[i], ref["shared"]), "plain")
            for name in ("s", "z", "c_k", "tail_k", "tail_v"):
                assert torch.equal(getattr(g, name)[1],
                                   getattr(old, name)[1])
        caches = new
