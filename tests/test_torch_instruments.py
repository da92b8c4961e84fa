"""The paper's instruments (``core/metrics.py`` and the analysis half of
``core/moment_matching.py``) held against the JAX reference.

Inputs are made with numpy from a seed at small N and fed to both sides.
Tolerances: fp32 results 1e-5 relative to the largest entry, float64
results (the eigen-based instruments, which work in float64 as the
reference's numpy does) 1e-9.  The (a, b) fit draws its samples from a
``torch.Generator`` (the reference from ``jax.random``), so the fit from
given samples (``_fit_from_samples``) is held against the reference's
formula on the same samples; a fresh fit is never held against the
shipped tables (that depends on the environment).  The streaming
instruments are held on the reference's serving caches converted to the
port's per-layer lists, with the drift renorm on and off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.configs import get_config as j_get_config
from repro.core import metrics as jmet
from repro.core import moment_matching as jmm
from repro.models import build_model as j_build_model
from repro.models import synthetic_batch as j_synthetic_batch
from repro_torch.convert import hybrid_cache_from_numpy, state_from_numpy
from repro_torch.core import metrics as tmet
from repro_torch.core import moment_matching as tmm

F32, F64 = 1e-5, 1e-9


def _close(got, want, rel=F32):
    want = np.asarray(want, np.float64)
    got = got.detach().double().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _gauss(seed, n=48, d=16, sigma=1.5):
    rng = np.random.default_rng(seed)
    return [(sigma * rng.standard_normal((n, d))).astype(np.float32)
            for _ in range(2)]


def _stochastic(seed, n=40, conc=2.0):
    rng = np.random.default_rng(seed)
    logits = conc * rng.standard_normal((n, n))
    p = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return p / p.sum(axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def matrices():
    """Softmax and moment-matched LLN attention matrices of the same
    Gaussian q, k, from both packages."""
    q, k = _gauss(0)
    alpha, beta = 2.1, 1.9
    return {
        "sm": (tmm.softmax_attn_matrix(*map(torch.from_numpy, (q, k))),
               jmm.softmax_attn_matrix(jnp.asarray(q), jnp.asarray(k))),
        "lln": (tmm.lln_attn_matrix(*map(torch.from_numpy, (q, k)), alpha,
                                    beta),
                jmm.lln_attn_matrix(jnp.asarray(q), jnp.asarray(k), alpha,
                                    beta))}


@pytest.mark.parametrize("which", ["sm", "lln"])
def test_attention_matrices_and_their_moments(matrices, which):
    """eq. 6 and eq. 9, the row entropy (eq. 7), ln P's moments, its
    variance and its log-normality score, as the reference computes them;
    each row sums to 1."""
    got, want = matrices[which]
    _close(got, want)
    _close(got.sum(-1), np.ones(got.shape[0]))
    _close(tmet.row_entropy(got), jmet.row_entropy(want))
    for g, w in zip(tmet.attention_log_moments(got),
                    jmet.attention_log_moments(want)):
        _close(g, w)
    _close(tmm.log_variance(got), jmm.log_variance(want))
    assert abs(tmet.lognormality_score(got)
               - jmet.lognormality_score(want)) <= F32


@pytest.mark.parametrize("which", ["sm", "lln"])
def test_eigen_instruments_in_float64(matrices, which):
    """The spectral gap (dense and by power iteration) and the variance
    along the major principal component on the same float64 matrix (the
    reference's fp32 matrix widened), against the reference at 1e-9."""
    _, want = matrices[which]
    p = np.asarray(want, np.float64)
    for fn in ("spectral_gap", "variance_along_pc"):
        assert abs(getattr(tmet, fn)(torch.from_numpy(p))
                   - getattr(jmet, fn)(p)) <= F64, fn
    assert abs(tmet.spectral_gap(p) - jmet.spectral_gap(p)) <= F64
    assert abs(tmet.spectral_gap_power(torch.from_numpy(p), iters=120)
               - jmet.spectral_gap_power(p, iters=120)) <= F64


def test_spectral_gap_power_matches_the_dense_gap():
    """The deflated power iteration against the dense eigenvalues (as
    ``tests/test_longctx.py`` holds the reference's)."""
    for n, conc in ((24, 0.5), (48, 2.0), (48, 8.0)):
        p = torch.from_numpy(_stochastic(n + int(conc), n, conc))
        dense = tmet.spectral_gap(p)
        power = tmet.spectral_gap_power(p, iters=400)
        assert abs(power - dense) < 0.02, (n, conc, dense, power)


def test_temperatures_and_norm_ppf():
    """tau_sm (eq. 5), tau_lln (eq. 11) and the inverse normal CDF."""
    for sq, sk, cc in ((1.0, 1.0, 0.0), (0.7, 1.8, 0.3)):
        assert tmet.temperature_sm(sq, sk, cc) == \
            pytest.approx(jmet.temperature_sm(sq, sk, cc), rel=F64)
        for a, b in ((2.2, 2.0), (0.5, 0.3)):
            assert tmet.temperature_lln(a, b, sq, sk) == pytest.approx(
                jmet.temperature_lln(a, b, sq, sk), rel=F64)
    probs = np.linspace(0.001, 0.999, 97)
    _close(tmet._norm_ppf(probs), jmet._norm_ppf(probs), F64)


def test_fit_from_samples_matches_the_reference_formula():
    """The fit of Var[ln P^(LLN)] = a sigma_tilde^2 + b from given samples
    against the reference's formula (``lln_attn_matrix`` + ``log_variance``
    + ``np.polyfit``) on the same numpy-made samples."""
    rng = np.random.default_rng(3)
    n, d = 64, 16
    samples = []
    for s2 in np.linspace(1.0, 16.0, 5):
        sig = float(np.sqrt(s2 / 2.0))
        for _ in range(2):
            q, k = (sig * rng.standard_normal((2, n, d))).astype(np.float32)
            samples.append((s2, q, k))
    xs = [s2 for s2, _, _ in samples]
    ys = [float(jmm.log_variance(jmm.lln_attn_matrix(
        jnp.asarray(q), jnp.asarray(k), 1.0, 1.0))) for _, q, k in samples]
    want = np.polyfit(np.asarray(xs), np.asarray(ys), 1)
    got = tmm._fit_from_samples((s2, torch.from_numpy(q), torch.from_numpy(k))
                                for s2, q, k in samples)
    np.testing.assert_allclose(got, want, rtol=F32, atol=F32)


def test_fit_lln_constants_is_seeded_on_its_device():
    """``fit_lln_constants`` draws from a seeded generator on the device it
    is given: the same seed gives the same (a, b), another seed another,
    and the slope is positive (the log-variance grows with sigma_tilde^2).
    The grid runs one fit per length."""
    kw = dict(d=8, n=32, sigma_tilde_sq=np.linspace(1.0, 9.0, 4),
              num_seeds=2, device="cpu")
    a, b = tmm.fit_lln_constants(seed=1, **kw)
    assert (a, b) == tmm.fit_lln_constants(seed=1, **kw)
    assert (a, b) != tmm.fit_lln_constants(seed=2, **kw)
    assert a > 0 and np.isfinite(b)
    grid = tmm.fit_lln_constants_grid(d=8, ns=(16, 32), num_seeds=1,
                                      device="cpu")
    assert sorted(grid) == [16, 32]


def test_update_stats_mask_ignores_padding():
    """A masked update on a padded batch equals the unmasked update on the
    dense batch, the unmasked padded update is pulled toward 0 (as
    ``tests/test_longctx.py`` holds the reference's), and each matches the
    reference's; ``matched_alpha_beta`` solves eq. 10 on the stats."""
    rng = np.random.default_rng(9)
    h, d = 4, 8
    q = rng.standard_normal((2, 6, h, d)).astype(np.float32)
    k = (2.0 * rng.standard_normal((2, 6, h, d))).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 0, 0, 0, 0]], np.float32)
    qp, kp = q * mask[:, :, None, None], k * mask[:, :, None, None]
    st0 = tmm.QKStats.init(h, device="cpu")
    jst0 = jmm.QKStats.init(h)
    got = tmm.update_stats(st0, *map(torch.from_numpy, (qp, kp)), decay=0.5,
                           mask=torch.from_numpy(mask))
    keep = mask.astype(bool)
    want = tmm.update_stats(st0, torch.from_numpy(q[keep][None]),
                            torch.from_numpy(k[keep][None]), decay=0.5)
    _close(got.sigma_q, want.sigma_q.numpy(), 1e-6)
    _close(got.sigma_k, want.sigma_k.numpy(), 1e-6)
    polluted = tmm.update_stats(st0, *map(torch.from_numpy, (qp, kp)),
                                decay=0.5)
    assert float(polluted.sigma_k.max()) < float(got.sigma_k.max())
    jgot = jmm.update_stats(jst0, jnp.asarray(qp), jnp.asarray(kp),
                            decay=0.5, mask=jnp.asarray(mask))
    _close(got.sigma_q, jgot.sigma_q)
    _close(got.sigma_k, jgot.sigma_k)
    for g, w in zip(tmm.matched_alpha_beta(got),
                    jmm.matched_alpha_beta(jgot)):
        _close(g, w)


def test_streaming_concentration_matches_reference():
    """The per-row instruments of one carried state, with c, with only
    log_scale, and with pos."""
    rng = np.random.default_rng(11)
    z = rng.uniform(0.01, 5.0, (3, 2, 4, 8)).astype(np.float32)
    c = rng.normal(size=(3, 2, 4)).astype(np.float32)
    ls = rng.uniform(0, 1, (3, 2, 4)).astype(np.float32)
    pos = np.array([5, 9], np.int32)
    for kw in ({"c": c, "pos": pos}, {"log_scale": ls}, {}):
        want = jmet.streaming_concentration(
            jnp.asarray(z), **{n: jnp.asarray(a) for n, a in kw.items()})
        got = tmet.streaming_concentration(
            torch.from_numpy(z), **{n: torch.from_numpy(a)
                                    for n, a in kw.items()})
        assert sorted(got) == sorted(want)
        for name in want:
            _close(got[name], want[name])


def _reference_serve(arch, impl, prompt, steps, renorm):
    """The reference's SMOKE model served for ``steps`` greedy tokens with
    the drift renorm at ``renorm`` (0 = off); its caches."""
    cfg = j_get_config(arch, smoke=True, attn_impl=impl,
                       compute_dtype="float32", lln_renorm=renorm)
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = j_synthetic_batch(cfg, 2, prompt + steps, text_seq=prompt)
    logits, caches = model.prefill(params, batch, prompt + steps)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    for i in range(steps):
        logits, caches = model.decode(params, caches, tok,
                                      jnp.asarray(prompt + i, jnp.int32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return jax.tree_util.tree_map(np.asarray, caches)


def _port_tree(arch, caches):
    """The reference's caches in the port's layout: per-layer lists."""
    if arch != "yi-9b":
        return hybrid_cache_from_numpy(caches, "cpu")
    n = caches["layers"]["s"].shape[0]
    return {"layers": [state_from_numpy(jax.tree_util.tree_map(
        lambda a, i=i: a[i], caches["layers"]), "cpu") for i in range(n)]}


@pytest.mark.parametrize("renorm", [0.0, 1.0], ids=["off", "on"])
@pytest.mark.parametrize("arch,impl", [("yi-9b", "lln"),
                                       ("zamba2-7b", "lln_diag")])
def test_streaming_concentration_tree_on_converted_caches(arch, impl,
                                                          renorm):
    """The tree walk over the port's cache layout (per-layer lists; the
    hybrid's Mamba2 caches carry no z) against the reference's over its
    stacked caches (row axis 1), on the reference's serving caches
    converted by ``convert``; with the renorm on, it fired and the log key
    mass is the renorm-off run's within 1e-5."""
    caches = _reference_serve(arch, impl, 20, 3, renorm)
    want = jmet.streaming_concentration_tree(caches, row_axis=1)
    got = tmet.streaming_concentration_tree(_port_tree(arch, caches))
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name])
    if renorm:
        attn = caches["layers" if arch == "yi-9b" else "shared"]
        assert float(np.max(attn["log_scale"])) > 0.0
        off = tmet.streaming_concentration_tree(
            _port_tree(arch, _reference_serve(arch, impl, 20, 3, 0.0)))
        _close(got["log_mass"], off["log_mass"].numpy())
    assert tmet.streaming_concentration_tree(
        {"layers": [{"state": torch.zeros(2, 3)}]}) is None
