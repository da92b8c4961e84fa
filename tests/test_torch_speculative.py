"""Speculative decoding in the port, held against the JAX reference.

Mirrors the reference's ``tests/test_speculative.py`` at its tiny config
(2 layers, d_model 64, 4 heads of 16, vocab 128, fp32):

* the acceptance rules (``core/speculative.py``): ``greedy_verify`` and
  ``emit_tokens`` equal the reference's exactly on seeded logits;
  ``residual_verify``'s deterministic properties, and a chi-square test
  (V = 8, a fixed ``torch.Generator``) that its emitted token follows the
  target's distribution (the port draws from a ``torch.Generator``, so its
  samples cannot equal JAX's bit for bit);
* the commit half of the partial-commit contract: after a
  ``commit_len = 0`` verify (which leaves the state bitwise as it was),
  ``AttentionEngine.commit`` equals ``decode(..., commit_len)`` bit for
  bit on the ``plain`` and ``ref`` kinds, for ``lln``, ``lln_diag`` (r 1
  and 4), ``log_linear`` and ``softmax``, and the reference engine's
  ``commit`` within 2e-4 of the largest entry (the ``plain`` kind's
  group-level constants compared at the reference's, as in
  ``tests/test_torch_contract.py``); ``lm_score`` leaves the caches
  bitwise unchanged and ``lm_commit`` equals ``lm_decode(commit_len)``;
* the tied draft (``draft_params`` shares the target's storage);
* ``make_spec_setup``: greedy tokens, ``n_emit`` and ``n_accept`` equal the
  reference's from converted weights (``lln_diag``), and the port's plain
  greedy loop for every impl; the tied full-depth draft accepts every
  draft; the ``--speculative`` CLI on the CPU.

Every JAX run is made once per module (module-scoped fixtures).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import speculative as jspec
from repro.core.engine import AttentionEngine as JEngine
from repro.kernels.registry import AttnSpec as JSpec
from repro.launch.mesh import compat_mesh
from repro.launch.steps import make_spec_setup as j_make_spec_setup
from repro.models import build_model as j_build_model
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.core import speculative as spec
from repro_torch.core.engine import AttentionEngine
from repro_torch.kernels.registry import AttnSpec
from repro_torch.launch.steps import (flatten_spec_tokens, make_serve_setup,
                                      make_spec_setup)
from repro_torch.models import build_model, draft_config, draft_params
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves_with_path

TOL = 2e-4
H, D = 4, 8


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


_TINY = dict(family="dense", n_layers=2, d_model=64, n_heads=4, d_ff=128,
             vocab=128, head_dim=16, diag_block=8, lln_chunk=8,
             softmax_chunk=16, compute_dtype="float32",
             param_dtype="float32", remat="none", tie_embeddings=True)


def _tiny_cfg(impl, r, cls=ArchConfig, **kw):
    return cls(name=f"spec-test-{impl}-r{r}", n_kv_heads=4 // r,
               attn_impl=impl,
               lln_fixed_ab=2.1 if impl != "softmax" else 0.0,
               **{**_TINY, **kw})


# ---------------------------------------------------------------------------
# Acceptance rules.
# ---------------------------------------------------------------------------

def test_greedy_verify_and_emit_match_the_reference():
    """Seeded logits with planted matches: n_accept, the correction or
    bonus token, commit_len and the packed emit buffer, exactly."""
    rng = np.random.default_rng(0)
    b, k, v = 6, 4, 16
    logits = rng.normal(size=(b, k + 1, v)).astype(np.float32)
    tgt = logits.argmax(-1)
    drafts = rng.integers(0, v, size=(b, k)).astype(np.int32)
    for row, n in enumerate([0, 1, 2, 3, 4, 4]):
        drafts[row, :n] = tgt[row, :n]        # accept n drafts, then differ
        if n < k and drafts[row, n] == tgt[row, n]:
            drafts[row, n] = (tgt[row, n] + 1) % v
    drafts[2, 3] = tgt[2, 3]                  # a match after a mismatch
    want = jspec.greedy_verify(jnp.asarray(drafts), jnp.asarray(logits))
    got = spec.greedy_verify(torch.from_numpy(drafts).long(),
                             torch.from_numpy(logits))
    for g, w in zip(got, want):
        assert g.tolist() == np.asarray(w).tolist()
    assert got[0].tolist() == [0, 1, 2, 3, 4, 4]
    jemit = jspec.emit_tokens(jnp.asarray(drafts), *want[:2])
    emit = spec.emit_tokens(torch.from_numpy(drafts).long(), *got[:2])
    assert emit.tolist() == np.asarray(jemit).tolist()
    via = spec.verify_tokens(torch.from_numpy(drafts).long(),
                             torch.from_numpy(logits), 0.0)
    assert all(torch.equal(a, b_) for a, b_ in zip(via, got))


def test_residual_verify_deterministic_properties():
    """Identical draft and target distributions accept every draft; a
    draft the target gives probability 0 is always rejected and replaced;
    ``verify_tokens`` needs draft logits to sample and the residual rule
    a positive temperature."""
    gen = torch.Generator().manual_seed(0)
    b, k, v = 64, 3, 8
    logits = torch.randn(b, k + 1, v, generator=gen)
    drafts = torch.randint(0, v, (b, k), generator=gen)
    n, nxt, commit = spec.residual_verify(drafts, logits[:, :k], logits,
                                          gen, 0.7)
    assert n.tolist() == [k] * b and torch.equal(commit, n + 1)
    tgt = torch.full((b, 2, v), 0.0)
    tgt[:, 0, 0] = -1e9                       # p(token 0) = 0
    dr = torch.zeros(b, 1, v)
    n, nxt, _ = spec.residual_verify(torch.zeros(b, 1, dtype=torch.long),
                                     dr, tgt, gen, 1.0)
    assert n.tolist() == [0] * b and bool((nxt != 0).all())
    with pytest.raises(ValueError, match="draft_logits"):
        spec.verify_tokens(drafts, logits, 0.5, generator=gen)
    with pytest.raises(ValueError, match="temperature"):
        spec.residual_verify(drafts, logits[:, :k], logits, gen, 0.0)


def test_residual_verify_emits_from_the_target_distribution():
    """V = 8, one draft per row drawn from q: the first emitted token (the
    accepted draft, or the residual resample) follows p.  Chi-square over
    20000 rows from a fixed generator, against the 0.999 quantile of
    chi-square with 7 degrees of freedom (24.32)."""
    gen = torch.Generator().manual_seed(1)
    n_rows, v = 20000, 8
    p_logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, 1.5, -1.0, 0.3])
    q_logits = torch.tensor([0.0, 1.5, 1.0, 0.5, 0.0, -1.0, 0.5, 0.0])
    p = torch.softmax(p_logits, 0)
    q = torch.softmax(q_logits, 0)
    drafts = torch.multinomial(q.expand(n_rows, v), 1, replacement=True,
                               generator=gen)
    tgt = p_logits.expand(n_rows, 2, v)
    n, nxt, _ = spec.residual_verify(drafts, q_logits.expand(n_rows, 1, v),
                                     tgt, gen, 1.0)
    first = torch.where(n == 1, drafts[:, 0], nxt)
    counts = torch.bincount(first, minlength=v).double()
    expect = p.double() * n_rows
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 24.32, (chi2, counts.tolist(), expect.tolist())
    assert 0 < int((n == 1).sum()) < n_rows        # both branches ran


# ---------------------------------------------------------------------------
# The commit half: engine, against decode(commit_len) and the reference.
# ---------------------------------------------------------------------------

COMMIT_CELLS = [("lln", 1), ("lln_diag", 1), ("lln_diag", 4),
                ("log_linear", 2), ("softmax", 2)]
COMMIT = np.array([3, 0, 1], np.int32)


def _qkv(rng, t, g, b=3):
    return (rng.normal(size=(b, t, H, D)).astype(np.float32),
            rng.normal(size=(b, t, g, D)).astype(np.float32),
            rng.normal(size=(b, t, g, D)).astype(np.float32))


def _spec_kw(impl, r):
    return dict(impl=impl, r=r, lln_chunk=8, diag_block=8)


@pytest.fixture(scope="module")
def reference_commits():
    """Per (impl, r): prompt and chunk inputs, the reference's prefill
    state, its ``commit_len = 0`` verify outputs and its state after
    ``commit`` of (3, 0, 1), as numpy."""
    out = {}
    for impl, r in COMMIT_CELLS:
        g = H // r
        rng = np.random.default_rng(5 + r)
        heads = dict(heads=H, kv_heads=g, head_dim=D, v_dim=D)
        jeng = JEngine(spec=JSpec(backend="auto", **_spec_kw(impl, r)),
                       **heads)
        prompt = _qkv(rng, 21, g)
        chunk = _qkv(rng, 3, g)
        _, jst = jeng.prefill(*map(jnp.asarray, prompt), max_len=40)
        jout, jst0, resid = jeng.verify(
            jst, *map(jnp.asarray, chunk), commit_len=jnp.zeros(3, jnp.int32),
            return_residuals=True)
        jst2 = jeng.commit(jst0, resid, commit_len=jnp.asarray(COMMIT))
        tree = jax.tree_util.tree_map(np.asarray, (jst, jst2))
        out[impl, r] = dict(chunk=chunk, state=tree[0], out=np.asarray(jout),
                            committed=tree[1])
    return out


def _equal_states(a, b):
    for (path, x), (_, y) in zip(leaves_with_path(a), leaves_with_path(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("kind", ["plain", "ref"])
@pytest.mark.parametrize("impl,r", COMMIT_CELLS)
def test_engine_commit_is_decode_with_commit_len(reference_commits, impl, r,
                                                 kind):
    """A ``commit_len = 0`` verify leaves the state bitwise; ``commit``
    after it equals ``decode(commit_len)`` bit for bit and the reference's
    ``commit``; verify's outputs equal the reference's."""
    cell = reference_commits[impl, r]
    g = H // r
    teng = AttentionEngine(spec=AttnSpec(backend=kind, **_spec_kw(impl, r)),
                           heads=H, kv_heads=g, head_dim=D, v_dim=D)
    st = state_from_numpy(cell["state"], "cpu")
    q, k, v = (torch.from_numpy(a) for a in cell["chunk"])
    out, st0, resid = teng.verify(st, q, k, v,
                                  commit_len=torch.zeros(3, dtype=torch.int32),
                                  return_residuals=True)
    _equal_states(st0, st)
    _close(out, cell["out"])
    cl = torch.from_numpy(COMMIT)
    got = teng.commit(st0, resid, commit_len=cl)
    _, want = teng.decode(st, q, k, v, commit_len=cl)
    _equal_states(got, want)
    ref = cell["committed"]
    for f in ("k", "v", "tail_k", "tail_v", "s", "z", "sl", "zl"):
        a = getattr(got, f)
        if a is None:
            continue
        if kind == "plain" and f in ("s", "z"):
            shift = torch.exp(got.c_k - torch.from_numpy(
                np.array(ref["c_k"])))[:, 0, :, 0]
            a = a * (shift[..., None, None] if f == "s" else shift[..., None])
        if kind == "plain" and f in ("sl", "zl"):
            shift = torch.exp(got.cl - torch.from_numpy(np.array(ref["cl"])))
            a = a * (shift[..., None, None] if f == "sl" else shift[..., None])
        _close(a, ref[f])
    for f in ("len", "pos"):
        if getattr(got, f) is not None:
            assert getattr(got, f).tolist() == np.asarray(ref[f]).tolist()


def test_commit_requires_commit_len_for_verify():
    teng = AttentionEngine(spec=AttnSpec(impl="lln", r=1, lln_chunk=8),
                           heads=H, kv_heads=H, head_dim=D, v_dim=D)
    st = teng.init_state(1, "cpu", 8)
    x = torch.zeros(1, 2, H, D)
    with pytest.raises(ValueError, match="commit_len"):
        teng.verify(st, x, x, x, commit_len=None)


# ---------------------------------------------------------------------------
# The model: score leaves the caches alone; the tied draft.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["lln_diag", "log_linear", "softmax"])
def test_lm_score_leaves_caches_and_commit_equals_decode(impl):
    """``lm_score`` leaves every cache leaf bitwise; its logits equal a
    ``commit_len = 0`` ``lm_decode``'s; ``lm_commit`` of (3, 0, 2) equals
    ``lm_decode`` with that ``commit_len``, bit for bit."""
    cfg = _tiny_cfg(impl, 2)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (3, 13), generator=gen)
    chunk = torch.randint(0, cfg.vocab, (3, 4), generator=gen)
    _, caches = model.prefill(params, {"inputs": prompt}, 24)
    pos = torch.full((3,), 13, dtype=torch.int32)
    before = [t.clone() for _, t in leaves_with_path(caches)]
    logits, resid = model.score(params, caches, chunk, pos)
    for a, (_, b_) in zip(before, leaves_with_path(caches)):
        assert torch.equal(a, b_)
    zero = torch.zeros(3, dtype=torch.int32)
    want_logits, same = model.decode(params, caches, chunk, pos,
                                     commit_len=zero)
    assert torch.equal(logits, want_logits)
    _equal_states(same, caches)
    cl = torch.tensor([3, 0, 2], dtype=torch.int32)
    got = model.commit(caches, resid, cl)
    _, want = model.decode(params, caches, chunk, pos, commit_len=cl)
    _equal_states(got, want)


def test_draft_params_share_storage_and_draft_config_validates():
    cfg = _tiny_cfg("lln_diag", 2)
    params = build_model(cfg, "cpu").init(0)
    d = draft_params(params, cfg, 1)
    assert len(d.layers) == 1 and d.layers[0] is params.layers[0]
    assert d.embed_table is params.embed_table
    assert d.final_norm is params.final_norm
    for (name, a), (_, b_) in zip(d.named_parameters(),
                                  params.named_parameters()):
        assert a.data_ptr() == b_.data_ptr(), name
    dcfg = draft_config(cfg, 1)
    assert dcfg.n_layers == 1 and dcfg.name == "spec-test-lln_diag-r2-draft1"
    assert draft_config(cfg, 2).n_layers == 2
    for bad in (0, 3):
        with pytest.raises(ValueError, match="draft_layers"):
            draft_config(cfg, bad)
    with pytest.raises(NotImplementedError, match="first-k-layers"):
        draft_config(cfg.replace(family="ssm"), 1)
    mcfg = cfg.replace(family="moe", n_experts=4, expert_d_ff=32)
    moe = draft_config(mcfg, 1)
    mparams = build_model(mcfg, "cpu").init(0)
    view = draft_params(mparams, moe, 1)
    assert len(view.layers) == 1 and view.layers[0] is mparams.layers[0]
    assert hasattr(view.layers[0], "moe")


# ---------------------------------------------------------------------------
# The loop: make_spec_setup.
# ---------------------------------------------------------------------------

PLEN, STEPS, K = 9, 10, 3


def _batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(b, PLEN)).astype(np.int32)


def _port_spec(cfg, params, toks, draft_layers, k=K):
    ml = PLEN + STEPS + k + 2
    sp = make_spec_setup(cfg, ShapeSpec("s", ml, toks.shape[0], "decode"),
                         "cpu", spec_k=k, draft_layers=draft_layers)
    logits, tc, dc = sp.prefill_fn(params, {
        "inputs": torch.from_numpy(toks).long()})
    tok = torch.argmax(logits[:, -1], -1)
    out = sp.make_generate(STEPS)(params, tc, dc, tok, PLEN)
    return tok, out


def _plain_greedy(cfg, params, toks):
    ss = make_serve_setup(cfg, ShapeSpec("s", PLEN + STEPS + 2,
                                         toks.shape[0], "decode"), "cpu")
    logits, caches = ss.prefill_fn(params, {
        "inputs": torch.from_numpy(toks).long()})
    tok = torch.argmax(logits[:, -1], -1)
    return ss.make_generate(STEPS)(params, caches, tok, PLEN)[0].numpy()


@pytest.fixture(scope="module")
def reference_spec():
    """The reference's ``make_spec_setup`` (lln_diag, r = 4, a 1-layer
    draft) on two rows: its weights as numpy, the prompts and its greedy
    outputs."""
    jcfg = _tiny_cfg("lln_diag", 4, cls=JArchConfig)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    toks = _batch(jcfg, seed=4)
    mesh = compat_mesh((1, 1), ("data", "model"))
    with mesh:
        sp = j_make_spec_setup(jcfg, JShapeSpec("s", PLEN + STEPS + K + 2, 2,
                                                "decode"), mesh,
                               spec_k=K, draft_layers=1)
        logits, tc, dc = sp.prefill_fn(jparams, {"inputs": jnp.asarray(toks)})
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        out = sp.make_generate(STEPS)(jparams, tc, dc, tok,
                                      jnp.asarray(PLEN, jnp.int32),
                                      jax.random.PRNGKey(0))
    return dict(params=jax.tree_util.tree_map(np.asarray, jparams),
                toks=toks, tok=np.asarray(tok),
                out=[np.asarray(a) for a in out[:4]])


def test_spec_matches_the_reference_spec_setup(reference_spec):
    """Converted weights, the same prompts: the first token, the
    flattened greedy tokens, and ``n_emit`` / ``n_accept`` / ``live`` per
    iteration equal the reference's."""
    cfg = _tiny_cfg("lln_diag", 4)
    params = params_from_numpy(reference_spec["params"], cfg, "cpu")
    tok, (toks, n_emit, n_acc, live, *_) = _port_spec(
        cfg, params, reference_spec["toks"], 1)
    jtoks, jemit, jacc, jlive = reference_spec["out"]
    assert tok.tolist() == reference_spec["tok"].tolist()
    assert toks.shape == jtoks.shape == (2, STEPS, K + 1)
    np.testing.assert_array_equal(flatten_spec_tokens(toks, n_emit, STEPS),
                                  flatten_spec_tokens(jtoks, jemit, STEPS))
    np.testing.assert_array_equal(n_emit.numpy(), jemit)
    np.testing.assert_array_equal(n_acc.numpy(), jacc)
    np.testing.assert_array_equal(live.numpy(), jlive)


@pytest.mark.parametrize("impl,r", [("lln", 1), ("lln_diag", 1),
                                    ("log_linear", 2), ("softmax", 4)])
def test_spec_greedy_matches_the_plain_loop(impl, r):
    """Greedy speculative tokens equal the plain greedy loop's with a
    1-layer draft; every row emits ``STEPS`` tokens."""
    cfg = _tiny_cfg(impl, r)
    params = build_model(cfg, "cpu").init(1)
    toks = _batch(cfg, seed=r)
    _, (out, n_emit, n_acc, live, *_) = _port_spec(cfg, params, toks, 1)
    np.testing.assert_array_equal(flatten_spec_tokens(out, n_emit, STEPS),
                                  _plain_greedy(cfg, params, toks))
    assert (n_acc <= K).all() and torch.equal(n_acc[~live],
                                              torch.zeros_like(n_acc[~live]))


def test_tied_full_draft_accepts_every_draft_and_rows_differ():
    """The full-depth draft is the target: every live iteration accepts
    all K drafts; a 1-layer draft's rows accept different counts and still
    give the plain loop's tokens."""
    cfg = _tiny_cfg("lln_diag", 2)
    params = build_model(cfg, "cpu").init(2)
    toks = _batch(cfg, b=3, seed=5)
    _, (out, n_emit, n_acc, live, *_) = _port_spec(cfg, params, toks, 2)
    assert n_acc[live].tolist() == [K] * int(live.sum())
    plain = _plain_greedy(cfg, params, toks)
    np.testing.assert_array_equal(flatten_spec_tokens(out, n_emit, STEPS),
                                  plain)
    _, (out, n_emit, n_acc, live, *_) = _port_spec(cfg, params, toks, 1,
                                                   k=2)
    np.testing.assert_array_equal(flatten_spec_tokens(out, n_emit, STEPS),
                                  plain)


def test_spec_temperature_sampling_and_pass_audit():
    """Sampling runs and is reproducible from the generator; each
    iteration is one target score pass (``DECODE_PASS_COUNTS``)."""
    cfg = _tiny_cfg("lln", 2)
    params = build_model(cfg, "cpu").init(3)
    toks = torch.from_numpy(_batch(cfg)).long()
    sp = make_spec_setup(cfg, ShapeSpec("s", PLEN + STEPS + K + 2, 2,
                                        "decode"), "cpu", spec_k=K,
                         draft_layers=1)
    outs = []
    for _ in range(2):
        logits, tc, dc = sp.prefill_fn(params, {"inputs": toks})
        tok = torch.argmax(logits[:, -1], -1)
        tr.DECODE_PASS_COUNTS.clear()
        res = sp.make_generate(STEPS, temperature=0.8)(
            params, tc, dc, tok, PLEN, torch.Generator().manual_seed(7))
        outs.append(flatten_spec_tokens(res[0], res[1], STEPS))
        iters = int(res[3].any(0).sum())
        assert tr.DECODE_PASS_COUNTS[cfg.name] == iters
    np.testing.assert_array_equal(outs[0], outs[1])
    # Sampling covers the padded vocab, as the reference's does.
    assert ((outs[0] >= 0) & (outs[0] < cfg.padded_vocab)).all()
    with pytest.raises(ValueError, match="spec_k"):
        make_spec_setup(cfg, ShapeSpec("s", 32, 1, "decode"), "cpu",
                        spec_k=0, draft_layers=1)


def test_speculative_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    flat = serve.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                       "--attn-impl", "lln_diag", "--speculative",
                       "--spec-k", "2", "--batch", "2", "--prompt-len", "12",
                       "--gen", "7"])
    assert flat.shape == (2, 6)
    out = capsys.readouterr().out
    assert "acceptance rate" in out and "draft_layers=1" in out
