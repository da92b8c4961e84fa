"""The whole slice: yi-9b SMOKE served by the port against the JAX reference.

The reference's params are converted through numpy; both packages then run
their own ``make_serve_setup`` on the CPU in fp32 (``compute_dtype=
"float32"``) over the same prompt.  Held: the prefill logits, every layer's
decode state, and teacher-forced decode steps of logits with equal greedy
tokens (8 for ``lln``/``lln_diag``; 20 for ``log_linear``, whose granule
is 16 in SMOKE, so that decode crosses position 127: 7 -> 8 closed
granules, a carry through every level into the saturated top).
Tolerances: 2e-4 absolute on logits (fp32 sums taken in another order
through 2 layers), 2e-4 relative to the largest entry on the summed
states, which grow with the prompt.
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
from repro.models import synthetic_batch as j_synthetic_batch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.steps import make_serve_setup

ATOL = 2e-4
STEPS = {"lln": 8, "lln_diag": 8, "log_linear": 20}
STATE_FIELDS = ("s", "z", "c_k", "tail_k", "tail_v", "pos", "alpha", "beta")
# Per impl: the fields a layer's decode state holds.
IMPL_FIELDS = {"lln": STATE_FIELDS, "lln_diag": STATE_FIELDS,
               "log_linear": ("s", "z", "c_k", "sl", "zl", "cl", "pos",
                              "alpha", "beta")}
SUMMED = ("s", "z", "sl", "zl")


def _close(got, want, scale=False):
    want = np.asarray(want, np.float32)
    atol = ATOL * max(1.0, float(np.abs(want).max())) if scale else ATOL
    np.testing.assert_allclose(got.float().cpu().numpy(), want, atol=atol,
                               rtol=0)


def _states_close(layer, jl, fields, ragged=False):
    """One layer's state against the reference's, raw where both took the
    same path.  A ragged ``log_linear`` prompt runs the reference's core
    path, which stabilizes per query head, and the port's kernel path,
    which stabilizes per kv group: outputs and decode do not depend on that
    choice, the raw states do, so those are compared at the reference's
    constants (``x * exp(c_port - c_ref)``)."""
    shift = {}
    if ragged:
        jc_k, jcl = (torch.tensor(np.asarray(jl[n])) for n in ("c_k", "cl"))
        shift = {"s": torch.exp(layer.c_k - jc_k)[:, 0, :, 0, None, None],
                 "z": torch.exp(layer.c_k - jc_k)[:, 0, :, 0, None],
                 "sl": torch.exp(layer.cl - jcl)[..., None, None],
                 "zl": torch.exp(layer.cl - jcl)[..., None]}
    for name in fields:
        if name in ("c_k", "cl") and shift:
            continue                  # folded into the shifted fields
        got = getattr(layer, name).float()
        _close(got * shift[name] if name in shift else got,
               np.asarray(jl[name]), scale=name in SUMMED)


@pytest.mark.parametrize("impl,prompt", [("lln", 32), ("lln_diag", 40),
                                         ("log_linear", 112),
                                         ("log_linear", 120)])
def test_port_serves_like_the_reference(impl, prompt):
    batch = 2
    steps = STEPS[impl]
    over = dict(attn_impl=impl, compute_dtype="float32")
    jcfg = j_get_config("yi-9b", smoke=True, **over)
    tcfg = get_config("yi-9b", smoke=True, **over)
    max_len = prompt + steps + 1
    jmodel = j_build_model(jcfg)
    mesh = compat_mesh((1, 1), ("data", "model"))
    with mesh:
        jsetup = j_make_serve_setup(jcfg, JShape("t", max_len, batch,
                                                 "decode"), mesh,
                                    multi_pod=False)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        jbatch = j_synthetic_batch(jcfg, batch, max_len, text_seq=prompt)
        jlogits, jcaches = jsetup.prefill_fn(jparams, jbatch)

    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               tcfg, "cpu")
    setup = make_serve_setup(tcfg, ShapeSpec("t", max_len, batch, "decode"),
                             device="cpu")
    tokens = torch.from_numpy(np.asarray(jbatch["inputs"]).astype(np.int64))
    logits, caches = setup.prefill_fn(params, {"inputs": tokens})
    _close(logits, jlogits)

    for i, layer in enumerate(caches["layers"]):
        jl = jax.tree_util.tree_map(lambda a, i=i: np.asarray(a)[i],
                                    jcaches["layers"])
        _states_close(layer, jl, IMPL_FIELDS[impl], ragged=(
            impl == "log_linear" and prompt % tcfg.lln_chunk != 0))

    tok_j = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)
    tok_t = torch.argmax(logits[:, -1], -1)
    with mesh:
        for step in range(steps):
            np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
            pos = prompt + step
            jlogits, jcaches = jsetup.decode_fn(jparams, jcaches, tok_j,
                                                jnp.asarray(pos, jnp.int32))
            logits, caches = setup.decode_fn(params, caches, tok_t, pos)
            _close(logits, jlogits)
            tok_j = jnp.argmax(jlogits, -1).astype(jnp.int32)
            tok_t = torch.argmax(logits, -1)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))


def test_log_linear_state_converts_from_the_reference():
    """A reference ``log_linear`` layer state (a prefill's, pyramid and open
    bucket) converts field for field; it has no diag tails."""
    from repro.core.engine import AttentionEngine as JEngine
    from repro.kernels.registry import AttnSpec as JSpec

    rng = np.random.default_rng(2)
    spec = JSpec(impl="log_linear", r=2, lln_chunk=8, num_scales=3)
    jeng = JEngine(spec=spec, heads=4, kv_heads=2, head_dim=8, v_dim=8)
    q = rng.normal(size=(2, 29, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 29, 2, 8)).astype(np.float32)
            for _ in range(2))
    _, jst = jeng.prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          max_len=40)
    st = state_from_numpy(jst, "cpu")
    assert st.tail_k is None and st.tail_v is None
    for name in IMPL_FIELDS["log_linear"] + ("log_scale",):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(jst[name]))
    assert st.sl.shape == (2, 3, 4, 8, 8) and st.cl.shape == (2, 3, 4)


def test_state_round_trip_is_exact():
    rng = np.random.default_rng(0)
    tree = {name: rng.normal(size=(2, 3)).astype(np.float32)
            for name in STATE_FIELDS + ("log_scale",)}
    tree["pos"] = np.array([5, 5], np.int32)
    st = state_from_numpy(tree, "cpu")
    for name, arr in tree.items():
        np.testing.assert_array_equal(getattr(st, name).numpy(), arr)


@pytest.mark.parametrize("impl", ["lln", "lln_diag", "log_linear"])
@pytest.mark.parametrize("backend", ["auto", "plain", "ref"])
def test_serve_cli_on_cpu(impl, backend, capsys):
    toks = serve.main(["--arch", "yi-9b", "--smoke", "--attn-impl", impl,
                       "--attn-backend", backend, "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20", "--gen", "5"])
    assert toks.shape == (2, 5)
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
    out = capsys.readouterr().out
    assert out.startswith("prefill: 2x20 in ")
    assert "sample tokens:" in out


def _cache_layout_matches(impl):
    from repro.models.transformer import lm_cache_init as j_cache_init
    from repro_torch.models import build_model

    over = dict(attn_impl=impl, compute_dtype="float32")
    jcfg = j_get_config("yi-9b", smoke=True, **over)
    tcfg = get_config("yi-9b", smoke=True, **over)
    jcaches = j_cache_init(None, jcfg, 3, 24)["layers"]
    model = build_model(tcfg, "cpu")
    caches = model.cache_init(model.init(0), 3, 24)["layers"]
    assert len(caches) == tcfg.n_layers
    for name in IMPL_FIELDS[impl] + ("log_scale",):
        want = np.asarray(jcaches[name])[0]
        got = getattr(caches[0], name)
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.float().numpy(), want)
    return caches[0]


def test_cache_init_matches_reference_layout():
    _cache_layout_matches("lln_diag")


def test_log_linear_cache_init_matches_reference_layout():
    st = _cache_layout_matches("log_linear")
    assert st.tail_k is None and st.tail_v is None


@pytest.mark.parametrize("impl", ["lln", "lln_diag"])
def test_engine_length_gain_matches_reference(impl):
    """The beta(n) schedule (off in the shipped configs): prefill at the
    prompt-length gain, decode at each row's own depth."""
    from repro.core.engine import AttentionEngine as JEngine
    from repro.kernels.registry import AttnSpec as JSpec
    from repro_torch.core.engine import AttentionEngine
    from repro_torch.kernels.registry import AttnSpec

    rng = np.random.default_rng(1)
    b, n, g, r, d, t = 2, 40, 2, 2, 16, 3
    h = g * r
    kw = dict(impl=impl, r=r, lln_chunk=16, diag_block=16, beta_n=0.5,
              calib_len=16)
    jeng = JEngine(spec=JSpec(**kw), heads=h, kv_heads=g, head_dim=d,
                   v_dim=d)
    teng = AttentionEngine(spec=AttnSpec(**kw), heads=h, kv_heads=g,
                           head_dim=d, v_dim=d)
    arrays = [rng.normal(size=(b, nn, hh, d)).astype(np.float32)
              for nn in (n, t) for hh in (h, g, g)]
    jout, jst = jeng.prefill(*(jnp.asarray(a) for a in arrays[:3]),
                             max_len=n + t)
    tout, tst = teng.prefill(*(torch.from_numpy(a) for a in arrays[:3]))
    _close(tout, jout)
    jout, jst = jeng.decode(jst, *(jnp.asarray(a) for a in arrays[3:]))
    tout, tst = teng.decode(tst, *(torch.from_numpy(a) for a in arrays[3:]))
    _close(tout, jout)
    for name in ("s", "z", "c_k", "tail_k", "pos"):
        _close(getattr(tst, name).float(), np.asarray(jst[name]),
               scale=name in ("s", "z"))
