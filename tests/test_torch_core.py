"""The port's calibration and guards, held against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages.  fp32
throughout; the tolerance (1e-6 relative) is a few fp32 ulps, since both
sides evaluate the same closed-form expressions.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.core import attention as jattn
from repro.core import moment_matching as jmm
from repro_torch.core import attention as tattn
from repro_torch.core import moment_matching as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels.registry import AttnSpec

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-6


@pytest.mark.parametrize("d", [16, 64, 100, 128, 256])
@pytest.mark.parametrize("n", [None, 512, 1024, 2000, 5000, 100_000])
def test_constants_for_dim(d, n):
    assert tmm.constants_for_dim(d, n) == jmm.constants_for_dim(d, n)


@pytest.mark.parametrize("beta_n,n", [(0.0, None), (0.5, 4096), (0.5, 512),
                                      (0.3, "rows")])
def test_solve_alpha_beta(beta_n, n):
    rng = np.random.default_rng(0)
    sq = rng.uniform(0.05, 3.0, (3, 8)).astype(np.float32)
    sk = rng.uniform(0.05, 3.0, (3, 8)).astype(np.float32)
    if n == "rows":
        n = np.array([100, 3000, 90_000], np.int32)
    a_j, b_j = jmm.solve_alpha_beta(jnp.asarray(sq), jnp.asarray(sk),
                                    n=None if n is None else jnp.asarray(n),
                                    beta_n=beta_n)
    a_t, b_t = tmm.solve_alpha_beta(torch.from_numpy(sq), torch.from_numpy(sk),
                                    n=None if n is None else torch.as_tensor(n),
                                    beta_n=beta_n)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=RTOL)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=RTOL)


def test_length_gain():
    n = np.array([1, 500, 1024, 1025, 40_000], np.int32)
    np.testing.assert_allclose(
        tmm.length_gain(torch.from_numpy(n), 0.7, 1024).numpy(),
        np.asarray(jmm.length_gain(jnp.asarray(n), 0.7, 1024)), rtol=RTOL)


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("fixed_ab", [0.0, 1.5])
def test_batch_alpha_beta(r, fixed_ab):
    rng = np.random.default_rng(r)
    g, d = 2, 16
    q = (rng.normal(size=(3, 24, g * r, d)) * 1.7).astype(np.float32)
    k = (rng.normal(size=(3, 24, g, d)) * 0.6).astype(np.float32)
    a_j, b_j = jattn.batch_alpha_beta(jnp.asarray(q), jnp.asarray(k),
                                      jattn.AttnConfig(fixed_ab=fixed_ab))
    a_t, b_t = tattn.batch_alpha_beta(torch.from_numpy(q), torch.from_numpy(k),
                                      AttnSpec(impl="lln", fixed_ab=fixed_ab))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=RTOL)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=RTOL)


# ---------------------------------------------------------------------------
# Guards.
# ---------------------------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_kernel_backend_raises_on_cpu_tensors():
    q = torch.zeros(1, 16, 2, 8)
    k = torch.zeros(1, 16, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.lln_prefill(q, k, k, 1.0, 1.0, chunk=16, backend="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.block_diag_fwd(q, k, k, 16, backend="kernel")


def test_entry_points_raise_without_a_device(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import serve, steps
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("yi-9b", smoke=True, attn_impl="lln")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.make_serve_setup(cfg, ShapeSpec("t", 8, 1, "decode"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "yi-9b", "--smoke", "--attn-impl", "lln"])


@pytest.mark.parametrize("argv", [["--continuous", "--speculative",
                                   "--requests", "12", "--segment", "4",
                                   "--gen-lens", "3,17"],
                                  ["--speculative", "--spec-k", "3"],
                                  ["--attn-impl", "log_linear",
                                   "--speculative", "--spec-k", "3"],
                                  ["--mesh", "2,1"]])
def test_serve_unported_modes_raise(argv, capsys):
    """``--mesh`` other than ``1,1`` needs as many processes as devices: in
    one process it raises ``ValueError`` before any process group starts
    (it raised ``NotImplementedError`` before meshes were ported);
    ``--speculative``, alone or with ``--continuous``, raised before
    speculative decoding was ported and now serves."""
    from repro_torch.launch import serve
    base = ["--arch", "yi-9b", "--smoke", "--device", "cpu"]
    if "--attn-impl" not in argv:
        base += ["--attn-impl", "lln"]
    if "--mesh" in argv:
        with pytest.raises(ValueError, match="2 devices needs 2 processes"):
            serve.main(base + argv)
        assert not torch.distributed.is_initialized()
        return
    out = serve.main(base + argv)
    text = capsys.readouterr().out
    assert "speculative" in text
    if "--continuous" in argv:
        assert out.statuses and set(out.statuses.values()) == {"done"}
        assert out.spec_k == 3 and out.verify_iters > 0
    else:
        assert out.shape == (4, 31) and "acceptance rate" in text


@pytest.mark.parametrize("argv", [[], ["--attn-impl", "softmax"]],
                         ids=["default", "explicit"])
@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_serve_cli_serves_softmax(argv, backend, capsys):
    """``softmax``, every config's default impl, serves (it was refused
    before the softmax impl was ported); backend ``ref`` prefills with the
    naive softmax."""
    from repro_torch.launch import serve
    toks = serve.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                       "--attn-backend", backend, "--batch", "2",
                       "--prompt-len", "20", "--gen", "5"] + argv)
    assert toks.shape == (2, 5)
    assert "sample tokens:" in capsys.readouterr().out
