"""The port's quadratic-form oracles (``repro_torch.kernels.ref``) against
the reference's (``repro.kernels.ref``) on the same numpy inputs, in fp32:
every output within 1e-5 of its largest entry (both evaluate the same
expressions, summed in another order).  Each oracle runs at GQA r = 1 and
2, causal and not where it takes the flag, with D != Dv and a few blocks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

import repro.kernels.ref as jref
import repro_torch.kernels.ref as tref

TOL = 1e-5
BH, N, D, DV, BLOCK = 4, 16, 8, 6, 4


def _inputs(r: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    bg = BH // r

    def normal(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    out = {"q": normal(BH, N, D), "k": normal(bg, N, D),
           "v": normal(bg, N, DV), "g": normal(BH, N, DV)}
    # The LLN inputs are pre-scaled and stabilized (<= 0).
    out["qs"] = -np.abs(normal(BH, N, D, scale=0.5))
    out["ks"] = -np.abs(normal(bg, N, D, scale=0.5))
    return out


def _fwd_res(x, causal, r):
    return (x["qs"], x["ks"], x["v"]), {"causal": causal, "r": r}


def _lln_bwd(x, causal, r):
    o, den = jref.lln_fwd_res_ref(*map(jnp.asarray, (x["qs"], x["ks"],
                                                      x["v"])), causal, r)
    return ((x["qs"], x["ks"], x["v"], x["g"], np.array(o),
             np.array(den)), {"causal": causal, "r": r})


def _fused_bwd(x, causal, r):
    o = jref.lln_diag_fused_ref(*map(jnp.asarray, (x["qs"], x["ks"], x["q"],
                                                    x["k"], x["v"])),
                                block=BLOCK, causal=True, r=r)
    _, den = jref.lln_fwd_res_ref(*map(jnp.asarray, (x["qs"], x["ks"],
                                                      x["v"])), True, r)
    return ((x["qs"], x["ks"], x["q"], x["k"], x["v"], x["g"],
             np.array(o), np.array(den)),
            {"block": BLOCK, "r": r, "scale": 0.4})


# name -> (causal flags it takes, arguments builder)
CASES = {
    "lln_bidir_ref": ((False,), lambda x, c, r: (
        (x["qs"], x["ks"], x["v"]), {"r": r})),
    "block_diag_ref": ((True, False), lambda x, c, r: (
        (x["q"], x["k"], x["v"]), {"block": BLOCK, "causal": c, "r": r})),
    "lln_fwd_res_ref": ((True, False), _fwd_res),
    "lln_bwd_ref": ((True, False), _lln_bwd),
    "block_diag_bwd_ref": ((True, False), lambda x, c, r: (
        (x["q"], x["k"], x["v"], x["g"]),
        {"block": BLOCK, "causal": c, "r": r, "scale": 0.3})),
    "lln_diag_fused_bwd_ref": ((True,), _fused_bwd),
    "lln_diag_fused_ref": ((True, False), lambda x, c, r: (
        (x["qs"], x["ks"], x["q"], x["k"], x["v"]),
        {"block": BLOCK, "causal": c, "r": r})),
}


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_oracle_matches_the_reference(name):
    flags, build = CASES[name]
    for r in (1, 2):
        for causal in flags:
            x = _inputs(r, seed=len(name) + r)
            args, kw = build(x, causal, r)
            want = _flat(getattr(jref, name)(*map(jnp.asarray, args), **kw))
            got = _flat(getattr(tref, name)(*map(torch.from_numpy, args),
                                            **kw))
            assert len(got) == len(want), name
            for i, (g, w) in enumerate(zip(got, want)):
                w = np.asarray(w, np.float32)
                assert tuple(g.shape) == w.shape, (name, i)
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=0,
                    atol=TOL * max(1.0, float(np.abs(w).max())),
                    err_msg=f"{name} output {i} r={r} causal={causal}")
