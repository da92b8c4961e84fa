"""The kernels' custom ops (``repro_torch::<wrapper>``) under
``FakeTensorMode``: for every op, its wrapper called on fake ``cuda``
tensors (so it takes the CUDA branch and reaches the op's fake
implementation) gives outputs of the shapes and dtypes that its ``*_plain``
twin gives on small real CPU inputs of the same shapes, and launches and
counts nothing.  Each case runs in bf16 and fp32 ``v`` (the two kernel
paths) and with every optional output.
"""
import importlib

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro_torch.kernels import block_diag as bd
from repro_torch.kernels import lln_backward as lb
from repro_torch.kernels import loglinear as ll
from repro_torch.kernels import ssd as sd

la = importlib.import_module("repro_torch.kernels.lln_attention")

BH, R, N, D, DV, BLK = 4, 2, 16, 8, 6, 8
BG = BH // R


def _lln(vdt):
    return {"qs": ((BH, N, D), torch.float32),
            "ks": ((BG, N, D), torch.float32), "v": ((BG, N, DV), vdt)}


def _raw(vdt):
    return {"q": ((BH, N, D), vdt), "k": ((BG, N, D), vdt)}


def _res(vdt):
    return {"g": ((BH, N, DV), vdt), "o": ((BH, N, DV), vdt),
            "den": ((BH, N), torch.float32)}


def _state():
    return {"s": ((BG, D, DV), torch.float32),
            "z": ((BG, 1, D), torch.float32)}


# name -> (wrapper, plain twin, {arg: (shape, dtype)} by v's dtype, kwargs
# variants)
CASES = {
    "lln_causal": (la.lln_causal, la.lln_causal_plain, _lln,
                   [{"return_res": a, "return_state": b}
                    for a in (False, True) for b in (False, True)]),
    "lln_diag_fused": (la.lln_diag_fused, la.lln_diag_fused_plain,
                       lambda dt: {"qs": ((BH, N, D), torch.float32),
                                   "ks": ((BG, N, D), torch.float32),
                                   **_raw(dt), "v": ((BG, N, DV), dt)},
                       [{"blk": BLK, "return_res": a} for a in (False,
                                                                True)]),
    "lln_decode": (la.lln_decode, la.lln_decode_plain,
                   lambda dt: {"qs": ((BH, 3, D), torch.float32),
                               "ks": ((BG, 3, D), torch.float32),
                               "v": ((BG, 3, DV), dt),
                               "s": ((BH, D, DV), torch.float32),
                               "z": ((BH, 1, D), torch.float32)},
                   [{}, {"scale": ((BH,), torch.float32)}]),
    "lln_bidir": (la.lln_bidir, la.lln_bidir_plain, _lln,
                  [{"return_res": a} for a in (False, True)]),
    "block_diag": (bd.block_diag, bd.block_diag_plain,
                   lambda dt: {"q": ((BH, N, D), dt), "k": ((BG, N, D), dt),
                               "v": ((BG, N, DV), dt)},
                   [{"blk": BLK, "causal": c} for c in (False, True)]),
    "block_diag_bwd": (bd.block_diag_bwd, bd.block_diag_bwd_plain,
                       lambda dt: {"q": ((BH, N, D), dt),
                                   "k": ((BG, N, D), dt),
                                   "v": ((BG, N, DV), dt),
                                   "g": ((BH, N, DV), dt)},
                       [{"blk": BLK, "causal": c} for c in (False, True)]),
    "lln_causal_bwd": (lb.lln_causal_bwd, lb.lln_causal_bwd_plain,
                       lambda dt: {**_lln(dt), **_res(dt)}, [{"blk": BLK}]),
    "lln_diag_fused_bwd": (lb.lln_diag_fused_bwd,
                           lb.lln_diag_fused_bwd_plain,
                           lambda dt: {"qs": ((BH, N, D), torch.float32),
                                       "ks": ((BG, N, D), torch.float32),
                                       **_raw(dt), "v": ((BG, N, DV), dt),
                                       **_res(dt)},
                           [{"blk": BLK}, {"blk": BLK, "scale": 0.3}]),
    "lln_bidir_bwd": (lb.lln_bidir_bwd, lb.lln_bidir_bwd_plain,
                      lambda dt: {**_lln(dt), **_res(dt), **_state()},
                      [{}]),
    "loglin_causal": (ll.loglin_causal, ll.loglin_causal_plain, _lln,
                      [{"blk": 4, "num_scales": 3, "return_state": a}
                       for a in (False, True)]),
    "ssd": (sd.ssd, sd.ssd_plain,
            lambda dt: {"log_a": ((BH, N), torch.float32),
                        "xbar": ((BH, N, DV), torch.float32),
                        "b_in": ((BG, N, D), dt), "c_in": ((BG, N, D), dt)},
            [{"blk": BLK}]),
}


def _tensor(spec, device, gen=None):
    shape, dtype = spec
    if device == "cpu":
        # Values the plain versions take: the LLN inputs stabilized (<= 0).
        return (-torch.rand(shape, generator=gen) - 0.1).to(dtype)
    return torch.empty(shape, dtype=dtype, device=device)


def _signature(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_fake_outputs_match_the_plain_twin(name):
    wrapper, plain, inputs, variants = CASES[name]
    assert hasattr(torch.ops.repro_torch, name)
    before = wrapper.launches
    for vdt in (torch.bfloat16, torch.float32):
        specs = inputs(vdt)
        for variant in variants:
            kw = {k: v for k, v in variant.items() if not isinstance(v, tuple)}
            extra = {k: v for k, v in variant.items() if isinstance(v, tuple)}
            gen = torch.Generator().manual_seed(0)
            args = {k: _tensor(s, "cpu", gen) for k, s in specs.items()}
            targs = {k: _tensor(s, "cpu", gen) for k, s in extra.items()}
            want = _signature(plain(*args.values(), **targs, r=R, **kw))
            with FakeTensorMode():
                fargs = {k: _tensor(s, "cuda") for k, s in specs.items()}
                fextra = {k: _tensor(s, "cuda") for k, s in extra.items()}
                got = wrapper(*fargs.values(), **fextra, r=R, **kw)
                assert all(t.device.type == "cuda" for t in
                           (got if isinstance(got, tuple) else (got,)))
                got = _signature(got)
            assert got == want, (name, vdt, variant)
    assert wrapper.launches == before
