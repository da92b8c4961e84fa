"""Attention backend registry: one declarative spec, one dispatch rule.

Port of ``repro.kernels.registry`` for the serving and training paths.
The backends:

``auto``
    The hand-written CUDA kernel for a CUDA tensor, its plain PyTorch
    version for a CPU tensor.
``kernel``
    The CUDA kernel; raises for a tensor that is not on a CUDA device.
``plain``
    The kernel's plain PyTorch version (kernel layout, GQA without
    repeated KV) on any device.
``ref``
    The core reference (``core/lln.py`` / ``core/diag.py`` /
    ``core/loglinear.py``: model layout, repeated KV).

This module owns the policy (spec validation, :func:`resolve`) and the
spec-level entry points: :func:`attention` (training, from
``core/attention.py:multi_head_attention``), the engine's prefill
(:func:`prefill`, :func:`diag_fwd`, :func:`loglin_prefill`) and the
``log_linear`` decode (:func:`decode_chunk`); the ops live in
``kernels/ops.py``.  The engine's ``lln``/``lln_diag`` decode reaches
``ops.lln_decode_chunk`` through ``core/attention.py:decode_lln_chunk``,
which adds the diag tail.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

IMPLS = ("lln", "lln_diag", "log_linear")
BACKENDS = ("auto", "kernel", "plain", "ref")
PRECISIONS = ("float32", "bfloat16", "float16")


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Declarative description of one attention configuration.

    impl: ``lln`` | ``lln_diag`` (paper §4.2 hybrid) | ``log_linear``
    (the Fenwick multi-scale state, causal only); causal: the decoder
    (True) or the bidirectional encoder (False); r: GQA ratio H // G;
    backend: see the module docstring; precision: dtype name of the diag
    tails; lln_chunk: chunk of the plain causal scan (the math does not
    depend on it), and the bucket granule of ``log_linear`` (it does);
    diag_block: block size of the §4.2 diag part (it fixes which keys are
    visible); fixed_ab / beta_n / calib_len: moment-matching calibration
    (``core/moment_matching.py``); num_scales / scale_decay: the
    ``log_linear`` pyramid's levels and per-level weight decay.
    """
    impl: str = "lln"
    causal: bool = True
    r: int = 1
    backend: str = "auto"
    precision: str = "float32"
    lln_chunk: int = 128
    diag_block: int = 256
    fixed_ab: float = 0.0
    beta_n: float = 0.0
    calib_len: int = 1024
    num_scales: int = 4
    scale_decay: float = 0.5

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise NotImplementedError(
                f"attn_impl {self.impl!r} is not ported yet (the port serves "
                f"{IMPLS}); see ROADMAP.md queue 1")
        if self.backend not in BACKENDS:
            raise ValueError(f"AttnSpec.backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"AttnSpec.precision must be one of "
                             f"{PRECISIONS}, got {self.precision!r}")
        if self.r < 1:
            raise ValueError(f"AttnSpec.r must be >= 1, got {self.r}")
        for name in ("lln_chunk", "diag_block"):
            if getattr(self, name) < 1:
                raise ValueError(f"AttnSpec.{name} must be positive")
        if self.fixed_ab < 0 or self.beta_n < 0 or self.calib_len < 1:
            raise ValueError("AttnSpec: fixed_ab and beta_n must be >= 0, "
                             "calib_len positive")
        if self.num_scales < 1 or not self.scale_decay > 0:
            raise ValueError("AttnSpec: num_scales must be >= 1 and "
                             "scale_decay > 0")
        if self.impl == "log_linear" and not self.causal:
            raise ValueError("log_linear attention is causal-only (the "
                             "Fenwick bucket pyramid is a running prefix "
                             "summary)")

    @classmethod
    def from_cfg(cls, cfg, r: Optional[int] = None) -> "AttnSpec":
        """The spec an ``ArchConfig`` implies.  ``use_serve_kernel=False``
        maps to ``backend='ref'``; a drift renorm is not ported yet."""
        if cfg.lln_renorm > 0 or cfg.lln_per_row_calib:
            raise NotImplementedError(
                "lln_renorm and lln_per_row_calib are not ported yet; see "
                "ROADMAP.md queue 1")
        backend = cfg.attn_backend
        if backend == "auto" and not cfg.use_serve_kernel:
            backend = "ref"
        return cls(impl=cfg.attn_impl,
                   r=r if r is not None else cfg.n_heads // cfg.n_kv_heads,
                   backend=backend, precision=str(cfg.compute_dtype),
                   lln_chunk=cfg.lln_chunk, diag_block=cfg.diag_block,
                   fixed_ab=cfg.lln_fixed_ab, beta_n=cfg.lln_beta_n,
                   calib_len=cfg.lln_calib_len, num_scales=cfg.lln_num_scales,
                   scale_decay=cfg.lln_scale_decay)


_WARNED: set[str] = set()


def reset_deprecations() -> None:
    """Forget which deprecated entry points already warned."""
    _WARNED.clear()


def warn_deprecated(name: str, replacement: str) -> None:
    """Emit one DeprecationWarning per process for ``name``."""
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(f"{name} is deprecated; use {replacement} instead",
                  DeprecationWarning, stacklevel=3)


def resolve(backend: str, device: torch.device) -> str:
    """The implementation kind a backend runs for tensors on ``device``:
    ``"kernel"``, ``"plain"`` or ``"ref"``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "auto":
        return "kernel" if device.type == "cuda" else "plain"
    if backend == "kernel" and device.type != "cuda":
        raise RuntimeError(f"backend='kernel' needs CUDA tensors, got a "
                           f"tensor on {device}")
    return backend


def attention(spec: AttnSpec, q, k, v, alpha, beta):
    """Full-sequence LLN / LLN+Diag / log-linear attention under
    ``spec.backend``, causal or bidirectional as ``spec.causal`` (the
    training forward; gradients through ``ops``' autograd Functions, none
    for ``log_linear``)."""
    from . import ops
    if spec.impl == "log_linear":
        return ops.loglin_attention(q, k, v, alpha, beta, spec.causal,
                                    spec.lln_chunk,
                                    num_scales=spec.num_scales,
                                    scale_decay=spec.scale_decay,
                                    backend=spec.backend)
    if spec.impl == "lln":
        return ops.lln_attention(q, k, v, alpha, beta, spec.causal,
                                 spec.lln_chunk, backend=spec.backend)
    return ops.lln_diag_attention(q, k, v, alpha, beta, spec.causal,
                                  spec.diag_block, backend=spec.backend)


def prefill(spec: AttnSpec, q, k, v, alpha, beta):
    """State-emitting causal LLN prefill; returns ``(out, s, z, c_k)``."""
    from . import ops
    return ops.lln_prefill(q, k, v, alpha, beta, chunk=spec.lln_chunk,
                           backend=spec.backend)


def diag_fwd(spec: AttnSpec, q, k, v):
    """Block-diagonal softmax (the §4.2 diag part of the prefill)."""
    from . import ops
    return ops.block_diag_fwd(q, k, v, spec.diag_block, causal=True,
                              backend=spec.backend)


def loglin_prefill(spec: AttnSpec, q, k, v, alpha, beta):
    """State-emitting causal log-linear prefill; returns ``(out, s, z, c_k,
    sl, zl, cl)``: the open bucket and the Fenwick pyramid
    (``core/loglinear.py`` layout)."""
    from . import ops
    return ops.loglin_prefill(q, k, v, alpha, beta, chunk=spec.lln_chunk,
                              num_scales=spec.num_scales,
                              scale_decay=spec.scale_decay,
                              backend=spec.backend)


def decode_chunk(spec: AttnSpec, state, q, k, v, alpha, beta, *, pos):
    """Advance a ``log_linear`` ``LogLinState`` over T tokens under
    ``spec.backend``; ``pos`` (B,) is the per-row depth that fixes each
    row's bucket layout (:func:`ops.loglin_decode_chunk`).  The
    ``lln``/``lln_diag`` decode runs through
    ``core/attention.py:decode_lln_chunk``, which adds the diag tail."""
    from . import ops
    if spec.impl != "log_linear":
        raise ValueError(f"registry.decode_chunk serves log_linear, not "
                         f"{spec.impl!r}: see core/attention.py:"
                         f"decode_lln_chunk")
    return ops.loglin_decode_chunk(state, q, k, v, alpha, beta, pos=pos,
                                   granule=spec.lln_chunk,
                                   num_scales=spec.num_scales,
                                   scale_decay=spec.scale_decay,
                                   backend=spec.backend)
