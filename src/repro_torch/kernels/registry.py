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
(:func:`prefill`, :func:`diag_fwd`, :func:`loglin_prefill`,
:func:`softmax_attention`), the ``log_linear`` decode
(:func:`decode_chunk`) and the speculative commit (:func:`commit_chunk`);
the ops live in ``kernels/ops.py``.  :func:`deprecated_shim` marks the
legacy entry points.

``softmax`` has no kernel, in the reference as here, so the backends do
not choose between a kernel and its twin for it: ``ref`` runs the
quadratic oracle ``core/attention.py:naive_softmax`` and every other
backend the online softmax ``flash_softmax``, on any device.  That is the
reference's rule, not a fallback.  The engine's ``lln``/``lln_diag`` decode reaches
``ops.lln_decode_chunk`` through ``core/attention.py:decode_lln_chunk``,
which adds the diag tail.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable, Optional

import torch

IMPLS = ("softmax", "lln", "lln_diag", "log_linear")
BACKENDS = ("auto", "kernel", "plain", "ref")
PRECISIONS = ("float32", "bfloat16", "float16")
CALIBRATIONS = ("batch", "per_row")


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Declarative description of one attention configuration.

    impl: ``softmax`` | ``lln`` | ``lln_diag`` (paper §4.2 hybrid) |
    ``log_linear`` (the Fenwick multi-scale state, causal only); causal:
    the decoder (True) or the bidirectional encoder (False); r: GQA ratio
    H // G; backend: see the module docstring; precision: dtype name of
    the diag tails and the softmax KV cache; calibration: ``batch`` pools
    the moment-matching statistics over the batch, ``per_row`` measures
    each row alone (alpha (B, H), beta (B, G)); lln_chunk: chunk of the plain
    causal scan (the math does not depend on it), and the bucket granule
    of ``log_linear`` (it does); diag_block: block size of the §4.2 diag
    part (it fixes which keys are visible); softmax_chunk: key chunk of
    the online softmax (the math does not depend on it); fixed_ab / beta_n
    / calib_len: moment-matching calibration
    (``core/moment_matching.py``); renorm: the decode's drift-renorm
    threshold on ``max_d z`` (0 = off; ``core/lln.py:decode_chunk``);
    num_scales / scale_decay: the ``log_linear`` pyramid's levels and
    per-level weight decay.
    """
    impl: str = "lln"
    causal: bool = True
    r: int = 1
    backend: str = "auto"
    precision: str = "float32"
    calibration: str = "batch"
    lln_chunk: int = 128
    diag_block: int = 256
    softmax_chunk: int = 1024
    fixed_ab: float = 0.0
    beta_n: float = 0.0
    calib_len: int = 1024
    renorm: float = 0.0
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
        if self.calibration not in CALIBRATIONS:
            raise ValueError(f"AttnSpec.calibration must be one of "
                             f"{CALIBRATIONS}, got {self.calibration!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"AttnSpec.precision must be one of "
                             f"{PRECISIONS}, got {self.precision!r}")
        if self.r < 1:
            raise ValueError(f"AttnSpec.r must be >= 1, got {self.r}")
        for name in ("lln_chunk", "diag_block", "softmax_chunk"):
            if getattr(self, name) < 1:
                raise ValueError(f"AttnSpec.{name} must be positive")
        if self.fixed_ab < 0 or self.beta_n < 0 or self.renorm < 0 \
                or self.calib_len < 1:
            raise ValueError("AttnSpec: fixed_ab, beta_n and renorm must be "
                             ">= 0, calib_len positive")
        if self.num_scales < 1 or not self.scale_decay > 0:
            raise ValueError("AttnSpec: num_scales must be >= 1 and "
                             "scale_decay > 0")
        if self.impl == "log_linear" and not self.causal:
            raise ValueError("log_linear attention is causal-only (the "
                             "Fenwick bucket pyramid is a running prefix "
                             "summary)")

    @classmethod
    def from_cfg(cls, cfg, causal: bool = True,
                 r: Optional[int] = None) -> "AttnSpec":
        """The spec an ``ArchConfig`` implies.  ``use_serve_kernel=False``
        maps to ``backend='ref'``; ``lln_per_row_calib`` to the ``per_row``
        calibration and ``lln_renorm`` to the drift-renorm threshold.
        ``r`` overrides the GQA ratio (MLA runs full heads whatever
        ``cfg.n_kv_heads`` says)."""
        backend = cfg.attn_backend
        if backend == "auto" and not cfg.use_serve_kernel:
            backend = "ref"
        return cls(impl=cfg.attn_impl, causal=causal,
                   r=r if r is not None else cfg.n_heads // cfg.n_kv_heads,
                   backend=backend, precision=str(cfg.compute_dtype),
                   calibration=("per_row" if cfg.lln_per_row_calib
                                else "batch"),
                   lln_chunk=cfg.lln_chunk, diag_block=cfg.diag_block,
                   softmax_chunk=cfg.softmax_chunk,
                   fixed_ab=cfg.lln_fixed_ab, beta_n=cfg.lln_beta_n,
                   calib_len=cfg.lln_calib_len, renorm=cfg.lln_renorm,
                   num_scales=cfg.lln_num_scales,
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


def deprecated_shim(name: str, replacement: str) -> Callable:
    """Decorator marking a legacy entry point: it warns once
    (:func:`warn_deprecated`), then delegates to the wrapped function,
    whose signature and return value it keeps.  The wrapper carries
    ``__deprecated_shim__ = (name, replacement)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            warn_deprecated(name, replacement)
            return fn(*args, **kwargs)
        wrapper.__deprecated_shim__ = (name, replacement)
        return wrapper
    return deco


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
    training forward; gradients through ``ops``' autograd Functions, and
    for ``log_linear`` through autograd of its plain and ``ref`` kinds, none
    on its kernel)."""
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


def softmax_attention(spec: AttnSpec, q, k, v, *, mask=None,
                      prefix_len: int = 0):
    """Softmax over the prompt under ``spec.causal``: ``naive_softmax`` for
    backend ``ref``, ``flash_softmax`` (key chunks of
    ``min(spec.softmax_chunk, N)``) for every other backend (see the module
    docstring).  ``mask`` (B, N) key validity; ``prefix_len`` the
    prefix-LM mask (keys below it visible to every query)."""
    from repro_torch.core import attention as ca
    if spec.backend == "ref":
        return ca.naive_softmax(q, k, v, causal=spec.causal, mask=mask,
                                prefix_len=prefix_len)
    return ca.flash_softmax(q, k, v, causal=spec.causal,
                            chunk=min(spec.softmax_chunk, k.shape[1]),
                            mask=mask, prefix_len=prefix_len)


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


def decode_chunk(spec: AttnSpec, state, q, k, v, alpha, beta, *, pos,
                 row_mask=None, commit_len=None):
    """Advance a ``log_linear`` ``LogLinState`` over T tokens under
    ``spec.backend``; ``pos`` (B,) is the per-row depth that fixes each
    row's bucket layout (:func:`ops.loglin_decode_chunk`); ``row_mask`` /
    ``commit_len`` the serving contract, ``spec.renorm`` its drift
    renorm.  The
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
                                   backend=spec.backend, row_mask=row_mask,
                                   commit_len=commit_len,
                                   renorm=spec.renorm or None)


def commit_chunk(spec: AttnSpec, state, k, v, beta, row_mask=None,
                 commit_len=None, pos=None):
    """Fold a scored chunk's accepted prefix into an ``LLNState`` (or, for
    ``log_linear``, a ``LogLinState`` at the per-row depth ``pos``) under
    ``spec.backend``, without scoring: the speculative verify's commit
    (``ops.lln_commit_chunk`` / ``ops.loglin_commit_chunk``), with
    ``spec.renorm``'s drift renorm."""
    from . import ops
    if spec.impl == "log_linear":
        return ops.loglin_commit_chunk(state, k, v, beta, pos=pos,
                                       granule=spec.lln_chunk,
                                       num_scales=spec.num_scales,
                                       backend=spec.backend,
                                       row_mask=row_mask,
                                       commit_len=commit_len,
                                       renorm=spec.renorm or None)
    return ops.lln_commit_chunk(state, k, v, beta, backend=spec.backend,
                                row_mask=row_mask, commit_len=commit_len,
                                renorm=spec.renorm or None)
