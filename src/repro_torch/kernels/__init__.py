"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the ops around them.  ``csrc/`` holds the CUDA sources; ``build.py``
compiles them with ``nvcc`` at first use.

The package exports the reference's public names: the ops of ``ops.py``
(autograd Functions and serving entries, dispatched by backend) and the
registry's :class:`AttnSpec`, ``BACKENDS``, ``IMPLS`` and :func:`resolve`.
"""
from .ops import (block_diag_attention, block_diag_fwd, lln_attention,
                  lln_decode_chunk, lln_diag_attention, lln_prefill,
                  ssd_scan)
from .registry import AttnSpec, BACKENDS, IMPLS, resolve

__all__ = ["lln_attention", "block_diag_attention", "block_diag_fwd",
           "lln_diag_attention", "lln_prefill", "lln_decode_chunk",
           "ssd_scan", "AttnSpec", "BACKENDS", "IMPLS", "resolve"]
