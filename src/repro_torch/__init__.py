"""PyTorch/CUDA port of the ``repro`` package (Linear Log-Normal attention).

Mirrors ``src/repro/`` module for module.  Plain tensor code is PyTorch;
each Pallas kernel of the reference is a hand-written CUDA kernel under
``csrc/`` with its plain PyTorch version beside the wrapper
(``kernels/lln_attention.py``, ``kernels/block_diag.py``).  Entry points run
on the CUDA card unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
