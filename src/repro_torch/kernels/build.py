"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, at first use, into
``build/`` at the repository root.  The file name carries a hash of the
sources and flags, so an edited kernel is rebuilt and a stale library is
never loaded.  :func:`build_all` starts one ``nvcc`` per source at once.
Libraries are loaded with ``ctypes``: pointers and the stream travel as
``c_void_p``, ints as ``c_int``, floats as ``c_float`` or ``c_double``,
and every entry returns its ``cudaGetLastError()``.

Nothing here runs at import time: the CPU tests import this module on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# Every entry point: (argument kinds) with "p" a pointer, "i" an int, "f" a
# float, "d" a double.
SIGNATURES = {
    "lln_causal": {"lln_causal_launch": "ppppppp" + "iiiiiiii" + "p",
                   "lln_causal_tc_launch": "p" * 10 + "i" * 6 + "p"},
    "block_diag": {"block_diag_launch": "pppp" + "iiiiiiiii" + "f" + "p",
                   "block_diag_tc_attrs": "iip"},
    "lln_decode": {"lln_decode_launch": "p" * 9 + "i" * 7 + "p"},
    "lln_diag_fused": {"lln_diag_fused_launch":
                       "ppppppp" + "iiiiiiii" + "f" + "p",
                       "lln_diag_fused_tc_launch":
                       "p" * 11 + "i" * 6 + "f" + "p",
                       "lln_diag_fused_tc_attrs": "iip"},
    "lln_causal_bwd": {"lln_causal_bwd_launch": "p" * 10 + "i" * 9 + "p",
                       "lln_causal_bwd_tc_launch": "p" * 16 + "i" * 6 + "p",
                       "lln_causal_bwd_tc_attrs": "iip"},
    "lln_diag_fused_bwd": {"lln_diag_fused_bwd_launch":
                           "p" * 14 + "i" * 9 + "f" + "p",
                           "lln_diag_fused_bwd_tc_launch":
                           "p" * 20 + "i" * 6 + "f" + "p",
                           "lln_diag_fused_bwd_tc_attrs": "iip"},
    "lln_bidir": {"lln_bidir_launch": "ppppppp" + "iiiiii" + "p",
                  "lln_bidir_tc_launch": "p" * 7 + "i" * 5 + "p"},
    "lln_bidir_bwd": {"lln_bidir_bwd_launch": "p" * 14 + "i" * 6 + "p",
                      "lln_bidir_bwd_tc_launch": "p" * 14 + "i" * 5 + "p"},
    "block_diag_bwd": {"block_diag_bwd_launch":
                       "p" * 8 + "i" * 8 + "f" + "p"},
    "loglin_causal": {"loglin_causal_launch": "p" * 8 + "i" * 10 + "d" + "p",
                      "loglin_causal_tc_launch":
                      "p" * 11 + "i" * 7 + "d" + "p"},
    "ssd": {"ssd_launch": "p" * 5 + "i" * 7 + "p",
            "ssd_tc_launch": "p" * 8 + "i" * 6 + "p"},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return str(path)


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp path, target)
    or None when the library is already built."""
    target = _library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)


def build_all() -> None:
    """Compile every kernel library that is not built yet, one ``nvcc``
    process per source, all started together."""
    with _lock:
        started = {name: _start(name) for name in SIGNATURES}
        errors = []
        for name, st in started.items():
            try:
                _finish(name, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_library_path(name)))
            kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                     "f": ctypes.c_float, "d": ctypes.c_double}
            for fn_name, sig in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = [kinds[c] for c in sig]
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


# The cudaError_t codes a launch here can return, by name.
_CUDA_ERRORS = {
    1: "cudaErrorInvalidValue: an argument out of range, e.g. more dynamic "
       "shared memory than a block may opt into",
    2: "cudaErrorMemoryAllocation",
    9: "cudaErrorInvalidConfiguration: a grid or block of a size the card "
       "does not take",
    98: "cudaErrorInvalidDeviceFunction",
    209: "cudaErrorNoKernelImageForDevice",
    700: "cudaErrorIllegalAddress",
}


def tc_attrs(name: str, d: int, dv: int) -> list[dict]:
    """The tensor-core kernels library ``name`` launches for bf16 inputs at
    head widths ``(d, dv)`` (``block_diag`` and ``lln_diag_fused``: one;
    ``lln_causal_bwd`` and ``lln_diag_fused_bwd``: their dq and dk/dv
    kernels), each as registers and local (spill) bytes a thread, CTAs per
    SM and dynamic shared bytes, from the CUDA runtime
    (``cudaFuncGetAttributes`` and the occupancy calculator)."""
    kernels = {"block_diag": ("block_diag_tc_kernel",),
               "lln_diag_fused": ("fused_tc_kernel",),
               "lln_causal_bwd": ("dq_tc_kernel", "dkv_tc_kernel"),
               "lln_diag_fused_bwd": ("dq_tc_kernel", "dkv_tc_kernel")}[name]
    out = (ctypes.c_int * (4 * len(kernels)))()
    check(getattr(library(name), f"{name}_tc_attrs")(d, dv,
                                                     ctypes.addressof(out)),
          f"{name}_tc_attrs")
    keys = ("registers", "local_bytes", "ctas_per_sm", "smem_bytes")
    return [dict(kernel=k, **dict(zip(keys, out[4 * i:4 * i + 4])))
            for i, k in enumerate(kernels)]


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        name = _CUDA_ERRORS.get(err, "see the CUDA runtime's cudaError_t")
        raise RuntimeError(f"{what} failed to launch: cudaError_t {err} "
                           f"({name})")
