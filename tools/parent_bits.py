#!/usr/bin/env python3
"""Hold the kernels of this checkout bit for bit to another build of their
CUDA sources, in one process on one CUDA card.

Run from the repository root:

    python3 tools/parent_bits.py OTHER_CSRC [--only lib,lib]

``OTHER_CSRC`` is another tree's ``src/repro_torch/csrc`` (e.g. the parent
commit's, unpacked with ``git archive`` into a git-ignored directory).
Every library of ``kernels/build.py`` that both trees have is compiled
from it by ``nvcc`` with this checkout's flags, one process per source,
all at once, and loaded under the entries of ``build.SIGNATURES`` that it
exports (the C interface must be this checkout's).  Each case calls this
checkout's wrapper twice, once on its own library and once with the other
build swapped into ``build._libs``, on the same seeded inputs, and asserts
that every output is bitwise equal.  The cases are the bf16 paths with D,
Dv <= 128 of rows 1, 2, 4-7, 9-11 (their tensor cores), at yi-9b's heads
(r 8, D = Dv = 128) and a narrow one (r 4, D = 64, Dv = 112), N 512 and a
ragged 300 (blk 60 where N % blk must be 0).  Prints one line per case
and then the card's name and power limit; exits 1 on a difference.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.block_diag import block_diag  # noqa: E402
from repro_torch.kernels.lln_attention import (lln_bidir,  # noqa: E402
                                               lln_causal, lln_diag_fused)
from repro_torch.kernels.lln_backward import (lln_bidir_bwd,  # noqa: E402
                                              lln_causal_bwd,
                                              lln_diag_fused_bwd)
from repro_torch.kernels.loglinear import loglin_causal  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402


def load_other(csrc: Path, names, out_dir: Path) -> dict:
    """Compile ``csrc/<name>.cu`` for every name at once; the loaded
    libraries by name."""
    procs = {}
    for name in names:
        lib = out_dir / f"libother_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
             "d": ctypes.c_double}
    libs = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        lib = ctypes.CDLL(str(path))
        for fn_name, sig in build.SIGNATURES[name].items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.argtypes = [kinds[c] for c in sig]
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def cases(gen):
    """(label, library, fn) with every input made from ``gen``."""
    dev = "cuda"

    def f(*shape, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) + shift

    out = []
    for r, d, dv in ((8, 128, 128), (4, 64, 112)):
        for n in (512, 300):
            bh, bg = 2 * r, 2
            qs, ks = f(bh, n, d, shift=-0.5), f(bg, n, d, shift=-0.5)
            q, k = f(bh, n, d).bfloat16(), f(bg, n, d).bfloat16()
            v, g = f(bg, n, dv).bfloat16(), f(bh, n, dv).bfloat16()
            tag = f"r{r} D={d} Dv={dv} N={n}"
            out += [
                (f"lln_causal state {tag}", "lln_causal",
                 lambda qs=qs, ks=ks, v=v, r=r: lln_causal(qs, ks, v, r=r)),
                (f"lln_causal res {tag}", "lln_causal",
                 lambda qs=qs, ks=ks, v=v, r=r: lln_causal(
                     qs, ks, v, r=r, return_res=True, return_state=False)),
                (f"block_diag causal {tag}", "block_diag",
                 lambda q=q, k=k, v=v, r=r: (block_diag(
                     q, k, v, r=r, blk=256, causal=True),)),
                (f"block_diag non-causal {tag} blk 64", "block_diag",
                 lambda q=q, k=k, v=v, r=r: (block_diag(
                     q, k, v, r=r, blk=64, causal=False),)),
                (f"lln_bidir {tag}", "lln_bidir",
                 lambda qs=qs, ks=ks, v=v, r=r: lln_bidir(
                     qs, ks, v, r=r, return_res=True)),
                (f"loglin_causal {tag}", "loglin_causal",
                 lambda qs=qs, ks=ks, v=v, r=r: loglin_causal(
                     qs, ks, v, r=r, return_state=True)),
            ]
            blks = (256, 64) if n % 256 == 0 else (60,)
            o, den = lln_causal(qs, ks, v, r=r, return_res=True,
                                return_state=False)
            out.append((f"lln_causal_bwd {tag}", "lln_causal_bwd",
                        lambda qs=qs, ks=ks, v=v, g=g, o=o, den=den, r=r,
                        blk=blks[0]: lln_causal_bwd(qs, ks, v, g, o, den,
                                                    r=r, blk=blk)))
            bo, s_, z_, bden = lln_bidir(qs, ks, v, r=r, return_res=True)
            out.append((f"lln_bidir_bwd {tag}", "lln_bidir_bwd",
                        lambda qs=qs, ks=ks, v=v, g=g, o=bo, den=bden, s=s_,
                        z=z_, r=r: lln_bidir_bwd(qs, ks, v, g, o, den, s, z,
                                                 r=r)))
            for blk in blks:
                out.append((f"lln_diag_fused {tag} blk {blk}",
                            "lln_diag_fused",
                            lambda qs=qs, ks=ks, q=q, k=k, v=v, r=r, blk=blk:
                            lln_diag_fused(qs, ks, q, k, v, r=r, blk=blk,
                                           return_res=True)))
                fo, fden = lln_diag_fused(qs, ks, q, k, v, r=r, blk=blk,
                                          return_res=True)
                out.append((f"lln_diag_fused_bwd {tag} blk {blk}",
                            "lln_diag_fused_bwd",
                            lambda qs=qs, ks=ks, q=q, k=k, v=v, g=g, o=fo,
                            den=fden, r=r, blk=blk: lln_diag_fused_bwd(
                                qs, ks, q, k, v, g, o, den, r=r, blk=blk)))
    b, h, n, p, s = 2, 24, 512, 64, 128
    dt = torch.nn.functional.softplus(f(b, h, n) * 0.5 - 0.5)
    log_a = (dt * -torch.linspace(1.0, 16.0, h, device=dev)[None, :, None]
             ).reshape(b * h, n).contiguous()
    xbar = (f(b * h, n, p) * dt.reshape(b * h, n, 1)).contiguous()
    bi, ci = f(b, n, s).bfloat16(), f(b, n, s).bfloat16()
    out.append((f"ssd r{h} N={n} P={p} S={s}", "ssd",
                lambda: ssd(log_a, xbar, bi, ci, r=h, blk=256)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--only", default="",
                    help="comma-separated libraries (default: every case)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("parent_bits: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    todo = [c for c in cases(gen)
            if not args.only or c[1] in args.only.split(",")]
    names = sorted({c[1] for c in todo})
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        other = load_other(args.other.resolve(), names, Path(tmp))
        for label, name, fn in todo:
            mine = build.library(name)
            got = [t.clone() for t in fn()]
            build._libs[name] = other[name]
            try:
                want = [t.clone() for t in fn()]
            finally:
                build._libs[name] = mine
            torch.cuda.synchronize()
            same = len(got) == len(want) and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(got, want))
            failed += not same
            print(f"{'bitwise equal' if same else 'DIFFERENT'}: {label} "
                  f"({len(got)} outputs)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"parent_bits: {len(todo) - failed} of {len(todo)} cases bitwise "
          "equal")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
