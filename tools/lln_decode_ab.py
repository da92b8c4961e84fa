#!/usr/bin/env python3
"""Time ``lln_decode`` of this checkout against another build of its CUDA
source, in one process on one CUDA card.

Run from the repository root:

    python3 tools/lln_decode_ab.py OTHER.cu --abi parent
    python3 tools/lln_decode_ab.py OTHER.cu --abi current --arg 2 --arg 4

``OTHER.cu`` is compiled by ``nvcc`` with the flags of
``kernels/build.py`` (its includes resolve from its own directory, so
unpack a whole ``csrc/``, e.g. an earlier commit's with ``git archive``,
into a git-ignored directory).  ``--abi parent``: the decode entry from
before the state's rescale moved into the kernel,
``lln_decode_launch(qs, ks, v, s0, z0, out, s1, z1, bh, bg, t, d, dv,
v_dtype, stream)``, timed alone and after the torch rescale of ``s`` and
``z`` that ``ops.lln_decode_chunk`` ran before it.  ``--abi current``: this
checkout's entry; each ``--arg`` is passed as its last int (the value
columns per CTA here; another build may read it otherwise).

At the serve shape (B=4, H=32, G=4, D=Dv=128, bf16 v, a (BH,) rescale
factor) and T = 1, 4, 16 and 64: this checkout's kernel at the route
``_decode_columns`` picks and at 32, 64 and 128 columns, the other build,
the torch rescale pass, a device copy of ``s`` and a one-element add, each
by ``chip_smoke.cuda_ms`` (CUDA events, 64 MB L2 flush, median of 25) in
turns A B B A; the profiler's device time per launch of this kernel and
the copy; and each result's max abs error against ``lln_decode_plain``.
Prints one JSON line per T, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

ABIS = {"parent": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6,
        "current": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7}


def load_other(src: Path, abi: str, out_dir: Path):
    lib_path = out_dir / "libother_decode.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                          str(lib_path), str(src)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(lib_path)).lln_decode_launch
    fn.argtypes = ABIS[abi] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--abi", choices=sorted(ABIS), required=True)
    ap.add_argument("--arg", type=int, action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lln_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    lla = importlib.import_module("repro_torch.kernels.lln_attention")
    with tempfile.TemporaryDirectory() as tmp:
        other = load_other(args.other.resolve(), args.abi, Path(tmp))
        b, h, g, d = cs.B, cs.H, cs.G, cs.D
        bh, bg, r = b * h, b * g, h // g
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED + 2)
        s = torch.randn(bh, d, d, generator=gen, device="cuda")
        z = torch.rand(bh, 1, d, generator=gen, device="cuda") + 0.5
        f = torch.exp(-torch.rand(bh, generator=gen, device="cuda"))
        chosen = lla._decode_columns

        def rescale():
            return s * f[:, None, None], z * f[:, None, None]

        for t in (1, 4, 16, 64):
            q, k, v, a, bb = cs._inputs(t, gen)
            qs, ks, _ = ops._scaled_stabilized(q, k, a, bb)
            vk = ops._to_kernel(v)
            stream = torch.cuda.current_stream().cuda_stream

            def run_other(extra, s0=s, z0=z, scaled=True):
                out = torch.empty(bh, t, d, dtype=vk.dtype, device="cuda")
                s1, z1 = torch.empty_like(s), torch.empty_like(z)
                ptrs = [qs, ks, vk, s0, z0]
                if args.abi == "current":
                    ptrs.append(f if scaled else None)
                ptrs += [out, s1, z1]
                err = other(*(p.data_ptr() if p is not None else None
                              for p in ptrs), bh, bg, t, d, d, 1, *extra,
                            stream)
                build.check(err, "other lln_decode")
                return out, s1, z1

            def run_cols(cols):
                lla._decode_columns = (lambda t, d: cols) if cols else chosen
                try:
                    return lla.lln_decode(qs, ks, vk, s, z, r=r, scale=f)
                finally:
                    lla._decode_columns = chosen

            fns = {"this": lambda: run_cols(None)}
            for cols in (32, 64, 128):
                fns[f"this cols={cols}"] = lambda c=cols: run_cols(c)
            if args.abi == "parent":
                fns["other"] = lambda: run_other([], *rescale(), scaled=False)
                pre = rescale()
                fns["other (state rescaled before)"] = lambda: run_other(
                    [], *pre, scaled=False)
            else:
                for x in args.arg:
                    fns[f"other arg={x}"] = lambda x=x: run_other([x])
            fns["torch rescale"] = rescale
            # Yardsticks: a device copy of s (the kernel's bytes: s read
            # once, s1 written once) and a one-element add (the floor of
            # cuda_ms for any launch).
            dst, one = torch.empty_like(s), torch.zeros(1, device="cuda")
            fns["copy of s"] = lambda: dst.copy_(s)
            fns["one-element add"] = lambda: one.add_(1)
            want = lla.lln_decode_plain(qs, ks, vk, s, z, r=r, scale=f)
            row = {"T": t, "cols": chosen(t, d), "max_abs_err": {}, "ms": {}}
            for name, fn in fns.items():
                if name.startswith(("this", "other")):
                    got = fn()
                    torch.cuda.synchronize()
                    row["max_abs_err"][name] = [cs.max_err(x, y)
                                                for x, y in zip(got, want)]
            names = list(fns)
            for turn in (names, names[::-1]):
                for name in turn:
                    row["ms"].setdefault(name, []).append(cs.cuda_ms(fns[name]))
            # The profiler's device time per launch (no event overhead),
            # the 64 MB flush before each of 20 calls.
            flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
            for name in ("this", "copy of s"):
                def run(fn=fns[name]):
                    for _ in range(20):
                        flush.zero_()
                        fn()
                _, top = cs.device_profile(run)
                row.setdefault("device_ms", {})[name] = [
                    (k[:60], ms / n) for k, ms, n in top if n == 20
                    and "Fill" not in k]
            print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
