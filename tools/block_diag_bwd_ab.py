#!/usr/bin/env python3
"""Time ``block_diag_bwd`` of this checkout against another build of its
CUDA source, in one process on one CUDA card.

Run from the repository root:

    python3 tools/block_diag_bwd_ab.py OTHER.cu

``OTHER.cu`` is compiled by ``nvcc`` with the flags of
``kernels/build.py`` (its includes resolve from its own directory, so
unpack a whole ``csrc/``, e.g. the parent commit's with ``git archive``,
into a git-ignored directory); its entry ``block_diag_bwd_launch`` takes
this checkout's arguments.  Two shapes, bf16: the encoder's (B=32, H=G=12,
N=512, D=Dv=64, blk 256, not causal) and chatglm3-6b's attention at r = 16
(B=4, H=32, G=2, N=512, D=Dv=128, blk 256, causal).  For each, both
builds' times by ``chip_smoke.cuda_ms`` (CUDA events, 64 MB L2 flush,
median of 25) in turns this, other, other, this, and each build's largest
error in dq, dk and dv against ``block_diag_bwd_plain`` over 1e-5 of the
largest plain entry (the gate: at most 1).  Prints one JSON line per
shape, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.block_diag import (block_diag_bwd,  # noqa: E402
                                            block_diag_bwd_plain)

# (label, B, H, G, N, D, causal)
SHAPES = (("encoder r=1", cs.EB, cs.EH, cs.EH, cs.EN, cs.ED, False),
          ("chatglm3-6b r=16", 4, 32, 2, 512, 128, True))


def load_other(src: Path, out_dir: Path):
    lib_path = out_dir / "libother_block_diag_bwd.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                          str(lib_path), str(src)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(lib_path)).block_diag_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("block_diag_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        other = load_other(args.other.resolve(), Path(tmp))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED + 27)
        for label, b, h, g_, n, d, causal in SHAPES:
            bh, bg = b * h, b * g_
            mk = lambda rows: torch.randn(  # noqa: E731
                rows, n, d, generator=gen, device="cuda").bfloat16()
            q, k, v, g = mk(bh), mk(bg), mk(bg), mk(bh)
            r = h // g_

            def run_other():
                out = [torch.empty(x.shape, device="cuda")
                       for x in (q, k, v)]
                stats = torch.empty(3, bh, n, device="cuda")
                err = other(*(x.data_ptr() for x in (q, k, v, g, *out,
                                                     stats)),
                            bh, bg, n, d, d, cs.BLK, int(causal), 1,
                            d ** -0.5,
                            torch.cuda.current_stream().cuda_stream)
                build.check(err, "other block_diag_bwd")
                return out

            fns = {"this": lambda: block_diag_bwd(q, k, v, g, r=r,
                                                  blk=cs.BLK, causal=causal),
                   "other": run_other}
            want = block_diag_bwd_plain(q, k, v, g, r=r, blk=cs.BLK,
                                        causal=causal)
            row = {"shape": label, "gate_ratio": {}, "ms": {}}
            for name, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                row["gate_ratio"][name] = [
                    cs.max_err(x, y) / cs.fp32_tol(y)
                    for x, y in zip(got, want)]
            for name in ("this", "other", "other", "this"):
                row["ms"].setdefault(name, []).append(cs.cuda_ms(fns[name]))
            print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
