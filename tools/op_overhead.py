#!/usr/bin/env python3
"""Host cost of the kernels' custom ops on one CUDA card: each kernel
wrapper's CUDA branch goes through the dispatcher as a ``torch.library``
custom op (``repro_torch::<wrapper>``); this times the host side of a
launch through the op against the op's own Python body called directly
(the launch code as it was before the ops), on the same inputs.

    python3 tools/op_overhead.py

``lln_decode`` at yi-9b's decode shape (B=4, H=32, G=4, D=Dv=128, T=1,
bf16 v, with ``scale``) and ``block_diag`` at its prefill shape (N=512,
blk 256): CALLS launches per timed run, host clock to the last enqueue
(then a synchronise, outside the time), median of REPEATS runs, in turns
(body, op, op, body).  Prints one JSON line of microseconds per launch,
then the card's name and power limit.
"""
from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

CALLS, REPEATS = 2000, 7


def _host_us(fn, args) -> float:
    runs = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn(*args)
        runs.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def main() -> int:
    la = importlib.import_module("repro_torch.kernels.lln_attention")
    from repro_torch.kernels import block_diag as bd
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return (-torch.rand(shape, generator=g, device=dev)).to(dtype)
    b, h, kv, d, n = 4, 32, 4, 128, 512
    cases = {
        "lln_decode": (la._lln_decode_op, (
            rand(b * h, 1, d), rand(b * kv, 1, d),
            rand(b * kv, 1, d, dtype=torch.bfloat16), rand(b * h, d, d),
            rand(b * h, 1, d), rand(b * h), h // kv)),
        "block_diag": (bd._block_diag_op, (
            rand(b * h, n, d, dtype=torch.bfloat16),
            rand(b * kv, n, d, dtype=torch.bfloat16),
            rand(b * kv, n, d, dtype=torch.bfloat16), h // kv, 256, True)),
    }
    out = {}
    for name, (op, args) in cases.items():
        body = op._init_fn
        op(*args)                                    # build and load
        turns = [("body", body), ("op", op), ("op", op), ("body", body)]
        got = {"body": [], "op": []}
        for label, fn in turns:
            got[label].append(_host_us(fn, args))
        out[name] = {"op_us": statistics.mean(got["op"]),
                     "body_us": statistics.mean(got["body"]),
                     "turns_us": got}
        out[name]["added_us"] = out[name]["op_us"] - out[name]["body_us"]
    print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
