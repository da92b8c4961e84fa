#!/usr/bin/env python3
"""Serve decode of this checkout and of another tree of the repository, in
turns (other, this, this, other), on one CUDA card.

Run from the repository root:

    python3 tools/serve_ab.py OTHER_TREE

``OTHER_TREE`` is a checkout of another commit, e.g. unpacked with ``git
archive`` into a git-ignored directory.  Each turn is a fresh process in
that tree running its ``chip_smoke.py`` serve phases (``phase_serve`` and
``phase_serve_loglin``: yi-9b at full width and depth, bf16 weights from a
seed, batch 4; ``lln`` and ``lln_diag`` at prompt 512, ``log_linear`` at
prompt 2040; their own checks and launch counts), which build that tree's
kernels.  Prints one JSON line per turn, each impl's decode ms per step on
the host clock and on the device (``torch.profiler``), then the card's name
and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TURN = """
import collections, json, chip_smoke as c
c.phase_device()
c.phase_build()
launches, times = collections.defaultdict(int), {}
c.phase_serve(launches, times)
c.phase_serve_loglin(launches, times)
print("SERVE_AB " + json.dumps({
    impl: {key: t[key] for key in ("decode_ms_per_step",
                                   "decode_device_ms_per_step")}
    for impl, t in times.items()}))
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[0]).resolve()
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        res = subprocess.run([sys.executable, "-c", TURN], cwd=tree,
                             capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("SERVE_AB ")]
        if res.returncode or not lines:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps({"turn": label, "tree": str(tree),
                          **json.loads(lines[-1][len("SERVE_AB "):])}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
