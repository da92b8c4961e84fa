"""Training command-line entry point of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \
      --attn-impl lln_diag --steps 50 --seq 128 --batch 8 --device cpu

Takes the reference CLI's flags (``python -m repro.launch.train``) plus
``--device`` (the CUDA card by default): a host-sharded, prefetched
``lm_batches`` stream (``mlm_batches`` for the encoder family, e.g.
``--arch roberta-lln``), the straggler watchdog and the same printed
lines.
As in the reference, the attention kernels are reached only with
``use_kernel=True`` in the config (``get_config(..., use_kernel=True)``);
the CLI leaves it at its default, so it trains through the core scan.
Meshes, checkpointing and the ``softmax`` impl are not ported yet and
raise ``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import HostShardedSource, Prefetcher, torch_placer
from repro_torch.data.synthetic import lm_batches, mlm_batches
from repro_torch.distributed.straggler import StepWatchdog
from repro_torch.launch.steps import make_train_setup

# What each unported option waits for (ROADMAP.md, queue 1).
_NOT_PORTED = {
    "mesh": "meshes and sharding (ROADMAP.md queue 1, item 12)",
    "ckpt": "checkpoint/ (ROADMAP.md queue 1, item 7)",
    "softmax": "the softmax impl (ROADMAP.md queue 1, 'left out of the "
               "first slice', item 1)",
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced config")
    ap.add_argument("--attn-impl", default=None,
                    choices=[None, "softmax", "lln", "lln_diag"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1,1",
                    help="data,model mesh sizes (only 1,1 is ported)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.mesh != "1,1":
        raise NotImplementedError(f"--mesh is not ported yet: "
                                  f"{_NOT_PORTED['mesh']}")
    if args.ckpt_dir:
        raise NotImplementedError(f"--ckpt-dir is not ported yet: "
                                  f"{_NOT_PORTED['ckpt']}")
    overrides = {}
    if args.attn_impl:
        overrides["attn_impl"] = args.attn_impl
    cfg = get_config(args.arch, smoke=args.smoke, **overrides)
    if cfg.attn_impl == "softmax":
        raise NotImplementedError(f"attn_impl 'softmax' is not ported yet: "
                                  f"{_NOT_PORTED['softmax']}")

    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    setup = make_train_setup(cfg, shape, device=args.device,
                             peak_lr=args.lr, total_steps=args.steps)
    state = setup.init_state(args.seed)

    batches = mlm_batches if cfg.family == "encoder" else lm_batches
    source = HostShardedSource(
        lambda b, s: batches(cfg.vocab, b, args.seq, seed=s), args.batch)
    pipe = Prefetcher(source, place=torch_placer(setup.device))
    watchdog = StepWatchdog(
        on_anomaly=lambda r: print(f"[straggler] step {r.step} took "
                                   f"{r.duration:.2f}s ({r.ratio:.1f}x)"))
    history = []
    t_start = time.time()
    try:
        for step in range(args.steps):
            batch = next(pipe)
            watchdog.start()
            state, metrics = setup.step_fn(state, batch)
            loss = float(metrics["loss"])
            watchdog.stop(step)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d}  loss {loss:8.4f}  "
                      f"gnorm {float(metrics['grad_norm']):7.3f}  "
                      f"lr {float(metrics['lr']):.2e}", flush=True)
            history.append({"step": step, "loss": loss})
    finally:
        pipe.close()
    dt = time.time() - t_start
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps / max(dt, 1e-9):.2f} it/s); "
          f"{len(watchdog.anomalies)} straggler events")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return history


if __name__ == "__main__":
    main()
