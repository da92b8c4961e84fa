"""Training command-line entry point of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \
      --attn-impl lln_diag --steps 50 --seq 128 --batch 8 --device cpu

Takes the reference CLI's flags (``python -m repro.launch.train``) plus
``--device`` (the CUDA card by default): a host-sharded, prefetched
``lm_batches`` stream (``mlm_batches`` for the encoder family, e.g.
``--arch roberta-lln``; ``lm_batches`` for ``--arch mamba2-130m``,
``--arch zamba2-7b`` and the MoE decoders; ``synthetic_batch``'s frames or
patches beside the tokens for ``--arch seamless-m4t-medium`` and
``--arch paligemma-3b``), the straggler watchdog and the same printed
lines.
As in the reference, the attention and SSD kernels are reached only with
``use_kernel=True`` in the config (``get_config(..., use_kernel=True)``);
the CLI leaves it at its default, so it trains through the core scans.
``--attn-impl`` takes ``softmax`` (every config's default), ``lln`` and
``lln_diag``.  ``--ckpt-dir`` restores or initializes ``{"params",
"opt"}`` through ``CheckpointManager``, starts the data stream at the
restored step, saves every ``--ckpt-interval`` steps on a thread and
once more at the end.  Its step labels are the reference's: the state
saved under label ``step`` is the state after step ``step`` has run, and
a resume from it starts at ``step`` (so step ``step`` runs twice; a quirk
of the reference, kept).

``--mesh d,m`` trains every family on a (data, model) DeviceMesh, one process per device under ``torchrun`` (NCCL on the card,
gloo with ``--device cpu``):

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch yi-9b --smoke --attn-impl lln_diag --mesh 2,2 --device cpu

Every rank draws the whole global batch (the meshless run's rows) and
keeps its slice; the state is sharded by ``param_shardings`` and a
``--ckpt-dir`` restore places it with the mesh's shardings.  Rank 0
prints and writes.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import (HostShardedSource, Prefetcher, device_placer,
                              torch_placer)
from repro_torch.data.synthetic import lm_batches, mlm_batches
from repro_torch.models import synthetic_batch
from repro_torch.distributed.straggler import StepWatchdog
from repro_torch.launch.mesh import is_main_rank, mesh_from_flag
from repro_torch.launch.steps import batch_struct, make_train_setup


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
                    help="data,model mesh sizes (1,1: no mesh; otherwise "
                    "one process per device under torchrun)")
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
    overrides = {}
    if args.attn_impl:
        overrides["attn_impl"] = args.attn_impl
    cfg = get_config(args.arch, smoke=args.smoke, **overrides)
    mesh = mesh_from_flag(args.mesh, cfg, args.device)

    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    setup = make_train_setup(cfg, shape, device=args.device,
                             peak_lr=args.lr, total_steps=args.steps,
                             mesh=mesh)
    start_step = 0
    mgr = None
    state = setup.init_state(args.seed)
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
        state, start_step = mgr.restore_or_init(
            lambda: state,
            None if mesh is None else setup.state_shardings(state))

    batches = mlm_batches if cfg.family == "encoder" else lm_batches
    if cfg.family in ("encdec", "vlm"):
        def batches(vocab, b, seq, seed):
            """The multimodal stubs: synthetic frames or patches beside
            the tokens, as the reference's train CLI makes them."""
            step = 0
            while True:
                yield {k: v.numpy() for k, v in synthetic_batch(
                    cfg, b, seq, seed=hash((seed, step)) % 2 ** 31,
                    device="cpu").items()}
                step += 1
    # On a mesh every rank draws the whole global batch (process 0 of 1)
    # and keeps its slice.
    one = {} if mesh is None else {"process_index": 0, "process_count": 1}
    source = HostShardedSource(
        lambda b, s: batches(cfg.vocab, b, args.seq, seed=s), args.batch,
        start_step=start_step, **one)
    if mesh is None:
        place = torch_placer(setup.device)
    else:
        specs = {k: v.spec for k, v in batch_struct(
            cfg, shape, mesh, setup.rules).items()}
        place = device_placer(mesh, specs)
    pipe = Prefetcher(source, place=place)
    watchdog = StepWatchdog(
        on_anomaly=lambda r: print(f"[straggler] step {r.step} took "
                                   f"{r.duration:.2f}s ({r.ratio:.1f}x)"))
    history = []
    t_start = time.time()
    try:
        for step in range(start_step, args.steps):
            batch = next(pipe)
            watchdog.start()
            state, metrics = setup.step_fn(state, batch)
            loss = float(metrics["loss"])
            watchdog.stop(step)
            if is_main_rank() and (step % args.log_every == 0
                                   or step == args.steps - 1):
                print(f"step {step:5d}  loss {loss:8.4f}  "
                      f"gnorm {float(metrics['grad_norm']):7.3f}  "
                      f"lr {float(metrics['lr']):.2e}", flush=True)
            history.append({"step": step, "loss": loss})
            if mgr:
                mgr.maybe_save(step, state)
    finally:
        pipe.close()
    if mgr:
        mgr.finalize(args.steps, state)
    dt = time.time() - t_start
    ran = args.steps - start_step
    if not is_main_rank():
        return history
    print(f"done: {ran} steps in {dt:.1f}s "
          f"({ran / max(dt, 1e-9):.2f} it/s); "
          f"{len(watchdog.anomalies)} straggler events")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return history


if __name__ == "__main__":
    main()
