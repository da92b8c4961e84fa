"""Serving driver of the port: batched prefill + a decode loop (static mode).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \
      --attn-impl lln_diag --device cpu

Takes the reference driver's flags (``python -m repro.launch.serve``) plus
``--device`` (the CUDA card by default).  Every row advances in lockstep;
the first decode step is timed on its own and the rest give the steady
tok/s.  ``--attn-impl`` takes ``softmax`` (every config's default),
``lln``, ``lln_diag`` and ``log_linear``; ``--arch`` the dense decoders
(yi-9b, qwen3-14b, stablelm-1.6b, chatglm3-6b), the MoE decoders
(qwen3-moe-235b-a22b, and deepseek-v2-236b with MLA), the encoder-decoder
seamless-m4t-medium (its source frames are a synthetic stub), the VLM
paligemma-3b (synthetic patches before the prompt; decode positions start
after them) and the SSM / hybrid LMs (mamba2-130m, zamba2-7b).  ``--continuous`` serves mixed-length
synthetic traffic from a slotted request pool (``launch/batcher.py``) with
the health sentinel, fault injection (``--fault-plan``) and pool snapshots
(``--snapshot-dir``, ``--snapshot-every``, ``--restore``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \
      --attn-impl lln_diag --device cpu --continuous --requests 8 \
      --gen-lens 4,12

``--speculative`` decodes draft-then-verify (a tied first-k-layers draft,
``--draft-layers``, by default half the layers, proposes ``--spec-k``
tokens and the target verifies them in one pass); with ``--continuous``
the pool's rows are speculative:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \
      --attn-impl lln_diag --device cpu --speculative --spec-k 3 --gen 16

``--mesh d,m`` serves every family with a decode step on a (data, model)
DeviceMesh, one process per device under ``torchrun`` (NCCL on the card,
gloo with ``--device cpu``), in every mode: static, ``--continuous`` (the
dense, MoE, ssm and hybrid pools) and ``--speculative`` (alone or in the
pool); every rank samples the same tokens from the whole logits, makes
the same pool decisions, and rank 0 prints:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch yi-9b --smoke --attn-impl lln_diag --mesh 2,2 --device cpu \
      --continuous --requests 8 --gen-lens 4,12
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.health import HealthConfig
from repro_torch.launch.batcher import ContinuousBatcher, synthetic_traffic
from repro_torch.launch.faults import FaultPlan, SimulatedCrash
from repro_torch.launch.mesh import is_main_rank, mesh_from_flag
from repro_torch.launch.steps import (flatten_spec_tokens, make_pool_setup,
                                      make_serve_setup, make_spec_setup,
                                      sample_token)
from repro_torch.models import synthetic_batch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attn-impl", default=None,
                    choices=[None, "softmax", "lln", "lln_diag",
                             "log_linear"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mesh", default="1,1")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-scan", dest="scan", action="store_false",
                    default=True, help="per-token loop (the port always "
                    "runs a Python loop of decode steps)")
    ap.add_argument("--no-serve-kernel", dest="serve_kernel",
                    action="store_false", default=True,
                    help="core reference path (attn_backend=ref)")
    ap.add_argument("--attn-backend", default=None,
                    choices=[None, "auto", "kernel", "plain", "ref"],
                    help="explicit attention backend (kernels/registry.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-then-verify decoding (composes with "
                    "--continuous)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="layers of the tied draft (default: half)")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="draft tokens per verify")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--segment", type=int, default=8)
    ap.add_argument("--gen-lens", default=None,
                    help="comma-separated generation budgets of the "
                    "--continuous traffic")
    ap.add_argument("--prompt-lens", default=None,
                    help="comma-separated prompt lengths (default: "
                    "--prompt-len)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request wall-clock budget in seconds")
    ap.add_argument("--queue-cap", type=int, default=1024)
    ap.add_argument("--drift", action="store_true",
                    help="quarantine rows whose concentration drifts")
    ap.add_argument("--no-health", dest="health", action="store_false",
                    default=True, help="turn the state-health sentinel off")
    ap.add_argument("--fault-plan", default=None,
                    help="FaultPlan JSON (a path or an inline literal)")
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--snapshot-every", type=int, default=4)
    ap.add_argument("--restore", action="store_true",
                    help="resume the pool from --snapshot-dir's latest "
                    "snapshot")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    overrides = {}
    if args.attn_impl:
        overrides["attn_impl"] = args.attn_impl
    if not args.serve_kernel:
        overrides["use_serve_kernel"] = False
    if args.attn_backend:
        overrides["attn_backend"] = args.attn_backend
    cfg = get_config(args.arch, smoke=args.smoke, **overrides)
    mesh = mesh_from_flag(args.mesh, cfg, args.device,
                          continuous=args.continuous,
                          speculative=args.speculative)
    if args.continuous:
        return _run_continuous(cfg, args, mesh)
    if args.speculative:
        return _run_speculative(cfg, args, mesh)

    max_len = args.prompt_len + args.gen + cfg.num_prefix_tokens
    setup = make_serve_setup(cfg, ShapeSpec("cli", max_len, args.batch,
                                            "decode"), device=args.device,
                             mesh=mesh)
    dev = setup.device
    params = setup.shard_params(setup.model.init(args.seed))
    batch = synthetic_batch(cfg, args.batch, max_len,
                            text_seq=args.prompt_len, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    logits, caches = setup.prefill_fn(params, batch)
    sync()
    t_prefill = time.time() - t0

    tok = torch.argmax(logits[:, -1], -1)
    generated = [tok]
    pos = batch["inputs"].shape[1]
    if cfg.family == "vlm":
        pos += cfg.num_prefix_tokens
    t_first = t_steady = 0.0
    if args.gen > 1:
        t0 = time.time()
        logits, caches = setup.decode_fn(params, caches, tok, pos)
        tok = sample_token(logits, args.temperature, gen)
        generated.append(tok)
        sync()
        t_first = time.time() - t0

    steady_steps = max(args.gen - 2, 0)
    if steady_steps > 0:
        gen_fn = setup.make_generate(steady_steps, args.temperature)
        t0 = time.time()
        toks, caches = gen_fn(params, caches, tok, pos + 1, gen)
        sync()
        t_steady = time.time() - t0
        generated.extend(toks.unbind(1))

    toks = torch.stack(generated, 1).cpu()
    mode = "scan" if args.scan else "loop"
    tok_s = steady_steps * args.batch / max(t_steady, 1e-9)
    if not is_main_rank():
        return toks
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill:.3f}s"
          f"  (serve_kernel={cfg.use_serve_kernel})")
    print(f"decode : first step {t_first:.3f}s (compile, excluded); "
          f"{steady_steps} steady steps [{mode}] in {t_steady:.3f}s "
          f"({tok_s:.1f} tok/s)")
    print("sample tokens:", toks[0, :16].tolist())
    return toks


def _run_speculative(cfg, args, mesh=None):
    """Draft-then-verify decoding: the tied first-k-layers draft and one
    target verify per iteration with per-row partial commits."""
    draft_layers = args.draft_layers or max(cfg.n_layers // 2, 1)
    steps = max(args.gen - 1, 1)
    max_len = args.prompt_len + args.gen + args.spec_k + 2
    setup = make_spec_setup(cfg, ShapeSpec("spec", max_len, args.batch,
                                           "decode"), device=args.device,
                            spec_k=args.spec_k, draft_layers=draft_layers,
                            mesh=mesh)
    dev = setup.device
    params = setup.shard_params(setup.model.init(args.seed))
    batch = synthetic_batch(cfg, args.batch, max_len,
                            text_seq=args.prompt_len, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    logits, tgt_caches, dr_caches = setup.prefill_fn(params, batch)
    sync()
    t_prefill = time.time() - t0
    tok0 = torch.argmax(logits[:, -1], -1)
    gen_fn = setup.make_generate(steps, args.temperature)
    t0 = time.time()
    toks, n_emit, n_acc, live, *_ = gen_fn(params, tgt_caches, dr_caches,
                                           tok0, args.prompt_len, gen)
    sync()
    t_gen = time.time() - t0
    n_emit_h, n_acc_h = n_emit.cpu().numpy(), n_acc.cpu().numpy()
    acc_rate = float(n_acc_h.sum()) / max(float(live.sum()) * args.spec_k,
                                          1.0)
    iters_used = [int(np.argmax(np.cumsum(n_emit_h[r]) >= steps)) + 1
                  for r in range(args.batch)]
    tps = float(np.mean([steps / i for i in iters_used]))
    flat = flatten_spec_tokens(toks, n_emit, steps)
    tok_s = steps * args.batch / max(t_gen, 1e-9)
    if not is_main_rank():
        return flat
    print(f"prefill: {args.batch}x{args.prompt_len} (target + "
          f"{draft_layers}-layer draft) in {t_prefill:.3f}s")
    print(f"speculative: k={args.spec_k}, draft_layers={draft_layers}; "
          f"{steps} tokens/row in {t_gen:.3f}s ({tok_s:.1f} tok/s)")
    print(f"  acceptance rate {acc_rate:.2f}, tokens/verify-step {tps:.2f} "
          f"(1.0 = non-speculative)")
    print("sample tokens:", flat[0, :16].tolist())
    return flat


def _run_continuous(cfg, args, mesh=None):
    """The continuous-batching pool over mixed-length synthetic traffic."""
    gen_lens = ([int(x) for x in args.gen_lens.split(",")]
                if args.gen_lens else [args.gen // 4 or 1] * 3 + [args.gen])
    prompt_lens = ([int(x) for x in args.prompt_lens.split(",")]
                   if args.prompt_lens else [args.prompt_len])
    # --speculative with --continuous: speculative pool rows, with the
    # spec_k slack reserved in the cache.
    spec_k = args.spec_k if args.speculative else 0
    draft_layers = ((args.draft_layers or max(cfg.n_layers // 2, 1))
                    if args.speculative else 0)
    max_len = max(prompt_lens) + max(gen_lens) + spec_k
    plan = FaultPlan.load(args.fault_plan) if args.fault_plan else None
    mgr = (CheckpointManager(args.snapshot_dir, keep_n=3, interval=1)
           if args.snapshot_dir else None)
    setup = make_pool_setup(
        cfg, args.device, slots=args.batch, max_len=max_len,
        segment=args.segment, temperature=args.temperature,
        health=(HealthConfig(check_drift=args.drift) if args.health
                else None), spec_k=spec_k, draft_layers=draft_layers,
        mesh=mesh)
    params = setup.shard_params(setup.model.init(args.seed))
    eng = ContinuousBatcher(setup, params, queue_cap=args.queue_cap,
                            snapshot_mgr=mgr,
                            snapshot_every=args.snapshot_every if mgr else 0)
    reqs = synthetic_traffic(args.requests, cfg.vocab, prompt_lens,
                             gen_lens, seed=args.seed)
    if args.deadline is not None:
        for r in reqs:
            r.deadline_s = args.deadline
    eng.warmup(prompt_lens)
    gen = None
    if args.temperature > 0:
        gen = torch.Generator(device=setup.device)
        gen.manual_seed(args.seed + 1)
    try:
        stats = eng.run(reqs, generator=gen, fault_plan=plan,
                        resume=args.restore)
    except SimulatedCrash as e:
        if not is_main_rank():
            return None
        print(f"simulated crash at segment boundary {e.segment}; "
              f"resume with --restore --snapshot-dir {args.snapshot_dir}")
        return None

    if not is_main_rank():
        return stats
    # Useful tokens over dispatched row-steps (+1 prefill-emitted token per
    # request), as the reference's report.
    util = stats.completed_tokens / max(
        stats.decode_steps * args.batch + max(stats.admitted, 1), 1)
    print(f"continuous: {args.requests} requests over {args.batch} slots, "
          f"segment={args.segment}, gen_lens={gen_lens}"
          + (f", speculative k={spec_k} draft_layers={draft_layers}"
             if spec_k else ""))
    print(f"  {stats.completed_tokens} tokens in {stats.wall_s:.3f}s "
          f"({stats.completed_tokens / max(stats.wall_s, 1e-9):.1f} tok/s "
          f"goodput), {stats.segments} segments, "
          f"slot utilization {util:.2f}")
    if stats.spec_k:
        print(f"  speculative: acceptance {stats.acceptance_rate:.2f} "
              f"({stats.accepted_tokens}/{stats.drafted_tokens} drafts), "
              f"{stats.goodput_tokens_per_iter:.2f} tokens/verify-iter "
              f"over {stats.verify_iters} iterations")
    by = {}
    for v in stats.statuses.values():
        by[v] = by.get(v, 0) + 1
    print(f"  statuses: {by}; recoveries={stats.recoveries}, "
          f"snapshots={stats.snapshots}, "
          f"stragglers={len(stats.stragglers)}, "
          f"segment EWMA {stats.segment_ewma_s * 1e3:.1f}ms"
          + (f" (restored from step {stats.restored_step})"
             if stats.restored_step is not None else ""))
    if stats.telemetry:
        t = stats.telemetry
        print(f"  concentration: drift_max {t['conc_drift_max']:.2f}, "
              f"log_mass {t['log_mass_mean']:.2f}, "
              f"log_var {t['log_mass_var_mean']:.3f}, "
              f"tau_hat {t['tau_hat_mean']:.3f}"
              + (" [drift quarantine ON]" if args.drift else ""))
    if stats.outputs:
        rid0 = min(stats.outputs)
        print(f"request {rid0} tokens:",
              stats.outputs[rid0][:16].tolist())
    return stats


if __name__ == "__main__":
    main()
