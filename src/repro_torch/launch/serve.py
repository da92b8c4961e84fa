"""Serving driver of the port: batched prefill + a decode loop (static mode).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \
      --attn-impl lln_diag --device cpu

Takes the reference driver's flags (``python -m repro.launch.serve``) plus
``--device`` (the CUDA card by default).  Every row advances in lockstep;
the first decode step is timed on its own and the rest give the steady
tok/s.  ``--attn-impl`` takes ``softmax`` (every config's default),
``lln``, ``lln_diag`` and ``log_linear``; ``--arch`` the dense decoders
(yi-9b, qwen3-14b, stablelm-1.6b, chatglm3-6b) and the SSM / hybrid LMs
(mamba2-130m, zamba2-7b).  Continuous
batching, speculative decoding and meshes are not ported yet and raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.steps import make_serve_setup, sample_token
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
    ap.add_argument("--speculative", action="store_true")
    # The reference's flags of the continuous and speculative modes: they
    # parse, so a reference command line reaches the NotImplementedError
    # that names the ROADMAP item.
    for flag, kind in (("--draft-layers", int), ("--spec-k", int),
                       ("--requests", int), ("--segment", int),
                       ("--gen-lens", str), ("--prompt-lens", str),
                       ("--deadline", float), ("--queue-cap", int),
                       ("--fault-plan", str), ("--snapshot-dir", str),
                       ("--snapshot-every", int)):
        ap.add_argument(flag, type=kind, default=None)
    for flag in ("--drift", "--no-health", "--restore"):
        ap.add_argument(flag, action="store_true")
    return ap


# What each unported mode waits for (ROADMAP.md, queue 1).
_NOT_PORTED = {
    "continuous": "continuous batching (ROADMAP.md queue 1, item 8)",
    "speculative": "speculative decoding (ROADMAP.md queue 1, item 9)",
    "mesh": "meshes and sharding (ROADMAP.md queue 1, item 12)",
}


def main(argv=None):
    args = _parser().parse_args(argv)
    for flag in ("continuous", "speculative"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported yet: "
                                      f"{_NOT_PORTED[flag]}")
    if args.mesh != "1,1":
        raise NotImplementedError(f"--mesh is not ported yet: "
                                  f"{_NOT_PORTED['mesh']}")
    overrides = {}
    if args.attn_impl:
        overrides["attn_impl"] = args.attn_impl
    if not args.serve_kernel:
        overrides["use_serve_kernel"] = False
    if args.attn_backend:
        overrides["attn_backend"] = args.attn_backend
    cfg = get_config(args.arch, smoke=args.smoke, **overrides)

    max_len = args.prompt_len + args.gen
    setup = make_serve_setup(cfg, ShapeSpec("cli", max_len, args.batch,
                                            "decode"), device=args.device)
    dev = setup.device
    params = setup.model.init(args.seed)
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
    pos = args.prompt_len
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
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill:.3f}s"
          f"  (serve_kernel={cfg.use_serve_kernel})")
    print(f"decode : first step {t_first:.3f}s (compile, excluded); "
          f"{steady_steps} steady steps [{mode}] in {t_steady:.3f}s "
          f"({tok_s:.1f} tok/s)")
    print("sample tokens:", toks[0, :16].tolist())
    return toks


if __name__ == "__main__":
    main()
