#!/usr/bin/env python3
"""yi-9b served at full width on a DeviceMesh of CUDA cards, against the
same model served on one card without a mesh.

  python3 tools/mesh_serve_check.py --mesh 1,1 --out out/m11.json
  torchrun --nproc-per-node 4 tools/mesh_serve_check.py --mesh 1,4 \\
      --out out/m14.json --against out/m11.json

``--mesh 1,1`` is the meshless run (one process).  Any other mesh runs one
process per card under ``torchrun`` (NCCL) through
``make_serve_setup(mesh=...)``.  Both draw the same weights (bf16, or
fp32 with ``--fp32``) from the seed, prefill a batch of ``--batch`` prompts of ``--prompt`` tokens and
decode ``--gen`` greedy steps (one untimed warm-up run first); rank 0
writes the tokens, the last prefill logits and the times as JSON.  With
``--against``, rank 0 compares: bf16 through the layers in another
summation order (partial sums over 'model') may move a logit by a few
bf16 steps, so the prefill logits are held to 0.1 of the largest one (as
``chip_smoke.py`` holds a full model against its plain backend) and the
share of equal tokens is printed; with ``--fp32`` (weights and compute)
the tokens must all be equal.

``--continuous`` serves through the request pool instead
(``launch/batcher.py`` over ``make_pool_setup(mesh=...)``): ``--batch``
slots, twice as many requests of ``--prompt`` tokens with budgets of a
quarter, a half and all of ``--gen``, segment 4; ``--speculative`` decodes
with ``make_spec_setup`` (k = 3, a draft of half the layers), or, with
``--continuous``, gives the pool speculative rows.  These compare each
row's or request's tokens only.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1,1")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--impl", default="lln_diag")
    ap.add_argument("--fp32", action="store_true",
                    help="fp32 weights and compute: the mesh then gives "
                         "the meshless tokens (sums in another order "
                         "only), which the check requires")
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--out", required=True)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import is_main_rank, mesh_from_flag
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import synthetic_batch
    dtype = "float32" if args.fp32 else "bfloat16"
    cfg = get_config("yi-9b", attn_impl=args.impl, n_layers=args.layers,
                     param_dtype=dtype, compute_dtype=dtype)
    mesh = mesh_from_flag(args.mesh, cfg, continuous=args.continuous,
                          speculative=args.speculative)
    if args.continuous or args.speculative:
        return _other_mode(args, cfg, mesh)
    total = args.prompt + args.gen + 1
    setup = make_serve_setup(cfg, ShapeSpec("check", total, args.batch,
                                            "decode"), mesh=mesh)
    params = setup.shard_params(setup.model.init(0))
    batch = synthetic_batch(cfg, args.batch, total, seed=0,
                            text_seq=args.prompt, device="cuda")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        logits, caches = setup.prefill_fn(params, batch)
        torch.cuda.synchronize()
        t_pre = time.time() - t0
        last = logits[:, -1].float()
        tok = torch.argmax(last, -1)
        toks = [tok]
        t0 = time.time()
        for i in range(args.gen):
            lg, caches = setup.decode_fn(params, caches, tok, args.prompt + i)
            tok = torch.argmax(lg, -1)
            toks.append(tok)
        torch.cuda.synchronize()
        t_dec = (time.time() - t0) / args.gen
    ok = True
    if is_main_rank():
        got = {"mesh": args.mesh, "world": dist.get_world_size()
               if dist.is_initialized() else 1,
               "device": torch.cuda.get_device_name(0),
               "tokens": torch.stack(toks, 1).tolist(),
               "prefill_logits": last.cpu().tolist(),
               "prefill_ms": t_pre * 1e3, "decode_ms_per_step": t_dec * 1e3}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(got))
        line = {k: got[k] for k in ("mesh", "world", "prefill_ms",
                                    "decode_ms_per_step")}
        if args.against:
            want = json.loads(Path(args.against).read_text())
            wl = torch.tensor(want["prefill_logits"])
            err = float((last.cpu() - wl).abs().max())
            tol = 0.1 * max(1.0, float(wl.abs().max()))
            same = (torch.tensor(got["tokens"])
                    == torch.tensor(want["tokens"])).float().mean()
            ok = err <= tol and (not args.fp32 or float(same) == 1.0)
            line.update(prefill_logit_err=err, tol=tol,
                        token_agreement=float(same))
        print(json.dumps(line), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0 if ok else 1


def _other_mode(args, cfg, mesh) -> int:
    """``--continuous`` / ``--speculative``: the tokens (one list per
    request or row) and the wall time, one untimed warm-up run first;
    rank 0 writes them and compares with ``--against``."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.batcher import ContinuousBatcher, Request
    from repro_torch.launch.mesh import is_main_rank
    from repro_torch.launch.steps import (flatten_spec_tokens,
                                          make_pool_setup, make_spec_setup)
    from repro_torch.models import synthetic_batch
    k = 3 if args.speculative else 0
    draft = max(args.layers // 2, 1)
    if args.continuous:
        setup = make_pool_setup(
            cfg, slots=args.batch, max_len=args.prompt + args.gen + k + 1,
            segment=4, spec_k=k, draft_layers=draft if k else 0, mesh=mesh)
        rng = np.random.default_rng(0)
        budgets = [max(args.gen // 4, 1), max(args.gen // 2, 1), args.gen]
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, args.prompt)
                        .astype(np.int32), gen_len=budgets[i % 3])
                for i in range(2 * args.batch)]
    else:
        setup = make_spec_setup(
            cfg, ShapeSpec("check", args.prompt + args.gen + k + 2,
                           args.batch, "decode"), spec_k=k,
            draft_layers=draft, mesh=mesh)
        batch = synthetic_batch(cfg, args.batch, args.prompt + args.gen,
                                seed=0, text_seq=args.prompt, device="cuda")
    params = setup.shard_params(setup.model.init(0))
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        if args.continuous:
            stats = ContinuousBatcher(setup, params).run(reqs)
            toks = [np.asarray(stats.outputs[r.rid]).tolist() for r in reqs]
        else:
            logits, tgt, dr = setup.prefill_fn(params, batch)
            tok = torch.argmax(logits[:, -1], -1)
            out, n_emit, *_ = setup.make_generate(args.gen)(
                params, tgt, dr, tok, args.prompt)
            toks = np.concatenate([tok[:, None].cpu().numpy(),
                                   flatten_spec_tokens(out, n_emit,
                                                       args.gen)], 1).tolist()
        torch.cuda.synchronize()
        wall = time.time() - t0
    ok = True
    if is_main_rank():
        mode = "+".join(m for m in ("continuous", "speculative")
                        if getattr(args, m))
        got = {"mesh": args.mesh, "mode": mode, "world":
               dist.get_world_size() if dist.is_initialized() else 1,
               "device": torch.cuda.get_device_name(0), "tokens": toks,
               "wall_ms": wall * 1e3}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(got))
        line = {k_: got[k_] for k_ in ("mesh", "mode", "world", "wall_ms")}
        if args.against:
            want = json.loads(Path(args.against).read_text())["tokens"]
            pairs = [(a, b) for ra, rb in zip(toks, want)
                     for a, b in zip(ra, rb)]
            same = sum(a == b for a, b in pairs) / max(len(pairs), 1)
            ok = not args.fp32 or toks == want
            line.update(token_agreement=same)
        print(json.dumps(line), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
