#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths (the yi-9b
decoder, with lln, lln_diag and log_linear), its encoder pre-training path
(roberta-lln, MLM) and its SSM training path (mamba2-130m, and the
zamba2-7b hybrid with lln_diag) on one CUDA card and check them.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device        - require CUDA, print the card's name and power limit,
                     TF32 off;
  2. build         - compile the eleven CUDA kernels from src/repro_torch/csrc,
                     one nvcc per source, all started together;
  3. kernels       - each serving kernel against its plain PyTorch version at
                     full-width shapes (B=4, H=32, G=4, D=Dv=128, bf16 q/k/v);
  4. kernels_train - each training kernel against its plain version at the
                     training shapes (B=4, N=1024 and 512, H=32, G=4,
                     D=Dv=128, blk 256, bf16 q/k/v/g);
  5. small         - yi-9b SMOKE in fp32 serving: kernels against the core
                     reference;
  6. small_train   - yi-9b SMOKE in fp32 training with use_kernel=True:
                     3 steps on the kernels against 3 on the core reference,
                     then the train CLI on the default device;
  7. serve         - yi-9b at full width and depth (bf16 weights from a
                     seed), attn_impl lln then lln_diag, batch 4, prompt 512,
                     32 greedy tokens, with launch counts read around each
                     path;
  8. train         - yi-9b at full width with 8 layers (fp32 master params,
                     bf16 compute, remat full, use_kernel=True), batch 4 x
                     seq 1024 from lm_batches, lln then lln_diag: the first
                     step's loss and grad norm on the kernels against the
                     plain versions, then one untimed and 3 timed steps with
                     launch counts read around them;
  9. kernels_encoder - each encoder kernel (lln_bidir, lln_bidir_bwd,
                     block_diag_bwd, and block_diag with causal=False)
                     against its plain version at the encoder shapes (B=32,
                     N=512 and a ragged 300, H=12, G=12 and 3, D=Dv=64,
                     blk 256, bf16 q/k/v/g), two runs of lln_bidir,
                     lln_bidir_bwd and block_diag_bwd bitwise equal;
 10. small_encoder - roberta-lln SMOKE in fp32 with use_kernel=True: 3 MLM
                     steps on the kernels against 3 through the core
                     reference, then the train CLI --arch roberta-lln;
 11. encoder_train - roberta-lln at full width and depth (12 layers, fp32
                     master params, bf16 compute, remat full,
                     use_kernel=True), batch 32 x seq 512 from mlm_batches,
                     lln then lln_diag: the first step on the kernels against
                     the plain versions, then one untimed and 3 timed steps
                     with launch counts;
 12. encoder_forward - Model.hidden plus logits on bf16 weights under
                     no_grad at the same batch, with launch counts;
 13. kernels_loglin - loglin_causal against its plain version at the serve
                     shapes (B=4, H=32, G=4, D=Dv=128, granule 256, 4
                     levels, bf16 v), N = 2048 and a ragged 2040, with and
                     without the state, two runs bitwise equal; the
                     two-pass log-linear decode
                     (kernel against plain) for T = 1 and T = 100;
 14. small_loglin  - yi-9b SMOKE in fp32 serving with log_linear (granule
                     16), prompts 112 and 120 and 24 greedy steps (decode
                     crosses position 127): kernels against the core
                     reference;
 15. serve_loglin  - yi-9b at full width and depth with log_linear, batch 4,
                     prompt 2040, 32 greedy tokens (decode crosses position
                     2047: 7 -> 8 closed granules), launch counts, logits
                     against the plain backend at prefill and at the step
                     that crosses;
 16. kernels_ssd   - ssd against its plain version at the mamba2-130m train
                     shape (B=8, H=24, N=2048, P=64, S=128, blk 256, bf16
                     B/C), the zamba2-7b one (B=4, H=112, S=64) and G=4 at
                     a small H, two runs bitwise equal; ops.ssd_scan's output
                     and gradients on the kernel route against the plain one;
 17. kernels_hybrid_attn - lln_diag_fused and lln_diag_fused_bwd against their
                     plain versions at zamba2-7b's shared attention (B=4,
                     H=G=32, D=Dv=112, N=2048, blk 256, bf16);
 18. small_ssm     - mamba2-130m SMOKE, and zamba2-7b SMOKE with lln_diag, in
                     fp32 with use_kernel=True: 3 steps on the kernels against
                     3 through the core reference (use_kernel=False for
                     mamba2, backend ref for zamba2), then the train CLI
                     --arch mamba2-130m --smoke;
 19. ssm_train     - mamba2-130m at full size (24 layers, fp32 master params,
                     bf16 compute, remat full, use_kernel=True), batch 8 x
                     2048 from lm_batches: the first step on the kernels
                     against the plain versions, then one untimed and 3 timed
                     steps with launch counts (48 ssd per step);
 20. hybrid_train  - zamba2-7b at full width with 15 layers (two groups of six,
                     the shared block after each, a 3-layer tail), lln_diag,
                     batch 4 x 2048, the same checks (per step 30 ssd, 4
                     lln_diag_fused, 2 lln_diag_fused_bwd);
 21. timings       - each kernel, its plain version and its bound at the
                     serve, training, encoder or SSD shapes; serve, train and
                     encoder times.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM memory rate (data sheet)
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12      # H100 SXM bf16 on the tensor cores (dense)
B, H, G, D = 4, 32, 4, 128    # yi-9b attention at the serve batch
N, BLK, GEN = 512, 256, 32    # prompt, diag block, generated tokens
TN, TL, TSTEPS = 1024, 8, 3   # training: sequence, layers, timed steps
EB, EH, ED = 32, 12, 64       # roberta-lln attention at the encoder batch
EN, ENR = 512, 300            # encoder sequence (two diag blocks), ragged N
LN, LNR = 2048, 2040          # log_linear: 8 granules of 256, ragged prompt
LEVELS, DECAY = 4, 0.5        # log_linear pyramid (the config's defaults)
SB, SH, SN, SP, SS = 8, 24, 2048, 64, 128  # mamba2-130m SSD, train batch
ZB, ZH, ZS, ZD = 4, 112, 64, 112  # zamba2-7b: SSD heads, state, attention dim
HL = 15                       # zamba2-7b layers: 2 groups of 6, a tail of 3
SEED = 0
# fp32 elementwise steps of the block softmax per (query, key) pair: scale,
# max, subtract, exp and sum forward; the backward's recomputed p (scale,
# subtract, exp, divide), delta's product and dsm = p (dp - delta).
SOFTMAX_FWD_OPS, SOFTMAX_BWD_OPS = 5, 7


def log(*a):
    print(*a, flush=True)


def _lln_module():
    """kernels/lln_attention.py, whose TC_BLOCK sets the block of
    lln_causal's and lln_causal_bwd's tensor-core paths (the package
    exports a function of the same name, so ``from repro_torch.kernels
    import lln_attention`` would not give the module)."""
    return importlib.import_module("repro_torch.kernels.lln_attention")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check(name, got, want, tol):
    err = max_err(got, want)
    log(f"  {name}: max abs err {err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


def bf16_tol(want) -> float:
    """One bf16 rounding step at the largest output: both sides compute in
    fp32 and round once, so a value near a rounding boundary may land one
    step (2^-7 relative at most) apart."""
    return 2.0 ** -7 * max(1.0, float(want.float().abs().max()))


def fp32_tol(want) -> float:
    """fp32 sums of up to N terms taken in another order: 1e-5 relative to
    the largest entry (sqrt(512) * 2^-24 is about 1.3e-6)."""
    return 1e-5 * max(1.0, float(want.abs().max()))


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, each after a
    64 MB write that evicts the 50 MB L2, so inputs come from device memory.
    (In the serve loop the op before each kernel has just written its
    inputs, which may still sit in L2; the profiler's per-kernel totals in
    the serve phase give those in-place times.)  A ~5 ms spin on the card
    after the flush keeps it busy while the host enqueues the events and
    ``fn``, so the time excludes host launch latency, which on a shared
    host would otherwise dominate a short kernel."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(10_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, bf16_flops: float = 0.0):
    """The least time for the work: bytes over the memory rate, or the
    operations over their peak, whichever is larger.  ``flops`` are fp32
    (CUDA cores); ``bf16_flops`` are products of two bf16 operands with
    fp32 accumulation, exact on the tensor cores, which run beside the
    CUDA cores, so the operations take the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOP_PER_S, bf16_flops / BF16_FLOP_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def device_profile(fn):
    """Run ``fn`` under ``torch.profiler``; return (device ms, every kernel
    as (name, ms, calls), the most device time first).  Device ms is 0.0
    where the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # Device-side events only: a host op (aten::mm) also reports the
        # device time of the kernels it launched, which would count twice.
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda x: -x[1])
    return sum(r[1] for r in rows), rows


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off")
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.time()
    build.build_all()
    for name in build.SIGNATURES:
        build.library(name)
    secs = time.time() - t0
    log(f"build: {secs:.1f}s for {len(build.SIGNATURES)} kernels "
        f"(nvcc, one process per source)")
    return secs


def _inputs(n, gen, b=B, h=H, g=G, d=D):
    """Post-RoPE-like bf16 q/k/v (b, n, h|g, d) and moment-matched
    alpha/beta from the port's calibration (yi-9b's heads by default)."""
    from repro_torch.core.attention import batch_alpha_beta
    from repro_torch.kernels.registry import AttnSpec
    dev = "cuda"
    q = torch.randn(b, n, h, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, n, g, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, n, g, d, generator=gen, device=dev).bfloat16()
    alpha, beta = batch_alpha_beta(q, k, AttnSpec(impl="lln", r=h // g))
    return q, k, v, alpha, beta


def phase_kernels(results):
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_diag import block_diag, block_diag_plain
    from repro_torch.kernels.lln_attention import (lln_causal, lln_causal_plain,
                                                   lln_decode, lln_decode_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    r = H // G
    state = None
    for n in (N, 300):
        q, k, v, alpha, beta = _inputs(n, gen)
        qs, ks, _ = ops._scaled_stabilized(q, k, alpha, beta)
        vk = ops._to_kernel(v)
        log(f"lln_causal N={n}:")
        got = lln_causal(qs, ks, vk, r=r, blk=BLK)
        want = lln_causal_plain(qs, ks, vk, r=r, blk=BLK)
        torch.cuda.synchronize()
        results["lln_causal (state)"] = max(
            results.get("lln_causal (state)", 0.0),
            check("out", got[0], want[0], bf16_tol(want[0])))
        check("s", got[1], want[1], fp32_tol(want[1]))
        check("z", got[2], want[2], fp32_tol(want[2]))
        if n == N:
            state = want[1], want[2]
        log(f"block_diag N={n} blk={BLK}:")
        qk, kk = ops._to_kernel(q), ops._to_kernel(k)
        got = block_diag(qk, kk, vk, r=r, blk=BLK, causal=True)
        want = block_diag_plain(qk, kk, vk, r=r, blk=BLK, causal=True)
        torch.cuda.synchronize()
        results["block_diag"] = max(results.get("block_diag", 0.0), check(
            "out", got, want, bf16_tol(want)))
    s0, z0 = state
    for t in (1, 4):
        q, k, v, alpha, beta = _inputs(t, gen)
        qs, ks, _ = ops._scaled_stabilized(q, k, alpha, beta)
        vk = ops._to_kernel(v)
        log(f"lln_decode T={t} (from the N={N} prefill state):")
        got = lln_decode(qs, ks, vk, s0, z0, r=r)
        want = lln_decode_plain(qs, ks, vk, s0, z0, r=r)
        torch.cuda.synchronize()
        results["lln_decode"] = max(results.get("lln_decode", 0.0), check(
            "out", got[0], want[0], bf16_tol(want[0])))
        check("s1", got[1], want[1], fp32_tol(want[1]))
        check("z1", got[2], want[2], fp32_tol(want[2]))


def phase_small():
    """yi-9b SMOKE in fp32 on the card: kernels (auto) against the core
    reference (ref), the repo's own oracle, on a ragged prompt."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import synthetic_batch
    for impl in ("lln", "lln_diag"):
        runs = {}
        for backend in ("auto", "ref"):
            cfg = get_config("yi-9b", smoke=True, attn_impl=impl,
                             compute_dtype="float32", attn_backend=backend)
            setup = make_serve_setup(cfg, ShapeSpec("small", 48, 2, "decode"))
            params = setup.model.init(SEED)
            batch = synthetic_batch(cfg, 2, 48, text_seq=40, device="cuda")
            logits, caches = setup.prefill_fn(params, batch)
            tok = torch.argmax(logits[:, -1], -1)
            toks, _ = setup.make_generate(7, 0.0)(params, caches, tok, 40)
            runs[backend] = (logits, torch.cat([tok[:, None], toks], 1))
        log(f"small {impl} (SMOKE fp32, prompt 40, kernels vs core ref):")
        check("prefill logits", runs["auto"][0], runs["ref"][0], 1e-4)
        if not torch.equal(runs["auto"][1], runs["ref"][1]):
            raise AssertionError(f"small {impl}: greedy tokens differ")
        log(f"  greedy tokens equal: {runs['auto'][1][0].tolist()}")
    from repro_torch.launch import serve
    log("serve CLI (SMOKE, default device):")
    toks = serve.main(["--arch", "yi-9b", "--smoke", "--attn-impl",
                       "lln_diag", "--batch", "2", "--prompt-len", "40",
                       "--gen", "8"])
    if toks.shape != (2, 8):
        raise AssertionError(f"serve CLI returned tokens of shape {toks.shape}")


def _train_inputs(n, gen, b=B, h=H, g=G, d=D):
    """Kernel-layout training inputs: fp32 qs/ks from the port's
    calibration, bf16 q/k/v and a bf16 cotangent g."""
    from repro_torch.kernels import ops
    q, k, v, alpha, beta = _inputs(n, gen, b, h, g, d)
    qs, ks, _ = ops._scaled_stabilized(q, k, alpha, beta)
    cot = torch.randn(b * h, n, d, generator=gen, device="cuda").bfloat16()
    return (qs, ks, ops._to_kernel(q), ops._to_kernel(k), ops._to_kernel(v),
            cot)


def phase_kernels_train(results):
    """The four training kernels against their plain versions.  Outputs in
    bf16 within one bf16 step; den and every fp32 gradient within 1e-5 of
    the largest plain entry (fp32 sums of up to r*N terms in another
    order); the two backwards' two runs bitwise equal."""
    from repro_torch.kernels.lln_attention import (lln_causal,
                                                   lln_causal_plain,
                                                   lln_diag_fused,
                                                   lln_diag_fused_plain)
    from repro_torch.kernels.lln_backward import (lln_causal_bwd,
                                                  lln_causal_bwd_plain,
                                                  lln_diag_fused_bwd,
                                                  lln_diag_fused_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    r = H // G

    def keep(name, err):
        results[name] = max(results.get(name, 0.0), err)

    for n in (TN, TN // 2):
        qs, ks, qk, kk, vk, g = _train_inputs(n, gen)
        log(f"lln_causal (res) N={n}:")
        got = lln_causal(qs, ks, vk, r=r, blk=BLK, return_res=True,
                         return_state=False)
        o, den = lln_causal_plain(qs, ks, vk, r=r, blk=BLK, return_res=True,
                                  return_state=False)
        torch.cuda.synchronize()
        keep("lln_causal (res)", check("out", got[0], o, bf16_tol(o)))
        keep("lln_causal (res)", check("den", got[1], den, fp32_tol(den)))
        log(f"lln_causal_bwd N={n}:")
        got = lln_causal_bwd(qs, ks, vk, g, o, den, r=r, blk=BLK)
        again = lln_causal_bwd(qs, ks, vk, g, o, den, r=r, blk=BLK)
        want = lln_causal_bwd_plain(qs, ks, vk, g, o, den, r=r, blk=BLK)
        torch.cuda.synchronize()
        for name, gt, wt in zip(("dqs", "dks", "dv"), got, want):
            keep("lln_causal_bwd", check(name, gt, wt, fp32_tol(wt)))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"lln_causal_bwd N={n}: two runs differ")
        log("  two runs bitwise equal")
        log(f"lln_diag_fused N={n} blk={BLK}:")
        got = lln_diag_fused(qs, ks, qk, kk, vk, r=r, blk=BLK,
                             return_res=True)
        o, den = lln_diag_fused_plain(qs, ks, qk, kk, vk, r=r, blk=BLK,
                                      return_res=True)
        torch.cuda.synchronize()
        keep("lln_diag_fused", check("out", got[0], o, bf16_tol(o)))
        keep("lln_diag_fused", check("den", got[1], den, fp32_tol(den)))
        log(f"lln_diag_fused_bwd N={n} blk={BLK}:")
        got = lln_diag_fused_bwd(qs, ks, qk, kk, vk, g, o, den, r=r, blk=BLK)
        again = lln_diag_fused_bwd(qs, ks, qk, kk, vk, g, o, den, r=r,
                                   blk=BLK)
        want = lln_diag_fused_bwd_plain(qs, ks, qk, kk, vk, g, o, den, r=r,
                                        blk=BLK)
        torch.cuda.synchronize()
        for name, gt, wt in zip(("dqs", "dqd", "dks", "dkd", "dv"), got,
                                want):
            keep("lln_diag_fused_bwd", check(name, gt, wt, fp32_tol(wt)))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"lln_diag_fused_bwd N={n}: two runs differ")
        log("  two runs bitwise equal")


def _small_vs_core(arch, batches_fn, label, impls=("lln", "lln_diag"),
                   core=None):
    """``arch`` SMOKE training in fp32 on the card with use_kernel=True: 3
    steps on the kernels (backend auto) against 3 through the core
    reference (backend ref, or the config overrides ``core``), from the
    same seeded init and batches of ``batches_fn``, for each attn_impl of
    ``impls`` (None: the config's own); losses and grad norms within 1e-4
    relative."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import torch_placer
    from repro_torch.launch.steps import make_train_setup
    for impl in impls:
        runs = {}
        for backend in ("auto", "ref"):
            over = dict(compute_dtype="float32", use_kernel=True,
                        attn_backend=backend)
            if impl:
                over["attn_impl"] = impl
            if backend == "ref" and core:
                over.update(core)
            cfg = get_config(arch, smoke=True, **over)
            setup = make_train_setup(cfg, ShapeSpec("small", 64, 2, "train"),
                                     peak_lr=1e-3, total_steps=3)
            state = setup.init_state(SEED)
            batches = batches_fn(cfg.vocab, 2, 64, seed=SEED)
            place = torch_placer("cuda")
            runs[backend] = []
            for _ in range(3):
                state, m = setup.step_fn(state, place(next(batches)))
                runs[backend].append((float(m["loss"]),
                                      float(m["grad_norm"])))
        log(f"{label} {impl} (SMOKE fp32, kernels vs core ref): "
            f"{runs['auto']} vs {runs['ref']}")
        for (la, ga), (lr_, gr) in zip(runs["auto"], runs["ref"]):
            if not (abs(la - lr_) <= 1e-4 * abs(lr_)
                    and abs(ga - gr) <= 1e-4 * abs(gr)):
                raise AssertionError(f"{label} {impl}: kernels {la}, {ga}"
                                     f" vs core ref {lr_}, {gr}")


def _train_cli(argv):
    """The train CLI on the default device for 3 steps; finite losses."""
    from repro_torch.launch import train
    log(f"train CLI {' '.join(argv)} (default device):")
    hist = train.main(argv + ["--steps", "3", "--seq", "64", "--batch", "2",
                              "--log-every", "1"])
    if len(hist) != 3 or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"train CLI history {hist}")


def phase_small_train():
    """yi-9b SMOKE training on the kernels against the core reference,
    then the train CLI (SMOKE, lln_diag)."""
    from repro_torch.data.synthetic import lm_batches
    _small_vs_core("yi-9b", lm_batches, "small_train")
    _train_cli(["--arch", "yi-9b", "--smoke", "--attn-impl", "lln_diag"])


def _counts():
    from repro_torch.kernels.block_diag import block_diag, block_diag_bwd
    from repro_torch.kernels.lln_attention import (lln_bidir, lln_causal,
                                                   lln_decode, lln_diag_fused)
    from repro_torch.kernels.lln_backward import (lln_bidir_bwd,
                                                  lln_causal_bwd,
                                                  lln_diag_fused_bwd)
    from repro_torch.kernels.loglinear import loglin_causal
    from repro_torch.kernels.ssd import ssd
    return {"lln_causal": lln_causal, "block_diag": block_diag,
            "lln_decode": lln_decode, "lln_diag_fused": lln_diag_fused,
            "lln_causal_bwd": lln_causal_bwd,
            "lln_diag_fused_bwd": lln_diag_fused_bwd,
            "lln_bidir": lln_bidir, "lln_bidir_bwd": lln_bidir_bwd,
            "block_diag_bwd": block_diag_bwd, "loglin_causal": loglin_causal,
            "ssd": ssd}


def _reset():
    for fn in _counts().values():
        fn.launches = 0


def _read():
    return {name: fn.launches for name, fn in _counts().items()}


def phase_serve(launches, serve_times):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import build_model, synthetic_batch
    params = None
    for impl in ("lln", "lln_diag"):
        cfg = get_config("yi-9b", attn_impl=impl, param_dtype="bfloat16")
        setup = make_serve_setup(cfg, ShapeSpec("chip", N + GEN, B, "decode"))
        if params is None:
            t0 = time.time()
            params = setup.model.init(SEED)
            torch.cuda.synchronize()
            log(f"serve: yi-9b {cfg.n_layers}L d_model {cfg.d_model}, "
                f"{setup.model.param_count(params) / 1e9:.2f}B params bf16 "
                f"(init {time.time() - t0:.1f}s), batch {B}, prompt {N}, "
                f"{GEN} greedy tokens")
        batch = synthetic_batch(cfg, B, N + GEN, seed=SEED, text_seq=N,
                                device="cuda")
        setup.prefill_fn(params, batch)             # warm-up (not counted)
        torch.cuda.synchronize()

        _reset()
        t0 = time.time()
        logits, caches = setup.prefill_fn(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.time() - t0
        pre = _read()
        _reset()
        tok = torch.argmax(logits[:, -1], -1)
        toks = [tok]
        logits1, caches = setup.decode_fn(params, caches, tok, N)
        tok = torch.argmax(logits1, -1)
        toks.append(tok)
        torch.cuda.synchronize()
        t0 = time.time()
        rest, caches = setup.make_generate(GEN - 2)(params, caches, tok, N + 1)
        torch.cuda.synchronize()
        t_steady = time.time() - t0
        dec = _read()
        toks = torch.cat([torch.stack(toks, 1), rest], 1)

        idle = {name: 0 for name in _counts()}
        want_pre = {**idle, "lln_causal": cfg.n_layers,
                    "block_diag": cfg.n_layers if impl == "lln_diag" else 0}
        want_dec = {**idle, "lln_decode": cfg.n_layers * (GEN - 1)}
        log(f"{impl}: prefill launches {pre}, decode launches {dec}")
        if pre != want_pre or dec != want_dec:
            raise AssertionError(f"{impl}: launch counts {pre} / {dec}, "
                                 f"expected {want_pre} / {want_dec}")
        for name in ("lln_causal (state)", "block_diag", "lln_decode"):
            key = name.split(" ")[0]
            launches[name] += pre[key] + dec[key]
        if toks.shape != (B, GEN) or not bool(
                ((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"{impl}: tokens out of range: {toks}")
        if not (bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(logits1).all())):
            raise AssertionError(f"{impl}: non-finite logits")

        # The same model through the kernels' plain versions.
        plain = build_model(cfg.replace(attn_backend="plain"))
        _reset()
        plain_logits, _ = plain.prefill(params, batch)
        torch.cuda.synchronize()
        if any(_read().values()):
            raise AssertionError("the plain backend launched a kernel")
        # bf16 through 48 layers: a one-step rounding difference inside a
        # layer (2^-8 relative) random-walks to about sqrt(48) * 2^-8 of the
        # logit scale; hold it to 0.1 of the largest logit.
        tol = 0.1 * max(1.0, float(plain_logits.abs().max()))
        check(f"{impl} prefill logits vs plain", logits, plain_logits, tol)
        agree = float((torch.argmax(logits[:, -1], -1)
                       == torch.argmax(plain_logits[:, -1], -1)).float().mean())
        log(f"  first-token agreement with plain: {agree:.2f}")
        step_ms = t_steady / (GEN - 2) * 1e3
        # Device time under the profiler (after the counted run): the share
        # of the unprofiled wall time in which the card is busy.
        pre_dev, pre_top = device_profile(
            lambda: setup.prefill_fn(params, batch))
        steps = 4
        dec_dev, dec_top = device_profile(
            lambda: setup.make_generate(steps)(params, caches, tok, N + GEN))
        dec_dev /= steps
        serve_times[impl] = {
            "prefill_ms": t_prefill * 1e3, "decode_ms_per_step": step_ms,
            "decode_tok_s": B / (step_ms / 1e3),
            "prefill_device_ms": pre_dev, "decode_device_ms_per_step": dec_dev,
            "prefill_busy": pre_dev / (t_prefill * 1e3),
            "decode_busy": dec_dev / step_ms}
        log(f"{impl}: prefill {t_prefill * 1e3:.2f} ms (device "
            f"{pre_dev:.2f} ms); decode {step_ms:.3f} ms/step "
            f"({B / (step_ms / 1e3):.1f} tok/s, device {dec_dev:.3f} ms/step) "
            f"over {GEN - 2} steps; tokens[0] {toks[0].tolist()}")
        for label, top in (("prefill", pre_top), ("decode x4", dec_top)):
            for name, ms, calls in top[:5]:
                log(f"  top {label}: {ms:9.3f} ms  {calls:6d} calls  "
                    f"{name[:90]}")
        del setup, caches, plain


QKV = ("q_w", "k_w", "v_w")
SSM_IN = ("w_x", "w_B", "w_C", "w_dt")


def _train_cell(cfg, batch_size, seq, batches_fn, want, label, probe=QKV):
    """Train ``cfg`` (use_kernel=True) at ``batch_size`` x ``seq`` on
    batches of ``batches_fn``: the first step's loss, grad norm and the grad
    norm of the weights named ``probe`` (by suffix) on the kernels against
    the plain versions, then one untimed and TSTEPS timed steps.
    ``want(steps)`` is the exact launch count of that many steps.  Returns
    (times, launches of the timed steps)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import torch_placer
    from repro_torch.launch.steps import make_train_setup
    from repro_torch.models import build_model
    from repro_torch.optim import global_norm
    impl = cfg.attn_impl if cfg.family != "ssm" else "(no attention)"
    setup = make_train_setup(cfg, ShapeSpec("chip", seq, batch_size, "train"),
                             peak_lr=3e-4, total_steps=1000)
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    state = setup.init_state(SEED)
    torch.cuda.synchronize()
    params = dict(state["params"].named_parameters())
    n_params = sum(p.numel() for p in params.values())
    log(f"{label} {impl}: {cfg.name} {cfg.n_layers}L d_model {cfg.d_model}, "
        f"{n_params / 1e6:.1f}M params fp32 + fp32 AdamW moments (init "
        f"{time.time() - t0:.1f}s), bf16 compute, remat {cfg.remat}, "
        f"batch {batch_size} x seq {seq}")
    place = torch_placer("cuda")
    batches = batches_fn(cfg.vocab, batch_size, seq, seed=SEED)
    batch = place(next(batches))

    # First step's loss and grad norm: kernels against plain versions.
    first = {}
    for backend in ("kernel", "plain"):
        model = build_model(cfg.replace(attn_backend=backend))
        _reset()
        loss = model.loss(state["params"], batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        gnorm = float(global_norm(grads))
        # The probed weights' gradients go straight through the backward of
        # the kernels' ops: the attention kernels' dq, dk and dv (q/k/v
        # projections), the SSD scan's dxbar, dB, dC and dlog_a (the SSM
        # input projections).
        qkv = float(global_norm({n_: g_ for n_, g_ in grads.items()
                                 if n_.endswith(probe)}))
        torch.cuda.synchronize()
        counted = _read()
        if counted != (want(1) if backend == "kernel" else want(0)):
            raise AssertionError(f"{label} {impl}: the {backend} backend's "
                                 f"first step launched {counted}")
        first[backend] = (float(loss.detach()), gnorm, qkv)
        del grads
    (lk, gk, qk), (lp, gp, qp) = first["kernel"], first["plain"]
    log(f"  first step: loss {lk:.6f} / {lp:.6f}, grad norm {gk:.6f} / "
        f"{gp:.6f}, {'/'.join(probe)} grad norm {qk:.6f} / {qp:.6f} "
        f"(kernels / plain)")
    # bf16 activations through the layers: a one-step rounding difference
    # in one layer's attention output propagates.  The decoder's runs before
    # this check showed relative gaps of 2e-5 in the loss and 2.6e-5 in the
    # grad norm; hold the loss to 1e-4 and both grad norms to 1e-3.
    if not (all(math.isfinite(x) for x in (lk, gk, qk))
            and abs(lk - lp) <= 1e-4 * abs(lp)
            and abs(gk - gp) <= 1e-3 * abs(gp)
            and abs(qk - qp) <= 1e-3 * abs(qp)):
        raise AssertionError(f"{label} {impl}: kernels {lk}, {gk}, {qk} vs "
                             f"plain {lp}, {gp}, {qp}")

    state, m = setup.step_fn(state, batch)            # untimed warm-up step
    torch.cuda.synchronize()
    losses, times = [], []
    _reset()
    for _ in range(TSTEPS):
        batch = place(next(batches))
        torch.cuda.synchronize()
        t0 = time.time()
        state, m = setup.step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    counted = _read()
    log(f"  launches over {TSTEPS} steps: {counted}")
    if counted != want(TSTEPS):
        raise AssertionError(f"{label} {impl}: launch counts {counted}, "
                             f"expected {want(TSTEPS)}")
    if not all(math.isfinite(x) for pair in losses for x in pair):
        raise AssertionError(f"{label} {impl}: non-finite {losses}")
    step_ms = statistics.median(times) * 1e3
    dev_ms, top = device_profile(lambda: setup.step_fn(
        state, place(next(batches))))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = batch_size * seq
    times_out = {
        "step_ms": step_ms, "step_ms_all": [t * 1e3 for t in times],
        "tokens_per_s": tokens / (step_ms / 1e3),
        "device_ms_per_step": dev_ms, "busy": dev_ms / step_ms,
        "peak_gib": peak, "loss_grad_norm": losses}
    log(f"{label} {impl}: step {step_ms:.1f} ms (median of {TSTEPS}: "
        f"{[round(t * 1e3, 1) for t in times]}), "
        f"{tokens / (step_ms / 1e3):.0f} tokens/s, device "
        f"{dev_ms:.1f} ms/step (busy {dev_ms / step_ms:.0%}), peak "
        f"{peak:.2f} GiB; (loss, grad norm) per step {losses}")
    for name, ms, calls in top[:5]:
        log(f"  top step: {ms:9.3f} ms  {calls:6d} calls  {name[:90]}")
    # The port's own kernels (the __global__ functions of csrc/), each
    # launch of a wrapper apart, e.g. the fused pair's Phi split, block
    # states and main kernels.
    ours = _port_kernels()
    log("  port kernels per step: " + "; ".join(
        f"{_kernel_name(name)} {ms:.3f} ms x{calls}"
        for name, ms, calls in top
        if _kernel_name(name).split("<")[0].split("::")[-1] in ours))
    del setup, state, params, batch, m
    torch.cuda.empty_cache()
    return times_out, counted


def phase_train(launches, train_times):
    """yi-9b at full width, TL layers, use_kernel=True, batch 4 x TN from
    lm_batches; lln then lln_diag."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    fwd = {"lln": "lln_causal", "lln_diag": "lln_diag_fused"}
    bwd = {"lln": "lln_causal_bwd", "lln_diag": "lln_diag_fused_bwd"}
    for impl in ("lln", "lln_diag"):
        cfg = get_config("yi-9b", attn_impl=impl, n_layers=TL,
                         use_kernel=True)

        def want(steps):
            out = {name: 0 for name in _counts()}
            out[fwd[impl]] = 2 * cfg.n_layers * steps
            out[bwd[impl]] = cfg.n_layers * steps
            return out

        train_times[impl], counted = _train_cell(cfg, B, TN, lm_batches,
                                                 want, "train")
        key = "lln_causal (res)" if impl == "lln" else fwd[impl]
        launches[key] += counted[fwd[impl]]
        launches[bwd[impl]] += counted[bwd[impl]]


def _lln_counts(bh, bg, n, d, dv, blk):
    """Bytes and operations of lln_causal (with den, "res", or with the
    final state, "state") and lln_causal_bwd at one shape, with ``blk`` the
    kernels' own block (lln_attention.TC_BLOCK): {name: (bytes, fp32 FLOPs,
    bf16 tensor-core FLOPs)}, and under the CUDA-core count (the linear
    form's fp32 work: Phi(q) S per query, the state update per key) with
    the key "... (CUDA cores)".  The products at the tensor cores' rate,
    an fp32 operand counted once per MMA its plane split takes: forward
    (two planes for the outputs, three for the states) Phi(q) Phi(k)^T
    three times and scores V twice per causal pair of a block, Phi(q) S_c
    three times per row past the first block, Phi(k)^T V three times per
    key before the last block (every key with the state); backward (three
    planes: fp32 x bf16 three MMAs, fp32 x fp32 six) per pair g v^T once,
    the scores, gmat Phi(k) and gmat^T Phi(q) six times each, scores^T u
    three times, per row past the first block u S_c^T and Phi(q)^T u
    three times each, per key before the last block the forward state
    three times, V dS_c^T three and Phi(k) dS_c six.  Exps, masks, sums,
    dots with z and the divisions are fp32 work.  Bytes: each input read
    once, each output written once."""
    f32, b16 = 4, 2
    sizes = [min(blk, n - b0) for b0 in range(0, n, blk)]
    pairs = bh * sum(m * (m + 1) // 2 for m in sizes)
    late, early = bh * (n - sizes[0]), bg * (n - sizes[-1])
    state = 2 * d * dv
    qsks = (bh + bg) * n * d * f32
    fwd_bytes = qsks + bg * n * dv * b16 + bh * n * dv * b16
    fwd_tc = pairs * (3 * 2 * d + 2 * 2 * dv) + late * 3 * state         + early * 3 * state
    fwd_f32 = (bh + bg) * n * d + pairs + late * 2 * d + bh * n * (dv + 2)         + bg * n * d
    bwd_bytes = qsks + bg * n * dv * b16 + 2 * bh * n * dv * b16         + bh * n * f32 + qsks + bg * n * dv * f32
    bwd_tc = pairs * (2 * dv + 3 * 6 * 2 * d + 3 * 2 * dv)         + late * 2 * 3 * state + early * (3 + 3 + 6) * state
    bwd_f32 = (bh + bg) * n * d + 3 * pairs + bh * n * (2 * dv + 3 * d)         + bg * n * 2 * d
    lln_fwd = bh * n * (2 * d * dv + 2 * d) + bg * n * (2 * d * dv + d) \
        + (bh + bg) * n * d
    lln_bwd = bh * n * (4 * d * dv + 3 * dv + 4 * d) \
        + bg * n * (6 * d * dv + 2 * d) + (bh + bg) * n * d
    res_bytes = fwd_bytes + bh * n * f32
    st_bytes = fwd_bytes + bh * (d * dv + d) * f32
    return {
        "lln_causal (res)": (res_bytes, fwd_f32, fwd_tc),
        "lln_causal (state)": (st_bytes, fwd_f32,
                               fwd_tc + bg * sizes[-1] * 3 * state),
        "lln_causal_bwd": (bwd_bytes, bwd_f32, bwd_tc),
        "lln_causal (res) (CUDA cores)": (res_bytes, lln_fwd, 0),
        "lln_causal (state) (CUDA cores)": (st_bytes, lln_fwd, 0),
        "lln_causal_bwd (CUDA cores)": (bwd_bytes, lln_bwd, 0),
    }


def _fused_counts(bh, bg, n, d, dv, blk):
    """Bytes and operations of lln_diag_fused and lln_diag_fused_bwd at one
    shape: {name: (bytes, fp32 FLOPs, bf16 tensor-core FLOPs)} under the
    convention of the block-softmax rows (products at the tensor cores'
    rate, an fp32 operand counted once per bf16 MMA it takes: fp32 x bf16
    twice, fp32 x fp32 three times; softmax steps and exps as fp32 work),
    and under the CUDA-core count (every product with an fp32 operand as
    fp32 work at the CUDA cores' rate) with the key "... (CUDA cores)".  Bytes: each input read once, each output written once.
    The block states are counted where this run's data needs them: Phi(q)
    S_c for the rows past the first block, the state updates for the keys
    (forward) and rows (reverse) before the last."""
    f32, b16 = 4, 2
    pairs = bh * (n // blk) * blk * (blk + 1) // 2
    late_rows, early_keys = bh * (n - blk), bg * (n - blk)
    exps = (bh + bg) * n * d
    qsks = bh * n * d * f32 + bg * n * d * f32
    fwd_bytes = qsks + (bh + bg) * n * d * b16 + bg * n * dv * b16 \
        + bh * n * dv * b16 + bh * n * f32
    bwd_bytes = qsks + (bh + bg) * n * d * b16 + bg * n * dv * b16 \
        + 2 * bh * n * dv * b16 + bh * n * f32 \
        + 2 * (bh + bg) * n * d * f32 + bg * n * dv * f32
    state = 2 * d * dv
    fwd_tc = pairs * (2 * d + 2 * 2 * dv + 3 * 2 * d + 2 * 2 * dv) \
        + late_rows * 3 * state + early_keys * 2 * state
    fwd_f32 = pairs * (SOFTMAX_FWD_OPS + 1) + exps + bh * n * (2 * d + 3 * dv)
    # Backward: the softmax part's 10 D + 6 Dv (block_diag_bwd's count),
    # the LLN scores Phi(q) Phi(k)^T, gmat Phi(k) and gmat^T Phi(q) (fp32 x
    # fp32), scores^T u (u = g / 2 den against bf16 g); the states u S^T,
    # Phi(q)^T u and V dS^T (fp32 x bf16) and Phi(k) dS (fp32 x fp32), and
    # the forward state Phi(k)^T V recomputed.
    bwd_tc = pairs * (10 * d + 6 * dv + 3 * 3 * 2 * d + 2 * 2 * dv) \
        + late_rows * 2 * 2 * state + early_keys * (2 + 2 + 3) * state \
        + early_keys * 2 * state
    bwd_f32 = pairs * (SOFTMAX_BWD_OPS + 2) + exps + bh * n * (2 * dv + 2 * d)
    lln_fwd = bh * n * (2 * d * dv + 2 * d) + bg * n * (2 * d * dv + d) \
        + (bh + bg) * n * d
    lln_bwd = bh * n * (4 * d * dv + 3 * dv + 4 * d) \
        + bg * n * (6 * d * dv + 2 * d) + (bh + bg) * n * d
    return {
        "lln_diag_fused": (fwd_bytes, fwd_f32, fwd_tc),
        "lln_diag_fused_bwd": (bwd_bytes, bwd_f32, bwd_tc),
        "lln_diag_fused (CUDA cores)": (
            fwd_bytes, lln_fwd + pairs * (2 * d + 1) + bh * n * dv * 2,
            pairs * 2 * d),
        "lln_diag_fused_bwd (CUDA cores)": (
            bwd_bytes, lln_bwd + pairs * (4 * d + 2 * dv + 6),
            pairs * (2 * d + 2 * dv)),
    }


def _bidir_counts(bh, bg, n, d, dv):
    """Bytes and operations of lln_bidir (with den) and lln_bidir_bwd at
    one shape: {name: (bytes, fp32 FLOPs, bf16 tensor-core FLOPs)}, and
    under the CUDA-core count (the linear form's fp32 work) with the key
    "... (CUDA cores)".  The products at the tensor cores' rate, an fp32
    operand counted once per MMA its plane split takes (two planes against
    two: three MMAs; three planes against bf16: three; three against
    three: six), 2 D Dv per row and MMA:
    - forward: the state Phi(k)^T v (Phi(k) in three planes, v bf16) 3
      per key; the apply Phi(q) s (both as hi + lo) 3 per query row;
    - backward: g s^T (g bf16, s in three planes) 3 per query row; the
      reverse state Phi(q)^T g (Phi(q) / den in three planes) 3 per query
      row; Phi(k) dS (both in three planes) 6 per key; V dS^T (V bf16)
      3 per key.
    fp32 work: the exps, z (a sum per key and column), den (a dot per
    row), out's division; w (a dot per row and a division), Phi(q) / den,
    dz (2 per row and column), the dq epilogue (3 per entry) and the dks
    epilogue (2 per entry).  Bytes: each input read once, each output
    written once."""
    f32, b16 = 4, 2
    state = 2 * d * dv
    qsks = (bh + bg) * n * d * f32
    exps = (bh + bg) * n * d
    fwd_bytes = qsks + bg * n * dv * b16 + bh * n * dv * b16 \
        + bh * n * f32 + bg * (d * dv + d) * f32
    bwd_bytes = qsks + bg * n * dv * b16 + 2 * bh * n * dv * b16 \
        + bh * n * f32 + bg * (d * dv + d) * f32 + (bh + bg) * n * d * f32 \
        + bg * n * dv * f32
    fwd_tc = bg * n * 3 * state + bh * n * 3 * state
    bwd_tc = bh * n * (3 + 3) * state + bg * n * (6 + 3) * state
    fwd_f32 = exps + bg * n * d + bh * n * (2 * d + dv)
    bwd_f32 = exps + bh * n * (2 * dv + 1) + bh * n * (d + 2 * d + 3 * d) \
        + bg * n * 2 * d
    lln_fwd = bh * n * (2 * d * dv + 2 * d) + bg * n * (2 * d * dv + d) \
        + exps
    lln_bwd = bh * n * (4 * d * dv + 3 * dv + 4 * d) \
        + bg * n * (4 * d * dv + 2 * d) + exps
    return {
        "lln_bidir": (fwd_bytes, fwd_f32, fwd_tc),
        "lln_bidir_bwd": (bwd_bytes, bwd_f32, bwd_tc),
        "lln_bidir (CUDA cores)": (fwd_bytes, lln_fwd, 0),
        "lln_bidir_bwd (CUDA cores)": (bwd_bytes, lln_bwd, 0),
    }


def _port_kernels():
    """The names of the __global__ functions in the port's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(\w+)")
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    return {m for f in csrc.glob("*.cu*") for m in pat.findall(f.read_text())}


def _kernel_name(key):
    """A profiler kernel key without its return type, anonymous namespace
    and argument list."""
    key = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return key.split("(")[0]


def phase_timings_train(errs, launches):
    """The four training kernels, their plain versions and their bounds at
    the training shapes.  Bounds count each input read once and each output
    written once, and the products at the tensor cores' rate:
    lln_causal and lln_causal_bwd by _lln_counts, the fused pair by
    _fused_counts; the CUDA-core count, with every fp32-operand product as
    fp32 work, is logged beside each.  lln_causal and lln_causal_bwd are
    also timed at the other blocks their tensor-core path could take.  The
    fused pair is also timed at zamba2-7b's shape (B=4, H=G=32,
    D=Dv=112, N=2048), returned apart."""
    from repro_torch.kernels.lln_attention import (lln_causal,
                                                   lln_causal_plain,
                                                   lln_diag_fused,
                                                   lln_diag_fused_plain)
    from repro_torch.kernels.lln_backward import (lln_causal_bwd,
                                                  lln_causal_bwd_plain,
                                                  lln_diag_fused_bwd,
                                                  lln_diag_fused_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    r = H // G
    bh, bg, n, dv = B * H, B * G, TN, D
    qs, ks, qk, kk, vk, g = _train_inputs(n, gen)
    o, den = lln_causal_plain(qs, ks, vk, r=r, blk=BLK, return_res=True,
                              return_state=False)
    fo, fden = lln_diag_fused_plain(qs, ks, qk, kk, vk, r=r, blk=BLK,
                                    return_res=True)
    lln_attention = _lln_module()
    counts = {**_fused_counts(bh, bg, n, D, dv, BLK),
              **_lln_counts(bh, bg, n, D, dv, lln_attention.TC_BLOCK)}
    specs = [
        ("lln_causal (res)", "lln_causal.cu", "lln_attention.py:94",
         lambda: lln_causal(qs, ks, vk, r=r, blk=BLK, return_res=True,
                            return_state=False),
         lambda: lln_causal_plain(qs, ks, vk, r=r, blk=BLK, return_res=True,
                                  return_state=False),
         counts["lln_causal (res)"]),
        ("lln_diag_fused", "lln_diag_fused.cu", "lln_attention.py:274",
         lambda: lln_diag_fused(qs, ks, qk, kk, vk, r=r, blk=BLK,
                                return_res=True),
         lambda: lln_diag_fused_plain(qs, ks, qk, kk, vk, r=r, blk=BLK,
                                      return_res=True),
         counts["lln_diag_fused"]),
        ("lln_causal_bwd", "lln_causal_bwd.cu", "lln_backward.py:160",
         lambda: lln_causal_bwd(qs, ks, vk, g, o, den, r=r, blk=BLK),
         lambda: lln_causal_bwd_plain(qs, ks, vk, g, o, den, r=r, blk=BLK),
         counts["lln_causal_bwd"]),
        ("lln_diag_fused_bwd", "lln_diag_fused_bwd.cu",
         "lln_backward.py:441",
         lambda: lln_diag_fused_bwd(qs, ks, qk, kk, vk, g, fo, fden, r=r,
                                    blk=BLK),
         lambda: lln_diag_fused_bwd_plain(qs, ks, qk, kk, vk, g, fo, fden,
                                          r=r, blk=BLK),
         counts["lln_diag_fused_bwd"]),
    ]
    rows = []
    for name, src, ref, kernel, plain, (nbytes, flops, tc) in specs:
        bnd, by = bound_ms(nbytes, flops, tc)
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=f"src/repro/kernels/{ref}", launches=launches[name],
            max_abs_err=errs[name], ms=cuda_ms(kernel, reps=10),
            plain_ms=cuda_ms(plain, reps=10), bound_ms=bnd, bound_by=by,
            library_ms=None))
        row = rows[-1]
        ob, oby = bound_ms(*counts[f"{name} (CUDA cores)"])
        log(f"timing {name}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) [CUDA-core count: {ob:.4f} ms ({oby})], "
            f"library none (no single PyTorch call computes LLN attention "
            f"or its gradient)")

    # The block of lln_causal's and lln_causal_bwd's tensor-core paths is
    # their own choice (lln_attention.TC_BLOCK): time the others beside it.
    chosen = lln_attention.TC_BLOCK
    try:
        for blk in (64, 128, 256):
            lln_attention.TC_BLOCK = blk
            fwd_ms = cuda_ms(specs[0][3], reps=10)
            bwd_ms = cuda_ms(specs[2][3], reps=10)
            log(f"timing TC_BLOCK {blk}{' (chosen)' if blk == chosen else ''}"
                f": lln_causal (res) {fwd_ms:.4f} ms, lln_causal_bwd "
                f"{bwd_ms:.4f} ms")
    finally:
        lln_attention.TC_BLOCK = chosen

    # The fused pair at zamba2-7b's shared attention (r = 1, D = Dv = 112).
    del qs, ks, qk, kk, vk, g, o, den, fo, fden
    zb, zh = ZB, H
    qs, ks, qk, kk, vk, g = _train_inputs(SN, gen, zb, zh, zh, ZD)
    fo, fden = lln_diag_fused_plain(qs, ks, qk, kk, vk, r=1, blk=BLK,
                                    return_res=True)
    fused = _fused_counts(zb * zh, zb * zh, SN, ZD, ZD, BLK)
    zamba2 = {}
    for name, kernel, plain in (
            ("lln_diag_fused",
             lambda: lln_diag_fused(qs, ks, qk, kk, vk, r=1, blk=BLK,
                                    return_res=True),
             lambda: lln_diag_fused_plain(qs, ks, qk, kk, vk, r=1, blk=BLK,
                                          return_res=True)),
            ("lln_diag_fused_bwd",
             lambda: lln_diag_fused_bwd(qs, ks, qk, kk, vk, g, fo, fden,
                                        r=1, blk=BLK),
             lambda: lln_diag_fused_bwd_plain(qs, ks, qk, kk, vk, g, fo,
                                              fden, r=1, blk=BLK))):
        bnd, by = bound_ms(*fused[name])
        ob, oby = bound_ms(*fused[f"{name} (CUDA cores)"])
        zamba2[name] = dict(ms=cuda_ms(kernel, reps=10),
                            plain_ms=cuda_ms(plain, reps=10), bound_ms=bnd,
                            bound_by=by, cuda_core_bound_ms=ob)
        row = zamba2[name]
        log(f"timing {name} (zamba2-7b shape B={zb} H=G={zh} D={ZD} "
            f"N={SN}): kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {bnd:.4f} ms ({by}) "
            f"[CUDA-core count: {ob:.4f} ms ({oby})]")
    return rows, zamba2


def phase_timings(errs, launches):
    """Each kernel, its plain version and (block_diag) one library call at
    the serve shapes; the bound counts each input read once, each output
    written once, and the operations the function needs: fp32, and the
    products at the tensor cores' bf16 rate (lln_causal: _lln_counts;
    block_diag: q k^T once and p v twice, p as hi + lo bf16), with the
    softmax's elementwise steps as fp32 work."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_diag import block_diag, block_diag_plain
    from repro_torch.kernels.lln_attention import (lln_causal, lln_causal_plain,
                                                   lln_decode, lln_decode_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    r = H // G
    bh, bg = B * H, B * G
    q, k, v, alpha, beta = _inputs(N, gen)
    qs, ks, _ = ops._scaled_stabilized(q, k, alpha, beta)
    qk, kk, vk = ops._to_kernel(q), ops._to_kernel(k), ops._to_kernel(v)
    rows = []

    counts = _lln_counts(bh, bg, N, D, D, _lln_module().TC_BLOCK)
    bnd, by = bound_ms(*counts["lln_causal (state)"])
    ob, oby = bound_ms(*counts["lln_causal (state) (CUDA cores)"])
    log(f"lln_causal (state) bound: {bnd:.4f} ms ({by}) [CUDA-core count: "
        f"{ob:.4f} ms ({oby})]")
    rows.append(dict(
        name="lln_causal (state)", route="cuda",
        source="src/repro_torch/csrc/lln_causal.cu",
        replaces="src/repro/kernels/lln_attention.py:94",
        launches=launches["lln_causal (state)"],
        max_abs_err=errs["lln_causal (state)"],
        ms=cuda_ms(lambda: lln_causal(qs, ks, vk, r=r, blk=BLK)),
        plain_ms=cuda_ms(lambda: lln_causal_plain(qs, ks, vk, r=r, blk=BLK)),
        bound_ms=bnd, bound_by=by, library_ms=None))

    nb = N // BLK
    pairs = nb * BLK * (BLK + 1) // 2
    nbytes = 2 * (bh * N * D + bg * N * D + bg * N * D + bh * N * D)
    bnd, by = bound_ms(nbytes, bh * pairs * SOFTMAX_FWD_OPS,
                       bh * pairs * (2 * D + 2 * 2 * D))

    def blocks(t):
        return t.reshape(B, nb, BLK, t.shape[2], D).permute(0, 1, 3, 2, 4) \
            .reshape(B * nb, t.shape[2], BLK, D)
    # SDPA yardstick: the same function on (B*nb, H, blk, D) blocks; k/v are
    # expanded to the H query heads before the timed call.
    qb = blocks(q)
    kb = blocks(torch.repeat_interleave(k, r, dim=2))
    vb = blocks(torch.repeat_interleave(v, r, dim=2))
    rows.append(dict(
        name="block_diag", route="cuda",
        source="src/repro_torch/csrc/block_diag.cu",
        replaces="src/repro/kernels/block_diag.py:109",
        launches=launches["block_diag"], max_abs_err=errs["block_diag"],
        ms=cuda_ms(lambda: block_diag(qk, kk, vk, r=r, blk=BLK, causal=True)),
        plain_ms=cuda_ms(lambda: block_diag_plain(qk, kk, vk, r=r, blk=BLK,
                                                  causal=True)),
        bound_ms=bnd, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, is_causal=True))))

    t = 1
    s0 = torch.randn(bh, D, D, generator=gen, device="cuda")
    z0 = torch.rand(bh, 1, D, generator=gen, device="cuda") + 0.5
    q1, k1, v1, a1, b1 = _inputs(t, gen)
    qs1, ks1, _ = ops._scaled_stabilized(q1, k1, a1, b1)
    vk1 = ops._to_kernel(v1)
    nbytes = (2 * bh * D * D * 4 + 2 * bh * D * 4 + bh * t * D * 4
              + bg * t * D * 4 + bg * t * D * 2 + bh * t * D * 2)
    flops = bh * t * (2 * D * D + 2 * D) + bh * t * (t + 1) // 2 * 4 * D \
        + bh * t * (2 * D * D + D)
    bnd, by = bound_ms(nbytes, flops)
    rows.append(dict(
        name="lln_decode", route="cuda",
        source="src/repro_torch/csrc/lln_decode.cu",
        replaces="src/repro/kernels/lln_attention.py:348",
        launches=launches["lln_decode"], max_abs_err=errs["lln_decode"],
        ms=cuda_ms(lambda: lln_decode(qs1, ks1, vk1, s0, z0, r=r)),
        plain_ms=cuda_ms(lambda: lln_decode_plain(qs1, ks1, vk1, s0, z0, r=r)),
        bound_ms=bnd, bound_by=by, library_ms=None))

    # The torch rescale of the carried state before each decode launch
    # (ops.lln_decode_chunk): a third pass over s, still outside the kernel.
    s_state = s0.reshape(B, H, D, D)
    resc = torch.rand(B, H, generator=gen, device="cuda")
    rescale_ms = cuda_ms(lambda: (s_state * resc[..., None, None]).reshape(
        bh, D, D))
    for row in rows:
        log(f"timing {row['name']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), library {row['library_ms']}")
    log(f"timing decode state rescale (torch, per layer, T=1): "
        f"{rescale_ms:.4f} ms")
    return rows, rescale_ms


# ---------------------------------------------------------------------------
# The encoder (roberta-lln, MLM pre-training).
# ---------------------------------------------------------------------------

def phase_kernels_encoder(results):
    """The encoder's kernels against their plain versions: lln_bidir,
    lln_bidir_bwd, block_diag_bwd and block_diag with causal=False, at
    N = 512 and a ragged 300, r = 1 and 4 (the r = 4 cases take the
    cotangent 0.5 g, as the hybrid passes it).  Outputs in bf16 within one
    bf16 step; s, z, den and every fp32 gradient within 1e-5 of the largest
    plain entry; two runs of lln_bidir, lln_bidir_bwd and block_diag_bwd
    bitwise equal."""
    from repro_torch.kernels.block_diag import (block_diag, block_diag_bwd,
                                                block_diag_bwd_plain,
                                                block_diag_plain)
    from repro_torch.kernels.lln_attention import lln_bidir, lln_bidir_plain
    from repro_torch.kernels.lln_backward import (lln_bidir_bwd,
                                                  lln_bidir_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)

    def keep(name, err):
        results[name] = max(results.get(name, 0.0), err)

    for g in (EH, 3):
        r = EH // g
        for n in (EN, ENR):
            qs, ks, qk, kk, vk, gk = _train_inputs(n, gen, EB, EH, g, ED)
            if r > 1:
                gk = 0.5 * gk
            log(f"lln_bidir N={n} r={r}:")
            got = lln_bidir(qs, ks, vk, r=r, return_res=True)
            again = lln_bidir(qs, ks, vk, r=r, return_res=True)
            want = lln_bidir_plain(qs, ks, vk, r=r, return_res=True)
            torch.cuda.synchronize()
            keep("lln_bidir", check("out", got[0], want[0],
                                    bf16_tol(want[0])))
            for name, gt, wt in zip(("s", "z", "den"), got[1:], want[1:]):
                keep("lln_bidir", check(name, gt, wt, fp32_tol(wt)))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"lln_bidir N={n} r={r}: two runs "
                                     f"differ")
            log("  two runs bitwise equal")
            o, s_, z_, den = want
            log(f"lln_bidir_bwd N={n} r={r}:")
            got = lln_bidir_bwd(qs, ks, vk, gk, o, den, s_, z_, r=r)
            again = lln_bidir_bwd(qs, ks, vk, gk, o, den, s_, z_, r=r)
            want = lln_bidir_bwd_plain(qs, ks, vk, gk, o, den, s_, z_, r=r)
            torch.cuda.synchronize()
            for name, gt, wt in zip(("dqs", "dks", "dv"), got, want):
                keep("lln_bidir_bwd", check(name, gt, wt, fp32_tol(wt)))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"lln_bidir_bwd N={n} r={r}: two runs "
                                     f"differ")
            log("  two runs bitwise equal")
            log(f"block_diag (causal=False) N={n} r={r} blk={BLK}:")
            got = block_diag(qk, kk, vk, r=r, blk=BLK, causal=False)
            want = block_diag_plain(qk, kk, vk, r=r, blk=BLK, causal=False)
            torch.cuda.synchronize()
            keep("block_diag (causal=False)",
                 check("out", got, want, bf16_tol(want)))
            log(f"block_diag_bwd (causal=False) N={n} r={r} blk={BLK}:")
            got = block_diag_bwd(qk, kk, vk, gk, r=r, blk=BLK, causal=False)
            want = block_diag_bwd_plain(qk, kk, vk, gk, r=r, blk=BLK,
                                        causal=False)
            torch.cuda.synchronize()
            for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
                keep("block_diag_bwd", check(name, gt, wt, fp32_tol(wt)))
            again = block_diag_bwd(qk, kk, vk, gk, r=r, blk=BLK, causal=False)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("block_diag_bwd: two runs differ")
            log("  two runs bitwise equal")


def phase_small_encoder():
    """roberta-lln SMOKE MLM training on the kernels against the core
    bidirectional form, then the train CLI --arch roberta-lln (SMOKE)."""
    from repro_torch.data.synthetic import mlm_batches
    _small_vs_core("roberta-lln", mlm_batches, "small_encoder")
    _train_cli(["--arch", "roberta-lln", "--smoke"])


def _enc_want(impl, n_layers, fwd_per_layer, bwd_per_layer):
    want = {name: 0 for name in _counts()}
    want["lln_bidir"] = fwd_per_layer * n_layers
    want["lln_bidir_bwd"] = bwd_per_layer * n_layers
    if impl == "lln_diag":
        want["block_diag"] = fwd_per_layer * n_layers
        want["block_diag_bwd"] = bwd_per_layer * n_layers
    return want


def _add_encoder_launches(launches, counted):
    """The encoder's launches; its non-causal block_diag apart from the
    serve path's (the kernels line times block_diag at the serve shapes)."""
    for name in ("lln_bidir", "lln_bidir_bwd", "block_diag_bwd"):
        launches[name] += counted[name]
    launches["block_diag (causal=False)"] += counted["block_diag"]


def phase_encoder_train(launches, enc_times):
    """roberta-lln at full width and depth, use_kernel=True, batch EB x EN
    from mlm_batches; lln then lln_diag.  Per step each layer runs the
    forward kernels twice (remat) and the backward kernels once."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import mlm_batches
    for impl in ("lln", "lln_diag"):
        cfg = get_config("roberta-lln", attn_impl=impl, use_kernel=True)
        enc_times[f"train {impl}"], counted = _train_cell(
            cfg, EB, EN, mlm_batches,
            lambda steps: _enc_want(impl, cfg.n_layers, 2 * steps, steps),
            "encoder_train")
        _add_encoder_launches(launches, counted)


def phase_encoder_forward(launches, enc_times):
    """Model.hidden plus the MLM logits of roberta-lln on bf16 weights
    under no_grad, batch EB x EN; kernels against the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.data import torch_placer
    from repro_torch.data.synthetic import mlm_batches
    from repro_torch.models import build_model
    from repro_torch.models.layers import logits_from_hidden
    for impl in ("lln", "lln_diag"):
        cfg = get_config("roberta-lln", attn_impl=impl, use_kernel=True,
                         param_dtype="bfloat16")
        model = build_model(cfg)
        params = model.init(SEED)
        batch = torch_placer("cuda")(next(mlm_batches(cfg.vocab, EB, EN,
                                                      seed=SEED + 1)))

        def forward(m=model):
            h, _ = m.hidden(params, batch)
            return logits_from_hidden(params.lm_head, h, cfg.cdtype)

        with torch.no_grad():
            forward()                               # warm-up (not counted)
            torch.cuda.synchronize()
            times = []
            for i in range(3):
                _reset()
                t0 = time.time()
                logits = forward()
                torch.cuda.synchronize()
                times.append(time.time() - t0)
                counted = _read()
                if counted != _enc_want(impl, cfg.n_layers, 1, 0):
                    raise AssertionError(f"encoder_forward {impl}: launches "
                                         f"{counted}")
            _add_encoder_launches(launches, counted)
            plain = build_model(cfg.replace(attn_backend="plain"))
            _reset()
            plain_logits = forward(plain)
            torch.cuda.synchronize()
            if any(_read().values()):
                raise AssertionError("the plain backend launched a kernel")
            dev_ms, top = device_profile(forward)
        if logits.shape != (EB, EN, cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"encoder_forward {impl}: logits "
                                 f"{tuple(logits.shape)}, non-finite?")
        # bf16 through 12 layers, as the serve check: 0.1 of the largest.
        tol = 0.1 * max(1.0, float(plain_logits.abs().max()))
        check(f"encoder_forward {impl} logits vs plain", logits,
              plain_logits, tol)
        ms = statistics.median(times) * 1e3
        enc_times[f"forward {impl}"] = {
            "ms": ms, "ms_all": [t * 1e3 for t in times],
            "tokens_per_s": EB * EN / (ms / 1e3), "device_ms": dev_ms,
            "busy": dev_ms / ms}
        log(f"encoder_forward {impl}: {ms:.2f} ms (median of 3), "
            f"{EB * EN / (ms / 1e3):.0f} tokens/s, device {dev_ms:.2f} ms "
            f"(busy {dev_ms / ms:.0%}); launches {counted}")
        for name, t, calls in top[:5]:
            log(f"  top forward: {t:9.3f} ms  {calls:6d} calls  {name[:90]}")
        del model, params, plain, logits, plain_logits
        torch.cuda.empty_cache()


def phase_timings_encoder(errs, launches):
    """The encoder's kernels, their plain versions and their bounds at the
    encoder shapes (B=32, H=G=12, N=512, D=Dv=64, blk 256, bf16).  Bounds
    count each input read once and each output written once, and the
    operations: lln_bidir and lln_bidir_bwd by _bidir_counts (the CUDA-core
    count logged beside); the block softmax per (query, key) pair its
    products at the tensor cores' bf16 rate, an fp32 left operand (p or
    dsm) counted twice since it goes in as hi + lo bf16 (forward q k^T and
    p v, 2 D + 4 Dv; backward q k^T, g v^T, dsm k, dsm^T q and p^T g,
    10 D + 6 Dv), and the softmax's elementwise steps as fp32 work
    (SOFTMAX_FWD_OPS, SOFTMAX_BWD_OPS).  Returns the three kernels' rows
    and block_diag's non-causal time, which is logged on a line of its own
    with the encoder's launches of it."""
    import torch.nn.functional as F
    from repro_torch.kernels.block_diag import (block_diag, block_diag_bwd,
                                                block_diag_bwd_plain,
                                                block_diag_plain)
    from repro_torch.kernels.lln_attention import lln_bidir, lln_bidir_plain
    from repro_torch.kernels.lln_backward import (lln_bidir_bwd,
                                                  lln_bidir_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    n, r = EN, 1
    bh = bg = EB * EH
    d = dv = ED
    qs, ks, qk, kk, vk, g = _train_inputs(n, gen, EB, EH, EH, ED)
    o, s_, z_, den = lln_bidir_plain(qs, ks, vk, r=r, return_res=True)
    f32, b16 = 4, 2
    counts = _bidir_counts(bh, bg, n, d, dv)
    pairs = bh * (n // BLK) * BLK * BLK
    qkvg = (bh + bg) * n * d * b16 + bg * n * dv * b16 + bh * n * dv * b16

    def blocks(t):
        nb = n // BLK
        return t.reshape(EB, EH, nb, BLK, t.shape[-1]).permute(0, 2, 1, 3, 4) \
            .reshape(EB * nb, EH, BLK, t.shape[-1])
    # SDPA yardsticks on (B*nb, H, blk, D) blocks (H = G: no repeat).
    qb, kb, vb, gb = (blocks(t) for t in (qk, kk, vk, g))
    qb, kb, vb = (t.detach().requires_grad_() for t in (qb, kb, vb))
    sdpa_out = F.scaled_dot_product_attention(qb, kb, vb)

    specs = [
        ("lln_bidir", "lln_bidir.cu", "lln_attention.py:166",
         lambda: lln_bidir(qs, ks, vk, r=r, return_res=True),
         lambda: lln_bidir_plain(qs, ks, vk, r=r, return_res=True),
         *counts["lln_bidir"], None),
        ("lln_bidir_bwd", "lln_bidir_bwd.cu", "lln_backward.py:261",
         lambda: lln_bidir_bwd(qs, ks, vk, g, o, den, s_, z_, r=r),
         lambda: lln_bidir_bwd_plain(qs, ks, vk, g, o, den, s_, z_, r=r),
         *counts["lln_bidir_bwd"], None),
        ("block_diag_bwd", "block_diag_bwd.cu", "block_diag.py:69",
         lambda: block_diag_bwd(qk, kk, vk, g, r=r, blk=BLK, causal=False),
         lambda: block_diag_bwd_plain(qk, kk, vk, g, r=r, blk=BLK,
                                      causal=False),
         qkvg + (bh + bg) * n * d * f32 + bg * n * dv * f32,
         pairs * SOFTMAX_BWD_OPS, pairs * (10 * d + 6 * dv),
         lambda: torch.autograd.grad(sdpa_out, (qb, kb, vb), gb,
                                     retain_graph=True)),
    ]
    rows = []
    for name, src, ref, kernel, plain, nbytes, flops, tc, library in specs:
        bnd, by = bound_ms(nbytes, flops, tc)
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=f"src/repro/kernels/{ref}", launches=launches[name],
            max_abs_err=errs[name], ms=cuda_ms(kernel, reps=10),
            plain_ms=cuda_ms(plain, reps=10), bound_ms=bnd, bound_by=by,
            library_ms=cuda_ms(library, reps=10) if library else None))
        row = rows[-1]
        core = counts.get(f"{name} (CUDA cores)")
        extra = " [CUDA-core count: {:.4f} ms ({})]".format(
            *bound_ms(*core)) if core else ""
        log(f"timing {name}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}){extra}, library {row['library_ms']}")
    # q, k, v in; out
    bnd, by = bound_ms(qkvg, pairs * SOFTMAX_FWD_OPS, pairs * (2 * d + 4 * dv))
    nc = dict(
        launches=launches["block_diag (causal=False)"],
        max_abs_err=errs["block_diag (causal=False)"],
        ms=cuda_ms(lambda: block_diag(qk, kk, vk, r=r, blk=BLK,
                                      causal=False), reps=10),
        plain_ms=cuda_ms(lambda: block_diag_plain(qk, kk, vk, r=r, blk=BLK,
                                                  causal=False), reps=10),
        bound_ms=bnd, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb), reps=10))
    log(f"timing block_diag (causal=False, encoder shapes B={EB} H={EH} "
        f"N={n} D={d} blk={BLK}): kernel {nc['ms']:.4f} ms, plain "
        f"{nc['plain_ms']:.4f} ms, bound {nc['bound_ms']:.4f} ms "
        f"({nc['bound_by']}), library {nc['library_ms']:.4f} ms (SDPA), "
        f"encoder launches {nc['launches']}")
    return rows, nc


# ---------------------------------------------------------------------------
# The log-linear serving path (yi-9b, attn_impl log_linear).
# ---------------------------------------------------------------------------

def phase_kernels_loglin(results):
    """loglin_causal against its plain version at the serve shapes, N =
    LN (8 granules: the top level fills) and a ragged LNR, with and without
    the state: out within one bf16 step, the pyramid and the open bucket
    within 1e-5 of the largest plain entry, two runs bitwise equal.  Then the two-pass decode
    (ops.loglin_decode_chunk) on the kernels against the plain versions
    from the ragged prefill's state: T = 1, and T = 100, which crosses the
    granule boundary and runs each pass as two chained launches."""
    from repro_torch.core.loglinear import LogLinState
    from repro_torch.kernels import ops
    from repro_torch.kernels.lln_attention import MAX_DECODE_T, lln_decode
    from repro_torch.kernels.loglinear import (loglin_causal,
                                               loglin_causal_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    r = H // G
    kw = dict(r=r, blk=BLK, num_scales=LEVELS, scale_decay=DECAY)
    for n in (LN, LNR):
        q, k, v, alpha, beta = _inputs(n, gen)
        qs, ks, _ = ops._scaled_stabilized(q, k, alpha, beta)
        vk = ops._to_kernel(v)
        for state in (True, False):
            log(f"loglin_causal N={n} return_state={state}:")
            got = loglin_causal(qs, ks, vk, return_state=state, **kw)
            want = loglin_causal_plain(qs, ks, vk, return_state=state, **kw)
            torch.cuda.synchronize()
            if not state:
                got, want = (got,), (want,)
            results["loglin_causal"] = max(
                results.get("loglin_causal", 0.0),
                check("out", got[0], want[0], bf16_tol(want[0])))
            for name, gt, wt in zip(("sl", "zl", "s", "z"), got[1:],
                                    want[1:]):
                check(name, gt, wt, fp32_tol(wt))
            again = loglin_causal(qs, ks, vk, return_state=state, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in
                       zip(got, again if state else (again,))):
                raise AssertionError(f"loglin_causal N={n}: two runs differ")
            log("  two runs bitwise equal")
    pre = ops.loglin_prefill(q, k, v, alpha, beta, chunk=BLK,
                             num_scales=LEVELS, scale_decay=DECAY,
                             backend="plain")
    st = LogLinState(*pre[1:], log_scale=torch.zeros(B, H, device="cuda"))
    pos = torch.full((B,), LNR, dtype=torch.int32, device="cuda")
    for t in (1, 100):
        q1, k1, v1, a1, b1 = _inputs(t, gen)
        runs = {}
        before = lln_decode.launches
        for kind in ("kernel", "plain"):
            runs[kind] = ops.loglin_decode_chunk(
                st, q1, k1, v1, alpha, beta, pos=pos, granule=BLK,
                num_scales=LEVELS, scale_decay=DECAY, backend=kind)
        torch.cuda.synchronize()
        n_launch = lln_decode.launches - before
        log(f"loglin decode T={t} from pos {LNR} (kernel vs plain, "
            f"{n_launch} lln_decode launches):")
        # Two passes per granule-sized sub-chunk, each in launches of at
        # most MAX_DECODE_T tokens: 2 for T = 1, 4 for T = 100.
        want = 2 * sum(-(-min(BLK, t - i) // MAX_DECODE_T)
                       for i in range(0, t, BLK))
        if n_launch != want:
            raise AssertionError(f"loglin decode T={t}: {n_launch} "
                                 f"launches, expected {want}")
        (go, gs), (wo, ws) = runs["kernel"], runs["plain"]
        check("out", go, wo, bf16_tol(wo))
        for name in ("s", "z", "c_k", "sl", "zl", "cl"):
            check(name, getattr(gs, name), getattr(ws, name),
                  fp32_tol(getattr(ws, name)))


def _serve_logits(setup, params, batch, toks, pos0, steps):
    """Prefill, then ``steps`` decode steps teacher-forced with ``toks``
    from position ``pos0``; returns (prefill logits, [step logits])."""
    logits, caches = setup.prefill_fn(params, batch)
    out = []
    for i in range(steps):
        step, caches = setup.decode_fn(params, caches, toks[:, i], pos0 + i)
        out.append(step)
    return logits, out


def phase_small_loglin():
    """yi-9b SMOKE in fp32 with log_linear (granule 16, 4 levels) on the
    card: the kernels (auto) against the core reference (ref), prompts 112
    (aligned) and 120 (ragged) and 24 greedy steps, so decode crosses
    position 127 (7 -> 8 closed granules: a carry through every level into
    the top).  The ref run is teacher-forced with the kernels' tokens;
    logits within 1e-4 and equal greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import synthetic_batch
    steps = 24
    for prompt in (112, 120):
        runs = {}
        for backend in ("auto", "ref"):
            cfg = get_config("yi-9b", smoke=True, attn_impl="log_linear",
                             compute_dtype="float32", attn_backend=backend)
            setup = make_serve_setup(cfg, ShapeSpec("small", prompt + steps,
                                                    2, "decode"))
            params = setup.model.init(SEED)
            batch = synthetic_batch(cfg, 2, prompt + steps, text_seq=prompt,
                                    device="cuda")
            if backend == "auto":
                logits, caches = setup.prefill_fn(params, batch)
                tok = torch.argmax(logits[:, -1], -1)
                rest, _ = setup.make_generate(steps - 1)(params, caches, tok,
                                                         prompt)
                toks = torch.cat([tok[:, None], rest], 1)
            runs[backend] = _serve_logits(setup, params, batch, toks, prompt,
                                          steps)
        log(f"small_loglin prompt {prompt} (SMOKE fp32, kernels vs core "
            f"ref, {steps} steps to position {prompt + steps - 1}):")
        check("prefill logits", runs["auto"][0], runs["ref"][0], 1e-4)
        err = max(max_err(a, b) for a, b in zip(runs["auto"][1],
                                                 runs["ref"][1]))
        check("decode logits (all steps)", torch.tensor(err),
              torch.tensor(0.0), 1e-4)
        ref_toks = torch.stack([torch.argmax(x, -1) for x in runs["ref"][1]],
                               1)
        if not torch.equal(ref_toks[:, :-1], toks[:, 1:]):
            raise AssertionError(f"small_loglin {prompt}: greedy tokens "
                                 f"differ")
        log(f"  greedy tokens equal: {toks[0].tolist()}")


def phase_serve_loglin(launches, serve_times):
    """yi-9b at full width and depth with log_linear (bf16 weights from the
    seed), batch B, prompt LNR (7 closed granules and 248 open keys), GEN
    greedy tokens: decode crosses position 2047 (7 -> 8 closed granules).
    Exact launch counts: one loglin_causal per layer per prefill, two
    lln_decode per layer per decode step, nothing else.  Prefill logits,
    and the logits of the step that crosses (teacher-forced with the same
    tokens), against the plain backend within 0.1 of the largest."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import synthetic_batch
    cfg = get_config("yi-9b", attn_impl="log_linear", param_dtype="bfloat16")
    setup = make_serve_setup(cfg, ShapeSpec("chip", LNR + GEN, B, "decode"))
    params = setup.model.init(SEED)
    log(f"serve_loglin: yi-9b {cfg.n_layers}L, log_linear (granule "
        f"{cfg.lln_chunk}, {cfg.lln_num_scales} levels, decay "
        f"{cfg.lln_scale_decay}), batch {B}, prompt {LNR}, {GEN} greedy "
        f"tokens")
    batch = synthetic_batch(cfg, B, LNR + GEN, seed=SEED, text_seq=LNR,
                            device="cuda")
    setup.prefill_fn(params, batch)                 # warm-up (not counted)
    torch.cuda.synchronize()

    _reset()
    t0 = time.time()
    logits, caches = setup.prefill_fn(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.time() - t0
    pre = _read()
    _reset()
    tok = torch.argmax(logits[:, -1], -1)
    toks = [tok]
    logits1, caches = setup.decode_fn(params, caches, tok, LNR)
    tok = torch.argmax(logits1, -1)
    toks.append(tok)
    torch.cuda.synchronize()
    t0 = time.time()
    rest, caches = setup.make_generate(GEN - 2)(params, caches, tok, LNR + 1)
    torch.cuda.synchronize()
    t_steady = time.time() - t0
    dec = _read()
    toks = torch.cat([torch.stack(toks, 1), rest], 1)

    idle = {name: 0 for name in _counts()}
    want_pre = {**idle, "loglin_causal": cfg.n_layers}
    want_dec = {**idle, "lln_decode": 2 * cfg.n_layers * (GEN - 1)}
    log(f"log_linear: prefill launches {pre}, decode launches {dec}")
    if pre != want_pre or dec != want_dec:
        raise AssertionError(f"log_linear: launch counts {pre} / {dec}, "
                             f"expected {want_pre} / {want_dec}")
    launches["loglin_causal"] += pre["loglin_causal"]
    launches["lln_decode (log_linear)"] += dec["lln_decode"]
    if toks.shape != (B, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"log_linear: tokens out of range: {toks}")
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(logits1).all())):
        raise AssertionError("log_linear: non-finite logits")

    # Teacher-forced with the kernels' tokens to the step at position 2047,
    # on the kernels and on the plain versions.
    cross = LN - 1 - LNR + 1                   # steps up to position 2047
    plain = make_serve_setup(cfg.replace(attn_backend="plain"),
                             ShapeSpec("chip", LNR + GEN, B, "decode"))
    k_pre, k_steps = _serve_logits(setup, params, batch, toks, LNR, cross)
    _reset()
    p_pre, p_steps = _serve_logits(plain, params, batch, toks, LNR, cross)
    torch.cuda.synchronize()
    if any(_read().values()):
        raise AssertionError("the plain backend launched a kernel")
    # bf16 through 48 layers, as the lln serve check: 0.1 of the largest.
    tol = 0.1 * max(1.0, float(p_pre.abs().max()))
    check("log_linear prefill logits vs plain", logits, p_pre, tol)
    tol = 0.1 * max(1.0, float(p_steps[-1].abs().max()))
    check(f"log_linear logits at position {LNR + cross - 1} (closes "
          f"granule 7) vs plain", k_steps[-1], p_steps[-1], tol)
    if not all(bool(torch.isfinite(x).all()) for x in k_steps):
        raise AssertionError("log_linear: non-finite decode logits")
    agree = float((torch.argmax(logits[:, -1], -1)
                   == torch.argmax(p_pre[:, -1], -1)).float().mean())
    log(f"  first-token agreement with plain: {agree:.2f}")
    del plain, k_pre, k_steps, p_pre, p_steps

    step_ms = t_steady / (GEN - 2) * 1e3
    pre_dev, pre_top = device_profile(lambda: setup.prefill_fn(params, batch))
    steps = 4
    dec_dev, dec_top = device_profile(
        lambda: setup.make_generate(steps)(params, caches, tok, LNR + GEN))
    dec_dev /= steps
    serve_times["log_linear"] = {
        "prefill_ms": t_prefill * 1e3, "decode_ms_per_step": step_ms,
        "decode_tok_s": B / (step_ms / 1e3),
        "prefill_device_ms": pre_dev, "decode_device_ms_per_step": dec_dev,
        "prefill_busy": pre_dev / (t_prefill * 1e3),
        "decode_busy": dec_dev / step_ms}
    log(f"log_linear: prefill {t_prefill * 1e3:.2f} ms (device "
        f"{pre_dev:.2f} ms); decode {step_ms:.3f} ms/step "
        f"({B / (step_ms / 1e3):.1f} tok/s, device {dec_dev:.3f} ms/step) "
        f"over {GEN - 2} steps; tokens[0] {toks[0].tolist()}")
    for label, top in (("prefill", pre_top), ("decode x4", dec_top)):
        for name, ms, calls in top[:5]:
            log(f"  top {label}: {ms:9.3f} ms  {calls:6d} calls  "
                f"{name[:90]}")
    del setup, caches, params
    torch.cuda.empty_cache()


def _loglin_counts(bh, bg, n, d, dv, blk, levels):
    """Bytes and operations of loglin_causal with the state at one shape:
    {route: (bytes, fp32 FLOPs, bf16 tensor-core FLOPs)}.  Bytes: each
    input read once, out and the state (pyramid and open bucket, r copies)
    written once.  "tensor cores" (the bf16-v path) counts the products at
    the tensor cores' rate, an fp32 operand once per MMA its plane split
    takes: Phi(q) Phi(k)^T three times (hi + lo against hi + lo) and scores
    V twice per causal pair of a granule, Phi(q) A_j three times for the
    rows past the first granule, Phi(k)^T V three times per key; the exps,
    row sums, Phi(q) . zA_j, den and the pyramid's weighted sums as fp32.
    "CUDA cores" is the earlier count, every product as fp32 work in the
    linear form (Phi(q) times the weighted state per query, the state
    update per key)."""
    f32, b16 = 4, 2
    nbytes = (bh + bg) * n * d * f32 + bg * n * dv * b16 + bh * n * dv * b16 \
        + bh * (levels + 1) * (d * dv + d) * f32
    sizes = [min(blk, n - g0) for g0 in range(0, n, blk)]
    pairs = bh * sum(m * (m + 1) // 2 for m in sizes)
    late = bh * (n - sizes[0])
    nf = n // blk
    tc = pairs * (3 * 2 * d + 2 * 2 * dv) + late * 3 * 2 * d * dv \
        + bg * n * 3 * 2 * d * dv
    fp = (bh + bg) * n * d + pairs + late * 2 * d + bh * n * (dv + 2) \
        + bg * n * d + bg * nf * 2 * levels * (d * dv + d)
    cores = bh * n * (2 * d * dv + 2 * d) + bg * n * (2 * d * dv + d) \
        + bg * nf * 2 * levels * (d * dv + d) + (bh + bg) * n * d
    return {"tensor cores": (nbytes, fp, tc), "CUDA cores": (nbytes, cores, 0)}


def phase_timings_loglin(errs, launches):
    """loglin_causal (with the state, as the prefill runs it) and its plain
    version at the serve shapes, N = LN; the bound from _loglin_counts (the
    tensor-core count, the CUDA-core count logged beside it)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.loglinear import (loglin_causal,
                                               loglin_causal_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    r = H // G
    bh, bg, n, d = B * H, B * G, LN, D
    q, k, v, alpha, beta = _inputs(n, gen)
    qs, ks, _ = ops._scaled_stabilized(q, k, alpha, beta)
    vk = ops._to_kernel(v)
    kw = dict(r=r, blk=BLK, num_scales=LEVELS, scale_decay=DECAY,
              return_state=True)
    counts = _loglin_counts(bh, bg, n, d, d, BLK, LEVELS)
    bnd, by = bound_ms(*counts["tensor cores"])
    ob, oby = bound_ms(*counts["CUDA cores"])
    row = dict(
        name="loglin_causal", route="cuda",
        source="src/repro_torch/csrc/loglin_causal.cu",
        replaces="src/repro/kernels/loglinear.py:111",
        launches=launches["loglin_causal"],
        max_abs_err=errs["loglin_causal"],
        ms=cuda_ms(lambda: loglin_causal(qs, ks, vk, **kw), reps=10),
        plain_ms=cuda_ms(lambda: loglin_causal_plain(qs, ks, vk, **kw),
                         reps=10),
        bound_ms=bnd, bound_by=by, library_ms=None)
    log(f"timing loglin_causal (N={n}, state): kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}) [CUDA-core count: {ob:.4f} ms ({oby})], "
        f"library none (no PyTorch call computes log-linear attention)")
    log(f"lln_decode launches on the log_linear serve path: "
        f"{launches['lln_decode (log_linear)']} (2 per layer per decode "
        f"step; the kernels line's lln_decode row counts the lln serve)")
    return row


# ---------------------------------------------------------------------------
# The SSM training path (mamba2-130m, and zamba2-7b with lln_diag).
# ---------------------------------------------------------------------------

def _ssd_inputs(gen, b, h, g, n, p, s, dtype):
    """Kernel-layout SSD inputs as ssm_apply makes them: dt = softplus(.),
    log a = dt * a with a = -exp(a_log) over the config's linspace(1, 16)
    (the fastest head decays by e^-16 per step at dt = 1), xbar = x dt, B/C
    in ``dtype``."""
    dev = "cuda"
    dt = torch.nn.functional.softplus(
        torch.randn(b, h, n, generator=gen, device=dev) * 0.5 - 0.5)
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    log_a = (dt * a[None, :, None]).reshape(b * h, n).contiguous()
    xbar = (torch.randn(b * h, n, p, generator=gen, device=dev)
            * dt.reshape(b * h, n, 1)).contiguous()
    b_in = torch.randn(b * g, n, s, generator=gen, device=dev).to(dtype)
    c_in = torch.randn(b * g, n, s, generator=gen, device=dev).to(dtype)
    return log_a, xbar, b_in, c_in


def _model_layout(args, b, h, g):
    """Kernel-layout SSD inputs -> ops.ssd_scan's (xbar, b_in, c_in, log_a)
    in model layout: (B, L, H, P), (B, L, G, S) twice, (B, L, H)."""
    log_a, xbar, b_in, c_in = args
    n, p, s = xbar.shape[1], xbar.shape[2], b_in.shape[2]
    return [xbar.reshape(b, h, n, p).transpose(1, 2),
            b_in.reshape(b, g, n, s).transpose(1, 2),
            c_in.reshape(b, g, n, s).transpose(1, 2),
            log_a.reshape(b, h, n).transpose(1, 2)]


def _ssd_tol(want) -> float:
    """fp32 sums over up to N steps in another order, and a cumulative sum
    of log a taken in another order (lcum reaches -2e3 in a chunk of the
    fastest head, so its differences carry a few 1e-4 absolute): 1e-4 of
    the largest entry."""
    return 1e-4 * max(1.0, float(want.detach().abs().max()))


def phase_kernels_ssd(results):
    """ssd against ssd_plain at the mamba2-130m and zamba2-7b train shapes
    (bf16 B/C) and at G=4 groups of a small H (fp32 B/C), two runs bitwise
    equal; then ops.ssd_scan on the kernel route against the plain route
    (both differentiate the core scan): y within _ssd_tol, the gradients of
    all four inputs within 1e-5 of the largest entry."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd import ssd, ssd_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    cases = (("mamba2-130m", SB, SH, 1, SN, SP, SS, torch.bfloat16),
             ("zamba2-7b", ZB, ZH, 1, SN, SP, ZS, torch.bfloat16),
             ("G=4", 2, 8, 4, 1024, SP, ZS, torch.float32))
    for label, b, h, g, n, p, s, dtype in cases:
        args = _ssd_inputs(gen, b, h, g, n, p, s, dtype)
        log(f"ssd {label} (B={b} H={h} G={g} N={n} P={p} S={s} {dtype}):")
        got = ssd(*args, r=h // g, blk=BLK)
        again = ssd(*args, r=h // g, blk=BLK)
        want = ssd_plain(*args, r=h // g, blk=BLK)
        torch.cuda.synchronize()
        results["ssd"] = max(results.get("ssd", 0.0),
                             check("y", got, want, _ssd_tol(want)))
        if not torch.equal(got, again):
            raise AssertionError(f"ssd {label}: two runs differ")
        log("  two runs bitwise equal")
    b, l, h, g, p, s = 2, 1024, 8, 2, SP, ZS
    inputs = _model_layout(
        _ssd_inputs(gen, b, h, g, l, p, s, torch.float32), b, h, g)
    cot = torch.randn(b, l, h, p, generator=gen, device="cuda")
    runs = {}
    for kind in ("kernel", "plain"):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        y = ops.ssd_scan(*leaves, BLK, backend=kind)
        runs[kind] = (y.detach(), torch.autograd.grad(y, leaves, cot))
    torch.cuda.synchronize()
    log(f"ops.ssd_scan kernel vs plain route (B={b} L={l} H={h} G={g}):")
    (yk, gk), (yp, gp) = runs["kernel"], runs["plain"]
    check("y", yk, yp, _ssd_tol(yp))
    for name, a, w in zip(("dxbar", "db", "dc", "dlog_a"), gk, gp):
        check(name, a, w, fp32_tol(w))


def phase_kernels_hybrid_attn(results):
    """lln_diag_fused and lln_diag_fused_bwd against their plain versions at
    zamba2-7b's shared attention: D = Dv = 112, not a multiple of the
    kernels' 32-column tile.  Out within one bf16 step, den and the
    gradients within 1e-5 of the largest plain entry."""
    from repro_torch.kernels.lln_attention import (lln_diag_fused,
                                                   lln_diag_fused_plain)
    from repro_torch.kernels.lln_backward import (lln_diag_fused_bwd,
                                                  lln_diag_fused_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    qs, ks, qk, kk, vk, g = _train_inputs(SN, gen, ZB, H, H, ZD)
    name = "lln_diag_fused (D=112)"
    log(f"lln_diag_fused B={ZB} H=G={H} D={ZD} N={SN} blk={BLK}:")
    got = lln_diag_fused(qs, ks, qk, kk, vk, r=1, blk=BLK, return_res=True)
    o, den = lln_diag_fused_plain(qs, ks, qk, kk, vk, r=1, blk=BLK,
                                  return_res=True)
    torch.cuda.synchronize()
    results[name] = max(check("out", got[0], o, bf16_tol(o)),
                        check("den", got[1], den, fp32_tol(den)))
    log(f"lln_diag_fused_bwd B={ZB} H=G={H} D={ZD} N={SN} blk={BLK}:")
    got = lln_diag_fused_bwd(qs, ks, qk, kk, vk, g, o, den, r=1, blk=BLK)
    want = lln_diag_fused_bwd_plain(qs, ks, qk, kk, vk, g, o, den, r=1,
                                    blk=BLK)
    torch.cuda.synchronize()
    results["lln_diag_fused_bwd (D=112)"] = max(
        check(n_, gt, wt, fp32_tol(wt))
        for n_, gt, wt in zip(("dqs", "dqd", "dks", "dkd", "dv"), got, want))


def phase_small_ssm():
    """mamba2-130m SMOKE trained on the kernels against the core reference
    (use_kernel=False: the core SSD scan), and zamba2-7b SMOKE with
    lln_diag against backend ref (the core SSD scan and the core attention
    with alpha and beta held constant, as the kernels' ops hold them; with
    use_kernel=False the reference also differentiates through the
    calibration statistics, a gradient the kernel path leaves out by
    design), then the train CLI --arch mamba2-130m --smoke."""
    from repro_torch.data.synthetic import lm_batches
    _small_vs_core("mamba2-130m", lm_batches, "small_ssm", (None,),
                   {"use_kernel": False})
    _small_vs_core("zamba2-7b", lm_batches, "small_ssm", ("lln_diag",))
    _train_cli(["--arch", "mamba2-130m", "--smoke"])


def phase_ssm_train(launches, train_times):
    """mamba2-130m at full size, use_kernel=True, batch SB x SN from
    lm_batches.  Per step each layer runs ssd twice (forward and remat);
    the backward differentiates the core scan."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    cfg = get_config("mamba2-130m", use_kernel=True)

    def want(steps):
        return {**{name: 0 for name in _counts()},
                "ssd": 2 * cfg.n_layers * steps}

    train_times["mamba2-130m"], counted = _train_cell(
        cfg, SB, SN, lm_batches, want, "ssm_train", probe=SSM_IN)
    launches["ssd"] += counted["ssd"]


def phase_hybrid_train(launches, train_times):
    """zamba2-7b at full width with HL layers, lln_diag, use_kernel=True,
    batch ZB x SN from lm_batches.  Per step: ssd twice per layer, the
    fused forward twice and its backward once per shared application."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    cfg = get_config("zamba2-7b", attn_impl="lln_diag", n_layers=HL,
                     use_kernel=True)
    shared = cfg.n_layers // cfg.shared_attn_period

    def want(steps):
        return {**{name: 0 for name in _counts()},
                "ssd": 2 * cfg.n_layers * steps,
                "lln_diag_fused": 2 * shared * steps,
                "lln_diag_fused_bwd": shared * steps}

    train_times["zamba2-7b lln_diag"], counted = _train_cell(
        cfg, ZB, SN, lm_batches, want, "hybrid_train", probe=QKV + SSM_IN)
    launches["ssd"] += counted["ssd"]
    for name in ("lln_diag_fused", "lln_diag_fused_bwd"):
        launches[f"{name} (hybrid)"] += counted[name]


def _ssd_counts(bh, bg, n, p, s, blk):
    """Bytes and operations of ssd at one shape: {route: (bytes, fp32
    FLOPs, bf16 tensor-core FLOPs)}.  Bytes: each input read once, y written
    once.  "tensor cores" (the bf16 B/C path) counts the products at the
    tensor cores' rate, an fp32 operand once per MMA its plane split takes:
    C B^T once (bf16 against bf16) and the decayed scores against xbar
    three times (hi + lo against hi + lo) per causal pair of a chunk, C
    state_c twice for the rows past the first chunk, B^T (e(.) xbar) three
    times (bf16 B against three planes) per step before the last chunk;
    the decay mask (subtract, exp, multiply per pair), the cumulative sum,
    the row and step exps, e(.) xbar and the state recurrence as fp32.  "CUDA cores" is the
    earlier count, the recurrent form's fp32 work: 4 S P FLOPs per head and
    step (C.state and the state update) plus one exp."""
    nbytes = bh * n * 4 + 2 * bh * n * p * 4 + 2 * bg * n * s * 2
    nc = n // blk
    pairs = bh * nc * blk * (blk + 1) // 2
    late = bh * (n - blk)
    tc = pairs * (2 * s + 3 * 2 * p) + late * 2 * 2 * s * p \
        + late * 3 * 2 * s * p
    fp = pairs * 3 + bh * n * (3 + p) + bh * (nc - 1) * 2 * s * p
    return {"tensor cores": (nbytes, fp, tc),
            "CUDA cores": (nbytes, bh * n * (4 * s * p + 1), 0)}


def phase_timings_ssd(errs, launches):
    """ssd and its plain version at the mamba2-130m shape (the kernels
    line's row) and at the zamba2-7b shape (a line of its own), bf16 B/C;
    the bound from _ssd_counts (the tensor-core count, the CUDA-core count
    logged beside it).  Also one layer's ops.ssd_scan, forward (the kernel)
    and forward plus backward (the backward differentiates the core scan),
    at both shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd import ssd, ssd_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 10)
    out, layer = {}, {}
    for label, b, h, s in (("mamba2-130m", SB, SH, SS),
                           ("zamba2-7b", ZB, ZH, ZS)):
        bh, n, p = b * h, SN, SP
        args = _ssd_inputs(gen, b, h, 1, n, p, s, torch.bfloat16)
        counts = _ssd_counts(bh, b, n, p, s, BLK)
        bnd, by = bound_ms(*counts["tensor cores"])
        ob, oby = bound_ms(*counts["CUDA cores"])
        out[label] = dict(
            name="ssd", route="cuda", source="src/repro_torch/csrc/ssd.cu",
            replaces="src/repro/kernels/ssd.py:61", launches=launches["ssd"],
            max_abs_err=errs["ssd"],
            ms=cuda_ms(lambda: ssd(*args, r=h, blk=BLK), reps=10),
            plain_ms=cuda_ms(lambda: ssd_plain(*args, r=h, blk=BLK), reps=10),
            bound_ms=bnd, bound_by=by, library_ms=None)
        row = out[label]
        log(f"timing ssd ({label} shape B={b} H={h} N={n} P={p} S={s}, bf16 "
            f"B/C): kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) "
            f"[CUDA-core count: {ob:.4f} ms ({oby})], library none (no "
            f"single PyTorch call computes the SSD scan)")
        leaves = [t.requires_grad_() for t in _model_layout(args, b, h, 1)]
        cot = torch.randn(b, n, h, p, generator=gen, device="cuda")
        fwd = cuda_ms(lambda: ops.ssd_scan(*leaves, BLK, backend="kernel"),
                      reps=5)
        both = cuda_ms(lambda: torch.autograd.grad(
            ops.ssd_scan(*leaves, BLK, backend="kernel"), leaves, cot),
            reps=5)
        layer[label] = {"layer_fwd_ms": fwd, "layer_fwd_bwd_ms": both}
        log(f"timing ops.ssd_scan ({label} layer): forward {fwd:.4f} ms, "
            f"forward + backward {both:.4f} ms (backward through the core "
            f"scan {both - fwd:.4f} ms)")
    log(f"lln_diag_fused / lln_diag_fused_bwd launches on the hybrid train "
        f"path (D=112): {launches['lln_diag_fused (hybrid)']} / "
        f"{launches['lln_diag_fused_bwd (hybrid)']}; max abs err at D=112 "
        f"{errs['lln_diag_fused (D=112)']:.3e} / "
        f"{errs['lln_diag_fused_bwd (D=112)']:.3e}")
    return out["mamba2-130m"], out["zamba2-7b"], layer


def main():
    smi = phase_device()
    phase_build()
    errs, serve_times, train_times = {}, {}, {}
    enc_times = {}
    launches = {name: 0 for name in (
        "lln_causal (state)", "block_diag", "lln_decode", "lln_causal (res)",
        "lln_diag_fused", "lln_causal_bwd", "lln_diag_fused_bwd",
        "lln_bidir", "lln_bidir_bwd", "block_diag_bwd",
        "block_diag (causal=False)", "loglin_causal",
        "lln_decode (log_linear)", "ssd", "lln_diag_fused (hybrid)",
        "lln_diag_fused_bwd (hybrid)")}
    phase_kernels(errs)
    phase_kernels_train(errs)
    phase_kernels_encoder(errs)
    phase_kernels_loglin(errs)
    phase_kernels_ssd(errs)
    phase_kernels_hybrid_attn(errs)
    phase_small()
    phase_small_train()
    phase_small_encoder()
    phase_small_loglin()
    phase_small_ssm()
    phase_serve(launches, serve_times)
    phase_serve_loglin(launches, serve_times)
    phase_train(launches, train_times)
    phase_encoder_train(launches, enc_times)
    phase_encoder_forward(launches, enc_times)
    phase_ssm_train(launches, train_times)
    phase_hybrid_train(launches, train_times)
    rows, rescale_ms = phase_timings(errs, launches)
    train_rows, fused_zamba2 = phase_timings_train(errs, launches)
    rows += train_rows
    enc_rows, block_diag_bidir = phase_timings_encoder(errs, launches)
    rows += enc_rows
    rows.append(phase_timings_loglin(errs, launches))
    ssd_row, ssd_zamba2, ssd_layer = phase_timings_ssd(errs, launches)
    rows.append(ssd_row)
    log("serve times: " + json.dumps(serve_times))
    log("train times: " + json.dumps(train_times))
    log("encoder times: " + json.dumps(enc_times))
    log("block_diag (causal=False, encoder shapes): "
        + json.dumps(block_diag_bidir))
    log(f"decode_rescale_ms: {rescale_ms}")
    log("ssd (zamba2-7b shape): " + json.dumps(ssd_zamba2))
    log("lln_diag_fused / lln_diag_fused_bwd (zamba2-7b shape): "
        + json.dumps(fused_zamba2))
    log("ops.ssd_scan per layer: " + json.dumps(ssd_layer))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
