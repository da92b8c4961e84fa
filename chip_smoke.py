#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths (the yi-9b
decoder, with lln, lln_diag and log_linear), its encoder pre-training path
(roberta-lln, MLM) and its SSM training path (mamba2-130m, and the
zamba2-7b hybrid with lln_diag) on one CUDA card and check them; since the
softmax and ssm / hybrid serving slice also softmax, mamba2-130m and
zamba2-7b serving, and since the dense-configs slice the serving of
qwen3-14b, chatglm3-6b and stablelm-1.6b, the decode contract (row_mask,
commit_len, the drift renorm) and the paper's instruments.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device        - require CUDA, print the card's name and power limit,
                     TF32 off;
  2. build         - compile the eleven CUDA kernels from src/repro_torch/csrc,
                     one nvcc per source, all started together;
  3. kernels       - each serving kernel against its plain PyTorch version at
                     full-width shapes (B=4, H=32, G=4, D=Dv=128, bf16 q/k/v);
                     lln_decode with the state's rescale inside, two runs
                     and the fold (against a torch rescale) bitwise equal;
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
                     serve, training, encoder or SSD shapes (lln_decode at
                     T = 1, 16 and 64, beside the torch rescale pass it
                     replaced); serve, train and encoder times.
Later phases (in main()'s order): kernels_hybrid_serve and kernels_dense
(rows 1-3 at zamba2-7b's serving shape and at those of qwen3-14b, r = 5,
chatglm3-6b, r = 16, and stablelm-1.6b, D = 64, decode at T = 1 and 16,
two runs bitwise equal), small_hybrid_serve, serve_softmax_ssm and
serve_dense (full-width, full-depth serving: yi-9b softmax, mamba2-130m,
zamba2-7b, qwen3-14b lln_diag, chatglm3-6b lln and lln_diag, stablelm-1.6b
lln_diag, logits against the plain backend, exact launch counts),
contract (row_mask and commit_len through lln_decode against the plain
kind, masked rows bitwise), renorm (yi-9b lln serving with the drift
renorm firing in every layer, and the streaming instruments of its caches
against CPU copies) and instruments (the paper's probe on Gaussian q, k
and fit_lln_constants on the card), and their kernels' timings.  Since
the checkpoint and pool slice: f4 (block_diag_bwd at r = 16, chatglm3-6b's
shape, within 1e-5, two runs bitwise; timed as the block_diag_bwd row's
"r16" entry), small_pool (yi-9b SMOKE fp32 through a 2-slot pool on the
kernels, equal to solo runs; a nan fault recovered; kill and resume),
pool (full-width yi-9b, PL layers, behind a 4-slot pool, lln_diag and
softmax, 10 requests: budgets met, first logits against solo prefills,
exact launch counts, nan and kill faults, steady decode tok/s and busy
share),
ckpt_train (full-size roberta-lln: 2 steps, save_now, restore, 2 steps,
bitwise equal to 4 uninterrupted steps; the train CLI's --ckpt-dir
resume) and remat_dots (the yi-9b train cell with remat="dots" against
"full").  Since the speculative-decoding slice: spec (yi-9b SMOKE in fp32
on the kernels: speculative greedy tokens equal to the plain greedy loop
for lln, lln_diag, log_linear and softmax, the tied full-depth draft
accepting every draft, AttentionEngine.commit after a commit_len = 0
verify bitwise equal to decode(commit_len); then full-width, full-depth
yi-9b with a 24-layer draft, k = 3, batch 4, prompt 512, 32 tokens,
lln_diag and softmax: exact launch counts, every emitted position's score
logits against the teacher-forced T = 1 decode, acceptance, tokens per
iteration, wall and device ms per iteration, busy share, target passes per
token, beside the plain decode's ms per step) and spec_pool (a SMOKE
speculative pool equal to solo speculative runs with a nan fault
recovered bitwise; then the pool cell (PL layers, a PL / 2-layer draft)
with spec_k = 2: budgets, launch counts, the teacher-forced check per
pooled iteration, a nan fault replayed on both states).
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

Since the families slice (item 11b): kernels_families (rows 1-3 at the
serving shapes of qwen3-moe-235b-a22b (H = 64, G = 4, D = 128),
deepseek-v2-236b's MLA (H = G = 128, D = 192, Dv = 128), paligemma-3b (H
= 8, G = 1, D = 256) and the seamless-m4t-medium decoder (H = G = 16, D =
64, N = 64), decode at T = 1 and 4; row 5 and the non-causal row 2 at
the seamless encoder's shape (B = 4, H = G = 16, N = 2048, D = 64); two
runs bitwise equal; D above 128 takes the CUDA-core kernels for rows 1
and 3, row 2 its tensor cores),
small_families (each family's SMOKE config in fp32 on the kernels against
the core reference, greedy tokens equal; a qwen3-moe pool and speculative
run equal to solo runs and the plain loop) and serve_families (full
width: qwen3-moe cut to 4 layers, deepseek-v2 cut to 4 (lln_diag, and
softmax with the absorbed decode), seamless 12 + 12 layers with 2048
source frames, paligemma 18 layers with 256 patches (lln_diag, and
softmax with the prefix-LM mask); exact launch counts, logits against
the plain backend), and the rows' timings.

Since the families' training slice (item 11c): kernels_families_train
(rows 4 and 9 at the four train cells' attention shapes, rows 1 with
den and 6 at the MLA and paligemma widths, rows 5, 7, the non-causal 2
and 8 at the seamless encoder's training shape, and block_diag_bwd in
bf16 above D = 128, causal and not, N 512 and 300; outputs within one
bf16 step, den, states and gradients within 1e-5 of the largest plain
entry, two runs bitwise equal), small_families_train (each family's
SMOKE config in fp32, 3 steps on the kernels against 3 through the core
reference; then the train CLI --arch <family> --smoke --attn-impl
lln_diag for 3 steps) and train_families (train_moe: qwen3-moe cut to 1
layer, batch 2 x 512; train_mla: deepseek-v2 cut to its dense first
layer, 4 x 512; train_encdec: seamless 12 + 12 layers, 4 x 1024 with
1024 stub frames; train_vlm: paligemma 18 layers, 2 x 512 with 256
patches: use_kernel=True, lln_diag, and lln for train_mla and
train_vlm, fp32 params and AdamW moments, the first step on the kernels
against the plain versions, exact launch counts, timed steps), and their
kernels' timings.

Since the mesh slice (item 12a), before the timings: mesh (a one-rank
NCCL group and a 1 x 1 DeviceMesh: yi-9b lln_diag at full width, ML
layers, batch 4, prompt 512, MGEN greedy steps through
make_serve_setup(mesh=...) with tokens and launch counts equal to the
meshless run from the same weights, and one decode step under cProfile;
the caches saved and restored with cache_shardings, bitwise; yi-9b
training, MTL layers, MSTEPS steps on the kernels, losses within 1e-5
and launches equal; qwen3-moe's MoE block at full width through the
expert-parallel path within 1e-5 of the meshless one; the group
destroyed at the end) and mesh_fake (in a child process: a fake process
group of 4 ranks, a (1, 4) mesh, yi-9b lln_diag at full width with 4
layers, one prefill and 2 decode steps: 8 query heads and 1 kv head per
rank in the state and the diag tails, rows 1-3 launched at those heads,
and the collectives of one decode step).  Item 12b adds to mesh_fake's
child the other families at full width (mamba2-130m, zamba2-7b, MLA in
lln_diag and softmax, seamless-m4t-medium, paligemma-3b, yi-9b
log_linear): every cache leaf at cache_shardings' shard on a rank, and
the kernels' q rows per rank; mesh_families (the one-rank NCCL group and
the 1 x 1 mesh again, at full width: each family served at batch B, 4
greedy steps, tokens and launch counts equal to the meshless run's from
the same weights; 2 training steps on the kernels per family, losses
within 1e-5 relative, launches equal); and dryrun (launch/dryrun.py in
child processes, one cell per family on 16 x 16 and 2 x 16 x 16, each ok
with the argument bytes the port's rules give).

``python3 chip_smoke.py --phases spec,spec_pool`` runs only the named
check phases (spec, spec_pool, small_pool, kernels_families,
small_families, serve_families, kernels_families_train,
small_families_train, train_families, mesh, mesh_fake, mesh_families,
mesh_pool, mesh_spec, dryrun) after device and build, and prints no
kernels line; timings_families and timings_families_train log their
kernel rows (after kernels_families and kernels_families_train in the
same call, whose errors they read).
"""
from __future__ import annotations

import collections
import importlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
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
PL = 16                       # yi-9b layers behind the pools (pool, spec_pool)
ZN, MN = 512, 2048            # serving prompts: zamba2-7b, mamba2-130m
PROFILE_STEPS = 4             # decode steps profiled after the served GEN
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
    where the profiler sees no device activity.

    Only the device activity is traced, and the trace's raw events are
    summed by name: ``key_averages()`` first builds the host op tree of
    every event, which on a 48-layer decode step costs seconds of host time
    per traced step (the device totals are the same)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        # Device-side events only (kernels, copies and sets on the card).
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        ns, calls = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (ns + e.duration_ns(), calls + 1)
    rows = [(name, ns / 1e6, calls) for name, (ns, calls) in by_name.items()]
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


def _inputs(n, gen, b=B, h=H, g=G, d=D, dv=None):
    """Post-RoPE-like bf16 q/k/v (b, n, h|g, d; v of width ``dv``, by
    default d) and moment-matched alpha/beta from the port's calibration
    (yi-9b's heads by default)."""
    from repro_torch.core.attention import batch_alpha_beta
    from repro_torch.kernels.registry import AttnSpec
    dev = "cuda"
    q = torch.randn(b, n, h, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, n, g, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, n, g, dv or d, generator=gen, device=dev).bfloat16()
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
    # A rescale factor exp(c_old - c_new) in (0.1, 1] per query head, as
    # ops.lln_decode_chunk passes it.
    scale = torch.exp(-2.3 * torch.rand(B * H, generator=gen, device="cuda"))
    for t in (1, 4):
        q, k, v, alpha, beta = _inputs(t, gen)
        qs, ks, _ = ops._scaled_stabilized(q, k, alpha, beta)
        vk = ops._to_kernel(v)
        log(f"lln_decode T={t} (from the N={N} prefill state, rescaled in "
            f"the kernel):")
        got = lln_decode(qs, ks, vk, s0, z0, r=r, scale=scale)
        again = lln_decode(qs, ks, vk, s0, z0, r=r, scale=scale)
        first = lln_decode(qs, ks, vk, s0 * scale[:, None, None],
                           z0 * scale[:, None, None], r=r)
        want = lln_decode_plain(qs, ks, vk, s0, z0, r=r, scale=scale)
        torch.cuda.synchronize()
        results["lln_decode"] = max(results.get("lln_decode", 0.0), check(
            "out", got[0], want[0], bf16_tol(want[0])))
        check("s1", got[1], want[1], fp32_tol(want[1]))
        check("z1", got[2], want[2], fp32_tol(want[2]))
        for name, a, b, c in zip(("out", "s1", "z1"), got, again, first):
            if not torch.equal(a, b):
                raise AssertionError(f"lln_decode {name}: two runs differ")
            if not torch.equal(a, c):
                raise AssertionError(f"lln_decode {name}: the folded rescale "
                                     f"differs from a torch rescale")
        log("  two runs bitwise equal; the folded rescale bitwise equal to a "
            "torch rescale and scale=None")


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


def _train_inputs(n, gen, b=B, h=H, g=G, d=D, dv=None):
    """Kernel-layout training inputs: fp32 qs/ks from the port's
    calibration, bf16 q/k/v (v of width ``dv``, by default d) and a bf16
    cotangent g."""
    from repro_torch.kernels import ops
    q, k, v, alpha, beta = _inputs(n, gen, b, h, g, d, dv)
    qs, ks, _ = ops._scaled_stabilized(q, k, alpha, beta)
    cot = torch.randn(b * h, n, dv or d, generator=gen,
                      device="cuda").bfloat16()
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
                   core=None, over=None):
    """``arch`` SMOKE training in fp32 on the card with use_kernel=True: 3
    steps on the kernels (backend auto) against 3 through the core
    reference (backend ref, or the config overrides ``core``), from the
    same seeded init and batches of ``batches_fn``, for each attn_impl of
    ``impls`` (None: the config's own), with the config overrides ``over``
    on both sides; losses and grad norms within 1e-4 relative."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import torch_placer
    from repro_torch.launch.steps import make_train_setup
    for impl in impls:
        runs = {}
        for backend in ("auto", "ref"):
            kw = dict(compute_dtype="float32", use_kernel=True,
                      attn_backend=backend, **(over or {}))
            if impl:
                kw["attn_impl"] = impl
            if backend == "ref" and core:
                kw.update(core)
            cfg = get_config(arch, smoke=True, **kw)
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


def _train_cli(argv, batch=2):
    """The train CLI on the default device for 3 steps; finite losses."""
    from repro_torch.launch import train
    log(f"train CLI {' '.join(argv)} --batch {batch} (default device):")
    hist = train.main(argv + ["--steps", "3", "--seq", "64", "--batch",
                              str(batch), "--log-every", "1"])
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
    _counts()["block_diag"].noncausal_launches = 0


def _read():
    """The launches since :func:`_reset`, per wrapper; block_diag's causal
    launches under "block_diag", its non-causal ones under "block_diag
    (causal=False)" (the wrapper counts those apart where it launches)."""
    got = {name: fn.launches for name, fn in _counts().items()}
    noncausal = _counts()["block_diag"].noncausal_launches
    got["block_diag"] -= noncausal
    got["block_diag (causal=False)"] = noncausal
    return got


def _idle():
    """Every count :func:`_read` returns, at 0."""
    return dict.fromkeys(_read(), 0)


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

        idle = _idle()
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
        plain_logits, _ = plain.prefill(params, batch, N + GEN)
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
        dk = [(ms, n) for name, ms, n in dec_top if "lln_decode_kernel" in name]
        if dk:
            log(f"  lln_decode in the decode loop: "
                f"{sum(m for m, _ in dk) / sum(n for _, n in dk):.5f} ms per "
                f"launch over {sum(n for _, n in dk)} launches")
        for label, top in (("prefill", pre_top), ("decode x4", dec_top)):
            for name, ms, calls in top[:5]:
                log(f"  top {label}: {ms:9.3f} ms  {calls:6d} calls  "
                    f"{name[:90]}")
        del setup, caches, plain


QKV = ("q_w", "k_w", "v_w")
SSM_IN = ("w_x", "w_B", "w_C", "w_dt")


def _train_cell(cfg, batch_size, seq, batches_fn, want, label, probe=QKV,
                first_fp32=False):
    """Train ``cfg`` (use_kernel=True) at ``batch_size`` x ``seq`` on
    batches of ``batches_fn``: the first step's loss, grad norm and the grad
    norm of the weights named ``probe`` (by suffix) on the kernels against
    the plain versions, then one untimed and TSTEPS timed steps.
    ``want(steps)`` is the exact launch count of that many steps.
    ``first_fp32``: take that first step in fp32 compute and hold the three
    numbers within 1e-5 relative (for a model whose attention runs the
    CUDA-core kernels, which take fp32 and bf16 inputs through the same
    code; in bf16 two correct routes already differ by about 1e-4 there).
    Returns (times, launches of the timed steps)."""
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
    first_cfg = cfg.replace(compute_dtype="float32") if first_fp32 else cfg
    for backend in ("kernel", "plain"):
        model = build_model(first_cfg.replace(attn_backend=backend))
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
    log(f"  first step{' (fp32 compute)' if first_fp32 else ''}: loss "
        f"{lk:.6f} / {lp:.6f}, grad norm {gk:.6f} / {gp:.6f}, "
        f"{'/'.join(probe)} grad norm {qk:.6f} / {qp:.6f} (kernels / plain)")
    # bf16 activations through the layers: a one-step rounding difference
    # in one layer's attention output propagates.  The decoder's runs before
    # this check showed relative gaps of 2e-5 in the loss and 2.6e-5 in the
    # grad norm; hold the loss to 1e-4 and both grad norms to 1e-3.  In fp32
    # the kernels and the plain versions differ by sums in another order
    # only: 1e-5 for all three.
    tl, tg = (1e-5, 1e-5) if first_fp32 else (1e-4, 1e-3)
    if not (all(math.isfinite(x) for x in (lk, gk, qk))
            and abs(lk - lp) <= tl * abs(lp)
            and abs(gk - gp) <= tg * abs(gp)
            and abs(qk - qp) <= tg * abs(qp)):
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
        "peak_gib": peak, "loss_grad_norm": losses,
        "first": first["kernel"]}
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
            out = _idle()
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

    # lln_decode as ops.lln_decode_chunk calls it: the carried state and
    # its (BH,) rescale factor, T=1 (the serve loop); T=16 and T=64 logged.
    s0 = torch.randn(bh, D, D, generator=gen, device="cuda")
    z0 = torch.rand(bh, 1, D, generator=gen, device="cuda") + 0.5
    scale = torch.exp(-torch.rand(bh, generator=gen, device="cuda"))
    decode_ms = {}
    for t in (1, 16, 64):
        q1, k1, v1, a1, b1 = _inputs(t, gen)
        qs1, ks1, _ = ops._scaled_stabilized(q1, k1, a1, b1)
        vk1 = ops._to_kernel(v1)
        nbytes = (2 * bh * D * D * 4 + 2 * bh * D * 4 + bh * 4
                  + bh * t * D * 4 + bg * t * D * 4 + bg * t * D * 2
                  + bh * t * D * 2)
        flops = bh * t * (2 * D * D + 2 * D) \
            + bh * t * (t + 1) // 2 * 4 * D + bh * t * (2 * D * D + D) \
            + bh * (D * D + D)
        bnd, by = bound_ms(nbytes, flops)
        ms = cuda_ms(lambda: lln_decode(qs1, ks1, vk1, s0, z0, r=r,
                                        scale=scale))
        plain = cuda_ms(lambda: lln_decode_plain(qs1, ks1, vk1, s0, z0, r=r,
                                                 scale=scale))
        decode_ms[t] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
        log(f"timing lln_decode T={t} (rescale inside): kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
    rows.append(dict(
        name="lln_decode", route="cuda",
        source="src/repro_torch/csrc/lln_decode.cu",
        replaces="src/repro/kernels/lln_attention.py:348",
        launches=launches["lln_decode"], max_abs_err=errs["lln_decode"],
        library_ms=None, **decode_ms[1]))

    # The parent's cost, no longer run: the torch rescale of the carried
    # state (s and z) before each decode launch, T=1.
    s_state = s0.reshape(B, H, D, D)
    z_state = z0.reshape(B, H, D)
    resc = scale.reshape(B, H)
    rescale_ms = cuda_ms(lambda: (
        (s_state * resc[..., None, None]).reshape(bh, D, D),
        (z_state * resc[..., None]).reshape(bh, 1, D)))
    for row in rows:
        log(f"timing {row['name']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), library {row['library_ms']}")
    log(f"timing the parent's decode state rescale (torch, per layer, T=1, "
        f"no longer run): {rescale_ms:.4f} ms")
    return rows, dict(rescale_ms=rescale_ms, **{
        f"T={t}": v for t, v in decode_ms.items()})


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
    want = _idle()
    want["lln_bidir"] = fwd_per_layer * n_layers
    want["lln_bidir_bwd"] = bwd_per_layer * n_layers
    if impl == "lln_diag":
        want["block_diag (causal=False)"] = fwd_per_layer * n_layers
        want["block_diag_bwd"] = bwd_per_layer * n_layers
    return want


def _add_encoder_launches(launches, counted):
    """The encoder's launches; its non-causal block_diag apart from the
    serve path's (the kernels line times block_diag at the serve shapes)."""
    for name in ("lln_bidir", "lln_bidir_bwd", "block_diag_bwd"):
        launches[name] += counted[name]
    launches["block_diag (causal=False)"] += \
        counted["block_diag (causal=False)"]


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
    products at the tensor cores' bf16 rate (forward: an fp32 left operand
    p counted once per bf16 plane it goes in as, q k^T and p v in hi + lo,
    2 D + 4 Dv; backward: each of the function's five products once, q
    k^T, g v^T, dsm k, dsm^T q and p^T g, 6 D + 4 Dv, whatever planes the
    kernel splits p and dsm into), and the softmax's elementwise steps as
    fp32 work
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
         pairs * SOFTMAX_BWD_OPS, pairs * (6 * d + 4 * dv),
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

    idle = _idle()
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
        return {**_idle(),
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
        return {**_idle(),
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


# ---------------------------------------------------------------------------
# Serving with softmax (yi-9b, zamba2-7b) and the ssm / hybrid serving path
# (mamba2-130m, and zamba2-7b whose lln_diag shared block runs the LLN
# serving kernels at D = 112).
# ---------------------------------------------------------------------------

def _check_serve_kernels(results, tag, b, h, g, d, seed, decode_ts=(1,),
                         dv=None, n=512):
    """The three serving kernels at one model's serving shape (``b`` rows,
    ``h`` query and ``g`` kv heads, N = ``n``, D = ``d``, Dv = ``dv`` (by
    default d), blk BLK, bf16 q/k/v with the port's calibration; D or Dv
    above 128 takes the CUDA-core kernels of lln_causal and lln_decode,
    block_diag's tensor cores up to 256) against their plain versions:
    lln_causal with the final state, causal block_diag and lln_decode at
    each T of ``decode_ts`` from that state with a rescale.  Out within one
    bf16 step, s, z, s1 and z1 within 1e-5 of the largest plain entry, two
    runs of each bitwise equal.  The errors go to ``results`` under
    "lln_causal (state, <tag>)", "block_diag (<tag>)" and "lln_decode
    (<tag>)"."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_diag import block_diag, block_diag_plain
    from repro_torch.kernels.lln_attention import (_tc_path, lln_causal,
                                                   lln_causal_plain,
                                                   lln_decode,
                                                   lln_decode_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    r, dv = h // g, dv or d
    shape = f"B={b} H={h} G={g} D={d} Dv={dv} N={n}"
    q, k, v, alpha, beta = _inputs(n, gen, b, h, g, d, dv)
    qs, ks, _ = ops._scaled_stabilized(q, k, alpha, beta)
    qk, kk, vk = ops._to_kernel(q), ops._to_kernel(k), ops._to_kernel(v)
    name = f"lln_causal (state, {tag})"
    log(f"{name} {shape} (tensor-core path: "
        f"{_tc_path(vk, d, dv, 'lln_causal')}):")
    runs = [lln_causal(qs, ks, vk, r=r, blk=BLK) for _ in range(2)]
    want = lln_causal_plain(qs, ks, vk, r=r, blk=BLK)
    torch.cuda.synchronize()
    results[name] = max(
        check("out", runs[0][0], want[0], bf16_tol(want[0])),
        check("s", runs[0][1], want[1], fp32_tol(want[1])),
        check("z", runs[0][2], want[2], fp32_tol(want[2])))
    _same_runs(name, *runs)
    s0, z0 = want[1], want[2]
    name = f"block_diag ({tag})"
    log(f"{name} {shape} blk={BLK} causal:")
    runs = [block_diag(qk, kk, vk, r=r, blk=BLK, causal=True)
            for _ in range(2)]
    want = block_diag_plain(qk, kk, vk, r=r, blk=BLK, causal=True)
    torch.cuda.synchronize()
    results[name] = check("out", runs[0], want, bf16_tol(want))
    _same_runs(name, (runs[0],), (runs[1],))
    name = f"lln_decode ({tag})"
    for t in decode_ts:
        q1, k1, v1, a1, b1 = _inputs(t, gen, b, h, g, d, dv)
        qs1, ks1, _ = ops._scaled_stabilized(q1, k1, a1, b1)
        vk1 = ops._to_kernel(v1)
        scale = torch.exp(-2.3 * torch.rand(b * h, generator=gen,
                                            device="cuda"))
        log(f"{name} T={t} {shape} (from the N={n} state, rescaled in the "
            f"kernel):")
        runs = [lln_decode(qs1, ks1, vk1, s0, z0, r=r, scale=scale)
                for _ in range(2)]
        want = lln_decode_plain(qs1, ks1, vk1, s0, z0, r=r, scale=scale)
        torch.cuda.synchronize()
        results[name] = max(
            results.get(name, 0.0),
            check("out", runs[0][0], want[0], bf16_tol(want[0])),
            check("s1", runs[0][1], want[1], fp32_tol(want[1])),
            check("z1", runs[0][2], want[2], fp32_tol(want[2])))
        _same_runs(f"{name} T={t}", *runs)


def phase_kernels_hybrid_serve(results):
    """The three serving kernels at zamba2-7b's serving shape (B = ZB, H =
    G = H so r = 1, N = ZN, D = Dv = ZD) against their plain versions
    (:func:`_check_serve_kernels`, decode at T = 1)."""
    _check_serve_kernels(results, "D=112", ZB, H, H, ZD, SEED + 11)


# The dense configs' serving shapes (batch B, N = 512): (tag, arch, H, G, D).
DENSE = (("qwen3-14b r=5", "qwen3-14b", 40, 8, 128),
         ("chatglm3-6b r=16", "chatglm3-6b", 32, 2, 128),
         ("stablelm-1.6b D=64", "stablelm-1.6b", 32, 32, 64))


def phase_kernels_dense(results):
    """The three serving kernels at the serving shapes of qwen3-14b (r = 5),
    chatglm3-6b (r = 16) and stablelm-1.6b (r = 1, D = 64) against their
    plain versions (:func:`_check_serve_kernels`, decode at T = 1 and
    16)."""
    for i, (tag, _, h, g, d) in enumerate(DENSE):
        _check_serve_kernels(results, tag, B, h, g, d, SEED + 30 + i,
                             decode_ts=(1, 16))


def _same_runs(name, first, again):
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{name}: two runs differ")
    log("  two runs bitwise equal")


def _serve_tokens(setup, params, batch, prompt, steps):
    """Prefill, then ``steps`` greedy decode steps; returns (prefill
    logits, tokens (B, steps + 1))."""
    logits, caches = setup.prefill_fn(params, batch)
    tok = torch.argmax(logits[:, -1], -1)
    rest, _ = setup.make_generate(steps)(params, caches, tok, prompt)
    return logits, torch.cat([tok[:, None], rest], 1)


def _forward_logits(setup, params, batch, toks, prompt):
    """Logits of the model's full-sequence forward over the prompt and the
    served tokens but the last, at the prompt's last position and after:
    what prefill and decode must give."""
    from repro_torch.models.layers import logits_from_hidden
    inputs = torch.cat([batch["inputs"], toks[:, :-1]], 1)
    cfg = setup.model.cfg
    with torch.no_grad():
        h, _ = setup.model.hidden(params, {"inputs": inputs})
        return logits_from_hidden(params.head, h[:, prompt - 1:], cfg.cdtype,
                                  cfg.logit_softcap)


def phase_small_hybrid_serve():
    """SMOKE serving in fp32 on the card against the core reference: yi-9b
    softmax, and zamba2-7b with softmax and with lln_diag, backend auto
    (lln_diag: the kernels) against ref (softmax: the naive prefill; lln_diag:
    the core LLN) with the same greedy tokens and prefill logits within
    1e-4; mamba2-130m's served logits (prefill and 7 decode steps: no kernel,
    as in the reference) against its full-sequence forward over the served
    tokens within 1e-4; then the serve CLI on the default device for
    mamba2-130m and zamba2-7b (its default softmax)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import synthetic_batch
    prompt, steps = 40, 7
    cells = (("yi-9b", "softmax"), ("zamba2-7b", "softmax"),
             ("zamba2-7b", "lln_diag"))
    for arch, impl in cells:
        runs = {}
        for backend in ("auto", "ref"):
            cfg = get_config(arch, smoke=True, attn_impl=impl,
                             compute_dtype="float32", attn_backend=backend)
            setup = make_serve_setup(cfg, ShapeSpec("small", prompt + steps,
                                                    2, "decode"))
            params = setup.model.init(SEED)
            batch = synthetic_batch(cfg, 2, prompt + steps, text_seq=prompt,
                                    device="cuda")
            runs[backend] = _serve_tokens(setup, params, batch, prompt, steps)
        log(f"small {arch} {impl} serve (SMOKE fp32, prompt {prompt}, auto "
            f"vs core ref):")
        check("prefill logits", runs["auto"][0], runs["ref"][0], 1e-4)
        if not torch.equal(runs["auto"][1], runs["ref"][1]):
            raise AssertionError(f"small {arch} {impl}: greedy tokens differ")
        log(f"  greedy tokens equal: {runs['auto'][1][0].tolist()}")
    cfg = get_config("mamba2-130m", smoke=True, compute_dtype="float32")
    setup = make_serve_setup(cfg, ShapeSpec("small", prompt + steps, 2,
                                            "decode"))
    params = setup.model.init(SEED)
    batch = synthetic_batch(cfg, 2, prompt + steps, text_seq=prompt,
                            device="cuda")
    logits, caches = setup.prefill_fn(params, batch)
    toks, served = [torch.argmax(logits[:, -1], -1)], [logits[:, -1]]
    for i in range(steps):
        logits, caches = setup.decode_fn(params, caches, toks[-1],
                                         prompt + i)
        served.append(logits)
        toks.append(torch.argmax(logits, -1))
    want = _forward_logits(setup, params, batch, torch.stack(toks, 1), prompt)
    log(f"small mamba2-130m serve (SMOKE fp32, prompt {prompt}, {steps} "
        f"steps) vs its full-sequence forward:")
    check("prefill and decode logits", torch.stack(served, 1), want, 1e-4)
    for argv in (["--arch", "mamba2-130m"], ["--arch", "zamba2-7b"]):
        log(f"serve CLI {' '.join(argv)} (SMOKE, default device):")
        toks = serve.main(argv + ["--smoke", "--batch", "2", "--prompt-len",
                                  "40", "--gen", "8"])
        if toks.shape != (2, 8):
            raise AssertionError(f"serve CLI returned tokens of shape "
                                 f"{toks.shape}")


def _serve_cell(cfg, prompt, want_pre, want_dec_step, against, label,
                batch=None, pos0=None):
    """Serve ``cfg`` (bf16 weights from the seed) at batch B: prompt
    ``prompt`` (or the family's ``batch``, whose decode starts at position
    ``pos0``: after a VLM's patches), GEN greedy tokens, with the launch
    counts read around the
    prefill and the decode steps held to ``want_pre`` and ``GEN - 1`` times
    ``want_dec_step``.  The prefill logits and the first decode step's
    (teacher-forced with the same token) are held within 0.1 of the largest
    against ``against``: another attention backend (no kernel may launch
    there) or "forward", the full-sequence forward over the same tokens.
    The KV caches hold PROFILE_STEPS positions past the GEN tokens for the
    profiled decode steps.  Returns (times, prefill launches, decode
    launches)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import synthetic_batch
    pos0 = prompt if pos0 is None else pos0
    torch.cuda.reset_peak_memory_stats()
    shape = ShapeSpec("chip", pos0 + GEN + PROFILE_STEPS, B, "decode")
    setup = make_serve_setup(cfg, shape)
    t0 = time.time()
    params = setup.model.init(SEED)
    torch.cuda.synchronize()
    log(f"{label}: {cfg.name} {cfg.n_layers}L d_model {cfg.d_model}, "
        f"{setup.model.param_count(params) / 1e9:.2f}B params bf16 (init "
        f"{time.time() - t0:.1f}s), batch {B}, prompt {prompt}, {GEN} "
        f"greedy tokens")
    if batch is None:
        batch = synthetic_batch(cfg, B, prompt + GEN, seed=SEED,
                                text_seq=prompt, device="cuda")
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
    logits1, caches = setup.decode_fn(params, caches, tok, pos0)
    tok = torch.argmax(logits1, -1)
    toks.append(tok)
    torch.cuda.synchronize()
    t0 = time.time()
    rest, caches = setup.make_generate(GEN - 2)(params, caches, tok,
                                                pos0 + 1)
    torch.cuda.synchronize()
    t_steady = time.time() - t0
    dec = _read()
    toks = torch.cat([torch.stack(toks, 1), rest], 1)
    want_dec = {name: n * (GEN - 1) for name, n in want_dec_step.items()}
    log(f"{label}: prefill launches {pre}, decode launches {dec}")
    if pre != want_pre or dec != want_dec:
        raise AssertionError(f"{label}: launch counts {pre} / {dec}, "
                             f"expected {want_pre} / {want_dec}")
    # Greedy argmax runs over the padded vocab, as in the reference (random
    # weights may pick a pad row: mamba2-130m pads 50280 to 50432).
    if toks.shape != (B, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.padded_vocab)).all()):
        raise AssertionError(f"{label}: tokens out of range: {toks}")
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(logits1).all())):
        raise AssertionError(f"{label}: non-finite logits")

    if against == "forward":
        full = _forward_logits(setup, params, batch, toks[:, :2], prompt)
        o_pre, o_step = full[:, :1], full[:, 1]
    else:
        other = make_serve_setup(cfg.replace(attn_backend=against), shape)
        _reset()
        o_pre, o_steps = _serve_logits(other, params, batch, toks, pos0, 1)
        o_step = o_steps[0]
        torch.cuda.synchronize()
        if any(_read().values()):
            raise AssertionError(f"the {against} backend launched a kernel")
        del other
    # bf16 through the layers: one-step rounding differences random-walk;
    # hold them to 0.1 of the largest logit, as the other serve phases.
    check(f"{label} prefill logits vs {against}", logits, o_pre,
          0.1 * max(1.0, float(o_pre.abs().max())))
    check(f"{label} first decode step logits vs {against}", logits1, o_step,
          0.1 * max(1.0, float(o_step.abs().max())))
    agree = float((torch.argmax(logits[:, -1], -1)
                   == torch.argmax(o_pre[:, -1], -1)).float().mean())
    log(f"  first-token agreement with {against}: {agree:.2f}")
    del o_pre, o_step

    step_ms = t_steady / (GEN - 2) * 1e3
    pre_dev, pre_top = device_profile(lambda: setup.prefill_fn(params, batch))
    dec_dev, dec_top = device_profile(
        lambda: setup.make_generate(PROFILE_STEPS)(params, caches, tok,
                                                   pos0 + GEN))
    dec_dev /= PROFILE_STEPS
    times = {
        "prefill_ms": t_prefill * 1e3, "decode_ms_per_step": step_ms,
        "decode_tok_s": B / (step_ms / 1e3),
        "prefill_device_ms": pre_dev, "decode_device_ms_per_step": dec_dev,
        "prefill_busy": pre_dev / (t_prefill * 1e3),
        "decode_busy": dec_dev / step_ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"{label}: prefill {t_prefill * 1e3:.2f} ms (device {pre_dev:.2f} "
        f"ms); decode {step_ms:.3f} ms/step ({B / (step_ms / 1e3):.1f} "
        f"tok/s, device {dec_dev:.3f} ms/step) over {GEN - 2} steps; "
        f"tokens[0] {toks[0].tolist()}")
    ours = _port_kernels()
    for tag, top in (("prefill", pre_top), ("decode", dec_top)):
        mine = [(ms, n) for name, ms, n in top
                if _kernel_name(name).split("<")[0].split("::")[-1] in ours]
        if mine:
            log(f"  port kernels in the {tag}: {sum(m for m, _ in mine):.3f}"
                f" ms over {sum(n for _, n in mine)} launches")
    for tag, top in (("prefill", pre_top),
                     (f"decode x{PROFILE_STEPS}", dec_top)):
        for name, ms, calls in top[:5]:
            log(f"  top {tag}: {ms:9.3f} ms  {calls:6d} calls  {name[:90]}")
    del setup, caches, params
    torch.cuda.empty_cache()
    return times, pre, dec


def phase_serve_softmax_ssm(launches, serve_times):
    """Full-width serving of the paths the softmax impl and the ssm /
    hybrid family opened: yi-9b with softmax (48 layers, prompt N; logits
    against backend ref, whose prefill is the naive softmax), mamba2-130m
    (24 layers, prompt MN; logits against its full-sequence forward),
    zamba2-7b (81 layers, prompt ZN) with lln_diag (per prefill one
    lln_causal with the state and one causal block_diag per application of
    the shared block, per decode step one lln_decode; logits against the
    plain backend) and with softmax, its default (logits against ref).
    softmax and the Mamba2 layers launch no kernel, as in the reference."""
    from repro_torch.configs import get_config
    idle = _idle()
    yi = get_config("yi-9b", attn_impl="softmax", param_dtype="bfloat16")
    serve_times["softmax"], _, _ = _serve_cell(yi, N, idle, idle, "ref",
                                               "serve softmax (yi-9b)")
    mamba = get_config("mamba2-130m", param_dtype="bfloat16")
    serve_times["mamba2-130m"], _, _ = _serve_cell(
        mamba, MN, idle, idle, "forward", "serve mamba2-130m")
    zamba = get_config("zamba2-7b", attn_impl="lln_diag",
                       param_dtype="bfloat16")
    shared = zamba.n_layers // zamba.shared_attn_period
    serve_times["zamba2-7b lln_diag"], pre, dec = _serve_cell(
        zamba, ZN, {**idle, "lln_causal": shared, "block_diag": shared},
        {**idle, "lln_decode": shared}, "plain", "serve zamba2-7b lln_diag")
    launches["lln_causal (state, hybrid)"] += pre["lln_causal"]
    launches["block_diag (hybrid)"] += pre["block_diag"]
    launches["lln_decode (hybrid)"] += dec["lln_decode"]
    serve_times["zamba2-7b softmax"], _, _ = _serve_cell(
        zamba.replace(attn_impl="softmax"), ZN, idle, idle, "ref",
        "serve zamba2-7b softmax")


def _serve_kernel_rows(errs, launches, tag, b, h, g, d, seed, row_names,
                       launch_keys=None, decode_ts=(1,), dv=None, n=512):
    """The three serving kernels, their plain versions and the bounds at
    one serving shape (``b`` rows, ``h`` query and ``g`` kv heads, N =
    ``n``, D = ``d``, Dv = ``dv``, by default d): lln_causal with the state
    (bound from _lln_counts at the kernels' own block), causal block_diag
    (q k^T once and p v twice at the tensor cores' rate, the softmax steps
    as fp32 work; SDPA on the blocks, k/v expanded to the h query heads before the timed call, as the
    library yardstick), lln_decode with the rescale (fp32 work and the
    state's bytes) at each T of ``decode_ts``, the first in the row and
    the others logged.  Rows 1 and 2 are bounded by the tensor-core count
    at every width, also where the kernel itself takes its CUDA cores (row
    1 above D or Dv = 128): the function needs no more work for that.  The
    CUDA-core count (every product as fp32 work) is logged beside, and
    block_diag's tensor-core kernel's registers, spills and CTAs per SM
    (:func:`_log_attrs`).  ``row_names`` names the three rows; the errors are
    read under "lln_causal (state, <tag>)", "block_diag (<tag>)" and
    "lln_decode (<tag>)" (the keys of :func:`_check_serve_kernels`), the
    launches under the same keys or ``launch_keys``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_diag import block_diag, block_diag_plain
    from repro_torch.kernels.lln_attention import (lln_causal, lln_causal_plain,
                                                   lln_decode, lln_decode_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    bh, bg, r, dv = b * h, b * g, h // g, dv or d
    keys = (f"lln_causal (state, {tag})", f"block_diag ({tag})",
            f"lln_decode ({tag})")
    lkeys = launch_keys or keys
    q, k, v, alpha, beta = _inputs(n, gen, b, h, g, d, dv)
    qs, ks, _ = ops._scaled_stabilized(q, k, alpha, beta)
    qk, kk, vk = ops._to_kernel(q), ops._to_kernel(k), ops._to_kernel(v)
    rows = []
    counts = _lln_counts(bh, bg, n, d, dv, _lln_module().TC_BLOCK)
    bnd, by = bound_ms(*counts["lln_causal (state)"])
    cores = [bound_ms(*counts["lln_causal (state) (CUDA cores)"])]
    rows.append(dict(
        name=row_names[0], route="cuda",
        source="src/repro_torch/csrc/lln_causal.cu",
        replaces="src/repro/kernels/lln_attention.py:94",
        launches=launches[lkeys[0]], max_abs_err=errs[keys[0]],
        ms=cuda_ms(lambda: lln_causal(qs, ks, vk, r=r, blk=BLK)),
        plain_ms=cuda_ms(lambda: lln_causal_plain(qs, ks, vk, r=r, blk=BLK)),
        bound_ms=bnd, bound_by=by, library_ms=None))

    blk = min(BLK, n)
    nb = n // blk
    pairs = nb * blk * (blk + 1) // 2
    nbytes = 2 * (bh * n * d + bg * n * d + bg * n * dv + bh * n * dv)
    bnd, by = bound_ms(nbytes, bh * pairs * SOFTMAX_FWD_OPS,
                       bh * pairs * (2 * d + 2 * 2 * dv))
    cores.append(bound_ms(nbytes, bh * pairs * (SOFTMAX_FWD_OPS + 2 * d
                                                + 2 * dv)))

    def blocks(t):
        w = t.shape[-1]
        return t.reshape(b, nb, blk, t.shape[2], w).permute(0, 1, 3, 2, 4) \
            .reshape(b * nb, t.shape[2], blk, w)
    qb = blocks(q)
    kb = blocks(torch.repeat_interleave(k, r, dim=2))
    vb = blocks(torch.repeat_interleave(v, r, dim=2))
    rows.append(dict(
        name=row_names[1], route="cuda",
        source="src/repro_torch/csrc/block_diag.cu",
        replaces="src/repro/kernels/block_diag.py:109",
        launches=launches[lkeys[1]], max_abs_err=errs[keys[1]],
        ms=cuda_ms(lambda: block_diag(qk, kk, vk, r=r, blk=BLK, causal=True)),
        plain_ms=cuda_ms(lambda: block_diag_plain(qk, kk, vk, r=r, blk=BLK,
                                                  causal=True)),
        bound_ms=bnd, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, is_causal=True))))

    _, s0, z0 = lln_causal_plain(qs, ks, vk, r=r, blk=BLK)
    scale = torch.exp(-torch.rand(bh, generator=gen, device="cuda"))
    decode = {}
    for t in decode_ts:
        q1, k1, v1, a1, b1 = _inputs(t, gen, b, h, g, d, dv)
        qs1, ks1, _ = ops._scaled_stabilized(q1, k1, a1, b1)
        vk1 = ops._to_kernel(v1)
        nbytes = (2 * bh * d * dv * 4 + 2 * bh * d * 4 + bh * 4
                  + bh * t * d * 4 + bg * t * d * 4 + bg * t * dv * 2
                  + bh * t * dv * 2)
        flops = bh * t * (2 * d * dv + 2 * d) \
            + bh * t * (t + 1) // 2 * (2 * d + 2 * dv) \
            + bh * t * (2 * d * dv + d) + bh * (d * dv + d)
        bnd, by = bound_ms(nbytes, flops)
        decode[t] = dict(
            ms=cuda_ms(lambda: lln_decode(qs1, ks1, vk1, s0, z0, r=r,
                                          scale=scale)),
            plain_ms=cuda_ms(lambda: lln_decode_plain(qs1, ks1, vk1, s0, z0,
                                                      r=r, scale=scale)),
            bound_ms=bnd, bound_by=by)
        if t != decode_ts[0]:
            log(f"timing {row_names[2]} T={t}: kernel "
                f"{decode[t]['ms']:.4f} ms, plain {decode[t]['plain_ms']:.4f}"
                f" ms, bound {bnd:.4f} ms ({by})")
    rows.append(dict(
        name=row_names[2], route="cuda",
        source="src/repro_torch/csrc/lln_decode.cu",
        replaces="src/repro/kernels/lln_attention.py:348",
        launches=launches[lkeys[2]], max_abs_err=errs[keys[2]],
        library_ms=None, **decode[decode_ts[0]]))
    for row, core in zip(rows, cores + [None]):
        extra = " [CUDA-core count: {:.4f} ms ({})]".format(*core) \
            if core else ""
        log(f"timing {row['name']} (B={b} H={h} G={g} N={n}): kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}){extra}, library "
            f"{row['library_ms']}, launches {row['launches']}")
    _log_attrs("block_diag", d, dv)
    return rows


def _log_attrs(name, d, dv):
    """Log the registers and local (spill) bytes a thread, CTAs per SM and
    shared bytes of the tensor-core kernels library ``name`` runs for bf16
    at (d, dv) (``build.tc_attrs``, from the CUDA runtime)."""
    from repro_torch.kernels import build
    for a in build.tc_attrs(name, d, dv):
        log(f"  {a['kernel']} (D={d} Dv={dv}): {a['registers']} registers, "
            f"{a['local_bytes']} local bytes a thread, {a['ctas_per_sm']} "
            f"CTAs per SM, {a['smem_bytes']} shared bytes")


def _log_split(name, d, dv, call):
    """:func:`_log_attrs` of library ``name``, then the device time of one
    ``call`` by kernel (:func:`device_profile`)."""
    _log_attrs(name, d, dv)
    dev_ms, kernels = device_profile(call)
    log(f"  one {name} call's device time {dev_ms:.4f} ms: " + ", ".join(
        f"{_kernel_name(k)} {ms:.4f}" for k, ms, _ in kernels))


def phase_timings_hybrid_serve(errs, launches):
    """Rows 1-3 at zamba2-7b's serving shape (B = ZB, H = G = H, N = ZN, D =
    Dv = ZD), decode at T = 1 (:func:`_serve_kernel_rows`)."""
    return _serve_kernel_rows(
        errs, launches, "D=112", ZB, H, H, ZD, SEED + 12,
        ("lln_causal (state, zamba2 D=112)", "block_diag (zamba2 D=112)",
         "lln_decode (zamba2 D=112)"),
        launch_keys=("lln_causal (state, hybrid)", "block_diag (hybrid)",
                     "lln_decode (hybrid)"))


def phase_timings_dense(errs, launches):
    """Rows 1-3 at the serving shapes of qwen3-14b, chatglm3-6b and
    stablelm-1.6b, decode at T = 1 (its row) and 16 (logged)."""
    rows = []
    for i, (tag, _, h, g, d) in enumerate(DENSE):
        rows += _serve_kernel_rows(
            errs, launches, tag, B, h, g, d, SEED + 40 + i,
            (f"lln_causal (state, {tag})", f"block_diag ({tag})",
             f"lln_decode ({tag})"), decode_ts=(1, 16))
    return rows


# ---------------------------------------------------------------------------
# The dense configs (qwen3-14b, chatglm3-6b, stablelm-1.6b), the decode
# contract and the drift renorm, and the paper's instruments.
# ---------------------------------------------------------------------------

def phase_serve_dense(launches, serve_times):
    """Full-width, full-depth serving of the three dense configs through
    _serve_cell (batch B, prompt N, GEN greedy tokens), logits against the
    plain backend: qwen3-14b with lln_diag (r = 5, qk-norm; per prefill 40
    lln_causal with the state and 40 causal block_diag, 40 lln_decode per
    step), chatglm3-6b with lln (r = 16; 28 lln_causal per prefill, 28
    lln_decode per step) and with lln_diag (28 + 28 per prefill: the path
    that runs block_diag at r = 16) and stablelm-1.6b with lln_diag (D =
    64; 24 + 24 per prefill, 24 per step).  Each model is freed before the
    next."""
    from repro_torch.configs import get_config
    idle = _idle()
    tags = {arch: tag for tag, arch, *_ in DENSE}
    for arch, impl in (("qwen3-14b", "lln_diag"), ("chatglm3-6b", "lln"),
                       ("chatglm3-6b", "lln_diag"),
                       ("stablelm-1.6b", "lln_diag")):
        tag = tags[arch]
        cfg = get_config(arch, attn_impl=impl, param_dtype="bfloat16")
        nl = cfg.n_layers
        want_pre = {**idle, "lln_causal": nl,
                    "block_diag": nl if impl == "lln_diag" else 0}
        serve_times[f"{arch} {impl}"], pre, dec = _serve_cell(
            cfg, N, want_pre, {**idle, "lln_decode": nl}, "plain",
            f"serve {arch} {impl}")
        launches[f"lln_causal (state, {tag})"] += pre["lln_causal"]
        launches[f"block_diag ({tag})"] += pre["block_diag"]
        launches[f"lln_decode ({tag})"] += dec["lln_decode"]


def phase_contract(errs):
    """The decode contract through the kernel at yi-9b's attention shape
    (B, H, G, D; a bf16 prompt of N on the kernels, then a chunk of T = 16):
    for lln and lln_diag, with row_mask (True, False, True, False) the
    masked rows keep every state leaf bitwise; with commit_len (0, 5, 16,
    11) the output and every state leaf within the kernel tolerances (one
    bf16 step, fp32 1e-5 of the largest entry) of the plain kind, the
    uncommitted row bitwise.  One lln_decode launch per decode."""
    from repro_torch.core.engine import AttentionEngine
    from repro_torch.kernels.lln_attention import lln_decode
    from repro_torch.kernels.registry import AttnSpec
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 50)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    fields = ("s", "z", "c_k", "log_scale", "tail_k", "tail_v", "pos")
    for impl in ("lln", "lln_diag"):
        eng = {kind: AttentionEngine(
            spec=AttnSpec(impl=impl, r=H // G, backend=kind, diag_block=BLK,
                          precision="bfloat16"),
            heads=H, kv_heads=G, head_dim=D, v_dim=D)
            for kind in ("kernel", "plain")}
        _, st = eng["kernel"].prefill(rnd(B, N, H, D), rnd(B, N, G, D),
                                      rnd(B, N, G, D))
        q, k, v = rnd(B, 16, H, D), rnd(B, 16, G, D), rnd(B, 16, G, D)
        worst = 0.0
        for what, kw, still in (
                ("row_mask", {"row_mask": torch.tensor(
                    [True, False, True, False], device="cuda")}, (1, 3)),
                ("commit_len", {"commit_len": torch.tensor(
                    [0, 5, 16, 11], dtype=torch.int32, device="cuda")}, (0,))):
            before = lln_decode.launches
            got, gst = eng["kernel"].decode(st, q, k, v, **kw)
            torch.cuda.synchronize()
            if lln_decode.launches != before + 1:
                raise AssertionError(f"contract {impl} {what}: "
                                     f"{lln_decode.launches - before} "
                                     f"lln_decode launches, expected 1")
            want, wst = eng["plain"].decode(st, q, k, v, **kw)
            keep = [i for i in range(B) if i not in still]
            log(f"contract {impl} {what} (T=16, kernel vs plain, rows "
                f"{list(still)} unchanged):")
            worst = max(worst, check("out", got[keep], want[keep],
                                     bf16_tol(want[keep])))
            for name in fields:
                a, w = getattr(gst, name), getattr(wst, name)
                for row in still:
                    if not torch.equal(a[row], getattr(st, name)[row]):
                        raise AssertionError(f"contract {impl} {what}: "
                                             f"{name}[{row}] changed")
                check(name, a, w, fp32_tol(w.float()))
            log(f"  rows {list(still)}: every leaf bitwise unchanged")
        errs[f"contract {impl}"] = worst


def phase_renorm(launches, serve_times):
    """yi-9b lln at full width and depth (bf16 weights from the seed, batch
    B, prompt N, GEN greedy tokens) with the drift renorm: the threshold
    is half the smallest max_d z that the prefill leaves in any layer, row
    and head, so it fires in every layer.  The first decode step's logits
    (the renorm acts on the state after the step's outputs) and the
    second's, scored from the renormalized state (both runs teacher-forced
    with the same tokens), within 0.1 of the largest of the renorm-off
    run's; the rows and layers that fired and the greedy tokens equal to
    the renorm-off run's are printed; 48 lln_decode launches per step.  Then the streaming instruments of the renorm-off run's caches
    on the card against the same function on CPU copies (1e-5 of the
    largest entry), and beside the renorm-on run's log key mass."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.metrics import streaming_concentration_tree
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import synthetic_batch
    cfg = get_config("yi-9b", attn_impl="lln", param_dtype="bfloat16")
    shape = ShapeSpec("chip", N + GEN, B, "decode")
    off = make_serve_setup(cfg, shape)
    params = off.model.init(SEED)
    batch = synthetic_batch(cfg, B, N + GEN, seed=SEED, text_seq=N,
                            device="cuda")
    logits, caches = off.prefill_fn(params, batch)
    thresh = 0.5 * min(float(st.z.amax(-1).min()) for st in caches["layers"])
    on = make_serve_setup(cfg.replace(lln_renorm=thresh), shape)
    tok = torch.argmax(logits[:, -1], -1)
    runs = {}
    tok2 = None
    for label, setup in (("off", off), ("on", on)):
        _reset()
        step1, c1 = setup.decode_fn(params, caches, tok, N)
        fired = torch.stack([st.log_scale > 0 for st in c1["layers"]])
        if tok2 is None:
            tok2 = torch.argmax(step1, -1)
        step2, c2 = setup.decode_fn(params, c1, tok2, N + 1)
        rest, c_end = setup.make_generate(GEN - 3)(
            params, c2, torch.argmax(step2, -1), N + 2)
        torch.cuda.synchronize()
        dec = _read()
        runs[label] = (step1, step2, fired, torch.cat(
            [tok[:, None], tok2[:, None], torch.argmax(step2, -1)[:, None],
             rest], 1), c_end)
        if dec["lln_decode"] != cfg.n_layers * (GEN - 1) or \
                sum(dec.values()) != dec["lln_decode"]:
            raise AssertionError(f"renorm {label}: decode launches {dec}")
    step_on, step2_on, fired, toks_on, c_on = runs["on"]
    step_off, step2_off, fired_off, toks_off, c_off = runs["off"]
    if bool(fired_off.any()):
        raise AssertionError("the renorm fired with the renorm off")
    layers_fired = int(fired.any(-1).any(-1).sum())
    log(f"renorm yi-9b lln (threshold {thresh:.4f}, half the prefill's "
        f"smallest max_d z): fired in {layers_fired} of {cfg.n_layers} "
        f"layers, {int(fired.any(-1).any(0).sum())} of {B} rows, "
        f"{int(fired.sum())} of {fired.numel()} (layer, row, head) states "
        f"at the first decode step; decode launches {cfg.n_layers} per step")
    if layers_fired != cfg.n_layers:
        raise AssertionError(f"renorm fired in {layers_fired} layers only")
    check("renorm first decode step logits vs renorm off", step_on, step_off,
          0.1 * max(1.0, float(step_off.abs().max())))
    check("renorm second decode step logits (from the renormalized state) "
          "vs renorm off", step2_on, step2_off,
          0.1 * max(1.0, float(step2_off.abs().max())))
    log(f"  greedy tokens equal to the renorm-off run: "
        f"{int((toks_on == toks_off).sum())} of {toks_on.numel()}")
    serve_times["lln renorm"] = {"threshold": thresh,
                                 "layers_fired": layers_fired,
                                 "tokens_equal": int((toks_on ==
                                                      toks_off).sum())}

    fields = ("z", "c_k", "log_scale", "pos")
    card = streaming_concentration_tree(c_off)
    host = streaming_concentration_tree(
        {"layers": [{f: getattr(st, f).cpu() for f in fields}
                    for st in c_off["layers"]]})
    log("streaming_concentration_tree (yi-9b lln serve caches, card vs "
        "CPU copies):")
    for name in sorted(card):
        check(name, card[name].cpu(), host[name], fp32_tol(host[name]))
    mass_on = streaming_concentration_tree(c_on)["log_mass"]
    log(f"  log_mass off {card['log_mass'].tolist()}, renorm on "
        f"{mass_on.tolist()}")
    del off, on, params, caches, c_on, c_off, runs
    torch.cuda.empty_cache()


def phase_instruments(errs):
    """The paper's probe on the card: Gaussian q, k (N = 1024, d = 128) at
    three sigma_tilde^2 of fit_lln_constants' grid (sigma_q = sigma_k =
    sigma_tilde / sqrt(2)), made on the card from the seed; softmax (eq. 6)
    against moment-matched LLN (eq. 9, alpha and beta from eq. 10 with the
    shipped (a, b) for d = 128): row entropy, log variance and the
    log-normality score (fp32, within 1e-5 relative of the same function
    on CPU copies of the same matrices) and spectral_gap_power (float64,
    within 1e-9).  Then fit_lln_constants(d=128, n=1024) on the card,
    printed beside the shipped constants (information only)."""
    import numpy as np
    from repro_torch.core import metrics as met
    from repro_torch.core import moment_matching as mm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 60)
    n, d = 1024, 128
    a, b = mm.constants_for_dim(d)
    grid = np.linspace(1.0, 36.0, 15)
    worst = 0.0
    for s2 in (grid[0], grid[7], grid[14]):
        sig = float(np.sqrt(s2 / 2.0))
        q = sig * torch.randn(n, d, generator=gen, device="cuda")
        k = sig * torch.randn(n, d, generator=gen, device="cuda")
        alpha, beta = (float(x) for x in mm.solve_alpha_beta(sig, sig, a, b))
        mats = {"softmax": mm.softmax_attn_matrix(q, k),
                "lln": mm.lln_attn_matrix(q, k, alpha, beta)}
        line = []
        for name, p in mats.items():
            ph = p.cpu()
            for what, fn in (("entropy", met.row_entropy),
                             ("log_variance", mm.log_variance)):
                got, want = fn(p), fn(ph)
                worst = max(worst, check(f"sigma_tilde^2={s2:.1f} {name} "
                                         f"{what}", got, want,
                                         1e-5 * max(1.0, float(want.abs()))))
                line.append(f"{name} {what} {float(got):.4f}")
            for what, fn, tol in (
                    ("lognormality", met.lognormality_score, 1e-5),
                    ("spectral_gap_power", met.spectral_gap_power, 1e-9)):
                got, want = fn(p), fn(ph)
                err = abs(got - want)
                log(f"  sigma_tilde^2={s2:.1f} {name} {what}: card {got:.6f},"
                    f" CPU {want:.6f}, err {err:.3e} (tol {tol:.0e})")
                if not err <= tol * max(1.0, abs(want)):
                    raise AssertionError(f"{name} {what}: {got} vs {want}")
                line.append(f"{name} {what} {got:.4f}")
        log(f"instruments sigma_tilde^2={s2:.1f} (alpha={alpha:.3f}, "
            f"beta={beta:.3f}): " + "; ".join(line))
    errs["instruments"] = worst
    t0 = time.time()
    fa, fb = mm.fit_lln_constants(d=d, n=n, device="cuda")
    log(f"fit_lln_constants(d=128, n=1024) on the card: a={fa:.4f} "
        f"b={fb:.4f} in {time.time() - t0:.1f}s; shipped d=128: "
        f"{mm.FITTED_CONSTANTS[128]} (n-grid 1024: "
        f"{mm.FITTED_CONSTANTS_N[128][1024]}); information only")


# ---------------------------------------------------------------------------
# F4, the request pool, checkpoints and remat "dots" (ROADMAP queue 1,
# items 7 and 8).
# ---------------------------------------------------------------------------

F4_SHAPE = ("chatglm3-6b", B, 32, 2, N, 128)   # tag, B, H, G, N, D: r = 16


def _f4_inputs(gen):
    _, b, h, g, n, d = F4_SHAPE
    mk = lambda rows: torch.randn(b * rows, n, d, generator=gen,  # noqa: E731
                                  device="cuda").bfloat16()
    return mk(h), mk(g), mk(g), mk(h)


def phase_f4(results):
    """block_diag_bwd (row 8) at r = 16, chatglm3-6b's attention shape
    (B=4, H=32, G=2, N=512, D=Dv=128, blk 256), bf16, causal and not: dq,
    dk, dv within 1e-5 of the largest plain entry (the gate it missed before
    its dk/dv kernel took p and dsm as three bf16 planes), two runs bitwise
    equal."""
    from repro_torch.kernels.block_diag import (block_diag_bwd,
                                                block_diag_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 25)
    q, k, v, g = _f4_inputs(gen)
    r = F4_SHAPE[2] // F4_SHAPE[3]
    for causal in (True, False):
        log(f"f4: block_diag_bwd r={r} causal={causal} blk={BLK} bf16 "
            f"({F4_SHAPE[0]} shape):")
        got = block_diag_bwd(q, k, v, g, r=r, blk=BLK, causal=causal)
        again = block_diag_bwd(q, k, v, g, r=r, blk=BLK, causal=causal)
        want = block_diag_bwd_plain(q, k, v, g, r=r, blk=BLK, causal=causal)
        torch.cuda.synchronize()
        for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
            err = check(name, gt, wt, fp32_tol(wt))
            results["block_diag_bwd (r=16)"] = max(
                results.get("block_diag_bwd (r=16)", 0.0), err)
        _same_runs("block_diag_bwd r=16", got, again)


def phase_timings_f4(errs, row8):
    """Row 8 at r = 16 (chatglm3-6b's shape, causal): the kernel, its plain
    version, SDPA's backward on the blocks (k and v repeated to the query
    heads outside the timing) and the bound, as ``row8["r16"]``.  The
    bound's products per causal (query, key) pair are the function's five,
    each once: q k^T, g v^T, dsm k, dsm^T q and p^T g (6 D + 4 Dv, the
    kernel's bf16 planes not counted), and the softmax's elementwise steps
    as fp32 work."""
    import torch.nn.functional as F
    from repro_torch.kernels.block_diag import (block_diag_bwd,
                                                block_diag_bwd_plain)
    tag, b, h, g_, n, d = F4_SHAPE
    r, nb = h // g_, n // BLK
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 26)
    q, k, v, g = _f4_inputs(gen)
    bh, bg = b * h, b * g_
    pairs = bh * nb * BLK * (BLK + 1) // 2
    nbytes = (2 * bh + 2 * bg) * n * d * 2 + (bh + 2 * bg) * n * d * 4
    bnd, by = bound_ms(nbytes, pairs * SOFTMAX_BWD_OPS, pairs * 10 * d)

    def blocks(t, heads):
        return t.reshape(b, heads, nb, BLK, d).permute(0, 2, 1, 3, 4) \
            .reshape(b * nb, heads, BLK, d)
    qb = blocks(q, h).detach().requires_grad_()
    kb = blocks(k, g_).repeat_interleave(r, 1).detach().requires_grad_()
    vb = blocks(v, g_).repeat_interleave(r, 1).detach().requires_grad_()
    gb = blocks(g, h)
    out = F.scaled_dot_product_attention(qb, kb, vb, is_causal=True)
    row8["r16"] = dict(
        shape=f"{tag}: B={b} H={h} G={g_} N={n} D=Dv={d} blk={BLK} causal",
        max_abs_err=errs["block_diag_bwd (r=16)"],
        ms=cuda_ms(lambda: block_diag_bwd(q, k, v, g, r=r, blk=BLK,
                                          causal=True), reps=10),
        plain_ms=cuda_ms(lambda: block_diag_bwd_plain(
            q, k, v, g, r=r, blk=BLK, causal=True), reps=10),
        bound_ms=bnd, bound_by=by,
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            out, (qb, kb, vb), gb, retain_graph=True), reps=10))
    e = row8["r16"]
    log(f"timing block_diag_bwd r=16 ({e['shape']}): kernel {e['ms']:.4f} "
        f"ms, plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
        f"({e['bound_by']}), library {e['library_ms']:.4f} ms (SDPA "
        f"backward, k/v repeated)")


class _PoolProbe:
    """Counts and times a ``PoolSetup``'s calls: prefills (one per admitted
    group or rebuilt row), segment steps, replay calls, the segments' wall
    time and emitted tokens, and every prefill's (tokens, last logits).
    The inputs of segment call ``profile_at`` (1-based) are copied into
    ``saved`` (the pool's functions leave their inputs unchanged, but the
    batcher writes into its tok/pos rows) for a profile after the run.
    While ``record`` is set, every decode step inside a segment is kept as
    (input tokens, positions, active rows, logits) and every admission as
    (decode steps so far, slots, prompts), for :meth:`trace`."""

    def __init__(self, setup, profile_at=0, record=False):
        self.setup, self.profile_at, self.record = setup, profile_at, record
        self.prefill_fn, self.segment_fn = setup.prefill_fn, setup.segment_fn
        self.replay_fn, self.admit_fn = setup.replay_fn, setup.admit_fn
        setup.prefill_fn, setup.segment_fn = self._prefill, self._segment
        setup.replay_fn, setup.admit_fn = self._replay, self._admit
        self.decode_fn = setup.model.decode
        # The Model is frozen; segment_fn looks its decode up on each step.
        object.__setattr__(setup.model, "decode", self._decode)
        self.prefills = self.steps = self.replays = self.calls = 0
        self.tokens = self.timed = 0
        self.segment_s = 0.0
        self.first, self.saved = [], None
        self.decodes, self.admits = [], []
        self.in_segment = False

    def _prefill(self, params, tokens):
        logits, caches = self.prefill_fn(params, tokens)
        self.prefills += 1
        self.first.append((tokens, logits[:, -1].float()))
        return logits, caches

    def _admit(self, pooled, slot_caches, slot_idx):
        if self.record:
            tokens = self.first[-1][0]
            slots = [int(x) for x in slot_idx]
            if len(slots) != tokens.shape[0]:
                raise AssertionError("pool probe: an admission without its "
                                     "prefill's rows")
            self.admits.append((len(self.decodes), slots, tokens))
        return self.admit_fn(pooled, slot_caches, slot_idx)

    def _decode(self, params, caches, tok, pos, **kw):
        logits, caches = self.decode_fn(params, caches, tok, pos, **kw)
        if self.record and self.in_segment:
            self.decodes.append((tok.clone(), pos.clone(),
                                 kw["row_mask"].clone(), logits.float()))
        return logits, caches

    def _segment(self, *args):
        self.calls += 1
        self.steps += self.setup.segment
        if self.calls == self.profile_at:
            from repro_torch.tree import map_with_path
            self.saved = (args[0], map_with_path(
                lambda _, a: a.clone(), args[1])) + tuple(
                a.clone() if torch.is_tensor(a) else a for a in args[2:])
        torch.cuda.synchronize()
        t0 = time.time()
        self.in_segment = True
        out = self.segment_fn(*args)
        self.in_segment = False
        torch.cuda.synchronize()
        self.segment_s += time.time() - t0
        self.timed += self.setup.segment
        self.tokens += int(out[6].sum())
        return out

    def _replay(self, *args):
        self.replays += 1
        return self.replay_fn(*args)

    def first_logits(self, prompt):
        """The last logits of the first prefill of ``prompt``."""
        p = torch.as_tensor(prompt, dtype=torch.long, device="cuda")
        for tokens, logits in self.first:
            for row in range(tokens.shape[0]):
                if tokens.shape[1] == p.shape[0] and torch.equal(
                        tokens[row], p):
                    return logits[row]
        raise AssertionError("no prefill of this prompt")

    def trace(self, prompt):
        """The recorded decode steps of the request with ``prompt`` in its
        slot, from its admission to the slot's next one: (input tokens,
        positions, logits (V,) per step)."""
        p = torch.as_tensor(prompt, dtype=torch.long, device="cuda")
        hits = [(at, slot) for at, slots, tokens in self.admits
                for j, slot in enumerate(slots)
                if tokens.shape[1] == p.shape[0]
                and torch.equal(tokens[j], p)]
        if len(hits) != 1:
            raise AssertionError(f"pool probe: {len(hits)} admissions of "
                                 "one prompt")
        start, slot = hits[0]
        end = min((at for at, slots, _ in self.admits
                   if slot in slots and at > start),
                  default=len(self.decodes))
        steps = self.decodes[start:end]
        active = torch.stack([st[2][slot] for st in steps]).tolist()
        toks = torch.stack([st[0][slot] for st in steps]).tolist()
        poss = torch.stack([st[1][slot] for st in steps]).tolist()
        keep = [i for i, a in enumerate(active) if a]
        return ([toks[i] for i in keep], [poss[i] for i in keep],
                [steps[i][3][slot] for i in keep])


def _pool_want(impl, n_layers, probe):
    want = _idle()
    if impl in ("lln", "lln_diag"):
        want["lln_causal"] = n_layers * probe.prefills
        want["lln_decode"] = n_layers * (probe.steps + probe.replays)
        if impl == "lln_diag":
            want["block_diag"] = n_layers * probe.prefills
    return want


def _expect_launches(label, got, want):
    log(f"  launches {got}")
    if got != want:
        raise AssertionError(f"{label}: launch counts {got}, expected {want}")


def _solo(model_cfg, params, req, max_len, cache):
    """The request alone: a batch-1 prefill and greedy decode."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    if "serve" not in cache:
        cache["serve"] = make_serve_setup(
            model_cfg, ShapeSpec("solo", max_len, 1, "decode"))
    sv = cache["serve"]
    prompt = torch.as_tensor(req.prompt, dtype=torch.long, device="cuda")
    logits, caches = sv.prefill_fn(params, {"inputs": prompt[None]})
    tok = torch.argmax(logits[:, -1], -1)
    out = [int(tok)]
    if req.budget > 1:
        toks, _ = sv.make_generate(req.budget - 1)(params, caches, tok,
                                                   len(req.prompt))
        out += toks[0].tolist()
    return logits[0, -1].float(), np.asarray(out, np.int32)


def _kill_and_resume(setup, params, reqs, every, kill_at, snap_dir):
    """A run killed at boundary ``kill_at`` with a snapshot every ``every``
    segments, then ``run([], resume=True)``; returns the resumed run's
    stats."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.batcher import ContinuousBatcher
    from repro_torch.launch.faults import FaultEvent, FaultPlan, SimulatedCrash
    mgr = CheckpointManager(snap_dir, keep_n=2, interval=1)
    eng = ContinuousBatcher(setup, params, snapshot_mgr=mgr,
                            snapshot_every=every)
    plan = FaultPlan(events=[FaultEvent(kind="kill", segment=kill_at)])
    t0 = time.time()
    try:
        eng.run(reqs, fault_plan=plan)
    except SimulatedCrash as e:
        log(f"  killed at segment boundary {e.segment}; latest snapshot "
            f"{mgr.latest_step()} ({time.time() - t0:.1f}s)")
    else:
        raise AssertionError("the kill fault did not fire")
    eng.snapshot_every = 0          # the resumed run needs no snapshots
    return eng.run([], resume=True)


def _same_tokens(label, stats, clean, rids):
    for rid in rids:
        if not np.array_equal(stats.outputs[rid], clean.outputs[rid]):
            raise AssertionError(f"{label}: request {rid} tokens "
                                 f"{stats.outputs[rid].tolist()} != "
                                 f"{clean.outputs[rid].tolist()}")
    log(f"  {label}: tokens bitwise equal for requests {list(rids)}")


def phase_small_pool(tmp):
    """yi-9b SMOKE in fp32 (use_kernel=True) through a 2-slot pool on the
    serving kernels, lln_diag and lln: mixed traffic (prompts 8 and 11,
    budgets 14 and 9, segment 3) equals each request served alone; a nan
    fault at segment 2 recovers the hurt request to the same tokens
    (status retried); a kill at segment 3, then run([], resume=True),
    finishes every request with the clean run's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.batcher import ContinuousBatcher, synthetic_traffic
    from repro_torch.launch.faults import FaultEvent, FaultPlan
    from repro_torch.launch.steps import make_pool_setup
    for impl in ("lln_diag", "lln"):
        cfg = get_config("yi-9b", smoke=True, attn_impl=impl,
                         compute_dtype="float32", use_kernel=True)
        setup = make_pool_setup(cfg, slots=2, max_len=48, segment=3)
        params = setup.model.init(SEED)
        reqs = synthetic_traffic(3, cfg.vocab, prompt_lens=[8, 11],
                                 gen_lens=[14, 9], seed=3)
        probe = _PoolProbe(setup)
        _reset()
        clean = ContinuousBatcher(setup, params).run(reqs)
        log(f"small_pool {impl}: statuses {clean.statuses}, "
            f"{clean.segments} segments")
        _expect_launches(f"small_pool {impl}", _read(),
                         _pool_want(impl, cfg.n_layers, probe))
        cache = {}
        for req in reqs:
            _, want = _solo(setup.cfg, params, req, 48, cache)
            if not np.array_equal(clean.outputs[req.rid], want):
                raise AssertionError(f"small_pool {impl}: request {req.rid}"
                                     f" differs from its solo run")
        log("  every request equals its solo run, token for token")
        plan = FaultPlan(events=[FaultEvent(kind="nan", segment=2, row=0)])
        faulty = ContinuousBatcher(setup, params).run(reqs, fault_plan=plan)
        hurt = faulty.health_events[0]["rid"] if faulty.health_events \
            else None
        if faulty.recoveries != 1 or faulty.statuses.get(hurt) != "retried":
            raise AssertionError(f"small_pool {impl}: nan fault gave "
                                 f"{faulty.statuses}, recoveries "
                                 f"{faulty.recoveries}")
        _same_tokens(f"nan fault (request {hurt} retried)", faulty, clean,
                     [r.rid for r in reqs])
        resumed = _kill_and_resume(setup, params, reqs, 1, 3,
                                   str(tmp / f"small_pool_{impl}"))
        _same_tokens("kill at segment 3 and resume", resumed, clean,
                     [r.rid for r in reqs])
        del setup, params


def _teacher_forced(label, sv, params, req, out, trace):
    """Feed the pool's tokens of ``req`` through the static batch-1 decode
    ``sv`` (make_serve_setup) and hold every step's logits to the pooled
    step's within the serve cell's bound (0.1 of the largest logit).  The
    trace must hold exactly the request's decode steps, its emitted tokens
    as inputs at positions plen, plen + 1, ...  Returns the worst step's
    error over its bound."""
    toks, poss, logits = trace
    plen, n = len(req.prompt), len(out) - 1
    if toks != [int(t) for t in out[:n]] or \
            poss != list(range(plen, plen + n)):
        raise AssertionError(f"{label}: request {req.rid}'s pooled decode "
                             f"steps took tokens {toks} at positions "
                             f"{poss}, not its {n} emitted tokens from "
                             f"position {plen}")
    prompt = torch.as_tensor(req.prompt, dtype=torch.long, device="cuda")
    _, caches = sv.prefill_fn(params, {"inputs": prompt[None]})
    worst = 0.0
    for k in range(n):
        tok = torch.as_tensor([int(out[k])], dtype=torch.long, device="cuda")
        lg, caches = sv.decode_fn(params, caches, tok, plen + k)
        want = lg[0].float()
        tol = 0.1 * max(1.0, float(want.abs().max()))
        err = max_err(logits[k], want)
        worst = max(worst, err / tol)
        if not err <= tol:
            raise AssertionError(f"{label}: request {req.rid} step {k} "
                                 f"logits {err} off the teacher-forced "
                                 f"batch-1 decode (tol {tol})")
    return worst


def phase_pool(launches, pool_times, tmp):
    """yi-9b at full width with PL of its 48 layers (bf16 weights from the
    seed; the depth is cut so that the script stays well inside its time
    limit: the pool's checks run every request solo, teacher-forced, with
    a fault and resumed, all host-bound) behind a 4-slot pool, lln_diag
    then softmax: 10 requests of synthetic_traffic
    (prompts 128, 300, 512; budgets 8, 24, 40), segment 8, max_len 576.
    Every request ends done with exactly its budget; each request's first
    logits within the serve cell's bound (0.1 of the largest logit) of its
    solo prefill; every pooled decode step (per-row positions, masked
    rows, per-row calibration at B = 4) within that bound of the static
    batch-1 decode fed the same tokens (teacher-forced); the greedy
    tokens' agreement with free-running solo runs printed (bf16 GEMMs at
    batch 4 and 1 may round apart); exact launch counts; after a nan fault
    on one row at segment 2 every request's tokens, the hurt one's too
    (retried: its admission group re-prefilled and its steps replayed),
    are bitwise the clean run's; a kill at segment 3 with a snapshot every 2 segments
    resumes to the clean run's tokens for every request.  Steady decode
    tok/s (tokens over the segments' wall time) and the device busy share
    (the device ms of the third segment, rerun on a copy of its inputs
    under the profiler after the timed run, per decode step, over the
    segments' mean wall ms per step) are recorded beside the static serve
    rows."""
    from repro_torch.configs import get_config
    from repro_torch.launch.batcher import ContinuousBatcher, synthetic_traffic
    from repro_torch.launch.faults import FaultEvent, FaultPlan
    from repro_torch.launch.steps import make_pool_setup
    params = None
    for impl in ("lln_diag", "softmax"):
        cfg = get_config("yi-9b", attn_impl=impl, param_dtype="bfloat16",
                         n_layers=PL)
        setup = make_pool_setup(cfg, slots=B, max_len=576, segment=8)
        if params is None:
            params = setup.model.init(SEED)
        reqs = synthetic_traffic(10, cfg.vocab, prompt_lens=[128, 300, 512],
                                 gen_lens=[8, 24, 40], seed=SEED)
        eng = ContinuousBatcher(setup, params)
        eng.warmup([128, 300, 512])
        probe = _PoolProbe(setup, profile_at=3, record=True)
        _reset()
        t0 = time.time()
        clean = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counted = _read()
        probe.record = False
        log(f"pool {impl}: {cfg.n_layers}L, {len(reqs)} requests over {B} "
            f"slots, {clean.segments} segments, {probe.prefills} prefills, "
            f"{probe.steps} decode steps in {wall:.2f}s")
        _expect_launches(f"pool {impl}", counted,
                         _pool_want(impl, cfg.n_layers, probe))
        for key, name in (("lln_causal", "lln_causal (state)"),
                          ("block_diag", "block_diag"),
                          ("lln_decode", "lln_decode")):
            launches[name] += counted[key]
        for req in reqs:
            if clean.statuses[req.rid] != "done" or \
                    len(clean.outputs[req.rid]) != req.budget:
                raise AssertionError(f"pool {impl}: request {req.rid} "
                                     f"{clean.statuses[req.rid]} with "
                                     f"{len(clean.outputs[req.rid])} tokens")
        dev_ms, top = device_profile(lambda: probe.segment_fn(*probe.saved))
        dev_ms /= setup.segment
        probe.saved = None
        agree = total = 0
        worst = worst_tf = 0.0
        cache = {}
        for req in reqs:
            solo_logits, solo = _solo(setup.cfg, params, req, 576, cache)
            tol = 0.1 * max(1.0, float(solo_logits.abs().max()))
            err = max_err(probe.first_logits(req.prompt), solo_logits)
            worst = max(worst, err / tol)
            if not err <= tol:
                raise AssertionError(f"pool {impl}: request {req.rid} first "
                                     f"logits {err} off its solo prefill "
                                     f"(tol {tol})")
            worst_tf = max(worst_tf, _teacher_forced(
                f"pool {impl}", cache["serve"], params, req,
                clean.outputs[req.rid], probe.trace(req.prompt)))
            agree += int((clean.outputs[req.rid] == solo).sum())
            total += len(solo)
        probe.decodes = []
        log(f"  first logits within {worst:.3f} of the bound of the solo "
            f"prefills; every pooled decode step within {worst_tf:.3f} of "
            f"the bound of the teacher-forced batch-1 decode; greedy tokens "
            f"equal to free-running solo runs: {agree} of {total}")
        steady = probe.tokens / probe.segment_s
        step_ms = probe.segment_s / probe.timed * 1e3
        pool_times[impl] = {
            "wall_s": wall, "segments": clean.segments,
            "decode_steps": probe.steps, "prefills": probe.prefills,
            "tokens": clean.completed_tokens, "steady_decode_tok_s": steady,
            "decode_ms_per_step": step_ms,
            "decode_device_ms_per_step": dev_ms, "busy": dev_ms / step_ms,
            "teacher_forced_worst": worst_tf,
            "solo_token_agreement": [agree, total]}
        log(f"  steady decode {steady:.1f} tok/s ({step_ms:.1f} ms per "
            f"step), device {dev_ms:.2f} ms per step (busy "
            f"{dev_ms / step_ms:.0%})")
        for name, ms, calls in top[:5]:
            log(f"  top pool segment: {ms:9.3f} ms  {calls:6d} calls  "
                f"{name[:80]}")

        plan = FaultPlan(events=[FaultEvent(kind="nan", segment=2, row=0)])
        faulty = ContinuousBatcher(setup, params).run(reqs, fault_plan=plan)
        hurt = faulty.health_events[0]["rid"] if faulty.health_events \
            else None
        if hurt is None or hurt < 0 or faulty.recoveries != 1 \
                or faulty.statuses[hurt] != "retried":
            raise AssertionError(f"pool {impl}: the nan fault gave "
                                 f"{faulty.health_events}, "
                                 f"{faulty.recoveries} recoveries")
        _same_tokens(f"nan fault (request {hurt} retried)", faulty, clean,
                     [r.rid for r in reqs])
        resumed = _kill_and_resume(setup, params, reqs, 2, 3,
                                   str(tmp / f"pool_{impl}"))
        if resumed.restored_step != 2:
            raise AssertionError(f"pool {impl}: resumed from "
                                 f"{resumed.restored_step}")
        _same_tokens("kill at segment 3, resumed from the snapshot at 2",
                     resumed, clean, [r.rid for r in reqs])
        del setup, eng, probe, cache
    del params
    torch.cuda.empty_cache()


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_ckpt_train(launches, ckpt_times, tmp):
    """roberta-lln at full size (lln_diag, use_kernel=True, batch EB x EN):
    through make_train_setup with total_steps 4, 2 steps, save_now,
    restore_or_init into a fresh state, 2 more steps; the losses and final
    parameters bitwise equal to an uninterrupted 4-step run.  Then the
    train CLI (SMOKE) with --ckpt-dir: 6 steps, then --steps 10 resumes at
    step 6."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import torch_placer
    from repro_torch.data.synthetic import mlm_batches
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_setup
    cfg = get_config("roberta-lln", attn_impl="lln_diag", use_kernel=True)
    setup = make_train_setup(cfg, ShapeSpec("ckpt", EN, EB, "train"),
                             peak_lr=3e-4, total_steps=4)
    place = torch_placer("cuda")
    gen = mlm_batches(cfg.vocab, EB, EN, seed=SEED + 2)
    batches = [place(next(gen)) for _ in range(4)]

    def steps(state, idx):
        losses = []
        for i in idx:
            state, m = setup.step_fn(state, batches[i])
            losses.append(m["loss"].detach().clone())
        return state, losses

    _reset()
    whole, losses = steps(setup.init_state(SEED), range(4))
    torch.cuda.synchronize()
    counted = _read()
    _expect_launches("ckpt_train (4 steps)", counted,
                     _enc_want("lln_diag", cfg.n_layers, 2 * 4, 4))
    _add_encoder_launches(launches, counted)
    mgr = CheckpointManager(str(tmp / "ckpt_train"), interval=2)
    state, first = steps(setup.init_state(SEED), range(2))
    torch.cuda.synchronize()
    t0 = time.time()
    path = mgr.save_now(2, state)
    t_save = time.time() - t0
    size = _dir_bytes(path)
    del state
    torch.cuda.synchronize()
    t0 = time.time()
    state, start = mgr.restore_or_init(lambda: setup.init_state(SEED + 1))
    torch.cuda.synchronize()
    t_restore = time.time() - t0
    if start != 2:
        raise AssertionError(f"ckpt_train: restored at step {start}")
    state, second = steps(state, range(2, 4))
    torch.cuda.synchronize()
    same_loss = all(torch.equal(a, b) for a, b in zip(first + second, losses))
    pa = dict(state["params"].named_parameters())
    pw = dict(whole["params"].named_parameters())
    same_params = all(torch.equal(pa[n], pw[n]) for n in pw)
    same_opt = all(torch.equal(state["opt"][k][n], whole["opt"][k][n])
                   for k in ("m", "v") for n in pw)
    n_params = sum(p.numel() for p in pw.values())
    log(f"ckpt_train: roberta-lln {n_params / 1e6:.1f}M params; checkpoint of params and AdamW moments {size / 1e9:.3f} "
        f"GB, save_now {t_save:.2f}s, restore {t_restore:.2f}s; losses "
        f"{[round(float(x), 6) for x in losses]}; after the resume the "
        f"losses {'are' if same_loss else 'are NOT'} bitwise equal, the "
        f"params {'are' if same_params else 'are NOT'}, the moments "
        f"{'are' if same_opt else 'are NOT'}")
    if not (same_loss and same_params and same_opt):
        raise AssertionError("ckpt_train: the resumed run differs from the "
                             "uninterrupted one")
    ckpt_times.update(bytes=size, save_now_s=t_save, restore_s=t_restore)
    del setup, state, whole, batches
    torch.cuda.empty_cache()
    ckpt = str(tmp / "ckpt_cli")
    base = ["--arch", "roberta-lln", "--smoke", "--ckpt-dir", ckpt,
            "--ckpt-interval", "2", "--seq", "64", "--batch", "2",
            "--log-every", "100"]
    log("train CLI --arch roberta-lln --smoke --ckpt-dir (default device):")
    h1 = train.main(base + ["--steps", "6"])
    h2 = train.main(base + ["--steps", "10"])
    if [h["step"] for h in h1] != list(range(6)) or \
            [h["step"] for h in h2] != list(range(6, 10)):
        raise AssertionError(f"train CLI resume: steps {h1} then {h2}")
    log("  the second call resumed at step 6 and ran to 9")


def phase_remat_dots(launches, train_times):
    """The yi-9b train cell (TL layers, lln_diag, batch B x TN) with
    remat="dots" (the matrix products' outputs kept, the rest recomputed,
    the kernels' Functions included): the same checks and timings as the
    cell with remat="full", its first step's loss and grad norm within the
    cell's gate of the "full" run's (bitwise equality printed)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    cfg = get_config("yi-9b", attn_impl="lln_diag", n_layers=TL,
                     use_kernel=True, remat="dots")

    def want(steps):
        out = _idle()
        out["lln_diag_fused"] = 2 * cfg.n_layers * steps
        out["lln_diag_fused_bwd"] = cfg.n_layers * steps
        return out

    times, counted = _train_cell(cfg, B, TN, lm_batches, want, "remat_dots")
    launches["lln_diag_fused"] += counted["lln_diag_fused"]
    launches["lln_diag_fused_bwd"] += counted["lln_diag_fused_bwd"]
    full = train_times["lln_diag"]
    (ld, gd), (lf, gf) = times["first"][:2], full["first"][:2]
    log(f"remat_dots: first step loss {ld:.6f} / {lf:.6f}, grad norm "
        f"{gd:.6f} / {gf:.6f} (dots / full), bitwise equal: "
        f"{ld == lf and gd == gf}; step {times['step_ms']:.1f} / "
        f"{full['step_ms']:.1f} ms, device {times['device_ms_per_step']:.1f}"
        f" / {full['device_ms_per_step']:.1f} ms, peak "
        f"{times['peak_gib']:.2f} / {full['peak_gib']:.2f} GiB")
    if not (abs(ld - lf) <= 1e-4 * abs(lf) and abs(gd - gf) <= 1e-3 * abs(gf)):
        raise AssertionError(f"remat_dots: first step {ld}, {gd} against "
                             f"full {lf}, {gf}")
    train_times["lln_diag remat=dots"] = times


SPEC_K, SPEC_POOL_K = 3, 2      # draft tokens per verify: spec, spec_pool


def _spec_want(impl, n_layers, draft_layers, k, iters, prefills=0,
               replays=0):
    """The launches of the speculative loop, from the code: per prefill
    every layer of the target and of the draft runs lln_causal (log_linear:
    loglin_causal), and with lln_diag block_diag; per verify iteration the
    draft's k T = 1 decodes and its commit decode of the (k+1)-token chunk
    run lln_decode in each draft layer, the target's score in each target
    layer, and the target's commit folds in torch (no kernel); a replay
    decodes both models once.  log_linear's decode runs lln_decode twice
    per layer and call.  softmax launches nothing."""
    want = _idle()
    if impl == "softmax":
        return want
    dec = iters * ((k + 1) * draft_layers + n_layers) \
        + replays * (draft_layers + n_layers)
    pre = prefills * (n_layers + draft_layers)
    if impl == "log_linear":
        want["loglin_causal"], want["lln_decode"] = pre, 2 * dec
        return want
    want["lln_causal"], want["lln_decode"] = pre, dec
    if impl == "lln_diag":
        want["block_diag"] = pre
    return want


def _equal_trees(label, got, want):
    from repro_torch.tree import leaves_with_path
    for (path, a), (_, b) in zip(leaves_with_path(got),
                                 leaves_with_path(want)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{label}: state leaf {path} differs")


def _commit_is_decode(impl, b, h, g, d, n, blk, seed):
    """AttentionEngine on the kernel route (backend auto, CUDA tensors):
    a commit_len = 0 verify leaves the prefilled state bitwise as it was,
    and commit of (k+1, 0, 1, 2, ...) after it equals decode with that
    commit_len, bit for bit."""
    from repro_torch.core.engine import AttentionEngine
    from repro_torch.kernels.registry import AttnSpec
    eng = AttentionEngine(spec=AttnSpec(impl=impl, r=h // g, lln_chunk=blk,
                                        diag_block=blk),
                          heads=h, kv_heads=g, head_dim=d, v_dim=d)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def qkv(t):
        return (torch.randn(b, t, h, d, generator=gen, device="cuda"),
                torch.randn(b, t, g, d, generator=gen, device="cuda"),
                torch.randn(b, t, g, d, generator=gen, device="cuda"))

    t = SPEC_K + 1
    _, st = eng.prefill(*qkv(n), max_len=n + t)
    qc, kc, vc = qkv(t)
    _, st0, resid = eng.verify(st, qc, kc, vc, commit_len=torch.zeros(
        b, dtype=torch.int32, device="cuda"), return_residuals=True)
    _equal_trees(f"{impl} commit_len=0 verify", st0, st)
    cl = torch.tensor([(t, 0, 1, 2)[i % 4] for i in range(b)],
                      dtype=torch.int32, device="cuda")
    got = eng.commit(st0, resid, commit_len=cl)
    _, want = eng.decode(st, qc, kc, vc, commit_len=cl)
    _equal_trees(f"{impl} commit", got, want)


def _spec_run(sp, params, batch, plen, steps, iters=None):
    logits, tc, dc = sp.prefill_fn(params, batch)
    tok = torch.argmax(logits[:, -1], -1)
    return tok, sp.make_generate(steps, iters=iters)(params, tc, dc, tok,
                                                     plen)


def _spec_small():
    """yi-9b SMOKE in fp32 on the kernels: speculative greedy tokens (k =
    SPEC_K, a draft of n_layers // 2 layers) equal the plain greedy loop's
    for lln, lln_diag, log_linear and softmax (prompt 20, 30 tokens: decode
    crosses granule and diag-block boundaries), with exact launch counts;
    the tied full-depth draft accepts every draft in every row; commit
    after a commit_len = 0 verify equals decode(commit_len) bitwise per
    impl, at SMOKE's heads and at yi-9b's (B=4, H=32, G=4, D=128, prompt
    300, block 256)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import (flatten_spec_tokens,
                                          make_serve_setup, make_spec_setup)
    from repro_torch.models import synthetic_batch
    plen, steps, k = 20, 30, SPEC_K
    for impl in ("lln", "lln_diag", "log_linear", "softmax"):
        cfg = get_config("yi-9b", smoke=True, attn_impl=impl,
                         compute_dtype="float32")
        ml = plen + steps + k + 2
        dl = cfg.n_layers // 2
        sp = make_spec_setup(cfg, ShapeSpec("spec", ml, B, "decode"),
                             spec_k=k, draft_layers=dl)
        params = sp.model.init(SEED)
        batch = synthetic_batch(cfg, B, ml, seed=SEED, text_seq=plen,
                                device="cuda")
        _reset()
        tok, (toks, n_emit, n_acc, live, *_) = _spec_run(sp, params, batch,
                                                         plen, steps)
        torch.cuda.synchronize()
        iters = int(live.any(0).sum())
        _expect_launches(f"spec small {impl}", _read(), _spec_want(
            impl, cfg.n_layers, dl, k, iters, prefills=1))
        ss = make_serve_setup(cfg, ShapeSpec("plain", plen + steps + 1, B,
                                             "decode"))
        logits, caches = ss.prefill_fn(params, batch)
        tok2 = torch.argmax(logits[:, -1], -1)
        plain = ss.make_generate(steps)(params, caches, tok2, plen)[0]
        flat = flatten_spec_tokens(toks, n_emit, steps)
        if not (torch.equal(tok, tok2)
                and np.array_equal(flat, plain.cpu().numpy())):
            raise AssertionError(f"spec small {impl}: speculative tokens "
                                 f"{flat.tolist()} != plain greedy "
                                 f"{plain.tolist()}")
        _, (toks, n_emit, n_acc_full, live_full, *_) = _spec_run(
            make_spec_setup(cfg, ShapeSpec("spec", ml, B, "decode"),
                            spec_k=k, draft_layers=cfg.n_layers),
            params, batch, plen, steps)
        if not bool((n_acc_full[live_full] == k).all()) or not \
                np.array_equal(flatten_spec_tokens(toks, n_emit, steps),
                               flat):
            raise AssertionError(f"spec small {impl}: the full-depth "
                                 f"draft accepted {n_acc_full.tolist()}")
        _commit_is_decode(impl, B, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 21,
                          cfg.diag_block, SEED + 1)
        _commit_is_decode(impl, B, H, G, D, 300, BLK, SEED + 2)
        log(f"spec small {impl}: {B} rows x {steps} tokens equal to the "
            f"plain greedy loop in {iters} iterations (accepted "
            f"{int(n_acc.sum())} of {int(live.sum()) * k} drafts); the "
            f"full-depth draft accepted all; commit bitwise equal to "
            f"decode(commit_len) at both shapes")


class _ScoreProbe:
    """Records every target score pass of a SpecSetup while ``record`` is
    set: (positions (B,), logits (B, k+1, V) fp32)."""

    def __init__(self, model):
        self.score, self.record, self.passes = model.score, False, []
        object.__setattr__(model, "score", self._score)

    def _score(self, params, caches, token, pos, row_mask=None):
        logits, resid = self.score(params, caches, token, pos, row_mask)
        if self.record:
            self.passes.append((pos.clone(), logits.float()))
        return logits, resid


def phase_spec(launches, spec_times):
    """Speculative decoding: the SMOKE checks (:func:`_spec_small`), then
    yi-9b at full width and depth (bf16 weights from the seed), batch B,
    prompt N, GEN tokens (the first from the prefill), k = SPEC_K and a
    24-layer draft, lln_diag then softmax: exact launch counts for the
    prefill and the loop; every score logit at an emitted position within
    the serve cell's bound (0.1 of the largest logit) of the batch-B T = 1
    decode fed the emitted sequence (teacher-forced, every emitted position
    covered), whose step time is the plain decode's; the acceptance rate,
    tokens per verify iteration, wall and device ms per iteration, busy
    share and target passes per emitted token (``_count_pass``, per row)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import (flatten_spec_tokens,
                                          make_serve_setup, make_spec_setup)
    from repro_torch.models import synthetic_batch
    from repro_torch.models import transformer as tr
    _spec_small()
    params = None
    k, steps = SPEC_K, GEN - 1
    for impl in ("lln_diag", "softmax"):
        cfg = get_config("yi-9b", attn_impl=impl, param_dtype="bfloat16")
        dl = cfg.n_layers // 2
        ml = N + GEN + k + 2
        sp = make_spec_setup(cfg, ShapeSpec("spec", ml, B, "decode"),
                             spec_k=k, draft_layers=dl)
        if params is None:
            params = sp.model.init(SEED)
        probe = _ScoreProbe(sp.model)
        batch = synthetic_batch(cfg, B, ml, seed=SEED, text_seq=N,
                                device="cuda")
        _spec_run(sp, params, batch, N, steps, iters=1)      # warm-up
        torch.cuda.synchronize()
        _reset()
        t0 = time.time()
        logits, tc, dc = sp.prefill_fn(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.time() - t0
        pre = _read()
        tok = torch.argmax(logits[:, -1], -1)
        _reset()
        tr.DECODE_PASS_COUNTS.clear()
        probe.record = True
        t0 = time.time()
        toks, n_emit, n_acc, live, *_ = sp.make_generate(steps)(
            params, tc, dc, tok, N)
        torch.cuda.synchronize()
        t_gen = time.time() - t0
        probe.record = False
        dec = _read()
        iters = int(live.any(0).sum())
        passes = tr.DECODE_PASS_COUNTS.get(cfg.name, 0)
        log(f"spec {impl}: {cfg.n_layers}L target, {dl}L draft, k={k}, "
            f"batch {B}, prompt {N}: prefill launches {pre}, loop "
            f"launches {dec} over {iters} iterations")
        _expect_launches(f"spec {impl} prefill", pre,
                         _spec_want(impl, cfg.n_layers, dl, k, 0, 1))
        _expect_launches(f"spec {impl} loop", dec,
                         _spec_want(impl, cfg.n_layers, dl, k, iters))
        if passes != iters or len(probe.passes) != iters:
            raise AssertionError(f"spec {impl}: {passes} target passes "
                                 f"counted, {len(probe.passes)} recorded, "
                                 f"for {iters} iterations")
        for key, name in (("lln_causal", "lln_causal (state)"),
                          ("block_diag", "block_diag"),
                          ("lln_decode", "lln_decode")):
            launches[name] += pre[key] + dec[key]
        flat = torch.as_tensor(flatten_spec_tokens(toks, n_emit, steps),
                               device="cuda").long()
        # Teacher-forced: the emitted sequence through the T = 1 decode.
        t_tf = time.time()
        ss = make_serve_setup(cfg, ShapeSpec("tf", N + GEN, B, "decode"))
        _, caches = ss.prefill_fn(params, batch)
        seq = torch.cat([tok[:, None], flat], 1)          # inputs at N + m
        tf = []
        torch.cuda.synchronize()
        t0 = time.time()
        for m in range(steps):
            lg, caches = ss.decode_fn(params, caches, seq[:, m], N + m)
            tf.append(lg.float())
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) / steps * 1e3
        worst, covered = 0.0, [set() for _ in range(B)]
        n_emit_h, live_h = n_emit.cpu(), live.cpu()
        for i, (pos, lg) in enumerate(probe.passes):
            for row in range(B):
                if not live_h[row, i]:
                    continue
                for j in range(int(n_emit_h[row, i])):
                    m = int(pos[row]) - N + j
                    if m >= steps:
                        break
                    want = tf[m][row]
                    tol = 0.1 * max(1.0, float(want.abs().max()))
                    err = max_err(lg[row, j], want)
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f"spec {impl}: row {row} position {N + m} score "
                            f"logits {err} off the teacher-forced decode "
                            f"(tol {tol})")
                    covered[row].add(m)
        if any(c != set(range(steps)) for c in covered):
            raise AssertionError(f"spec {impl}: the score passes cover "
                                 f"{[len(c) for c in covered]} of {steps} "
                                 f"emitted positions per row")
        probe.passes = []
        t_check = time.time() - t_tf
        t0 = time.time()
        dev_ms, top = device_profile(lambda: sp.make_generate(
            steps, iters=1)(params, tc, dc, tok, N))
        t_profile = time.time() - t0
        wall_ms = t_gen / iters * 1e3
        emitted = int(n_emit.sum())
        acc = float(n_acc.sum()) / max(float(live.sum()) * k, 1.0)
        spec_times[impl] = {
            "prefill_ms": t_prefill * 1e3, "iterations": iters,
            "acceptance_rate": acc,
            "tokens_per_iter": emitted / max(int(live.sum()), 1),
            "wall_ms_per_iter": wall_ms, "device_ms_per_iter": dev_ms,
            "busy": dev_ms / wall_ms,
            "target_passes_per_token": passes / (emitted / B),
            "ms_per_token": t_gen / steps * 1e3,
            "plain_decode_ms_per_step": plain_ms,
            "teacher_forced_worst": worst}
        log(f"  every emitted position's score logits within {worst:.3f} of "
            f"the bound of the teacher-forced decode")
        log(f"  acceptance {acc:.3f} (random weights: the draft and the "
            f"target agree by chance only), {emitted / int(live.sum()):.3f} "
            f"tokens per verify iteration, {wall_ms:.1f} ms wall and "
            f"{dev_ms:.2f} ms device per iteration (busy "
            f"{dev_ms / wall_ms:.0%}), {passes / (emitted / B):.3f} target "
            f"passes per emitted token; {t_gen / steps * 1e3:.1f} ms per "
            f"token against the plain decode's {plain_ms:.1f} ms per step")
        log(f"  host s: loop {t_gen:.1f}, teacher-forced check "
            f"{t_check:.1f}, profile of one iteration {t_profile:.1f}")
        for name, ms, calls in top[:5]:
            log(f"  top spec iteration: {ms:9.3f} ms  {calls:6d} calls  "
                f"{name[:80]}")
        del sp, ss, caches, tc, dc, tf, probe
    del params
    torch.cuda.empty_cache()


class _SpecPoolProbe(_PoolProbe):
    """A :class:`_PoolProbe` for a speculative pool: while ``record`` is
    set, every target score pass inside a segment is kept as (chunk tokens
    (B, k+1), positions, active rows, logits (B, k+1, V)), so
    :meth:`trace` gives a request's verify iterations."""

    def __init__(self, setup, record=False):
        super().__init__(setup, record=record)
        self.score_fn = setup.model.score
        object.__setattr__(setup.model, "score", self._score)

    def _score(self, params, caches, token, pos, row_mask=None):
        logits, resid = self.score_fn(params, caches, token, pos, row_mask)
        if self.record and self.in_segment:
            self.decodes.append((token.clone(), pos.clone(),
                                 row_mask.clone(), logits.float()))
        return logits, resid

    def reset(self):
        self.prefills = self.steps = self.replays = self.calls = 0
        self.tokens = self.timed = 0
        self.segment_s = 0.0
        self.first, self.decodes, self.admits = [], [], []


def _spec_teacher_forced(label, sv, params, reqs, outputs, probe):
    """Hold each pooled speculative request's verify logits to the static
    T = 1 decode ``sv`` fed its emitted tokens (the requests of one prompt
    length decoded as one batch, a row past its end fed its last token):
    in each of its iterations the chunk's accepted prefix (inputs equal to
    the emitted sequence from the chunk's position) scores within 0.1 of
    the largest logit, and every emitted position is covered.  Returns the
    worst error over its bound."""
    worst = 0.0
    for plen in sorted({len(r.prompt) for r in reqs}):
        group = [r for r in reqs if len(r.prompt) == plen]
        seqs = [[int(t) for t in outputs[r.rid]] for r in group]
        n_max = max(len(q) for q in seqs) - 1
        prompts = torch.as_tensor(np.stack([r.prompt for r in group]),
                                  dtype=torch.long, device="cuda")
        _, caches = sv.prefill_fn(params, {"inputs": prompts})
        tf = []
        for m in range(n_max):
            tok = torch.as_tensor([q[min(m, len(q) - 1)] for q in seqs],
                                  dtype=torch.long, device="cuda")
            lg, caches = sv.decode_fn(params, caches, tok, plen + m)
            tf.append(lg.float())
        for i, (req, seq) in enumerate(zip(group, seqs)):
            chunks, poss, logits = probe.trace(req.prompt)
            n, covered = len(seq) - 1, set()
            for chunk, p, lg in zip(chunks, poss, logits):
                if p - plen >= n:
                    continue
                if chunk[0] != seq[p - plen]:
                    raise AssertionError(
                        f"{label}: request {req.rid}'s iteration at "
                        f"position {p} took token {chunk[0]}, not its "
                        f"emitted {seq[p - plen]}")
                for j, t in enumerate(chunk):
                    m = p - plen + j
                    if m >= n or t != seq[m]:
                        break
                    want = tf[m][i]
                    tol = 0.1 * max(1.0, float(want.abs().max()))
                    err = max_err(lg[j], want)
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f"{label}: request {req.rid} position "
                            f"{plen + m} logits {err} off the "
                            f"teacher-forced decode (tol {tol})")
                    covered.add(m)
            if covered != set(range(n)):
                raise AssertionError(
                    f"{label}: request {req.rid}'s iterations cover "
                    f"{sorted(covered)} of its {n} decode inputs")
    return worst


def _spec_pool_small():
    """yi-9b SMOKE in fp32 on the kernels through a 2-slot speculative pool
    (k = SPEC_POOL_K, 1-layer draft, lln_diag): mixed traffic equals each
    request served alone by make_spec_setup, with exact launch counts; a
    nan fault at segment 2 recovers by replaying both states, and every
    request's tokens equal the clean run's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.batcher import ContinuousBatcher, synthetic_traffic
    from repro_torch.launch.faults import FaultEvent, FaultPlan
    from repro_torch.launch.steps import (flatten_spec_tokens,
                                          make_pool_setup, make_spec_setup)
    k = SPEC_POOL_K
    cfg = get_config("yi-9b", smoke=True, attn_impl="lln_diag",
                     compute_dtype="float32")
    setup = make_pool_setup(cfg, slots=2, max_len=48, segment=3, spec_k=k,
                            draft_layers=1)
    params = setup.model.init(SEED)
    reqs = synthetic_traffic(3, cfg.vocab, prompt_lens=[8, 11],
                             gen_lens=[14, 9], seed=3)
    probe = _SpecPoolProbe(setup)
    _reset()
    clean = ContinuousBatcher(setup, params).run(reqs)
    _expect_launches("spec_pool small", _read(), _spec_want(
        "lln_diag", cfg.n_layers, 1, k, probe.steps, probe.prefills,
        probe.replays))
    sp = make_spec_setup(setup.cfg, ShapeSpec("solo", 48, 1, "decode"),
                         spec_k=k, draft_layers=1)
    for req in reqs:
        prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                 device="cuda")[None]
        tok, (toks, n_emit, *_) = _spec_run(sp, params, {"inputs": prompt},
                                            len(req.prompt), req.budget - 1)
        want = [int(tok)] + flatten_spec_tokens(toks, n_emit,
                                                req.budget - 1)[0].tolist()
        if clean.outputs[req.rid].tolist() != want:
            raise AssertionError(f"spec_pool small: request {req.rid} "
                                 f"{clean.outputs[req.rid].tolist()} != "
                                 f"solo {want}")
    probe.reset()
    _reset()
    plan = FaultPlan(events=[FaultEvent(kind="nan", segment=2, row=0)])
    faulty = ContinuousBatcher(setup, params).run(reqs, fault_plan=plan)
    hurt = faulty.health_events[0]["rid"] if faulty.health_events else None
    if faulty.recoveries != 1 or faulty.statuses.get(hurt) != "retried" \
            or probe.replays < 1:
        raise AssertionError(f"spec_pool small: nan fault gave "
                             f"{faulty.statuses}, {probe.replays} replays")
    _expect_launches("spec_pool small, nan fault", _read(), _spec_want(
        "lln_diag", cfg.n_layers, 1, k, probe.steps, probe.prefills,
        probe.replays))
    _same_tokens(f"spec_pool small nan fault (request {hurt} retried, "
                 f"{probe.replays} replays of both states)", faulty, clean,
                 [r.rid for r in reqs])


def phase_spec_pool(launches, pool_times):
    """The pool cell (yi-9b at full width with PL layers, bf16 weights from
    the seed, 4 slots, lln_diag, 10 requests of prompts 128, 300, 512 and
    budgets 8, 24, 40, segment 8, max_len 576) with speculative rows:
    k = SPEC_POOL_K and a draft of PL / 2 layers.  After the SMOKE checks
    (:func:`_spec_pool_small`): every request done with exactly its budget;
    exact launch counts; per pooled iteration, each request's accepted
    prefix scores within 0.1 of the largest logit of the static T = 1
    decode fed its emitted tokens (every emitted position covered); a nan
    fault on one row at segment 2 is quarantined and rebuilt by replaying
    the target and the draft (exact launch counts with the replays), and
    every request's tokens, the hurt one's too, are bitwise the clean
    run's.  Acceptance, tokens per iteration and the segments' tok/s are
    recorded."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.batcher import ContinuousBatcher, synthetic_traffic
    from repro_torch.launch.faults import FaultEvent, FaultPlan
    from repro_torch.launch.steps import make_pool_setup, make_serve_setup
    _spec_pool_small()
    k = SPEC_POOL_K
    cfg = get_config("yi-9b", attn_impl="lln_diag", param_dtype="bfloat16",
                     n_layers=PL)
    dl = cfg.n_layers // 2
    setup = make_pool_setup(cfg, slots=B, max_len=576, segment=8, spec_k=k,
                            draft_layers=dl)
    params = setup.model.init(SEED)
    reqs = synthetic_traffic(10, cfg.vocab, prompt_lens=[128, 300, 512],
                             gen_lens=[8, 24, 40], seed=SEED)
    probe = _SpecPoolProbe(setup, record=True)
    _reset()
    t0 = time.time()
    clean = ContinuousBatcher(setup, params).run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counted = _read()
    probe.record = False
    log(f"spec_pool lln_diag: {cfg.n_layers}L target, {dl}L draft, k={k}, "
        f"{len(reqs)} requests over {B} slots, {clean.segments} segments, "
        f"{probe.prefills} prefills, {probe.steps} iterations in "
        f"{wall:.2f}s")
    _expect_launches("spec_pool", counted, _spec_want(
        "lln_diag", cfg.n_layers, dl, k, probe.steps, probe.prefills,
        probe.replays))
    for key, name in (("lln_causal", "lln_causal (state)"),
                      ("block_diag", "block_diag"),
                      ("lln_decode", "lln_decode")):
        launches[name] += counted[key]
    for req in reqs:
        if clean.statuses[req.rid] != "done" or \
                len(clean.outputs[req.rid]) != req.budget:
            raise AssertionError(f"spec_pool: request {req.rid} "
                                 f"{clean.statuses[req.rid]} with "
                                 f"{len(clean.outputs[req.rid])} tokens")
    t0 = time.time()
    sv = make_serve_setup(setup.cfg, ShapeSpec("tf", 576, B, "decode"))
    worst = _spec_teacher_forced("spec_pool", sv, params, reqs,
                                 clean.outputs, probe)
    probe.decodes = []
    t_check = time.time() - t0
    steady = probe.tokens / probe.segment_s
    pool_times["lln_diag spec_k=2"] = {
        "wall_s": wall, "segments": clean.segments,
        "iterations": probe.steps, "prefills": probe.prefills,
        "tokens": clean.completed_tokens, "steady_decode_tok_s": steady,
        "ms_per_iteration": probe.segment_s / probe.timed * 1e3,
        "acceptance_rate": clean.acceptance_rate,
        "tokens_per_iter": clean.goodput_tokens_per_iter,
        "teacher_forced_worst": worst}
    log(f"  every pooled iteration's accepted prefix within {worst:.3f} of "
        f"the bound of the teacher-forced decode; acceptance "
        f"{clean.acceptance_rate:.3f} (random weights), "
        f"{clean.goodput_tokens_per_iter:.3f} tokens per verify iteration, "
        f"steady {steady:.1f} tok/s, "
        f"{probe.segment_s / probe.timed * 1e3:.1f} ms per iteration "
        f"(the teacher-forced check {t_check:.1f}s)")
    probe.reset()
    _reset()
    plan = FaultPlan(events=[FaultEvent(kind="nan", segment=2, row=0)])
    faulty = ContinuousBatcher(setup, params).run(reqs, fault_plan=plan)
    hurt = faulty.health_events[0]["rid"] if faulty.health_events else None
    if hurt is None or hurt < 0 or faulty.recoveries != 1 \
            or probe.replays < 1:
        raise AssertionError(f"spec_pool: the nan fault gave "
                             f"{faulty.health_events}, {probe.replays} "
                             "replays")
    counted = _read()
    _expect_launches("spec_pool, nan fault", counted, _spec_want(
        "lln_diag", cfg.n_layers, dl, k, probe.steps, probe.prefills,
        probe.replays))
    for key, name in (("lln_causal", "lln_causal (state)"),
                      ("block_diag", "block_diag"),
                      ("lln_decode", "lln_decode")):
        launches[name] += counted[key]
    if faulty.statuses[hurt] != "retried":
        raise AssertionError(f"spec_pool: the hurt request {hurt} ended "
                             f"{faulty.statuses[hurt]}")
    _same_tokens(f"spec_pool nan fault (request {hurt} retried after "
                 f"{probe.replays} replays of target and draft)", faulty,
                 clean, [r.rid for r in reqs])
    del setup, params, probe, sv
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The MoE, MLA, encoder-decoder and VLM families (qwen3-moe-235b-a22b,
# deepseek-v2-236b, seamless-m4t-medium, paligemma-3b).
# ---------------------------------------------------------------------------

# Their attention at the serving batch B (tag, arch, H, G, D, Dv, N): rows
# 1-3 at each.  D or Dv above 128 (MLA's assembled q/k, paligemma's heads)
# take the CUDA-core kernels of rows 1 and 3 and the tensor cores of row 2
# (up to 256).  The seamless decoder serves a 64-token target prompt.
FAMILIES = (("qwen3-moe r=16", "qwen3-moe-235b-a22b", 64, 4, 128, 128, N),
            ("mla D=192 Dv=128", "deepseek-v2-236b", 128, 128, 192, 128, N),
            ("paligemma D=256 r=8", "paligemma-3b", 8, 1, 256, 256, N),
            ("seamless decoder D=64", "seamless-m4t-medium", 16, 16, 64, 64,
             64))
FL = 4                          # layers of the two cut MoE cells
SEAMLESS = (B, 16, 2048, 64)    # the seamless encoder: B, H = G, frames, D
VLM_TEXT = 256                  # paligemma's text prompt after 256 patches


def phase_kernels_families(results):
    """Rows 1-3 at the families' serving shapes (:data:`FAMILIES`; decode
    at T = 1 and 4) against their plain versions, two runs bitwise equal
    (:func:`_check_serve_kernels`); then the seamless encoder's kernels at
    its shape (:data:`SEAMLESS`, H = G): lln_bidir (out within one bf16
    step, s, z and den within 1e-5 of the largest plain entry) and
    block_diag with causal=False (blk BLK), two runs of each bitwise
    equal."""
    from repro_torch.kernels.block_diag import block_diag, block_diag_plain
    from repro_torch.kernels.lln_attention import lln_bidir, lln_bidir_plain
    for i, (tag, _, h, g, d, dv, n) in enumerate(FAMILIES):
        _check_serve_kernels(results, tag, B, h, g, d, SEED + 60 + i,
                             decode_ts=(1, 4), dv=dv, n=n)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 64)
    b, h, n, d = SEAMLESS
    qs, ks, qk, kk, vk, _ = _train_inputs(n, gen, b, h, h, d)
    log(f"lln_bidir (seamless encoder) B={b} H=G={h} N={n} D=Dv={d}:")
    runs = [lln_bidir(qs, ks, vk, r=1, return_res=True) for _ in range(2)]
    want = lln_bidir_plain(qs, ks, vk, r=1, return_res=True)
    torch.cuda.synchronize()
    results["lln_bidir (seamless encoder)"] = max(
        check("out", runs[0][0], want[0], bf16_tol(want[0])),
        *(check(nm, gt, wt, fp32_tol(wt))
          for nm, gt, wt in zip(("s", "z", "den"), runs[0][1:], want[1:])))
    _same_runs("lln_bidir (seamless encoder)", *runs)
    log(f"block_diag (causal=False, seamless encoder) blk={BLK}:")
    runs = [block_diag(qk, kk, vk, r=1, blk=BLK, causal=False)
            for _ in range(2)]
    want = block_diag_plain(qk, kk, vk, r=1, blk=BLK, causal=False)
    torch.cuda.synchronize()
    results["block_diag (causal=False, seamless encoder)"] = check(
        "out", runs[0], want, bf16_tol(want))
    _same_runs("block_diag (causal=False, seamless encoder)", (runs[0],),
               (runs[1],))


def _no_drop(cfg):
    """``cfg`` with a capacity no slot can pass (n_experts / top_k): a
    dropped slot makes a row's MoE output depend on the other rows of its
    batch (in the reference as here), so the pool and speculative checks
    run without drops."""
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


def phase_small_families():
    """Each family's SMOKE config in fp32 with use_kernel=True, prompt 20
    and 8 greedy tokens, the kernels (backend auto) against the core
    reference (backend ref): qwen3-moe lln and lln_diag, deepseek-v2
    lln_diag and softmax (the absorbed decode), seamless lln_diag (its
    encoder through lln_bidir and the non-causal block_diag), paligemma
    lln_diag and softmax (the prefix-LM mask): prefill logits within 1e-4,
    greedy tokens equal.  Then qwen3-moe SMOKE (lln_diag, no drops)
    through a 2-slot pool, plain and with spec_k = 2 (a 1-layer draft),
    each request equal to its solo run, and make_spec_setup's greedy
    tokens (k = 3) equal to the plain greedy loop."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.batcher import ContinuousBatcher, synthetic_traffic
    from repro_torch.launch.steps import (flatten_spec_tokens, make_pool_setup,
                                          make_serve_setup, make_spec_setup)
    from repro_torch.models import synthetic_batch
    prompt, steps = 20, 8
    cells = (("qwen3-moe-235b-a22b", "lln"), ("qwen3-moe-235b-a22b",
                                              "lln_diag"),
             ("deepseek-v2-236b", "lln_diag"), ("deepseek-v2-236b",
                                                "softmax"),
             ("seamless-m4t-medium", "lln_diag"), ("paligemma-3b", "lln_diag"),
             ("paligemma-3b", "softmax"))
    for arch, impl in cells:
        runs = {}
        for backend in ("auto", "ref"):
            cfg = get_config(arch, smoke=True, attn_impl=impl,
                             compute_dtype="float32", use_kernel=True,
                             attn_backend=backend)
            extra = cfg.num_prefix_tokens
            ml = prompt + steps + 1 + extra
            setup = make_serve_setup(cfg, ShapeSpec("small", ml, 2,
                                                    "decode"))
            params = setup.model.init(SEED)
            batch = synthetic_batch(cfg, 2, ml, seed=SEED, text_seq=prompt,
                                    device="cuda")
            _reset()
            runs[backend] = _serve_tokens(
                setup, params, batch, batch["inputs"].shape[1] + extra,
                steps)
            runs[backend + " launches"] = _read()
        log(f"small {arch} {impl} (SMOKE fp32, auto vs core ref; kernel "
            f"launches {runs['auto launches']}):")
        if any(runs["ref launches"].values()):
            raise AssertionError(f"small {arch} {impl}: the ref backend "
                                 f"launched {runs['ref launches']}")
        if impl != "softmax" and not runs["auto launches"]["lln_decode"]:
            raise AssertionError(f"small {arch} {impl}: no lln_decode")
        check("prefill logits", runs["auto"][0], runs["ref"][0], 1e-4)
        if not torch.equal(runs["auto"][1], runs["ref"][1]):
            raise AssertionError(f"small {arch} {impl}: greedy tokens "
                                 f"differ: {runs['auto'][1].tolist()} vs "
                                 f"{runs['ref'][1].tolist()}")
        log(f"  greedy tokens equal: {runs['auto'][1][0].tolist()}")

    cfg = _no_drop(get_config("qwen3-moe-235b-a22b", smoke=True,
                              attn_impl="lln_diag", compute_dtype="float32"))
    for spec_k in (0, 2):
        setup = make_pool_setup(cfg, slots=2, max_len=48, segment=3,
                                spec_k=spec_k, draft_layers=1 if spec_k
                                else 0)
        params = setup.model.init(SEED)
        reqs = synthetic_traffic(4, cfg.vocab, prompt_lens=[8, 8, 11],
                                 gen_lens=[3, 7, 5], seed=5)
        stats = ContinuousBatcher(setup, params).run(reqs)
        cache = {}
        for req in reqs:
            got = stats.outputs[req.rid]
            want = _solo(setup.cfg, params, req, 48, cache)[1]
            if not np.array_equal(got, want):
                raise AssertionError(f"small qwen3-moe pool spec_k={spec_k}"
                                     f": request {req.rid} {got} != solo "
                                     f"{want}")
        log(f"small qwen3-moe pool (2 slots, spec_k={spec_k}): 4 requests "
            f"equal to their solo runs")
    plen, steps, k = 9, 10, 3
    sp = make_spec_setup(cfg, ShapeSpec("s", plen + steps + k + 2, 2,
                                        "decode"), spec_k=k, draft_layers=1)
    params = sp.model.init(SEED + 1)
    batch = synthetic_batch(cfg, 2, plen, seed=SEED, device="cuda")
    tok, (toks, n_emit, *_) = _spec_run(sp, params, batch, plen, steps)
    ss = make_serve_setup(cfg, ShapeSpec("s", plen + steps + 2, 2, "decode"))
    _, caches = ss.prefill_fn(params, batch)
    plain = ss.make_generate(steps)(params, caches, tok, plen)[0]
    if not np.array_equal(flatten_spec_tokens(toks, n_emit, steps),
                          plain.cpu().numpy()):
        raise AssertionError("small qwen3-moe speculative tokens differ "
                             "from the plain greedy loop")
    log("small qwen3-moe speculative (k = 3, 1-layer draft): tokens equal "
        "to the plain greedy loop")


def phase_serve_families(launches, serve_times):
    """Full-width serving of the four families through _serve_cell (bf16
    weights from the seed, batch B, GEN greedy tokens, logits against the
    plain backend at the prefill and the first decode step; softmax cells
    against ref, whose prefill is the naive softmax), exact launch counts:
    - serve_moe: qwen3-moe-235b-a22b cut to FL of its 94 layers (94 are
      about 470 GB in bf16), lln_diag, prompt N: per prefill FL
      lln_causal and FL causal block_diag, FL lln_decode per step;
    - serve_mla: deepseek-v2-236b cut to FL of 60 (the dense first layer
      and 3 MoE layers), prompt N, lln_diag (the engine at G = H = 128, D
      = 192, Dv = 128: FL + FL per prefill, FL per step) and softmax (the
      absorbed decode over the latent cache: no kernel);
    - serve_encdec: seamless-m4t-medium at full depth (12 encoder and 12
      decoder layers), use_kernel=True, 2048 source frames and a 64-token
      target prompt, lln_diag: per prefill 12 lln_bidir and 12 non-causal
      block_diag in the encoder (read apart by the wrapper's non-causal
      count) and 12 lln_causal and 12 causal block_diag in the decoder, 12
      lln_decode per step;
    - serve_vlm: paligemma-3b at full depth (18 layers), 256 patches and
      VLM_TEXT text tokens, lln_diag (18 + 18 per prefill, 18 per step) and
      softmax with the prefix-LM mask (no kernel).
    Each model is freed before the next."""
    from repro_torch.configs import get_config
    from repro_torch.models import synthetic_batch
    idle = _idle()
    tags = {arch: tag for tag, arch, *_ in FAMILIES}

    def diag(nl):
        return ({**idle, "lln_causal": nl, "block_diag": nl},
                {**idle, "lln_decode": nl})

    def count(tag, pre, dec):
        launches[f"lln_causal (state, {tag})"] += pre["lln_causal"]
        launches[f"block_diag ({tag})"] += pre["block_diag"]
        launches[f"lln_decode ({tag})"] += dec["lln_decode"]

    cfg = get_config("qwen3-moe-235b-a22b", attn_impl="lln_diag",
                     n_layers=FL)
    serve_times["serve_moe lln_diag"], pre, dec = _serve_cell(
        cfg, N, *diag(FL), "plain", f"serve_moe qwen3-moe ({FL} layers)")
    count(tags[cfg.name], pre, dec)

    for impl in ("lln_diag", "softmax"):
        cfg = get_config("deepseek-v2-236b", attn_impl=impl, n_layers=FL)
        want = diag(FL) if impl == "lln_diag" else (idle, idle)
        serve_times[f"serve_mla {impl}"], pre, dec = _serve_cell(
            cfg, N, *want, "plain" if impl == "lln_diag" else "ref",
            f"serve_mla deepseek-v2 ({FL} layers) {impl}")
        if impl == "lln_diag":
            count(tags[cfg.name], pre, dec)

    cfg = get_config("seamless-m4t-medium", attn_impl="lln_diag",
                     param_dtype="bfloat16", use_kernel=True)
    b, _, frames, _ = SEAMLESS
    tgt = FAMILIES[3][6]
    batch = synthetic_batch(cfg, b, frames, seed=SEED, text_seq=tgt,
                            device="cuda")
    nl = cfg.n_layers
    want_pre = {**idle, "lln_bidir": cfg.enc_layers, "lln_causal": nl,
                "block_diag": nl, "block_diag (causal=False)": cfg.enc_layers}
    serve_times["serve_encdec lln_diag"], pre, dec = _serve_cell(
        cfg, tgt, want_pre, {**idle, "lln_decode": nl}, "plain",
        "serve_encdec seamless (12 + 12 layers)", batch=batch)
    count(tags[cfg.name], pre, dec)
    launches["lln_bidir (seamless encoder)"] += pre["lln_bidir"]
    launches["block_diag (causal=False, seamless encoder)"] += \
        pre["block_diag (causal=False)"]

    for impl in ("lln_diag", "softmax"):
        cfg = get_config("paligemma-3b", attn_impl=impl,
                         param_dtype="bfloat16")
        p = cfg.num_prefix_tokens
        batch = synthetic_batch(cfg, B, p + VLM_TEXT, seed=SEED,
                                device="cuda")
        nl = cfg.n_layers
        want = diag(nl) if impl == "lln_diag" else (idle, idle)
        serve_times[f"serve_vlm {impl}"], pre, dec = _serve_cell(
            cfg, VLM_TEXT, *want, "plain" if impl == "lln_diag" else "ref",
            f"serve_vlm paligemma {impl} ({p} patches + {VLM_TEXT} text)",
            batch=batch, pos0=p + VLM_TEXT)
        if impl == "lln_diag":
            count(tags[cfg.name], pre, dec)


def phase_timings_families(errs, launches):
    """Rows 1-3 at the families' serving shapes (:data:`FAMILIES`, decode
    at T = 1 in the row, T = 4 logged; :func:`_serve_kernel_rows`, whose
    bounds take the tensor-core count at every width), then row 5 and the
    non-causal row 2 at the seamless encoder's shape (lln_bidir by
    _bidir_counts, its CUDA-core count logged; block_diag as
    phase_timings_encoder counts it, SDPA on the blocks as the library
    yardstick)."""
    import torch.nn.functional as F
    from repro_torch.kernels.block_diag import block_diag, block_diag_plain
    from repro_torch.kernels.lln_attention import lln_bidir, lln_bidir_plain
    rows = []
    for i, (tag, arch, h, g, d, dv, n) in enumerate(FAMILIES):
        rows += _serve_kernel_rows(
            errs, launches, tag, B, h, g, d, SEED + 70 + i,
            (f"lln_causal (state, {arch} {tag})",
             f"block_diag ({arch} {tag})", f"lln_decode ({arch} {tag})"),
            decode_ts=(1, 4), dv=dv, n=n)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 75)
    b, h, n, d = SEAMLESS
    bh = b * h
    qs, ks, qk, kk, vk, _ = _train_inputs(n, gen, b, h, h, d)
    counts = _bidir_counts(bh, bh, n, d, d)
    bnd, by = bound_ms(*counts["lln_bidir"])
    rows.append(dict(
        name="lln_bidir (seamless-m4t-medium encoder)", route="cuda",
        source="src/repro_torch/csrc/lln_bidir.cu",
        replaces="src/repro/kernels/lln_attention.py:166",
        launches=launches["lln_bidir (seamless encoder)"],
        max_abs_err=errs["lln_bidir (seamless encoder)"],
        ms=cuda_ms(lambda: lln_bidir(qs, ks, vk, r=1, return_res=True)),
        plain_ms=cuda_ms(lambda: lln_bidir_plain(qs, ks, vk, r=1,
                                                 return_res=True)),
        bound_ms=bnd, bound_by=by, library_ms=None))
    log("  lln_bidir (seamless) CUDA-core count: {:.4f} ms ({})".format(
        *bound_ms(*counts["lln_bidir (CUDA cores)"])))
    nb = n // BLK
    pairs = bh * nb * BLK * BLK
    nbytes = 2 * (bh * n * d * 4)
    bnd, by = bound_ms(nbytes, pairs * SOFTMAX_FWD_OPS, pairs * 6 * d)

    def blocks(t):
        return t.reshape(b, h, nb, BLK, d).permute(0, 2, 1, 3, 4) \
            .reshape(b * nb, h, BLK, d)
    qb, kb, vb = (blocks(t) for t in (qk, kk, vk))
    rows.append(dict(
        name="block_diag (causal=False, seamless-m4t-medium encoder)",
        route="cuda", source="src/repro_torch/csrc/block_diag.cu",
        replaces="src/repro/kernels/block_diag.py:109",
        launches=launches["block_diag (causal=False, seamless encoder)"],
        max_abs_err=errs["block_diag (causal=False, seamless encoder)"],
        ms=cuda_ms(lambda: block_diag(qk, kk, vk, r=1, blk=BLK,
                                      causal=False)),
        plain_ms=cuda_ms(lambda: block_diag_plain(qk, kk, vk, r=1, blk=BLK,
                                                  causal=False)),
        bound_ms=bnd, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb))))
    for row in rows[-2:]:
        log(f"timing {row['name']} (B={b} H=G={h} N={n} D={d}): kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library "
            f"{row['library_ms']}, launches {row['launches']}")
    return rows


# ---------------------------------------------------------------------------
# The families' training path (item 11c): make_train_setup -> Model.loss ->
# autograd -> AdamW for qwen3-moe, deepseek-v2, seamless and paligemma.
# ---------------------------------------------------------------------------

# Their self-attention in the train cells (tag, arch, B, H, G, D, Dv, N):
# rows 4 and 9 at each, blk BLK (the configs' diag_block).  D or Dv above
# 128 take the tensor cores of rows 4, 6 and 9 (up to 256) and the CUDA
# cores of row 1.
FAMILIES_TRAIN = (
    ("qwen3-moe r=16", "qwen3-moe-235b-a22b", 2, 64, 4, 128, 128, 512),
    ("mla D=192 Dv=128", "deepseek-v2-236b", 4, 128, 128, 192, 128, 512),
    ("seamless decoder D=64", "seamless-m4t-medium", 4, 16, 16, 64, 64,
     1024),
    ("paligemma D=256 r=8", "paligemma-3b", 2, 8, 1, 256, 256, 512))
SEAMLESS_TRAIN = (4, 16, 1024, 64)  # the encoder in training: B, H = G, N, D
# block_diag_bwd in bf16 above D = 128, at the MLA and paligemma cells'
# heads: (tag, B, H, G, D, Dv).
WIDE_BDB = (("bf16 mla D=192 Dv=128", 4, 128, 128, 192, 128),
            ("bf16 paligemma D=256 r=8", 2, 8, 1, 256, 256))


def _is_wide(d, dv):
    return max(d, dv) > 128


def _hold(results, key, runs, want, names, bf16_first=False):
    """``runs[0]`` against ``want``, entry by entry under ``names``: the
    first within one bf16 step if ``bf16_first`` (an output), the others
    within 1e-5 of the largest plain entry (fp32 den, states and
    gradients); ``runs[0]`` and ``runs[1]`` bitwise equal.  The largest
    error is kept under ``key``."""
    errs = [check(nm, gt, wt, bf16_tol(wt) if i == 0 and bf16_first
                  else fp32_tol(wt))
            for i, (nm, gt, wt) in enumerate(zip(names, runs[0], want))]
    _same_runs(key, *runs)
    results[key] = max(results.get(key, 0.0), *errs)


def phase_kernels_families_train(results):
    """The families' backward kernels and their forwards at the train
    cells' shapes, each against its plain version (:func:`_hold`): rows 4
    and 9 at :data:`FAMILIES_TRAIN`; rows 1 (``return_res``) and 6 at the
    wide heads (MLA, paligemma); rows 5, 7, the non-causal 2 and 8 at the
    seamless encoder's (:data:`SEAMLESS_TRAIN`); row 8 in bf16 above D =
    128 (:data:`WIDE_BDB`), causal and not, N 512 and a ragged 300.  Rows
    4, 6 and 9 take their tensor cores at every train cell's shape (bf16,
    D and Dv up to 256; row 1 its CUDA cores above 128)."""
    from repro_torch.kernels.block_diag import (block_diag, block_diag_bwd,
                                                block_diag_bwd_plain,
                                                block_diag_plain)
    from repro_torch.kernels.lln_attention import (_tc_path, lln_bidir,
                                                   lln_bidir_plain,
                                                   lln_causal,
                                                   lln_causal_plain,
                                                   lln_diag_fused,
                                                   lln_diag_fused_plain)
    from repro_torch.kernels.lln_backward import (lln_bidir_bwd,
                                                  lln_bidir_bwd_plain,
                                                  lln_causal_bwd,
                                                  lln_causal_bwd_plain,
                                                  lln_diag_fused_bwd,
                                                  lln_diag_fused_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 80)
    for tag, _, b, h, g, d, dv, n in FAMILIES_TRAIN:
        r = h // g
        qs, ks, qk, kk, vk, cot = _train_inputs(n, gen, b, h, g, d, dv)
        log(f"lln_diag_fused (train, {tag}) B={b} H={h} G={g} N={n} D={d} "
            f"Dv={dv} blk={BLK} (tensor-core path: "
            f"{_tc_path(vk, d, dv, 'lln_diag_fused')}):")
        runs = [lln_diag_fused(qs, ks, qk, kk, vk, r=r, blk=BLK,
                               return_res=True) for _ in range(2)]
        want = lln_diag_fused_plain(qs, ks, qk, kk, vk, r=r, blk=BLK,
                                    return_res=True)
        torch.cuda.synchronize()
        _hold(results, f"lln_diag_fused (train, {tag})", runs, want,
              ("out", "den"), bf16_first=True)
        o, den = want
        log(f"lln_diag_fused_bwd (train, {tag}) (tensor-core path: "
            f"{_tc_path(vk, d, dv, 'lln_diag_fused_bwd')}):")
        runs = [lln_diag_fused_bwd(qs, ks, qk, kk, vk, cot, o, den, r=r,
                                   blk=BLK) for _ in range(2)]
        want = lln_diag_fused_bwd_plain(qs, ks, qk, kk, vk, cot, o, den,
                                        r=r, blk=BLK)
        torch.cuda.synchronize()
        _hold(results, f"lln_diag_fused_bwd (train, {tag})", runs, want,
              ("dqs", "dqd", "dks", "dkd", "dv"))
        if _is_wide(d, dv):
            log(f"lln_causal (res, {tag}) (tensor-core path: "
                f"{_tc_path(vk, d, dv, 'lln_causal')}):")
            runs = [lln_causal(qs, ks, vk, r=r, blk=BLK, return_res=True,
                               return_state=False) for _ in range(2)]
            want = lln_causal_plain(qs, ks, vk, r=r, blk=BLK,
                                    return_res=True, return_state=False)
            torch.cuda.synchronize()
            _hold(results, f"lln_causal (res, {tag})", runs, want,
                  ("out", "den"), bf16_first=True)
            o, den = want
            log(f"lln_causal_bwd ({tag}) (tensor-core path: "
                f"{_tc_path(vk, d, dv, 'lln_causal_bwd')}):")
            runs = [lln_causal_bwd(qs, ks, vk, cot, o, den, r=r, blk=BLK)
                    for _ in range(2)]
            want = lln_causal_bwd_plain(qs, ks, vk, cot, o, den, r=r,
                                        blk=BLK)
            torch.cuda.synchronize()
            _hold(results, f"lln_causal_bwd ({tag})", runs, want,
                  ("dqs", "dks", "dv"))
        del qs, ks, qk, kk, vk, cot, o, den, runs, want

    b, h, n, d = SEAMLESS_TRAIN
    qs, ks, qk, kk, vk, cot = _train_inputs(n, gen, b, h, h, d)
    gh = 0.5 * cot                      # as _LLNDiagAttention passes it
    log(f"lln_bidir (train, seamless encoder) B={b} H=G={h} N={n} D={d}:")
    runs = [lln_bidir(qs, ks, vk, r=1, return_res=True) for _ in range(2)]
    want = lln_bidir_plain(qs, ks, vk, r=1, return_res=True)
    torch.cuda.synchronize()
    _hold(results, "lln_bidir (train, seamless encoder)", runs, want,
          ("out", "s", "z", "den"), bf16_first=True)
    o, s_, z_, den = want
    log("lln_bidir_bwd (seamless encoder):")
    runs = [lln_bidir_bwd(qs, ks, vk, gh, o, den, s_, z_, r=1)
            for _ in range(2)]
    want = lln_bidir_bwd_plain(qs, ks, vk, gh, o, den, s_, z_, r=1)
    torch.cuda.synchronize()
    _hold(results, "lln_bidir_bwd (seamless encoder)", runs, want,
          ("dqs", "dks", "dv"))
    log(f"block_diag (causal=False, train, seamless encoder) blk={BLK}:")
    runs = [(block_diag(qk, kk, vk, r=1, blk=BLK, causal=False),)
            for _ in range(2)]
    want = (block_diag_plain(qk, kk, vk, r=1, blk=BLK, causal=False),)
    torch.cuda.synchronize()
    _hold(results, "block_diag (causal=False, train, seamless encoder)",
          runs, want, ("out",), bf16_first=True)
    log(f"block_diag_bwd (causal=False, seamless encoder) blk={BLK}:")
    runs = [block_diag_bwd(qk, kk, vk, gh, r=1, blk=BLK, causal=False)
            for _ in range(2)]
    want = block_diag_bwd_plain(qk, kk, vk, gh, r=1, blk=BLK, causal=False)
    torch.cuda.synchronize()
    _hold(results, "block_diag_bwd (seamless encoder)", runs, want,
          ("dq", "dk", "dv"))
    del qs, ks, qk, kk, vk, cot, gh, runs, want

    for tag, b, h, g, d, dv in WIDE_BDB:
        r = h // g
        for n in (N, 300):
            q, k, v, _, _ = _inputs(n, gen, b, h, g, d, dv)
            qk, kk, vk = (t.permute(0, 2, 1, 3).reshape(-1, n, t.shape[-1])
                          .contiguous() for t in (q, k, v))
            cot = torch.randn(b * h, n, dv, generator=gen,
                              device="cuda").bfloat16()
            for causal in (True, False):
                log(f"block_diag_bwd ({tag}) B={b} H={h} G={g} N={n} "
                    f"blk={BLK} causal={causal} (CUDA cores):")
                runs = [block_diag_bwd(qk, kk, vk, cot, r=r, blk=BLK,
                                       causal=causal) for _ in range(2)]
                want = block_diag_bwd_plain(qk, kk, vk, cot, r=r, blk=BLK,
                                            causal=causal)
                torch.cuda.synchronize()
                _hold(results, f"block_diag_bwd ({tag})", runs, want,
                      ("dq", "dk", "dv"))
            del q, k, v, qk, kk, vk, cot, runs, want


def _synthetic_batches(cfg):
    """A ``batches_fn(vocab, b, seq, seed)`` for :func:`_train_cell` and
    :func:`_small_vs_core`: the family's synthetic batches as numpy (stub
    frames or patches beside the tokens, as the train CLI makes them)."""
    from repro_torch.models import synthetic_batch

    def batches(vocab, b, seq, seed):
        step = 0
        while True:
            yield {k: t.numpy() for k, t in synthetic_batch(
                cfg, b, seq, seed=seed + step, device="cpu").items()}
            step += 1
    return batches


def phase_small_families_train():
    """Each family's SMOKE config in fp32 with use_kernel=True and one
    microbatch: 3 steps on the kernels against 3 through the core
    reference (:func:`_small_vs_core`), lln_diag for each, and lln for
    deepseek-v2 and paligemma (the causal pair at D != Dv and r = 4).
    Then the train CLI --arch <family> --smoke --attn-impl lln_diag for
    each (batch 8 for the MoE configs, which accumulate 8 microbatches)."""
    from repro_torch.configs import get_config
    families = (("qwen3-moe-235b-a22b", ("lln_diag",)),
                ("deepseek-v2-236b", ("lln_diag", "lln")),
                ("seamless-m4t-medium", ("lln_diag",)),
                ("paligemma-3b", ("lln_diag", "lln")))
    for arch, impls in families:
        cfg = get_config(arch, smoke=True)
        _small_vs_core(arch, _synthetic_batches(cfg),
                       f"small_families_train {arch}", impls=impls,
                       over=dict(grad_accum=1))
    for arch, _ in families:
        cfg = get_config(arch, smoke=True)
        _train_cli(["--arch", arch, "--smoke", "--attn-impl", "lln_diag"],
                   batch=max(2, cfg.grad_accum))


def phase_train_families(launches, train_times):
    """Four train cells through :func:`_train_cell` at full width
    (use_kernel=True, lln_diag, bf16 compute, fp32 params and AdamW
    moments, remat full, one microbatch), exact launch counts; per layer
    and step the forward kernels run twice (the forward and remat's
    recompute) and the backward ones once:
    - train_moe: qwen3-moe-235b-a22b cut to 1 of its 94 layers (a second
      layer's fp32 params, moments and gradients would add 39 GB), batch 2
      x 512: the fused pair at H = 64, G = 4 (r = 16) on the tensor cores;
    - train_mla: deepseek-v2-236b cut to its dense first layer (its first
      MoE layer would add 3.77 B expert weights, about 60 GB at 16 B per
      param), batch 4 x 512: the fused pair at H = G = 128, D = 192, Dv =
      128 (both on the tensor cores), then with lln the causal pair
      (lln_causal with den on the CUDA cores, lln_causal_bwd on the
      tensor cores) there;
    - train_encdec: seamless-m4t-medium at full depth (12 + 12 layers),
      batch 4 x 1024 with 1024 stub source frames: lln_bidir and the
      non-causal block_diag with their backwards in the encoder, the fused
      pair in the decoder;
    - train_vlm: paligemma-3b at full depth (18 layers), batch 2 x 512
      (256 patches + 256 text tokens): the fused pair at r = 8, D = 256 as
      at MLA, then with lln the causal pair there.
    The MoE configs accumulate 8 microbatches, which a batch of 2 or 4
    does not split into: both cells take grad_accum = 1.  The first step
    of train_mla and train_vlm is held in fp32 (_train_cell's
    ``first_fp32``)."""
    from repro_torch.configs import get_config
    idle = _idle()
    tags = {arch: tag for tag, arch, *_ in FAMILIES_TRAIN}
    mla_probe = ("w_uq", "w_uk", "w_uv", "w_kr")
    cells = (("train_moe", "qwen3-moe-235b-a22b", dict(n_layers=1), QKV,
              ("lln_diag",)),
             ("train_mla", "deepseek-v2-236b", dict(n_layers=1), mla_probe,
              ("lln_diag", "lln")),
             ("train_encdec", "seamless-m4t-medium", {},
              ("attn.q_w", "attn.k_w", "attn.v_w"), ("lln_diag",)),
             ("train_vlm", "paligemma-3b", {}, QKV, ("lln_diag", "lln")))
    fwd = {"lln": "lln_causal", "lln_diag": "lln_diag_fused"}
    bwd = {"lln": "lln_causal_bwd", "lln_diag": "lln_diag_fused_bwd"}
    for label, arch, cut, probe, impls in cells:
        tag = tags[arch]
        b, d, dv, n = next((b, d, dv, n) for t, _, b, _, _, d, dv, n
                           in FAMILIES_TRAIN if t == tag)
        for impl in impls:
            cfg = get_config(arch, attn_impl=impl, use_kernel=True,
                             param_dtype="float32", grad_accum=1, **cut)
            enc = cfg.enc_layers if cfg.family == "encdec" else 0

            def want(steps, nl=cfg.n_layers, enc=enc, impl=impl):
                out = dict(idle)
                out[fwd[impl]] = 2 * nl * steps
                out[bwd[impl]] = nl * steps
                out["lln_bidir"] = out["block_diag (causal=False)"] = \
                    2 * enc * steps
                out["lln_bidir_bwd"] = out["block_diag_bwd"] = enc * steps
                return out

            # The wide heads (MLA, paligemma) hold their first step in fp32,
            # which runs the CUDA-core kernels (in bf16 two correct routes
            # already differ by about 1e-4, tools/first_step_gaps.py); the
            # bf16 tensor-core backward is held by kernels_families_train at
            # these shapes.
            train_times[f"{label} {impl}"], counted = _train_cell(
                cfg, b, n, _synthetic_batches(cfg), want, label,
                probe=probe, first_fp32=_is_wide(d, dv))
            if impl == "lln":
                launches[f"lln_causal (res, {tag})"] += \
                    counted["lln_causal"]
                launches[f"lln_causal_bwd ({tag})"] += \
                    counted["lln_causal_bwd"]
            else:
                launches[f"lln_diag_fused (train, {tag})"] += \
                    counted["lln_diag_fused"]
                launches[f"lln_diag_fused_bwd (train, {tag})"] += \
                    counted["lln_diag_fused_bwd"]
            if enc:
                for key, name in (
                        ("lln_bidir", "lln_bidir (train, seamless encoder)"),
                        ("lln_bidir_bwd", "lln_bidir_bwd (seamless encoder)"),
                        ("block_diag (causal=False)",
                         "block_diag (causal=False, train, seamless "
                         "encoder)"),
                        ("block_diag_bwd",
                         "block_diag_bwd (seamless encoder)")):
                    launches[name] += counted[key]


def _block_diag_bwd_counts(bh, bg, n, d, dv, blk, causal):
    """Bytes and operations of block_diag_bwd at one shape as
    phase_timings_encoder counts them: bf16 q, k, v and g read, fp32 dq,
    dk and dv written; per (query, key) pair of a block the function's
    five products (q k^T, g v^T, dsm k, dsm^T q, p^T g: 6 D + 4 Dv) at the
    tensor cores' rate and the softmax's steps as fp32 work."""
    sizes = [min(blk, n - b0) for b0 in range(0, n, blk)]
    pairs = bh * sum(m * (m + 1) // 2 if causal else m * m for m in sizes)
    nbytes = 2 * ((bh + bg) * n * d + bg * n * dv + bh * n * dv) \
        + 4 * ((bh + bg) * n * d + bg * n * dv)
    return nbytes, pairs * SOFTMAX_BWD_OPS, pairs * (6 * d + 4 * dv)


def _sdpa_blocks(t, b, heads, n, blk, r=1):
    """(B, N, heads, w) -> (B * nb, heads * r, blk, w) blocks for SDPA (kv
    heads repeated r times)."""
    if r > 1:
        t = torch.repeat_interleave(t, r, dim=2)
    nb = n // blk
    return t.reshape(b, nb, blk, t.shape[2], t.shape[-1]) \
        .permute(0, 1, 3, 2, 4).reshape(b * nb, t.shape[2], blk,
                                       t.shape[-1])


def phase_timings_families_train(errs, launches):
    """The families' train kernels, their plain versions and their bounds
    at the train cells' shapes: rows 4 and 9 (_fused_counts), rows 1 and 6
    at the wide heads (_lln_counts at the kernels' own block), rows 5 and
    7 (_bidir_counts), the non-causal row 2 (as phase_timings_families
    counts it) and row 8 (_block_diag_bwd_counts) at the seamless
    encoder's, and row 8 in bf16 above D = 128 (N 512, non-causal, the
    case a wide lln_diag encoder layer would run).  Every row is bounded
    by the tensor-core count, also where the kernel takes its CUDA cores
    (rows 1 and 8 above D or Dv = 128): the function needs no more work
    for that; the CUDA-core count is logged beside.  Rows 4, 6 and 9 log
    their tensor-core kernels' registers, spills and CTAs per SM
    (:func:`_log_attrs`) and one call's device time by kernel
    (:func:`device_profile`).  Rows 2 and 8 take SDPA on the blocks
    (forward, or autograd's backward) as the library yardstick."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_diag import (block_diag, block_diag_bwd,
                                                block_diag_bwd_plain,
                                                block_diag_plain)
    from repro_torch.kernels.lln_attention import (lln_bidir,
                                                   lln_bidir_plain,
                                                   lln_causal,
                                                   lln_causal_plain,
                                                   lln_diag_fused,
                                                   lln_diag_fused_plain)
    from repro_torch.kernels.lln_backward import (lln_bidir_bwd,
                                                  lln_bidir_bwd_plain,
                                                  lln_causal_bwd,
                                                  lln_causal_bwd_plain,
                                                  lln_diag_fused_bwd,
                                                  lln_diag_fused_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 90)
    rows = []

    def row(name, src, ref, key, kernel, plain, counts, core=None,
            library=None, shape=""):
        bnd, by = bound_ms(*counts)
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=f"src/repro/kernels/{ref}", launches=launches[key],
            max_abs_err=errs[key], ms=cuda_ms(kernel, reps=10),
            plain_ms=cuda_ms(plain, reps=10), bound_ms=bnd, bound_by=by,
            library_ms=cuda_ms(library, reps=10) if library else None))
        r_ = rows[-1]
        extra = " [CUDA-core count: {:.4f} ms ({})]".format(
            *bound_ms(*core)) if core else ""
        log(f"timing {name} ({shape}): kernel {r_['ms']:.4f} ms, plain "
            f"{r_['plain_ms']:.4f} ms, bound {bnd:.4f} ms ({by}){extra}, "
            f"library {r_['library_ms']}, launches {r_['launches']}")

    for tag, arch, b, h, g, d, dv, n in FAMILIES_TRAIN:
        r, bh, bg = h // g, b * h, b * g
        shape = f"B={b} H={h} G={g} N={n} D={d} Dv={dv} blk={BLK}"
        qs, ks, qk, kk, vk, cot = _train_inputs(n, gen, b, h, g, d, dv)
        o, den = lln_diag_fused_plain(qs, ks, qk, kk, vk, r=r, blk=BLK,
                                      return_res=True)
        fused = _fused_counts(bh, bg, n, d, dv, BLK)
        key = f"lln_diag_fused (train, {tag})"
        row(f"lln_diag_fused (train, {arch} {tag})", "lln_diag_fused.cu",
            "lln_attention.py:274", key,
            lambda: lln_diag_fused(qs, ks, qk, kk, vk, r=r, blk=BLK,
                                   return_res=True),
            lambda: lln_diag_fused_plain(qs, ks, qk, kk, vk, r=r, blk=BLK,
                                         return_res=True),
            fused["lln_diag_fused"], fused["lln_diag_fused (CUDA cores)"],
            shape=shape)
        _log_split("lln_diag_fused", d, dv, lambda: lln_diag_fused(
            qs, ks, qk, kk, vk, r=r, blk=BLK, return_res=True))
        key = f"lln_diag_fused_bwd (train, {tag})"
        row(f"lln_diag_fused_bwd (train, {arch} {tag})",
            "lln_diag_fused_bwd.cu", "lln_backward.py:441", key,
            lambda: lln_diag_fused_bwd(qs, ks, qk, kk, vk, cot, o, den, r=r,
                                       blk=BLK),
            lambda: lln_diag_fused_bwd_plain(qs, ks, qk, kk, vk, cot, o, den,
                                             r=r, blk=BLK),
            fused["lln_diag_fused_bwd"],
            fused["lln_diag_fused_bwd (CUDA cores)"], shape=shape)
        _log_split("lln_diag_fused_bwd", d, dv, lambda: lln_diag_fused_bwd(
            qs, ks, qk, kk, vk, cot, o, den, r=r, blk=BLK))
        if _is_wide(d, dv):
            lo, lden = lln_causal_plain(qs, ks, vk, r=r, blk=BLK,
                                        return_res=True, return_state=False)
            lc = _lln_counts(bh, bg, n, d, dv, _lln_module().TC_BLOCK)
            row(f"lln_causal (res, {arch} {tag})", "lln_causal.cu",
                "lln_attention.py:94", f"lln_causal (res, {tag})",
                lambda: lln_causal(qs, ks, vk, r=r, blk=BLK, return_res=True,
                                   return_state=False),
                lambda: lln_causal_plain(qs, ks, vk, r=r, blk=BLK,
                                         return_res=True,
                                         return_state=False),
                lc["lln_causal (res)"], lc["lln_causal (res) (CUDA cores)"],
                shape=shape)
            row(f"lln_causal_bwd ({arch} {tag})", "lln_causal_bwd.cu",
                "lln_backward.py:160", f"lln_causal_bwd ({tag})",
                lambda: lln_causal_bwd(qs, ks, vk, cot, lo, lden, r=r,
                                       blk=BLK),
                lambda: lln_causal_bwd_plain(qs, ks, vk, cot, lo, lden, r=r,
                                             blk=BLK),
                lc["lln_causal_bwd"], lc["lln_causal_bwd (CUDA cores)"],
                shape=shape)
            _log_split("lln_causal_bwd", d, dv, lambda: lln_causal_bwd(
                qs, ks, vk, cot, lo, lden, r=r, blk=BLK))
            del lo, lden
        del qs, ks, qk, kk, vk, cot, o, den

    b, h, n, d = SEAMLESS_TRAIN
    bh = b * h
    shape = f"B={b} H=G={h} N={n} D={d} blk={BLK}"
    q, k, v, alpha, beta = _inputs(n, gen, b, h, h, d)
    qs, ks, _ = ops._scaled_stabilized(q, k, alpha, beta)
    qk, kk, vk = ops._to_kernel(q), ops._to_kernel(k), ops._to_kernel(v)
    gh = 0.5 * torch.randn(bh, n, d, generator=gen, device="cuda").bfloat16()
    o, s_, z_, den = lln_bidir_plain(qs, ks, vk, r=1, return_res=True)
    bidir = _bidir_counts(bh, bh, n, d, d)
    row("lln_bidir (train, seamless-m4t-medium encoder)", "lln_bidir.cu",
        "lln_attention.py:166", "lln_bidir (train, seamless encoder)",
        lambda: lln_bidir(qs, ks, vk, r=1, return_res=True),
        lambda: lln_bidir_plain(qs, ks, vk, r=1, return_res=True),
        bidir["lln_bidir"], bidir["lln_bidir (CUDA cores)"], shape=shape)
    row("lln_bidir_bwd (seamless-m4t-medium encoder)", "lln_bidir_bwd.cu",
        "lln_backward.py:261", "lln_bidir_bwd (seamless encoder)",
        lambda: lln_bidir_bwd(qs, ks, vk, gh, o, den, s_, z_, r=1),
        lambda: lln_bidir_bwd_plain(qs, ks, vk, gh, o, den, s_, z_, r=1),
        bidir["lln_bidir_bwd"], bidir["lln_bidir_bwd (CUDA cores)"],
        shape=shape)
    qb, kb, vb, gb = (_sdpa_blocks(t, b, h, n, BLK) for t in (
        q, k, v, gh.reshape(b, h, n, d).permute(0, 2, 1, 3)))
    qb, kb, vb = (t.detach().requires_grad_() for t in (qb, kb, vb))
    sdpa_out = F.scaled_dot_product_attention(qb, kb, vb)
    pairs = bh * (n // BLK) * BLK * BLK
    row("block_diag (causal=False, train, seamless-m4t-medium encoder)",
        "block_diag.cu", "block_diag.py:109",
        "block_diag (causal=False, train, seamless encoder)",
        lambda: block_diag(qk, kk, vk, r=1, blk=BLK, causal=False),
        lambda: block_diag_plain(qk, kk, vk, r=1, blk=BLK, causal=False),
        (2 * 4 * bh * n * d, pairs * SOFTMAX_FWD_OPS, pairs * 6 * d),
        library=lambda: F.scaled_dot_product_attention(qb, kb, vb),
        shape=shape)
    row("block_diag_bwd (seamless-m4t-medium encoder)", "block_diag_bwd.cu",
        "block_diag.py:69", "block_diag_bwd (seamless encoder)",
        lambda: block_diag_bwd(qk, kk, vk, gh, r=1, blk=BLK, causal=False),
        lambda: block_diag_bwd_plain(qk, kk, vk, gh, r=1, blk=BLK,
                                     causal=False),
        _block_diag_bwd_counts(bh, bh, n, d, d, BLK, False),
        library=lambda: torch.autograd.grad(sdpa_out, (qb, kb, vb), gb,
                                            retain_graph=True),
        shape=shape)
    del q, k, v, qs, ks, qk, kk, vk, gh, o, s_, z_, den, qb, kb, vb, gb, \
        sdpa_out

    n = N
    for tag, b, h, g, d, dv in WIDE_BDB:
        r = h // g
        shape = f"B={b} H={h} G={g} N={n} D={d} Dv={dv} blk={BLK}, causal=False"
        q, k, v, _, _ = _inputs(n, gen, b, h, g, d, dv)
        qk, kk, vk = (t.permute(0, 2, 1, 3).reshape(-1, n, t.shape[-1])
                      .contiguous() for t in (q, k, v))
        cot = torch.randn(b * h, n, dv, generator=gen,
                          device="cuda").bfloat16()
        qb = _sdpa_blocks(q, b, h, n, BLK)
        kb, vb = (_sdpa_blocks(t, b, g, n, BLK, r) for t in (k, v))
        gb = _sdpa_blocks(cot.reshape(b, h, n, dv).permute(0, 2, 1, 3), b,
                          h, n, BLK)
        qb, kb, vb = (t.detach().requires_grad_() for t in (qb, kb, vb))
        sdpa_out = F.scaled_dot_product_attention(qb, kb, vb)
        nbytes, f32, tc = _block_diag_bwd_counts(b * h, b * g, n, d, dv,
                                                 BLK, False)
        pairs = b * h * n * BLK
        row(f"block_diag_bwd ({tag})", "block_diag_bwd.cu",
            "block_diag.py:69", f"block_diag_bwd ({tag})",
            lambda: block_diag_bwd(qk, kk, vk, cot, r=r, blk=BLK,
                                   causal=False),
            lambda: block_diag_bwd_plain(qk, kk, vk, cot, r=r, blk=BLK,
                                         causal=False),
            (nbytes, f32, tc), (nbytes, f32 + pairs * (6 * d + 4 * dv)),
            library=lambda: torch.autograd.grad(sdpa_out, (qb, kb, vb), gb,
                                                retain_graph=True),
            shape=shape)
        del q, k, v, qk, kk, vk, cot, qb, kb, vb, gb, sdpa_out
    return rows



# ---------------------------------------------------------------------------
# Item 12a: the port on a DTensor mesh.
# ---------------------------------------------------------------------------

ML, MGEN = 8, 16              # mesh serve: yi-9b layers, greedy decode steps
MTL, MTN, MSTEPS = 4, 512, 2  # mesh train: layers, sequence, steps
FAKE_WORLD, FAKE_L = 4, 4     # mesh_fake: ranks of the fake group, layers


def _mesh_serve_run(setup, params, batch):
    """Prefill and MGEN greedy decode steps (one untimed warm-up run
    first); returns (tokens (B, 1 + MGEN), prefill launches, decode
    launches, caches, prefill ms, decode ms per step)."""
    for counted in (False, True):
        _reset()
        torch.cuda.synchronize()
        t0 = time.time()
        logits, caches = setup.prefill_fn(params, batch)
        torch.cuda.synchronize()
        t_pre = time.time() - t0
        pre = _read()
        _reset()
        tok = torch.argmax(logits[:, -1], -1)
        toks = [tok]
        t0 = time.time()
        for i in range(MGEN):
            logits, caches = setup.decode_fn(params, caches, tok, N + i)
            tok = torch.argmax(logits, -1)
            toks.append(tok)
        torch.cuda.synchronize()
        t_dec = time.time() - t0
        dec = _read()
    return (torch.stack(toks, 1), pre, dec, caches, t_pre * 1e3,
            t_dec / MGEN * 1e3)


def phase_mesh(launches, mesh_times):
    """A one-rank NCCL group and a 1 x 1 DeviceMesh: yi-9b lln_diag at full
    width (ML layers, bf16 weights), batch B, prompt N, MGEN greedy steps
    through make_serve_setup(mesh=...) against the meshless run from the
    same weights (tokens and launch counts equal); a save of the mesh
    run's caches restored with cache_shardings, bitwise; yi-9b training
    (MTL layers, fp32 params and moments, use_kernel=True) for MSTEPS
    steps, losses within 1e-5 relative and launch counts equal; qwen3-moe's
    first MoE block at full width through the expert-parallel path, within
    1e-5 of the meshless path.  The group is destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.data import torch_placer
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import make_serve_setup, make_train_setup
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import synthetic_batch
    from repro_torch.tree import leaves_with_path
    mesh = make_smoke_mesh(1, 1)
    log(f"mesh: {dist.get_backend()} group of {dist.get_world_size()}, "
        f"{mesh}")
    try:
        # Serving: the meshless run, then the mesh run from the same weights.
        cfg = get_config("yi-9b", attn_impl="lln_diag", n_layers=ML,
                         param_dtype="bfloat16")
        shape = ShapeSpec("chip", N + MGEN + 1, B, "decode")
        plain = make_serve_setup(cfg, shape)
        params = plain.model.init(SEED)
        batch = synthetic_batch(cfg, B, N + MGEN + 1, seed=SEED, text_seq=N,
                                device="cuda")
        toks0, pre0, dec0, _, pre_ms0, dec_ms0 = _mesh_serve_run(
            plain, params, batch)
        setup = make_serve_setup(cfg, shape, mesh=mesh)
        params = setup.shard_params(params)
        toks1, pre1, dec1, caches, pre_ms1, dec_ms1 = _mesh_serve_run(
            setup, params, batch)
        want_pre = {**_idle(), "lln_causal": ML, "block_diag": ML}
        want_dec = {**_idle(), "lln_decode": ML * MGEN}
        log(f"mesh serve: launches meshless {pre0} / {dec0}, mesh "
            f"{pre1} / {dec1}; tokens[0] {toks1[0].tolist()}")
        if (pre0, dec0) != (want_pre, want_dec) or (pre1, dec1) != (pre0,
                                                                    dec0):
            raise AssertionError("mesh serve: launch counts differ")
        if not torch.equal(toks0, toks1):
            raise AssertionError(f"mesh serve: tokens {toks1.tolist()} vs "
                                 f"meshless {toks0.tolist()}")
        for name in ("lln_causal (state)", "block_diag", "lln_decode"):
            key = name.split(" ")[0]
            launches[name] += pre1[key] + dec1[key]
        mesh_times["serve"] = {
            "prefill_ms": pre_ms1, "decode_ms_per_step": dec_ms1,
            "meshless_prefill_ms": pre_ms0,
            "meshless_decode_ms_per_step": dec_ms0}
        log(f"mesh serve: prefill {pre_ms1:.1f} ms (meshless {pre_ms0:.1f}),"
            f" decode {dec_ms1:.2f} ms/step (meshless {dec_ms0:.2f})")
        # Where the host time of one mesh decode step goes (cProfile, by
        # the functions' own time).
        import cProfile
        import pstats
        prof = cProfile.Profile()
        tok = toks1[:, -1]
        prof.enable()
        setup.decode_fn(params, caches, tok, N + MGEN)
        torch.cuda.synchronize()
        prof.disable()
        st = pstats.Stats(prof).stats
        total = sum(v[2] for v in st.values())
        top = sorted(st.items(), key=lambda kv: -kv[1][2])[:8]
        mesh_times["decode_profile"] = {
            "total_s": total, "calls": sum(v[1] for v in st.values()),
            "top": [(f"{Path(f).name}:{ln}:{fn}", v[1], v[2])
                    for (f, ln, fn), v in top]}
        log(f"mesh decode step under cProfile: {total:.3f} s own time in "
            f"{mesh_times['decode_profile']['calls']} calls; top "
            + "; ".join(f"{n} x{c} {t:.3f}s"
                        for n, c, t in mesh_times["decode_profile"]["top"]))
        # Who calls the two costliest (by cumulative time of the callers'
        # edges), walking up six levels.
        for key, _ in top[:2]:
            chain, cur = [], key
            for _ in range(6):
                callers = st[cur][4]
                if not callers:
                    break
                cur = max(callers, key=lambda c: callers[c][3])
                chain.append(f"{Path(cur[0]).name}:{cur[1]}:{cur[2]}")
            log(f"  callers of {Path(key[0]).name}:{key[2]}: "
                + " <- ".join(chain))

        # The mesh run's caches, saved (gathered; rank 0 writes) and
        # restored with the mesh's shardings.
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
        try:
            t0 = time.time()
            ck.save(str(tmp), 1, {"caches": caches})
            template = {"caches": setup.model.cache_init(None, B,
                                                         N + MGEN + 1)}
            shardings = {f"caches/{k}": v for k, v in setup.cache_shardings(
                template["caches"]).items()}
            got = dict(leaves_with_path(ck.restore(str(tmp), 1, template,
                                                   shardings)))
            for kp, want in leaves_with_path({"caches": caches}):
                if tuple(got[kp].placements) != tuple(want.placements) or \
                        not torch.equal(got[kp].full_tensor(),
                                        want.full_tensor()):
                    raise AssertionError(f"mesh restore: {kp} differs")
            mesh_times["ckpt_s"] = time.time() - t0
            log(f"mesh checkpoint: {len(got)} cache leaves saved and "
                f"restored bitwise in {time.time() - t0:.1f}s")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del plain, setup, params, caches, got, template
        torch.cuda.empty_cache()

        # Training: MSTEPS steps without and with the mesh.
        cfg = get_config("yi-9b", attn_impl="lln_diag", n_layers=MTL,
                         use_kernel=True)
        tshape = ShapeSpec("chip", MTN, B, "train")
        place = torch_placer("cuda")
        gen = lm_batches(cfg.vocab, B, MTN, seed=SEED)
        tbatches = [place(next(gen)) for _ in range(MSTEPS)]
        runs = {}
        for label, mesh_ in (("meshless", None), ("mesh", mesh)):
            tsetup = make_train_setup(cfg, tshape, mesh=mesh_,
                                      peak_lr=3e-4, total_steps=1000)
            state = tsetup.init_state(SEED)
            torch.cuda.synchronize()
            _reset()
            t0 = time.time()
            losses = []
            for tb in tbatches:
                state, m = tsetup.step_fn(state, tb)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            runs[label] = (losses, _read(), (time.time() - t0) / MSTEPS)
            del tsetup, state, m
            torch.cuda.empty_cache()
        (l0, c0, s0), (l1, c1, s1) = runs["meshless"], runs["mesh"]
        log(f"mesh train: losses {l1} (meshless {l0}); launches {c1}; "
            f"{s1 * 1e3:.0f} ms/step (meshless {s0 * 1e3:.0f}, the first "
            f"step's warm-up included)")
        if c1 != c0 or not c1["lln_diag_fused"]:
            raise AssertionError(f"mesh train: launches {c1} vs {c0}")
        if any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(l1, l0)):
            raise AssertionError(f"mesh train: losses {l1} vs {l0}")
        launches["lln_diag_fused"] += c1["lln_diag_fused"]
        launches["lln_diag_fused_bwd"] += c1["lln_diag_fused_bwd"]
        mesh_times["train"] = {"losses": l1, "meshless_losses": l0,
                               "ms_per_step": s1 * 1e3,
                               "meshless_ms_per_step": s0 * 1e3}

        # qwen3-moe's MoE block (E = 128, top 8, D = 4096) at full width.
        mcfg = get_config("qwen3-moe-235b-a22b", n_layers=1)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        block = moe_mod.MoE(mcfg, mcfg.pdtype, "cuda", gen)
        x = torch.randn(B, 128, mcfg.d_model, device="cuda",
                        generator=gen).to(mcfg.cdtype)
        rules = shd.make_rules(mcfg, multi_pod=False)
        with torch.no_grad():
            want, _ = moe_mod.moe_apply(block, x, mcfg)
            shd.shard_tree(block, shd.param_shardings(block, mesh))
            with shd.logical_rules(mesh, rules):
                xd = shd.place_leaf(x, shd.NamedSharding(mesh, shd.fit_spec(
                    shd.P(rules["act_batch"], rules["act_seq"], None),
                    x.shape, mesh)))
                got, _ = moe_mod.moe_apply(block, xd, mcfg)
        err = max_err(got.full_tensor(), want)
        log(f"mesh moe: expert-parallel block vs meshless, max abs err "
            f"{err:.3e} (largest {float(want.abs().max()):.3e})")
        if err > 1e-5 * max(1.0, float(want.abs().max())):
            raise AssertionError(f"mesh moe: error {err}")
        mesh_times["moe_err"] = err
    finally:
        dist.destroy_process_group()


def _mesh_fake_child():
    """The body of phase mesh_fake, in its own process: a fake process group
    of FAKE_WORLD ranks (its collectives are no-ops, so the values are
    garbage and only shapes and launches are checked), a (1, FAKE_WORLD)
    mesh on the card and yi-9b lln_diag at full width with FAKE_L layers:
    one prefill and 2 decode steps.  Prints one JSON line."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import synthetic_batch
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=FAKE_WORLD)
    try:
        mesh = make_smoke_mesh(1, FAKE_WORLD)
        shapes = collections.defaultdict(set)
        for name in ("lln_causal", "block_diag", "lln_decode", "lln_bidir",
                     "loglin_causal"):
            def rec(*args, _fn=getattr(ops, name), _name=name, **kw):
                shapes[_name].add(tuple(tuple(a.shape) for a in args[:3]))
                return _fn(*args, **kw)
            setattr(ops, name, rec)
        cfg = get_config("yi-9b", attn_impl="lln_diag", n_layers=FAKE_L,
                         param_dtype="bfloat16")
        setup = make_serve_setup(cfg, ShapeSpec("chip", N + 3, B, "decode"),
                                 mesh=mesh)
        params = setup.shard_params(setup.model.init(SEED))
        batch = synthetic_batch(cfg, B, N + 3, seed=SEED, text_seq=N,
                                device="cuda")
        _reset()
        logits, caches = setup.prefill_fn(params, batch)
        tok = torch.argmax(logits[:, -1], -1)
        _, caches = setup.decode_fn(params, caches, tok, N)
        with CommDebugMode() as comm:
            _, caches = setup.decode_fn(params, caches, tok, N + 1)
        torch.cuda.synchronize()
        local = {k: list(getattr(caches["layers"][0], k).to_local().shape)
                 for k in ("s", "z", "c_k", "tail_k", "tail_v")}
        got = {"local": local, "launches": _read(),
               "shapes": {k: sorted(v) for k, v in shapes.items()},
               "comm": {str(op): n for op, n in
                        comm.get_comm_counts().items()}}
        del setup, params, caches
        torch.cuda.empty_cache()
        got["families"] = _fake_family_runs(mesh, shapes)
        print(json.dumps(got))
    finally:
        dist.destroy_process_group()


def phase_mesh_fake(launches):
    """mesh_fake: run _mesh_fake_child in a process of its own (no group of
    it outlives the phase) and check its line: 8 query heads and 1 kv head
    per rank in the (s, z) state and the diag tails, and rows 1-3 launched
    at those heads (kernel layout: B x heads rows)."""
    del launches                  # a fake group's values are not results
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--mesh-fake-child"], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"mesh_fake child failed:\n{proc.stdout}"
                             f"\n{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    hq, hk = H // FAKE_WORLD, G // FAKE_WORLD
    want = {"s": [B, hq, D, D], "z": [B, hq, D], "c_k": [B, 1, hq, 1],
            "tail_k": [B, BLK, hk, D], "tail_v": [B, BLK, hk, D]}
    log(f"mesh_fake: local state {got['local']}; launches "
        f"{got['launches']}; kernel input shapes {got['shapes']}; "
        f"collectives of one decode step {got['comm']}")
    if got["local"] != want:
        raise AssertionError(f"mesh_fake: local shapes {got['local']}, "
                             f"expected {want}")
    rows = {"lln_causal": FAKE_L, "block_diag": FAKE_L,
            "lln_decode": 2 * FAKE_L}
    for name, n in rows.items():
        if got["launches"][name] != n:
            raise AssertionError(f"mesh_fake: {name} launched "
                                 f"{got['launches'][name]} times, not {n}")
        heads = {(s[0][0], s[1][0]) for s in got["shapes"][name]}
        if heads != {(B * hq, B * hk)}:
            raise AssertionError(f"mesh_fake: {name} ran at q/k rows "
                                 f"{heads}, expected {(B * hq, B * hk)}")
    _check_fake_families(got["families"])


# Per mesh_fake family: (cache leaf, dim, its size on one of the
# FAKE_WORLD ranks) by the reference's rules (every leaf is also held to
# cache_shardings' shard), and (kernel, the q rows per call: B x the heads
# per rank).
FAKE_WANT = {
    # replicate: the batch over (data, model), so the rows split and the
    # 24 heads stay whole on each rank.
    "mamba2-130m": ((("layers/0/state", 0, B // FAKE_WORLD),
                     ("layers/0/state", 1, 24)), ()),
    "zamba2-7b": ((("layers/0/state", 1, 112 // FAKE_WORLD),
                   ("shared/0/s", 1, 32 // FAKE_WORLD)),
                  (("lln_causal", B * 32 // FAKE_WORLD),
                   ("lln_decode", B * 32 // FAKE_WORLD))),
    "mla lln_diag": ((("layers/0/s", 1, 128 // FAKE_WORLD),
                      ("first_layers/0/s", 1, 128 // FAKE_WORLD)),
                     (("lln_causal", B * 128 // FAKE_WORLD),
                      ("lln_decode", B * 128 // FAKE_WORLD))),
    "mla softmax": ((("layers/0/ckv", 2, 512 // FAKE_WORLD),), ()),
    "seamless-m4t-medium": ((("layers/0/self/s", 1, 16 // FAKE_WORLD),
                             ("layers/0/ck", 2, 16 // FAKE_WORLD)),
                            (("lln_bidir", B * 16 // FAKE_WORLD),
                             ("lln_causal", B * 16 // FAKE_WORLD))),
    # context: attention whole per rank (all 8 heads), the state split.
    "paligemma-3b": ((("layers/0/s", 1, 8 // FAKE_WORLD),),
                     (("lln_causal", B * 8),)),
    "yi-9b log_linear": ((("layers/0/sl", 2, 32 // FAKE_WORLD),),
                         (("loglin_causal", B * 32 // FAKE_WORLD),))}


def _check_fake_families(got):
    """mesh_fake's families: each local state leaf and each kernel's q rows
    per rank as FAKE_WANT says."""
    for label, (leaves, kernels) in FAKE_WANT.items():
        res = got[label]
        log(f"mesh_fake {label}: local cache {res['local']}; kernel input "
            f"shapes {res['kernels']}")
        if res["wrong"]:
            raise AssertionError(f"mesh_fake {label}: cache leaves not at "
                                 f"cache_shardings' shard: {res['wrong']}")
        for leaf, dim, size in leaves:
            if res["local"][leaf][dim] != size:
                raise AssertionError(f"mesh_fake {label}: {leaf} local "
                                     f"{res['local'][leaf]}, dim {dim} "
                                     f"should be {size}")
        for name, rows in kernels:
            seen = {tuple(s)[0][0] for s in res["kernels"].get(name, [])}
            if seen != {rows}:
                raise AssertionError(f"mesh_fake {label}: {name} q rows "
                                     f"{seen}, expected {{{rows}}}")


# ---------------------------------------------------------------------------
# Item 12b: the other families on a mesh, and the production-mesh dry run.
# ---------------------------------------------------------------------------

MF_GEN = 4                    # mesh_families: greedy decode steps
# (label, arch, impl, overrides, text prompt): served at batch B on the
# 1 x 1 mesh and without it (paligemma: 256 patches before its text;
# seamless: MF_SRC source frames before a 64-token target prompt).
MF_SERVE = (("mamba2-130m", "mamba2-130m", "softmax", {}, N),
            ("zamba2-7b", "zamba2-7b", "lln_diag", {"n_layers": 7}, N),
            ("deepseek-v2 lln_diag", "deepseek-v2-236b", "lln_diag",
             {"n_layers": 2}, N),
            ("deepseek-v2 softmax", "deepseek-v2-236b", "softmax",
             {"n_layers": 2}, N),
            ("seamless-m4t-medium", "seamless-m4t-medium", "lln_diag", {},
             64),
            ("paligemma-3b lln_diag", "paligemma-3b", "lln_diag",
             {"n_layers": 4}, VLM_TEXT),
            ("paligemma-3b softmax", "paligemma-3b", "softmax",
             {"n_layers": 4}, VLM_TEXT),
            ("yi-9b log_linear", "yi-9b", "log_linear", {"n_layers": 8}, N))
MF_SRC = 512
# (label, arch, impl, overrides, batch, sequence): 2 steps on the kernels
# (fp32 params and moments; fp32 compute at the wide heads, as PR 28's
# train cells held their first step).
MF_TRAIN = (("mamba2-130m", "mamba2-130m", "softmax", {}, 4, N),
            ("zamba2-7b", "zamba2-7b", "lln_diag", {"n_layers": 7}, 4, N),
            ("deepseek-v2", "deepseek-v2-236b", "lln_diag",
             {"n_layers": 1, "compute_dtype": "float32"}, 4, N),
            ("seamless-m4t-medium", "seamless-m4t-medium", "lln_diag", {}, 4,
             N),
            ("roberta-lln", "roberta-lln", "lln_diag", {}, EB, EN),
            ("paligemma-3b", "paligemma-3b", "lln_diag",
             {"n_layers": 4, "compute_dtype": "float32"}, 2, N))
# Where a family run's launches go in the kernels line (the rows' keys).
MF_KEYS = {"lln_causal": "lln_causal (state)", "block_diag": "block_diag",
           "lln_decode": "lln_decode", "lln_bidir": "lln_bidir",
           "block_diag (causal=False)": "block_diag (causal=False)",
           "loglin_causal": "loglin_causal",
           "lln_diag_fused": "lln_diag_fused",
           "lln_diag_fused_bwd": "lln_diag_fused_bwd",
           "lln_bidir_bwd": "lln_bidir_bwd",
           "block_diag_bwd": "block_diag_bwd", "ssd": "ssd",
           "lln_causal_bwd": "lln_causal_bwd"}


def _mf_batch(cfg, prompt):
    """A serving batch: ``prompt`` text tokens, and the family's patches or
    MF_SRC source frames; returns (batch, first decode position)."""
    from repro_torch.models import synthetic_batch
    if cfg.family == "encdec":
        batch = synthetic_batch(cfg, B, MF_SRC, seed=SEED, text_seq=prompt,
                                device="cuda")
    else:
        batch = synthetic_batch(cfg, B, prompt + cfg.num_prefix_tokens,
                                seed=SEED, text_seq=prompt, device="cuda")
    batch = {k: v for k, v in batch.items()
             if k in ("inputs", "src", "patches")}
    return batch, batch["inputs"].shape[1] + (
        cfg.num_prefix_tokens if cfg.family == "vlm" else 0)


def _mf_serve(setup, params, batch, pos0):
    """Prefill and MF_GEN greedy steps: (tokens, prefill launches, decode
    launches, prefill ms, decode ms per step)."""
    _reset()
    torch.cuda.synchronize()
    t0 = time.time()
    logits, caches = setup.prefill_fn(params, batch)
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    pre = _read()
    _reset()
    tok = torch.argmax(logits[:, -1], -1)
    t0 = time.time()
    toks, caches = setup.make_generate(MF_GEN)(params, caches, tok, pos0)
    torch.cuda.synchronize()
    t_dec = time.time() - t0
    dec = _read()
    return (torch.cat([tok[:, None], toks], 1), pre, dec, t_pre * 1e3,
            t_dec / MF_GEN * 1e3)


def phase_mesh_families(launches, mesh_times):
    """Item 12b on a one-rank NCCL group and a 1 x 1 DeviceMesh, at full
    width: each MF_SERVE cell (bf16 weights from the seed, use_kernel=True,
    batch B) served without the mesh and then through
    make_serve_setup(mesh=...) from the same weights, MF_GEN greedy steps:
    the tokens and every kernel's launch counts equal; each MF_TRAIN cell
    (use_kernel=True, one microbatch) 2 steps without and with the mesh:
    losses within 1e-5 relative and the launch counts equal.  The mesh
    runs' launches go into the kernels line; each model is freed before
    the next.  The group is destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import torch_placer
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import make_serve_setup, make_train_setup
    mesh = make_smoke_mesh(1, 1)

    def count(got):
        for key, n in got.items():
            if key in MF_KEYS:
                launches[MF_KEYS[key]] += n

    try:
        for label, arch, impl, over, prompt in MF_SERVE:
            cfg = get_config(arch, attn_impl=impl, param_dtype="bfloat16",
                             use_kernel=True, **over)
            batch, pos0 = _mf_batch(cfg, prompt)
            shape = ShapeSpec("chip", pos0 + MF_GEN + 1, B, "decode")
            plain = make_serve_setup(cfg, shape)
            params = plain.model.init(SEED)
            _mf_serve(plain, params, batch, pos0)          # warm-up
            toks0, pre0, dec0, p0, d0 = _mf_serve(plain, params, batch,
                                                  pos0)
            setup = make_serve_setup(cfg, shape, mesh=mesh)
            params = setup.shard_params(params)
            toks1, pre1, dec1, p1, d1 = _mf_serve(setup, params, batch, pos0)
            log(f"mesh_families serve {label}: launches {pre1} / {dec1}; "
                f"prefill {p1:.1f} ms (meshless {p0:.1f}), decode "
                f"{d1:.2f} ms/step (meshless {d0:.2f})")
            if (pre1, dec1) != (pre0, dec0):
                raise AssertionError(f"mesh_families serve {label}: "
                                     f"launches {pre1} / {dec1} vs "
                                     f"meshless {pre0} / {dec0}")
            if not torch.equal(toks0, toks1):
                raise AssertionError(f"mesh_families serve {label}: tokens "
                                     f"{toks1.tolist()} vs meshless "
                                     f"{toks0.tolist()}")
            if impl != "softmax" and not (pre1["lln_causal"]
                                          or pre1["loglin_causal"]):
                raise AssertionError(f"mesh_families serve {label}: no "
                                     f"prefill kernel launched: {pre1}")
            if impl == "log_linear":
                launches["lln_decode (log_linear)"] += dec1["lln_decode"]
                dec1 = {**dec1, "lln_decode": 0}
            count(pre1)
            count(dec1)
            mesh_times[f"serve {label}"] = {
                "prefill_ms": p1, "decode_ms_per_step": d1,
                "meshless_prefill_ms": p0, "meshless_decode_ms_per_step": d0}
            del plain, setup, params
            torch.cuda.empty_cache()
        place = torch_placer("cuda")
        for label, arch, impl, over, b, n in MF_TRAIN:
            cfg = get_config(arch, attn_impl=impl, use_kernel=True,
                             param_dtype="float32", grad_accum=1, **over)
            gen = _synthetic_batches(cfg)(cfg.vocab, b, n, seed=SEED)
            tbatches = [place(next(gen)) for _ in range(2)]
            runs = {}
            for tag, mesh_ in (("meshless", None), ("mesh", mesh)):
                tsetup = make_train_setup(
                    cfg, ShapeSpec("chip", n, b, "train"), mesh=mesh_,
                    peak_lr=3e-4, total_steps=1000)
                state = tsetup.init_state(SEED)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _reset()
                t0 = time.time()
                losses = []
                for tb in tbatches:
                    state, m = tsetup.step_fn(state, tb)
                    losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                runs[tag] = (losses, _read(), (time.time() - t0) / 2,
                             torch.cuda.max_memory_allocated() / 2 ** 30)
                del tsetup, state, m
                torch.cuda.empty_cache()
            (l0, c0, s0, g0), (l1, c1, s1, g1) = runs["meshless"], runs["mesh"]
            log(f"mesh_families train {label}: losses {l1} (meshless {l0}); "
                f"launches {c1}; {s1 * 1e3:.0f} ms/step (meshless "
                f"{s0 * 1e3:.0f}, the first step included); peak "
                f"{g1:.2f} GiB")
            if c1 != c0 or not any(c1.values()):
                raise AssertionError(f"mesh_families train {label}: "
                                     f"launches {c1} vs {c0}")
            if any(abs(a - b_) > 1e-5 * abs(b_) for a, b_ in zip(l1, l0)):
                raise AssertionError(f"mesh_families train {label}: losses "
                                     f"{l1} vs {l0}")
            if max(g0, g1) > 70:
                raise AssertionError(f"mesh_families train {label}: peak "
                                     f"{max(g0, g1):.1f} GiB")
            count(c1)
            mesh_times[f"train {label}"] = {
                "losses": l1, "meshless_losses": l0, "ms_per_step": s1 * 1e3,
                "meshless_ms_per_step": s0 * 1e3, "peak_gib": g1}
    finally:
        dist.destroy_process_group()


# mesh_pool / mesh_spec (the pool and speculative decoding on a mesh):
# yi-9b at full width cut to MP_LAYERS layers, its draft MP_DRAFT, and
# mamba2-130m to MP_SSM_LAYERS (of 48 and 24: the script's time limit);
# the pool's requests' budgets, prompt MP_N.
MP_LAYERS, MP_DRAFT, MP_N = 4, 2, 128
MP_SSM_LAYERS = 8
MP_BUDGETS = (4, 4, 8, 16) * 2
MS_STEPS = 8                   # mesh_spec: tokens per row
MP_KEYS = {"lln_causal": "lln_causal (state)", "block_diag": "block_diag",
           "lln_decode": "lln_decode", "ssd": "ssd"}


def _mp_requests(vocab):
    from repro_torch.launch.batcher import Request
    rng = np.random.default_rng(SEED)
    return [Request(rid=i, prompt=rng.integers(0, vocab, MP_N).astype(
        np.int32), gen_len=g) for i, g in enumerate(MP_BUDGETS)]


def _mp_run(setup, params, reqs):
    """One pool run (after a warm-up pass): (outputs, launches, wall ms per
    segment, decode steps)."""
    from repro_torch.launch.batcher import ContinuousBatcher
    eng = ContinuousBatcher(setup, params)
    eng.warmup([MP_N])
    torch.cuda.synchronize()
    _reset()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    got = _read()
    bad = {r: s for r, s in stats.statuses.items() if s != "done"}
    if bad:
        raise AssertionError(f"pool statuses {bad}")
    return ({r: np.asarray(t).tolist() for r, t in stats.outputs.items()},
            got, stats.wall_s * 1e3 / max(stats.segments, 1),
            stats.decode_steps)


def phase_mesh_pool(launches, mesh_times):
    """The pool on a one-rank NCCL group and a 1 x 1 DeviceMesh: the
    request pool (launch/batcher.py over make_pool_setup(mesh=...)) against
    the meshless pool from the same bf16 weights, B slots, the
    MP_BUDGETS requests (prompt MP_N), segment 4: yi-9b at full width cut
    to MP_LAYERS layers (lln_diag), plain and with speculative rows
    (spec_k 2, an MP_DRAFT-layer draft), and mamba2-130m (24 layers,
    use_kernel=True).  Each request's greedy tokens and every kernel's
    launch count equal the meshless run's; every request ends done.  The
    mesh runs' launches go into the kernels line; the ms per segment of
    both go into the mesh times.  The group is destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import make_pool_setup
    mesh = make_smoke_mesh(1, 1)
    # (label, arch, overrides, spec_k, the kernels the run must launch:
    # none for mamba2, whose serving prefill is the core SSD scan).
    yi = {"attn_impl": "lln_diag", "n_layers": MP_LAYERS}
    cells = (("yi-9b", "yi-9b", yi, 0, ("lln_causal", "block_diag",
                                        "lln_decode")),
             ("yi-9b spec", "yi-9b", yi, 2, ("lln_causal", "block_diag",
                                             "lln_decode")),
             ("mamba2-130m", "mamba2-130m", {"n_layers": MP_SSM_LAYERS}, 0,
              ()))
    try:
        for label, arch, over, spec_k, used in cells:
            cfg = get_config(arch, param_dtype="bfloat16", **over)
            reqs = _mp_requests(cfg.vocab)
            kw = dict(slots=B, max_len=MP_N + max(MP_BUDGETS) + spec_k + 1,
                      segment=4, spec_k=spec_k,
                      draft_layers=MP_DRAFT if spec_k else 0)
            plain = make_pool_setup(cfg, **kw)
            params = plain.model.init(SEED)
            out0, c0, ms0, steps0 = _mp_run(plain, params, reqs)
            setup = make_pool_setup(cfg, mesh=mesh, **kw)
            params = setup.shard_params(params)
            out1, c1, ms1, steps1 = _mp_run(setup, params, reqs)
            log(f"mesh_pool {label}: launches {c1} (meshless {c0}); "
                f"{ms1:.1f} ms per segment (meshless {ms0:.1f}); request 0 "
                f"{out1[0]}")
            if c1 != c0 or not all(c1[k] for k in used):
                raise AssertionError(f"mesh_pool {label}: launches {c1} vs "
                                     f"{c0}")
            if out1 != out0:
                raise AssertionError(f"mesh_pool {label}: tokens {out1} vs "
                                     f"meshless {out0}")
            for key, name in MP_KEYS.items():
                launches[name] += c1[key]
            mesh_times[f"pool {label}"] = {
                "ms_per_segment": ms1, "meshless_ms_per_segment": ms0,
                "decode_steps": steps1, "meshless_decode_steps": steps0}
            del plain, setup, params
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def phase_mesh_spec(launches, mesh_times):
    """make_spec_setup on a one-rank NCCL group and a 1 x 1 DeviceMesh:
    yi-9b at full width cut to MP_LAYERS layers (lln_diag, bf16 weights),
    an MP_DRAFT-layer draft, k = 3, batch B at prompt N, MS_STEPS greedy
    tokens per row, against the meshless loop from the same weights: the
    tokens, n_emit and every kernel's launch count equal.  The group is
    destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import make_spec_setup
    from repro_torch.models import synthetic_batch
    mesh = make_smoke_mesh(1, 1)
    try:
        cfg = get_config("yi-9b", attn_impl="lln_diag", n_layers=MP_LAYERS,
                         param_dtype="bfloat16")
        total = N + MS_STEPS + 4 + 1
        shape = ShapeSpec("chip", total, B, "decode")
        batch = synthetic_batch(cfg, B, total, seed=SEED, text_seq=N,
                                device="cuda")
        params, runs = None, {}
        for label, mesh_ in (("meshless", None), ("mesh", mesh)):
            sp = make_spec_setup(cfg, shape, spec_k=3, draft_layers=MP_DRAFT,
                                 mesh=mesh_)
            params = sp.shard_params(sp.model.init(SEED) if params is None
                                     else params)
            for counted in (False, True):
                _reset()
                torch.cuda.synchronize()
                t0 = time.time()
                logits, tgt, dr = sp.prefill_fn(params, batch)
                tok = torch.argmax(logits[:, -1], -1)
                toks, n_emit, _, live, *_ = sp.make_generate(MS_STEPS)(
                    params, tgt, dr, tok, N)
                torch.cuda.synchronize()
                wall = time.time() - t0
            iters = int(live.any(0).sum())
            runs[label] = (toks.cpu(), n_emit.cpu(), _read(),
                           wall * 1e3 / max(iters, 1), iters)
        (t0_, e0, c0, ms0, i0), (t1, e1, c1, ms1, i1) = (runs["meshless"],
                                                       runs["mesh"])
        log(f"mesh_spec: launches {c1} (meshless {c0}); {i1} iterations, "
            f"{ms1:.1f} ms each with the prefill (meshless {ms0:.1f})")
        if c1 != c0 or not c1["lln_decode"]:
            raise AssertionError(f"mesh_spec: launches {c1} vs {c0}")
        if not (torch.equal(t0_, t1) and torch.equal(e0, e1)):
            raise AssertionError("mesh_spec: tokens differ from the "
                                 "meshless loop's")
        for key, name in MP_KEYS.items():
            launches[name] += c1[key]
        mesh_times["spec"] = {"ms_per_iteration": ms1,
                              "meshless_ms_per_iteration": ms0,
                              "iterations": i1}
    finally:
        dist.destroy_process_group()


# mesh_fake's families at full width (label, arch, impl, overrides), prompt
# FAKE_N (paligemma: its 256 patches before it), and what one rank of the
# (1, FAKE_WORLD) mesh holds.
FAKE_N = 64
FAKE_FAMILIES = (("mamba2-130m", "mamba2-130m", "softmax", {"n_layers": 2}),
                 ("zamba2-7b", "zamba2-7b", "lln_diag", {"n_layers": 6}),
                 ("mla lln_diag", "deepseek-v2-236b", "lln_diag",
                  {"n_layers": 2}),
                 ("mla softmax", "deepseek-v2-236b", "softmax",
                  {"n_layers": 2}),
                 ("seamless-m4t-medium", "seamless-m4t-medium", "lln_diag",
                  {"n_layers": 2, "enc_layers": 2}),
                 ("paligemma-3b", "paligemma-3b", "lln_diag",
                  {"n_layers": 2}),
                 ("yi-9b log_linear", "yi-9b", "log_linear",
                  {"n_layers": 2}))


def _fake_family_runs(mesh, shapes):
    """The FAKE_FAMILIES cells on the fake mesh: a prefill and one decode
    step each; returns {label: {cache leaf: local shape}} for the first
    layer's cache leaves (and the shared block's)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.tree import leaves_with_path, path_str
    out = {}
    for label, arch, impl, over in FAKE_FAMILIES:
        cfg = get_config(arch, attn_impl=impl, param_dtype="bfloat16",
                         use_kernel=True, **over)
        batch, pos0 = _mf_batch(cfg, FAKE_N)
        setup = make_serve_setup(cfg, ShapeSpec("chip", pos0 + 3, B,
                                                "decode"), mesh=mesh)
        params = setup.shard_params(setup.model.init(SEED))
        shapes.clear()
        _, caches = setup.prefill_fn(params, batch)
        _, caches = setup.decode_fn(params, caches,
                                    torch.zeros(B, dtype=torch.int64,
                                                device="cuda"), pos0)
        rules = setup.cache_shardings(caches)
        local, wrong = {}, []
        for kp, a in leaves_with_path(caches):
            key = path_str(kp)
            want = list(a.shape)
            for i, pl in enumerate(rules[key].placements):
                if pl.is_shard():
                    want[pl.dim] //= mesh.size(i)
            if list(a.to_local().shape) != want:
                wrong.append((key, list(a.to_local().shape), want))
            if key.split("/")[1] == "0":
                local[key] = list(a.to_local().shape)
        out[label] = {"local": local, "wrong": wrong,
                      "kernels": {k: sorted(v) for k, v in shapes.items()}}
        del setup, params, caches
        torch.cuda.empty_cache()
    return out


# One dry-run cell per family (arch, shape, overrides), on both production
# meshes.
DRY_CELLS = (("yi-9b", "decode_32k", {"n_layers": 1}),
             ("qwen3-moe-235b-a22b", "decode_32k", {"n_layers": 1}),
             ("deepseek-v2-236b", "decode_32k", {"n_layers": 2}),
             ("mamba2-130m", "decode_32k", {"n_layers": 1}),
             ("zamba2-7b", "decode_32k", {"n_layers": 6}),
             ("seamless-m4t-medium", "decode_32k",
              {"n_layers": 1, "enc_layers": 1}),
             ("paligemma-3b", "decode_32k", {"n_layers": 1}),
             ("roberta-lln", "train_4k", {"n_layers": 1}))
# use_kernel=True cells on 16 x 16 (arch, shape, overrides, impl), each
# beside its use_kernel=False twin: the hand kernels' custom ops traced on
# fake cuda tensors (the train cells reach the backward ops' fakes).
DRY_KERNEL_CELLS = (("yi-9b", "decode_32k", {"n_layers": 1}, "lln_diag"),
                    ("yi-9b", "train_4k", {"n_layers": 1}, "lln_diag"),
                    ("mamba2-130m", "train_4k", {"n_layers": 1}, "auto"))
DRY_CHILD = """
import json, sys
import torch.distributed as dist
from repro_torch.launch import dryrun
from repro_torch.kernels import ops  # noqa: F401 (every wrapper imported)
cells, multi_pod = json.loads(sys.argv[1]), sys.argv[2] == "1"
out = [dryrun.run_cell(a, s, multi_pod, (c[3] if len(c) > 3 else "auto"),
                       o) for c in cells for a, s, o in [c[:3]]]
dist.destroy_process_group()
import chip_smoke
print(json.dumps({"cells": out, "launches": chip_smoke._read()}))
"""


def _dryrun_expected(arch, shape_name, over, multi_pod, impl="auto"):
    """A dry-run cell's per-rank argument bytes by the port's rules on a
    duck mesh of the production shape: parameters (and AdamW moments) by
    param_specs, caches by cache_shardings, the batch or token by the
    rules' batch axes."""
    from types import SimpleNamespace
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves_with_path, path_str
    cfg, _, shape = dryrun.cell_config(arch, shape_name, impl, over)
    dims = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    duck = SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=dims))
    sizes = dict(zip(names, dims))
    rules = shd.make_rules(cfg, multi_pod=multi_pod,
                           serve=shape.kind != "train")

    def nbytes(shape_, dtype, spec):
        n = 1
        for dim, axes in zip(shape_, tuple(spec) + (None,) * len(shape_)):
            axes = () if axes is None else (
                axes if isinstance(axes, tuple) else (axes,))
            n *= dim // math.prod(sizes[a] for a in axes)
        return n * torch.empty((), dtype=dtype).element_size()

    def tree_bytes(tree, specs):
        return sum(nbytes(t.shape, t.dtype, specs[path_str(kp)])
                   for kp, t in leaves_with_path(tree))

    b, n = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        model = build_model(cfg, "cpu")
        params = model.init(None)
        if shape.kind == "train":
            state = {"params": params, "opt": adamw_init(params)}
            total = tree_bytes(state, shd.param_specs(state, duck))
            spec = shd.fit_spec(shd.P(rules["act_batch"], rules["act_seq"]),
                                (b, n), duck)
            return total + 2 * nbytes((b, n), torch.int64, spec) + nbytes(
                (b, n), torch.float32, spec)
        total = tree_bytes(params, shd.param_specs(params, duck))
        caches = model.cache_init(None, b, n)
        total += tree_bytes(caches, {
            k: v.spec for k, v in steps.cache_shardings(
                caches, cfg, duck, rules).items()})
        spec = shd.fit_spec(shd.P(rules["act_batch"]), (b,), duck)
        return total + nbytes((b,), torch.int64, spec)


def phase_dryrun(results):
    """launch/dryrun.py on the card's host: child processes (one for 16 x
    16, two for 2 x 16 x 16; each starts its own fake group of 256 or 512
    ranks and traces with fake cuda tensors, nothing launched) run the
    DRY_CELLS; each cell is ok and its per-rank argument bytes are the
    ones the port's rules give (_dryrun_expected).  The 16 x 16 child also
    runs the DRY_KERNEL_CELLS with use_kernel=True and False: each ok, the
    kernel cell's argument bytes equal its twin's, its trace dispatched
    the kernels' custom ops (its twin's none), and no child launched or
    counted a kernel."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    half = len(DRY_CELLS) // 2
    kern = [c for arch, shape, over, impl in DRY_KERNEL_CELLS
            for c in ((arch, shape, {**over, "use_kernel": True}, impl),
                      (arch, shape, over, impl))]
    jobs = [(False, list(DRY_CELLS) + kern), (True, DRY_CELLS[:half]),
            (True, DRY_CELLS[half:])]
    procs = [subprocess.Popen(
        [sys.executable, "-c", DRY_CHILD, json.dumps(cells),
         "1" if mp else "0"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=str(ROOT)) for mp, cells in jobs]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"dryrun child failed:\n{err[-4000:]}")
            got = json.loads(out.strip().splitlines()[-1])
            if any(got["launches"].values()):
                raise AssertionError(f"dryrun launched {got['launches']}")
            outs.append(got["cells"])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    got = {False: outs[0][:len(DRY_CELLS)], True: outs[1] + outs[2]}
    for mp in (False, True):
        for (arch, shape, over), cell in zip(DRY_CELLS, got[mp]):
            want = _dryrun_expected(arch, shape, over, mp)
            _dry_log(results, arch, shape, cell, want)
            if cell["kernel_ops"]:
                raise AssertionError(f"dryrun {arch} {shape}: kernel ops "
                                     f"{cell['kernel_ops']} on the core "
                                     "path")
    pairs = outs[0][len(DRY_CELLS):]
    for i, (arch, shape, over, impl) in enumerate(DRY_KERNEL_CELLS):
        cell, twin = pairs[2 * i], pairs[2 * i + 1]
        want = _dryrun_expected(arch, shape, over, False, impl)
        _dry_log(results, arch, f"{shape} use_kernel", cell, want)
        _dry_log(results, arch, f"{shape} twin", twin, want)
        log(f"  kernel ops per rank: {cell['kernel_ops']}")
        if not cell["kernel_ops"] or twin["kernel_ops"]:
            raise AssertionError(f"dryrun {arch} {shape}: kernel ops "
                                 f"{cell['kernel_ops']} / twin "
                                 f"{twin['kernel_ops']}")
        if shape == "train_4k" and not any(
                k.endswith("_bwd") for k in cell["kernel_ops"]) and \
                arch != "mamba2-130m":
            raise AssertionError(f"dryrun {arch} {shape}: no backward op")


def _dry_log(results, arch, shape, cell, want):
    """Log one dry-run cell and hold it ok with ``want`` argument bytes."""
    log(f"dryrun {arch} {shape} {cell['mesh']}: ok {cell['ok']}, "
        f"trace {cell.get('lower_s')} s, args "
        f"{cell.get('argument_size_in_bytes')} B (rules: {want}), outputs "
        f"{cell.get('output_size_in_bytes')} B, temp "
        f"{cell.get('temp_size_in_bytes')} B, flops {cell.get('flops')}, "
        f"collectives {cell.get('collectives')}")
    if not cell["ok"] or cell["argument_size_in_bytes"] != want:
        raise AssertionError(f"dryrun {arch} {shape} {cell['mesh']}: "
                             f"{cell}, expected argument bytes {want}")
    results[f"dryrun {arch} {shape} {cell['mesh']}"] = {
        k: cell[k] for k in ("lower_s", "argument_size_in_bytes",
                             "output_size_in_bytes", "temp_size_in_bytes",
                             "flops", "collectives", "kernel_ops")}


_T0 = time.time()


def _phase(fn, *args):
    """Run one phase and log its wall time and the run's so far."""
    t0 = time.time()
    out = fn(*args)
    log(f"[{fn.__name__}: {time.time() - t0:.1f}s; {time.time() - _T0:.1f}s "
        f"since the start]")
    return out


def _selected(argv):
    """``--phases a,b`` (names without ``phase_``): run only those check
    phases after device and build, and print no kernels line (the timing
    phases that make it do not run).  No argument: the whole run."""
    if not argv:
        return None
    if argv == ["--mesh-fake-child"]:
        return argv[0]
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: chip_smoke.py [--phases name,name,...]")
    return set(argv[1].split(","))


def main(argv=None):
    only = _selected(sys.argv[1:] if argv is None else argv)
    if only == "--mesh-fake-child":
        phase_device()
        _mesh_fake_child()
        return 0
    smi = phase_device()
    _phase(phase_build)
    if only is not None:
        return _main_selected(smi, only)
    errs, serve_times, train_times = {}, {}, {}
    enc_times = {}
    launches = {name: 0 for name in (
        "lln_causal (state)", "block_diag", "lln_decode", "lln_causal (res)",
        "lln_diag_fused", "lln_causal_bwd", "lln_diag_fused_bwd",
        "lln_bidir", "lln_bidir_bwd", "block_diag_bwd",
        "block_diag (causal=False)", "loglin_causal",
        "lln_decode (log_linear)", "ssd", "lln_diag_fused (hybrid)",
        "lln_diag_fused_bwd (hybrid)", "lln_causal (state, hybrid)",
        "block_diag (hybrid)", "lln_decode (hybrid)")}
    for tag, *_ in DENSE + FAMILIES:
        for name in (f"lln_causal (state, {tag})", f"block_diag ({tag})",
                     f"lln_decode ({tag})"):
            launches[name] = 0
    launches["lln_bidir (seamless encoder)"] = 0
    launches["block_diag (causal=False, seamless encoder)"] = 0
    for tag, _, b, h, g, d, dv, n in FAMILIES_TRAIN:
        launches[f"lln_diag_fused (train, {tag})"] = 0
        launches[f"lln_diag_fused_bwd (train, {tag})"] = 0
        if _is_wide(d, dv):
            launches[f"lln_causal (res, {tag})"] = 0
            launches[f"lln_causal_bwd ({tag})"] = 0
    for name in ("lln_bidir (train, seamless encoder)",
                 "lln_bidir_bwd (seamless encoder)",
                 "block_diag (causal=False, train, seamless encoder)",
                 "block_diag_bwd (seamless encoder)"):
        launches[name] = 0
    for tag, *_ in WIDE_BDB:
        launches[f"block_diag_bwd ({tag})"] = 0
    _phase(phase_kernels, errs)
    _phase(phase_kernels_train, errs)
    _phase(phase_kernels_encoder, errs)
    _phase(phase_kernels_loglin, errs)
    _phase(phase_kernels_ssd, errs)
    _phase(phase_kernels_hybrid_attn, errs)
    _phase(phase_kernels_hybrid_serve, errs)
    _phase(phase_kernels_dense, errs)
    _phase(phase_kernels_families, errs)
    _phase(phase_kernels_families_train, errs)
    _phase(phase_f4, errs)
    _phase(phase_small)
    _phase(phase_small_train)
    _phase(phase_small_encoder)
    _phase(phase_small_loglin)
    _phase(phase_small_ssm)
    _phase(phase_small_hybrid_serve)
    _phase(phase_small_families)
    _phase(phase_small_families_train)
    _phase(phase_serve, launches, serve_times)
    _phase(phase_serve_loglin, launches, serve_times)
    _phase(phase_serve_softmax_ssm, launches, serve_times)
    _phase(phase_serve_dense, launches, serve_times)
    _phase(phase_serve_families, launches, serve_times)
    _phase(phase_contract, errs)
    _phase(phase_renorm, launches, serve_times)
    _phase(phase_instruments, errs)
    _phase(phase_train, launches, train_times)
    _phase(phase_encoder_train, launches, enc_times)
    _phase(phase_encoder_forward, launches, enc_times)
    _phase(phase_ssm_train, launches, train_times)
    _phase(phase_hybrid_train, launches, train_times)
    _phase(phase_train_families, launches, train_times)
    pool_times, ckpt_times = {}, {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        _phase(phase_small_pool, tmp)
        _phase(phase_pool, launches, pool_times, tmp)
        _phase(phase_ckpt_train, launches, ckpt_times, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _phase(phase_remat_dots, launches, train_times)
    spec_times = {}
    _phase(phase_spec, launches, spec_times)
    _phase(phase_spec_pool, launches, pool_times)
    mesh_times = {}
    _phase(phase_mesh, launches, mesh_times)
    _phase(phase_mesh_fake, launches)
    _phase(phase_mesh_families, launches, mesh_times)
    _phase(phase_mesh_pool, launches, mesh_times)
    _phase(phase_mesh_spec, launches, mesh_times)
    dry = {}
    _phase(phase_dryrun, dry)
    rows, decode_times = _phase(phase_timings, errs, launches)
    train_rows, fused_zamba2 = _phase(phase_timings_train, errs, launches)
    rows += train_rows
    enc_rows, block_diag_bidir = _phase(phase_timings_encoder, errs, launches)
    _phase(phase_timings_f4, errs, next(r for r in enc_rows
                                if r["name"] == "block_diag_bwd"))
    rows += enc_rows
    rows.append(_phase(phase_timings_loglin, errs, launches))
    ssd_row, ssd_zamba2, ssd_layer = _phase(phase_timings_ssd, errs, launches)
    rows.append(ssd_row)
    rows += _phase(phase_timings_hybrid_serve, errs, launches)
    rows += _phase(phase_timings_dense, errs, launches)
    rows += _phase(phase_timings_families, errs, launches)
    rows += _phase(phase_timings_families_train, errs, launches)
    log("serve times: " + json.dumps(serve_times))
    log("train times: " + json.dumps(train_times))
    log("encoder times: " + json.dumps(enc_times))
    log("block_diag (causal=False, encoder shapes): "
        + json.dumps(block_diag_bidir))
    log("lln_decode (rescale inside) and the parent's torch rescale: "
        + json.dumps(decode_times))
    log("ssd (zamba2-7b shape): " + json.dumps(ssd_zamba2))
    log("lln_diag_fused / lln_diag_fused_bwd (zamba2-7b shape): "
        + json.dumps(fused_zamba2))
    log("ops.ssd_scan per layer: " + json.dumps(ssd_layer))
    log("pool times: " + json.dumps(pool_times))
    log("speculative times: " + json.dumps(spec_times))
    log("checkpoint (roberta-lln train state): " + json.dumps(ckpt_times))
    log("mesh times: " + json.dumps(mesh_times))
    log("dryrun cells: " + json.dumps(dry))
    print(smi)
    print(json.dumps({"kernels": rows}))
    _print_ok()
    return 0


def _print_ok():
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _small_pool_in_tmp():
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_small_pool(Path(tmp))


def _main_selected(smi, only):
    """The check phases named in ``only``, each with fresh accumulators."""
    launches = collections.defaultdict(int)
    times, results = {}, {}
    table = {"spec": lambda: phase_spec(launches, times),
             "spec_pool": lambda: phase_spec_pool(launches, times),
             "small_pool": _small_pool_in_tmp,
             "kernels_families": lambda: phase_kernels_families(results),
             "small_families": phase_small_families,
             "serve_families": lambda: phase_serve_families(launches,
                                                            times),
             "kernels_families_train":
                 lambda: phase_kernels_families_train(results),
             "small_families_train": phase_small_families_train,
             "train_families": lambda: phase_train_families(launches,
                                                            times),
             "timings_families": lambda: log("kernels: " + json.dumps(
                 phase_timings_families(results, launches))),
             "timings_families_train": lambda: log("kernels: " + json.dumps(
                 phase_timings_families_train(results, launches))),
             "mesh": lambda: phase_mesh(launches, times),
             "mesh_fake": lambda: phase_mesh_fake(launches),
             "mesh_families": lambda: phase_mesh_families(launches, times),
             "mesh_pool": lambda: phase_mesh_pool(launches, times),
             "mesh_spec": lambda: phase_mesh_spec(launches, times),
             "dryrun": lambda: phase_dryrun(results)}
    unknown = only - set(table)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; known: "
                         f"{sorted(table)}")
    for name in sorted(only, key=list(table).index):
        t0 = time.time()
        table[name]()
        log(f"[{name}: {time.time() - t0:.1f}s; {time.time() - _T0:.1f}s "
            f"since the start]")
    log("launches: " + json.dumps(launches))
    log("times: " + json.dumps(times))
    if results:
        log("max abs errors: " + json.dumps(results))
    print(smi)
    _print_ok()
    return 0


if __name__ == "__main__":
    sys.exit(main())
