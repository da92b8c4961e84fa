#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device   - require CUDA, print the card's name and power limit, TF32 off;
  2. build    - compile the three CUDA kernels from src/repro_torch/csrc;
  3. kernels  - each kernel against its plain PyTorch version at full-width
                shapes (B=4, H=32, G=4, D=Dv=128, bf16 q/k/v);
  4. small    - yi-9b SMOKE in fp32: the kernels against the core reference;
  5. serve    - yi-9b at full width and depth (bf16 weights from a seed),
                attn_impl lln then lln_diag, batch 4, prompt 512, 32 greedy
                tokens, with launch counts read around each path;
  6. timings  - each kernel, its plain version and its bound at the serve
                shapes; prefill and decode times per impl.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
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
B, H, G, D = 4, 32, 4, 128    # yi-9b attention at the serve batch
N, BLK, GEN = 512, 256, 32    # prompt, diag block, generated tokens
SEED = 0


def log(*a):
    print(*a, flush=True)


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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def device_profile(fn):
    """Run ``fn`` under ``torch.profiler``; return (device ms, the five
    kernels with the most device time as (name, ms, calls)).  Device ms is
    0.0 where the profiler sees no device activity."""
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
    return sum(r[1] for r in rows), rows[:5]


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


def _inputs(n, gen):
    """Post-RoPE-like bf16 q/k/v (B, n, H|G, D) and moment-matched
    alpha/beta from the port's calibration."""
    from repro_torch.core.attention import batch_alpha_beta
    from repro_torch.kernels.registry import AttnSpec
    dev = "cuda"
    q = torch.randn(B, n, H, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, n, G, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, n, G, D, generator=gen, device=dev).bfloat16()
    alpha, beta = batch_alpha_beta(q, k, AttnSpec(impl="lln", r=H // G))
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
        results["lln_causal"] = max(results.get("lln_causal", 0.0), check(
            "out", got[0], want[0], bf16_tol(want[0])))
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


def _counts():
    from repro_torch.kernels.block_diag import block_diag
    from repro_torch.kernels.lln_attention import lln_causal, lln_decode
    return {"lln_causal": lln_causal, "block_diag": block_diag,
            "lln_decode": lln_decode}


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

        want_pre = {"lln_causal": cfg.n_layers, "lln_decode": 0,
                    "block_diag": cfg.n_layers if impl == "lln_diag" else 0}
        want_dec = {"lln_causal": 0, "block_diag": 0,
                    "lln_decode": cfg.n_layers * (GEN - 1)}
        log(f"{impl}: prefill launches {pre}, decode launches {dec}")
        if pre != want_pre or dec != want_dec:
            raise AssertionError(f"{impl}: launch counts {pre} / {dec}, "
                                 f"expected {want_pre} / {want_dec}")
        for name in launches:
            launches[name] += pre[name] + dec[name]
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
            for name, ms, calls in top:
                log(f"  top {label}: {ms:9.3f} ms  {calls:6d} calls  "
                    f"{name[:90]}")
        del setup, caches, plain


def phase_timings(errs, launches):
    """Each kernel, its plain version and (block_diag) one library call at
    the serve shapes; the bound counts each input read once, each output
    written once, and the fp32 operations the function needs."""
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

    nbytes = (bh * N * D * 4 + bg * N * D * 4 + bg * N * D * 2
              + bh * N * D * 2 + bh * D * D * 4 + bh * D * 4)
    flops = bh * N * (2 * D * D + 2 * D) + bg * N * (2 * D * D + D) \
        + (bh + bg) * N * D
    bnd, by = bound_ms(nbytes, flops)
    rows.append(dict(
        name="lln_causal", route="cuda",
        source="src/repro_torch/csrc/lln_causal.cu",
        replaces="src/repro/kernels/lln_attention.py:94",
        launches=launches["lln_causal"], max_abs_err=errs["lln_causal"],
        ms=cuda_ms(lambda: lln_causal(qs, ks, vk, r=r, blk=BLK)),
        plain_ms=cuda_ms(lambda: lln_causal_plain(qs, ks, vk, r=r, blk=BLK)),
        bound_ms=bnd, bound_by=by, library_ms=None))

    nb = N // BLK
    pairs = nb * BLK * (BLK + 1) // 2
    nbytes = 2 * (bh * N * D + bg * N * D + bg * N * D + bh * N * D)
    flops = bh * pairs * (2 * D + 2 * D + 1)
    bnd, by = bound_ms(nbytes, flops)

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


def main():
    smi = phase_device()
    phase_build()
    errs, serve_times = {}, {}
    launches = {name: 0 for name in ("lln_causal", "block_diag", "lln_decode")}
    phase_kernels(errs)
    phase_small()
    phase_serve(launches, serve_times)
    rows, rescale_ms = phase_timings(errs, launches)
    log("serve times: " + json.dumps(serve_times))
    log(f"decode_rescale_ms: {rescale_ms}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
