#!/usr/bin/env python3
"""The host cost of tracing the serve decode with ``torch.profiler``, on one
CUDA card.

Run from the repository root:

    python3 tools/profile_cost.py

yi-9b at full width with ``lln_diag`` (bf16 weights from a seed, batch 4,
prompt 512), at 12 and then 48 layers: four decode steps unprofiled, then
under the profiler with host and device activity and with device activity
only, twice each.  Per trace it prints the seconds of the traced run with
the profiler's stop, the seconds of ``key_averages()``, and the device ms
and kernel count summed over its device events; then an empty trace's.
"""
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def prof(fn, acts):
    t0 = time.time()
    with profile(activities=acts) as p:
        fn()
        torch.cuda.synchronize()
    t1 = time.time()
    ka = p.key_averages()
    dev = 0.0
    n = 0
    for e in ka:
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        dev += us / 1e3
        n += e.count
    t2 = time.time()
    return t1 - t0, t2 - t1, dev, n


def main():
    cs.phase_device()
    cs.phase_build()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.models import synthetic_batch
    for nl in (12, 48):
        cfg = get_config("yi-9b", attn_impl="lln_diag",
                         param_dtype="bfloat16", n_layers=nl)
        s = make_serve_setup(cfg, ShapeSpec("c", 600, 4, "decode"))
        params = s.model.init(0)
        batch = synthetic_batch(cfg, 4, 600, seed=0, text_seq=512,
                                device="cuda")
        logits, caches = s.prefill_fn(params, batch)
        tok = torch.argmax(logits[:, -1], -1)

        def gen():
            return s.make_generate(4)(params, caches, tok, 512)
        gen()
        torch.cuda.synchronize()
        t0 = time.time()
        gen()
        torch.cuda.synchronize()
        print(nl, "plain wall", time.time() - t0, flush=True)
        both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        for name, acts in (("cpu+cuda", both),
                           ("cuda", [ProfilerActivity.CUDA]),
                           ("cpu+cuda again", both),
                           ("cuda again", [ProfilerActivity.CUDA])):
            r = prof(gen, acts)
            print(nl, name, "run+stop %.2f s, key_averages %.2f s, device "
                  "%.3f ms, %d kernels" % r, flush=True)
        print(nl, "empty", prof(lambda: None, both), flush=True)
        del s, params, caches
        torch.cuda.empty_cache()
    print(cs.phase_device())


if __name__ == "__main__":
    main()
