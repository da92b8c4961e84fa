"""The port's optimizer, schedules, data pipeline and straggler watchdog,
held against the JAX reference.

Inputs are made with numpy from a seed and fed to both sides.  Tolerances:
AdamW parameters and moments within 1e-6 relative to the largest entry
(fp32, the same operations in the same order); schedules within 1e-7 of
the peak; the synthetic batches and the watchdog's decisions exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import lm_batches as j_lm_batches
from repro.optim import adamw as j_adamw
from repro.optim import schedules as j_sched
from repro_torch.data import (HostShardedSource, Prefetcher, lm_batches,
                              torch_placer)
from repro_torch.distributed.straggler import StepWatchdog
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, global_norm,
                               warmup_cosine, warmup_linear)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("clip", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_adamw_matches_reference_over_steps(clip):
    cfg = AdamWConfig(clip_norm=clip)
    jcfg = j_adamw.AdamWConfig(clip_norm=clip)
    params = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = j_adamw.adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = adamw_init(tp)
    for step in range(4):
        grads = _tree(10 + step)
        lr = 1e-2 * (step + 1)
        jp, js, jm = j_adamw.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, js, jp,
            jnp.float32(lr), jcfg)
        _, ts, tm = adamw_update({k: torch.from_numpy(v)
                                  for k, v in grads.items()}, ts, tp,
                                 torch.tensor(lr), cfg)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-6 * float(jm["grad_norm"])
        for name in params:
            for got, want in ((tp[name], jp[name]), (ts["m"][name],
                                                     js["m"][name]),
                              (ts["v"][name], js["v"][name])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=1e-6 * max(1e-3, float(np.abs(want).max())))
    assert int(ts["step"]) == int(js["step"]) == 4


def test_clip_and_norm_keep_dtypes():
    grads = {"a": torch.full((3,), 2.0, dtype=torch.bfloat16),
             "b": torch.full((4,), 1.0)}
    norm = float(global_norm(grads))
    assert norm == pytest.approx(np.sqrt(3 * 4.0 + 4 * 1.0))
    clipped, n2 = clip_by_global_norm(grads, 1.0)
    assert float(n2) == pytest.approx(norm)
    assert clipped["a"].dtype == torch.bfloat16
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-2)


@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_linear"])
def test_schedules_match_reference(name):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = float(globals()[name](torch.tensor(step), **kw))
        want = float(getattr(j_sched, name)(step, **kw))
        assert abs(got - want) <= 1e-7 * kw["peak_lr"], (step, got, want)


def test_lm_batches_equal_the_reference():
    a, b = lm_batches(512, 3, 17, seed=5), j_lm_batches(512, 3, 17, seed=5)
    for _ in range(2):
        x, y = next(a), next(b)
        for key in ("inputs", "targets", "mask"):
            np.testing.assert_array_equal(x[key], y[key])
    assert np.array_equal(x["inputs"][:, 1:], x["targets"][:, :-1])


def test_host_sharding_prefetch_and_placement():
    """Two hosts draw disjoint deterministic slices; the prefetcher hands
    them on in order, placed as int64 tokens and fp32 masks."""
    def gen(b, s):
        return lm_batches(64, b, 8, seed=s)
    src = [HostShardedSource(gen, 4, process_index=i, process_count=2)
           for i in range(2)]
    assert [s.local_batch for s in src] == [2, 2]
    want = next(lm_batches(64, 2, 8, seed=1))
    pipe = Prefetcher(src[1], place=torch_placer("cpu"))
    try:
        got = next(pipe)
    finally:
        pipe.close()
    assert got["inputs"].dtype == torch.int64
    assert got["mask"].dtype == torch.float32
    np.testing.assert_array_equal(got["inputs"].numpy(), want["inputs"])
    with pytest.raises(ValueError, match="split"):
        HostShardedSource(gen, 3, process_index=0, process_count=2)


def test_watchdog_flags_a_straggler(monkeypatch):
    clock = iter([0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 4.0, 4.0, 14.0])
    monkeypatch.setattr("repro_torch.distributed.straggler.time.monotonic",
                        lambda: next(clock))
    seen = []
    wd = StepWatchdog(warmup_steps=3, on_anomaly=seen.append)
    for step in range(5):
        wd.start()
        wd.stop(step)
    assert [r.step for r in wd.anomalies] == [4] and seen == wd.anomalies
    assert wd.anomalies[0].ratio == pytest.approx(10.0)
    with pytest.raises(RuntimeError):
        wd.stop(5)
