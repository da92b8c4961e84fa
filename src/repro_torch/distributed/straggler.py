"""Straggler detection: per-step wall-clock watchdog (a copy of
``repro.distributed.straggler``, pure Python).

EWMA + k*MAD anomaly detector over step times; ``on_anomaly`` is called
with a :class:`StragglerReport`, and every report is kept in
``anomalies``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerReport:
    step: int
    duration: float
    expected: float
    ratio: float


class StepWatchdog:
    def __init__(self, *, alpha: float = 0.1, k: float = 5.0,
                 warmup_steps: int = 3,
                 on_anomaly: Optional[Callable[[StragglerReport], None]] = None):
        self.alpha = alpha
        self.k = k
        self.warmup = warmup_steps
        self.on_anomaly = on_anomaly
        self.ewma: Optional[float] = None
        self.mad: float = 0.0
        self.count = 0
        self.anomalies: list[StragglerReport] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> Optional[StragglerReport]:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        dt = time.monotonic() - self._t0
        self._t0 = None
        self.count += 1
        if self.ewma is None:
            self.ewma, self.mad = dt, dt * 0.1
            return None
        report = None
        threshold = self.ewma + self.k * max(self.mad, 1e-4)
        if self.count > self.warmup and dt > threshold:
            report = StragglerReport(step=step, duration=dt,
                                     expected=self.ewma,
                                     ratio=dt / max(self.ewma, 1e-9))
            self.anomalies.append(report)
            if self.on_anomaly:
                self.on_anomaly(report)
        else:
            # Only track the healthy population so anomalies don't poison
            # the baseline.
            self.mad = (1 - self.alpha) * self.mad + \
                self.alpha * abs(dt - self.ewma)
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return report
