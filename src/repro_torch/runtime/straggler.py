"""Straggler detection from per-step timing statistics: port copy of
``repro.runtime.straggler``.

At 1000+ nodes the slowest participant sets the synchronous step time; the
first mitigation is *measurement*.  A ring buffer of step durations flags
outliers against a robust (median/MAD) baseline; per-host timings (when
provided) identify *which* host lags.  Mitigation hooks:

  * report() feeds the job log / dashboard,
  * `on_straggler` can trigger data-shard re-balancing or host eviction
    (the trainer wires this; default logs).
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import numpy as np


class StragglerMonitor:
    def __init__(self, *, window: int = 64, threshold: float = 2.0,
                 on_straggler: Optional[Callable[[dict], None]] = None):
        self.window = window
        self.threshold = threshold
        self.times = collections.deque(maxlen=window)
        self.host_times: dict[int, collections.deque] = {}
        self.on_straggler = on_straggler
        self.events = []

    def record(self, step: int, duration_s: float,
               per_host: Optional[dict] = None):
        self.times.append(duration_s)
        if per_host:
            for host, t in per_host.items():
                self.host_times.setdefault(
                    host, collections.deque(maxlen=self.window)).append(t)
        if len(self.times) >= 8:
            med = float(np.median(self.times))
            mad = float(np.median(np.abs(np.asarray(self.times) - med)))
            limit = med + self.threshold * max(3 * mad, 0.1 * med)
            if duration_s > limit:
                event = {"step": step, "duration": duration_s,
                         "median": med, "limit": limit,
                         "slow_hosts": self._slow_hosts()}
                self.events.append(event)
                if self.on_straggler:
                    self.on_straggler(event)

    def _slow_hosts(self):
        out = []
        if not self.host_times:
            return out
        meds = {h: float(np.median(t)) for h, t in self.host_times.items()}
        overall = float(np.median(list(meds.values())))
        for h, m in meds.items():
            if m > self.threshold * overall:
                out.append(h)
        return out

    def report(self) -> dict:
        arr = np.asarray(self.times) if self.times else np.zeros(1)
        return {
            "steps_tracked": len(self.times),
            "median_s": float(np.median(arr)),
            "p95_s": float(np.percentile(arr, 95)),
            "events": len(self.events),
            "slow_hosts": self._slow_hosts(),
        }
