"""Straggler mitigation: per-step wall-time monitor with robust outlier
detection, plus the mitigation hooks a 1000-node deployment needs (the
reference's ``repro.train.straggler``, copied: it is plain Python).

A step time on a CUDA card is a host time: synchronize the device before
``stop``, or the time is the host's enqueue of the step.

On a real multi-host pod the per-host step time is implicitly synchronized
by the first collective, so a straggling host shows up as a global
step-time spike; the monitor keeps a rolling window, flags steps beyond
``threshold`` x median (p99-style detection without assuming a
distribution), and recommends an action:

  * "warn"       — isolated spike (logged)
  * "checkpoint" — sustained slowdown: snapshot now, so the scheduler can
                   evict/replace the slow host cheaply
  * "rebalance"  — persistent slowdown: trigger elastic restore onto a
                   mesh without the sick host (checkpoint manager +
                   elastic resharding make this a restart, not a rewrite)
"""
from __future__ import annotations

import collections
import time


class StragglerMonitor:
    def __init__(self, window: int = 50, threshold: float = 2.0,
                 sustained: int = 5):
        self.window = window
        self.threshold = threshold
        self.sustained = sustained
        self.times = collections.deque(maxlen=window)
        self.slow_streak = 0
        self.events: list[dict] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int):
        """Record a step; returns an action string or None."""
        dt = time.perf_counter() - self._t0
        action = None
        if len(self.times) >= 10:
            srt = sorted(self.times)
            med = srt[len(srt) // 2]
            if dt > self.threshold * med:
                self.slow_streak += 1
                if self.slow_streak >= self.sustained:
                    action = "rebalance"
                elif self.slow_streak >= 2:
                    action = "checkpoint"
                else:
                    action = "warn"
                self.events.append({"step": step, "dt": dt, "median": med,
                                    "action": action})
            else:
                self.slow_streak = 0
        self.times.append(dt)
        return action

    def summary(self):
        if not self.times:
            return {}
        srt = sorted(self.times)
        n = len(srt)
        return {"n": n, "median_s": srt[n // 2],
                "p99_s": srt[min(int(n * 0.99), n - 1)],
                "events": len(self.events)}
