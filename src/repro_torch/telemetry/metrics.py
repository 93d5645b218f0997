"""Metrics registry: counters, gauges, log-bucket histograms, as
``repro.telemetry.metrics`` (the same bucket edges and quantile rule, so
the same observations give the same quantiles).

``EngineStats`` and ``PipelineStats`` keep their fields here:

  * :class:`Counter`  — monotone-by-convention total (``add``);
  * :class:`Gauge`    — instantaneous level with an atomically-tracked
    high-water mark (``adjust``/``set`` update value AND high under the
    registry lock, so a concurrent reader can never observe a level
    above the recorded high — the queue-depth bug class);
  * :class:`Histogram`— fixed log-scale buckets: ``observe`` costs one
    ``log``-free bisect, p50/p99 come straight off the bucket counts,
    and NO samples are ever stored, so a week of serving costs the same
    memory as a minute.

All mutation goes through one registry-level lock: metric updates are a
few nanoseconds of bookkeeping, never device syncs, so a shared lock is
cheaper than per-metric locks and keeps ``snapshot()`` a consistent cut
across every metric at once.
"""
from __future__ import annotations

import bisect
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0

    def add(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def set(self, v):
        """Direct (re)set: the write path of the stats classes' field
        properties (``stats.field += 1``, always under the caller's stats
        lock; a bare read-modify-write would race)."""
        with self._lock:
            self._value = v

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    __slots__ = ("name", "_lock", "_value", "_high")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0
        self._high = 0

    def adjust(self, delta):
        """Atomic level change; the high-water mark updates under the
        same lock, so it can never under-report a peak two threads built
        together."""
        with self._lock:
            self._value += delta
            if self._value > self._high:
                self._high = self._value
            return self._value

    def set(self, v):
        with self._lock:
            self._value = v
            if v > self._high:
                self._high = v

    def note_high(self, v):
        """Seed/extend the high-water mark without touching the level."""
        with self._lock:
            if v > self._high:
                self._high = v

    @property
    def value(self):
        return self._value

    @property
    def high(self):
        return self._high

    def to_dict(self) -> dict:
        return {"type": "gauge", "value": self._value, "high": self._high}


class Histogram:
    """Fixed log-scale buckets over (0, inf).

    Bucket upper edges form a geometric ladder from `lo` to `hi` with
    `per_decade` buckets per factor of 10 (plus an underflow bucket
    below `lo` and an overflow bucket above `hi`). Quantiles interpolate
    within the containing bucket, so p50/p99 are exact to one bucket
    width (~±12% at the default 8/decade) with zero sample storage.
    """

    __slots__ = ("name", "_lock", "edges", "counts", "_n", "_sum")

    def __init__(self, name: str, lock: threading.Lock, *,
                 lo: float = 1.0, hi: float = 1e8, per_decade: int = 8):
        if not (lo > 0 and hi > lo and per_decade >= 1):
            raise ValueError("need 0 < lo < hi and per_decade >= 1")
        self.name = name
        self._lock = lock
        n = int(math.ceil(math.log10(hi / lo) * per_decade))
        ratio = 10.0 ** (1.0 / per_decade)
        self.edges = [lo * ratio ** i for i in range(n + 1)]   # upper edges
        self.counts = [0] * (n + 2)                            # +under/over
        self._n = 0
        self._sum = 0.0

    def observe(self, x: float):
        # counts[0] = underflow (x <= lo); counts[j] covers
        # (edges[j-1], edges[j]]; counts[-1] = overflow (x > hi)
        i = 0 if x <= self.edges[0] else \
            min(bisect.bisect_left(self.edges, x), len(self.counts) - 1)
        with self._lock:
            self.counts[i] += 1
            self._n += 1
            self._sum += x

    @property
    def count(self) -> int:
        return self._n

    @property
    def total(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._n if self._n else 0.0

    def quantile(self, q: float) -> float:
        """Approximate q-quantile from bucket counts (upper-edge linear
        interpolation; underflow reports `lo`, overflow `hi`)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q={q} outside [0, 1]")
        with self._lock:
            n, counts = self._n, list(self.counts)
        if n == 0:
            return 0.0
        rank = q * n
        acc = 0.0
        for i, c in enumerate(counts):
            if acc + c >= rank and c > 0:
                if i == 0:
                    return self.edges[0]
                if i == len(counts) - 1:
                    return self.edges[-1]
                lo_edge = self.edges[i - 1]
                hi_edge = self.edges[i]
                frac = (rank - acc) / c
                return lo_edge + (hi_edge - lo_edge) * min(max(frac, 0.0), 1.0)
            acc += c
        return self.edges[-1]

    def to_dict(self) -> dict:
        return {"type": "histogram", "count": self._n, "sum": self._sum,
                "p50": self.quantile(0.5), "p90": self.quantile(0.9),
                "p99": self.quantile(0.99),
                "buckets": {"edges": self.edges, "counts": list(self.counts)}}


class MetricsRegistry:
    """Named get-or-create metric registry; one lock for all mutation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, self._lock, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-ready {name: metric dict} consistent cut."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.to_dict() for name, m in sorted(items)}
