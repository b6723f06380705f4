"""Tagged metrics registry (palantir pkg/metrics analog).

Counters, gauges, and histograms keyed by (name, sorted tags).  The
reference's ~40 metric names (internal/metrics/metrics.go:30-68) are
declared in :mod:`.names`.
"""

from __future__ import annotations

import math
import random
import threading
from collections import defaultdict
from typing import Dict, List, Tuple

TagSet = Tuple[Tuple[str, str], ...]

# seeded per-histogram for reproducible quantiles in tests; the seed is
# fixed (not time-derived) so two runs over the same stream agree
_RESERVOIR_SEED = 0x5EED


def _tags(tags: Dict[str, str] | None) -> TagSet:
    return tuple(sorted((tags or {}).items()))


class Histogram:
    """Decaying-free simple histogram: count/sum/max/p50/p95/p99 over a
    bounded reservoir.

    Once the reservoir is full, replacement is Vitter's Algorithm R:
    the i-th update survives with probability cap/i, giving every update
    an equal chance of being in the sample — so quantiles estimate the
    whole stream.  (The previous ``count % cap`` overwrite kept only an
    arbitrary recent window, biasing quantiles toward whatever the last
    ~cap updates happened to be.)  max is tracked exactly, not sampled.
    """

    __slots__ = ("values", "count", "total", "maximum", "_cap", "_rng")

    def __init__(self, cap: int = 2048):
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self.maximum = 0.0
        self._cap = cap
        self._rng = random.Random(_RESERVOIR_SEED)

    def update(self, v: float) -> None:
        self.count += 1
        self.total += v
        if self.count == 1 or v > self.maximum:
            self.maximum = v
        if len(self.values) < self._cap:
            self.values.append(v)
        else:  # Algorithm R: keep with probability cap/count
            j = self._rng.randrange(self.count)
            if j < self._cap:
                self.values[j] = v

    def quantile(self, q: float) -> float:
        if not self.values:
            return 0.0
        s = sorted(self.values)
        idx = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
        return s[idx]

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean": (self.total / self.count) if self.count else 0.0,
            "p50": self.quantile(0.5),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "max": self.maximum if self.count else 0.0,
        }


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.RLock()
        self._counters: Dict[Tuple[str, TagSet], float] = defaultdict(float)
        self._gauges: Dict[Tuple[str, TagSet], float] = {}
        self._histograms: Dict[Tuple[str, TagSet], Histogram] = {}

    def counter(self, name: str, tags: Dict[str, str] | None = None, inc: float = 1.0) -> None:
        with self._lock:
            self._counters[(name, _tags(tags))] += inc

    def gauge(self, name: str, value: float, tags: Dict[str, str] | None = None) -> None:
        with self._lock:
            self._gauges[(name, _tags(tags))] = value

    def histogram(self, name: str, value: float, tags: Dict[str, str] | None = None) -> None:
        with self._lock:
            key = (name, _tags(tags))
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram()
            h.update(value)

    # -- introspection -------------------------------------------------------

    def get_counter(self, name: str, tags: Dict[str, str] | None = None) -> float:
        with self._lock:
            return self._counters.get((name, _tags(tags)), 0.0)

    def get_histogram(self, name: str, tags: Dict[str, str] | None = None) -> dict:
        with self._lock:
            h = self._histograms.get((name, _tags(tags)))
            return h.snapshot() if h else Histogram().snapshot()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {self._fmt(k): v for k, v in self._counters.items()},
                "gauges": {self._fmt(k): v for k, v in self._gauges.items()},
                "histograms": {
                    self._fmt(k): h.snapshot() for k, h in self._histograms.items()
                },
            }

    @staticmethod
    def _fmt(key: Tuple[str, TagSet]) -> str:
        name, tags = key
        if not tags:
            return name
        return name + "[" + ",".join(f"{k}={v}" for k, v in tags) + "]"


default_registry = MetricsRegistry()
