"""Tagged metrics registry (palantir pkg/metrics analog).

Counters, gauges, and histograms keyed by (name, sorted tags).  The
reference's ~40 metric names (internal/metrics/metrics.go:30-68) are
declared in :mod:`.names`; periodic reporters live in
:mod:`.reporters`.
"""

from __future__ import annotations

import math
import random
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

from ..tracing.spans import current_trace_id

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

    __slots__ = ("values", "count", "total", "maximum", "_cap", "_rng", "exemplar")

    def __init__(self, cap: int = 2048):
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self.maximum = 0.0
        self._cap = cap
        self._rng = random.Random(_RESERVOIR_SEED)
        # (trace_id, observed value) of the most recent observation made
        # inside an active trace — the OpenMetrics exemplar linking PR 1
        # spans to this series (metrics/prometheus.py render_openmetrics)
        self.exemplar: Tuple[str, float] | None = None

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
        # trace correlation read OUTSIDE the registry lock (a contextvar
        # read — ~100ns; None whenever no span is active, e.g. direct
        # library use or background reporters)
        trace_id = current_trace_id()
        with self._lock:
            key = (name, _tags(tags))
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram()
            h.update(value)
            if trace_id is not None:
                h.exemplar = (trace_id, float(value))

    def timer(self, name: str, tags: Dict[str, str] | None = None):
        """Context manager recording elapsed seconds into a histogram."""
        registry = self

        class _Timer:
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                registry.histogram(name, time.perf_counter() - self._t0, tags)
                return False

        return _Timer()

    # -- introspection -------------------------------------------------------

    def get_counter(self, name: str, tags: Dict[str, str] | None = None) -> float:
        with self._lock:
            return self._counters.get((name, _tags(tags)), 0.0)

    def get_gauge(self, name: str, tags: Dict[str, str] | None = None) -> float | None:
        with self._lock:
            return self._gauges.get((name, _tags(tags)))

    def get_histogram(self, name: str, tags: Dict[str, str] | None = None) -> dict:
        with self._lock:
            h = self._histograms.get((name, _tags(tags)))
            return h.snapshot() if h else Histogram().snapshot()

    def prune_gauges(self, name: str, keep: "set | None" = None) -> int:
        """Drop every gauge series under ``name`` whose tag dict is not
        in ``keep`` (an iterable of tag dicts; None = drop all).  For
        emitters whose label sets track external state — e.g. the
        capacity observatory's per-(shape, group, zone) headroom — so a
        vanished label combination stops exporting its last stale value
        and live cardinality stays bounded by the emitter's own caps."""
        keep_keys = {_tags(t) for t in keep} if keep is not None else set()
        with self._lock:
            dead = [
                k
                for k in self._gauges
                if k[0] == name and k[1] not in keep_keys
            ]
            for k in dead:
                del self._gauges[k]
            return len(dead)

    def series_stats(self) -> Dict[str, int]:
        """Per-metric-name label-set cardinality across counters,
        gauges, and histograms — the registry's own label-explosion
        canary (reported as …tpu.metrics.registry.series)."""
        with self._lock:
            counts: Dict[str, int] = {}
            for store in (self._counters, self._gauges, self._histograms):
                for name, _tags_key in store:
                    counts[name] = counts.get(name, 0) + 1
            return counts

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {self._fmt(k): v for k, v in self._counters.items()},
                "gauges": {self._fmt(k): v for k, v in self._gauges.items()},
                "histograms": {
                    self._fmt(k): h.snapshot() for k, h in self._histograms.items()
                },
            }

    def collect(self) -> dict:
        """Structured (name, tags) → value dump for exposition formats
        that need tags as labels, not baked into the name string
        (metrics/prometheus.py).  Histograms include the running sum so
        summaries can expose ``_sum``."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    k: dict(h.snapshot(), sum=h.total, exemplar=h.exemplar)
                    for k, h in self._histograms.items()
                },
            }

    @staticmethod
    def _fmt(key: Tuple[str, TagSet]) -> str:
        name, tags = key
        if not tags:
            return name
        return name + "[" + ",".join(f"{k}={v}" for k, v in tags) + "]"


default_registry = MetricsRegistry()
