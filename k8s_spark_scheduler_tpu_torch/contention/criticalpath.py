"""Critical-path extraction — "where does the millisecond go"; a copy
of the reference package's ``contention/criticalpath.py``.

Walks every completed request trace (a :class:`tracing.spans.Tracer`
observer fires on root-span exit) and decomposes end-to-end handler
latency into named gating segments:

- ``gate-queue``  — admission-gate entry wait (``gateWaitMs`` root tag)
- ``lock-wait``   — extender predicate-lock wait (``lockWaitMs`` root
  tag, stamped by the lock's ``TimedLock`` wrapper while the request's
  root span is active)
- ``serde``       — request read/decode + response encode spans
- ``solve``       — the predicate span tree: snapshot build, FIFO gate,
  binpack/kernel time
- ``write-back``  — reservation/state write-back spans
- ``other``       — the unattributed remainder (kept explicit so the
  decomposition always sums to the request, and so a growing "other"
  is itself a finding)

Attribution is *exclusive* (self-time): each span's duration minus its
children is charged to the nearest classified ancestor, so nothing is
counted twice and the segments plus ``other`` reconstruct the root
duration exactly.  The two synthetic gap segments (gate-queue,
lock-wait) happen between spans — they are carved out of the root's
self-time using the tags measured at the wait sites.

Per-request records land in a bounded ring served by
``GET /debug/criticalpath``; per-segment histograms and the coverage
ratio (attributed / total) go to the metrics registry.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

from ..analysis.guarded import guarded_by

# span name -> segment; spans with unlisted names inherit the nearest
# classified ancestor's segment (descendants of "predicate" therefore
# default to "solve": deltasolve.*, kernel:*, fast_path.* and the other
# helper spans)
SPAN_SEGMENTS: Dict[str, str] = {
    "http.read": "serde",
    "serde.decode": "serde",
    "serde.encode": "serde",
    "predicate": "solve",
    "reconcile": "solve",
    "fifo_gate": "solve",
    "binpack": "solve",
    "fast_path.build_tensor": "solve",
    "executor.fast_reschedule": "solve",
    # the reference's concurrent engine's speculative solve, which runs
    # before the lock; this package has no such engine yet (ROADMAP
    # A.4), and keeps the segment so the bodies match the reference's
    "speculation.solve": "speculate",
    "reservation.writeback": "write-back",
    "state.writeback.enqueue": "write-back",
}

SEGMENT_NAMES = (
    "gate-queue", "lock-wait", "serde", "solve", "speculate", "write-back",
    "other",
)


def decompose(root) -> Optional[Dict[str, Any]]:
    """One request's segment decomposition, or None for traces that are
    not scheduling requests (or carry no measurable duration — e.g.
    traces whose clock never advanced)."""
    if root.name == "http.request":
        if root.tags.get("path") != "/predicates":
            return None
    elif root.name != "predicate":
        return None
    total_ms = (root.duration or 0.0) * 1000.0
    if total_ms <= 0.0:
        return None
    segments = {name: 0.0 for name in SEGMENT_NAMES}

    def walk(span, inherited: str) -> None:
        segment = SPAN_SEGMENTS.get(span.name, inherited)
        duration_ms = (span.duration or 0.0) * 1000.0
        children_ms = 0.0
        for child in span.children:
            children_ms += (child.duration or 0.0) * 1000.0
            walk(child, segment)
        segments[segment] += max(duration_ms - children_ms, 0.0)

    walk(root, "other")
    # the synthetic gap segments: measured at the wait sites, carved
    # out of the root self-time where those waits actually happened
    gate_ms = float(root.tags.get("gateWaitMs") or 0.0)
    lock_ms = float(root.tags.get("lockWaitMs") or 0.0)
    segments["gate-queue"] = gate_ms
    segments["lock-wait"] = lock_ms
    segments["other"] = max(segments["other"] - gate_ms - lock_ms, 0.0)
    attributed = total_ms - segments["other"]
    dominant = max(segments, key=lambda name: segments[name])
    return {
        "traceId": root.trace_id,
        "startTime": root.start_time,
        "totalMs": round(total_ms, 4),
        "segments": {name: round(ms, 4) for name, ms in segments.items()},
        "coverage": round(min(max(attributed / total_ms, 0.0), 1.0), 4),
        "dominant": dominant,
        "outcome": root.tags.get("outcome", ""),
    }


def _pct(ordered: List[float], q: float) -> float:
    if not ordered:
        return 0.0
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


@guarded_by("_lock", "_ring", "_dominant_counts", "_requests")
class CriticalPathAnalyzer:
    """Tracer observer + bounded per-request ring + metric emission.

    ``on_trace`` runs on the request thread at root-span exit (outside
    the tracer's ring lock) — the walk is O(#spans) over a tree that is
    already in cache, and metric recording happens outside this
    object's own lock."""

    def __init__(self, metrics=None, capacity: int = 256):
        self._metrics = metrics
        self._ring: deque = deque(maxlen=capacity)
        self._dominant_counts: Dict[str, int] = {}
        self._requests = 0
        self._lock = threading.Lock()

    def on_trace(self, root) -> None:
        record = decompose(root)
        if record is None:
            return
        with self._lock:
            self._requests += 1
            self._ring.append(record)
            self._dominant_counts[record["dominant"]] = (
                self._dominant_counts.get(record["dominant"], 0) + 1
            )
        metrics = self._metrics
        if metrics is not None:
            from ..metrics import names as M

            for name, ms in record["segments"].items():
                metrics.histogram(
                    M.CRITICALPATH_SEGMENT_TIME,
                    ms / 1000.0,
                    {M.TAG_SEGMENT: name},
                )
            metrics.histogram(M.CRITICALPATH_COVERAGE, record["coverage"])
            metrics.counter(
                M.CRITICALPATH_DOMINANT_COUNT,
                {M.TAG_SEGMENT: record["dominant"]},
            )

    # -- read side -------------------------------------------------------------

    def recent(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._ring)
        out.reverse()
        if limit is not None:
            out = out[: max(limit, 0)]
        return out

    def summary(self) -> Dict[str, Any]:
        """Percentile decomposition over the ring: per-segment p50/p95/
        p99/mean plus total and coverage — the /debug/criticalpath
        payload head."""
        with self._lock:
            records = list(self._ring)
            requests = self._requests
            dominant = dict(self._dominant_counts)
        totals = sorted(r["totalMs"] for r in records)
        coverages = sorted(r["coverage"] for r in records)
        segments: Dict[str, Dict[str, float]] = {}
        for name in SEGMENT_NAMES:
            values = sorted(r["segments"][name] for r in records)
            segments[name] = {
                "p50Ms": round(_pct(values, 0.50), 4),
                "p95Ms": round(_pct(values, 0.95), 4),
                "p99Ms": round(_pct(values, 0.99), 4),
                "meanMs": round(sum(values) / len(values), 4) if values else 0.0,
            }
        return {
            "requests": requests,
            "window": len(records),
            "totalMs": {
                "p50": round(_pct(totals, 0.50), 4),
                "p95": round(_pct(totals, 0.95), 4),
                "p99": round(_pct(totals, 0.99), 4),
            },
            "coverage": {
                "p50": round(_pct(coverages, 0.50), 4),
                "min": round(coverages[0], 4) if coverages else 0.0,
            },
            "segments": segments,
            "dominant": dominant,
        }
