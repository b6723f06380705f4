"""Spans, trace assembly, and the bounded completed-trace ring.

One trace per scheduling request: the HTTP layer opens the root span
(``http.request``), the extender and the solvers open children, and
when the root closes the finished tree is serialized into the tracer's
ring where ``GET /traces`` reads it.

The active span is a module-level ``ContextVar`` — per-thread in the
threaded HTTP server (each request handler thread has its own context),
and shared across tracer instances so ``events.events`` and log lines
can stamp the current ``trace_id`` without any plumbing.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import deque
from contextvars import ContextVar
from typing import Any, Dict, List, Optional, Tuple

from .. import timesource
from ..analysis.guarded import guarded_by

# the single active-span slot shared by every Tracer (see module doc)
_CURRENT: ContextVar[Optional["Span"]] = ContextVar(
    "k8s_spark_scheduler_tpu_torch_current_span", default=None
)

_SPAN_SEQ = itertools.count(1)


def current_span() -> Optional["Span"]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    span = _CURRENT.get()
    return span.trace_id if span is not None else None


def add_tag(key: str, value: Any) -> None:
    """Tag the active span, if any — safe to call from untraced code."""
    span = _CURRENT.get()
    if span is not None:
        span.tags[key] = value


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def child_span(name: str, tags: Optional[Dict[str, Any]] = None):
    """Span attached to the active trace, or the shared no-op when none
    is active — for library layers (state caches, solvers) that must
    observe request traces but never start root traces of their own."""
    parent = _CURRENT.get()
    if parent is None:
        return NOOP_SPAN
    span = Span(name, parent.trace_id, parent)
    parent.children.append(span)
    if tags:
        span.tags.update(tags)
    return span


class Span:
    """One timed phase.  Children attach at creation; duration lands at
    context-manager exit.  Not a dataclass: __slots__ + plain attribute
    writes keep per-span cost to a few hundred ns."""

    __slots__ = (
        "name",
        "trace_id",
        "span_id",
        "parent",
        "start_time",
        "duration",
        "tags",
        "children",
        "_t0",
        "_token",
        "_tracer",
    )

    def __init__(self, name: str, trace_id: str, parent: Optional["Span"]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = format(next(_SPAN_SEQ), "x")
        self.parent = parent
        self.start_time = 0.0
        self.duration: Optional[float] = None
        self.tags: Dict[str, Any] = {}
        self.children: List[Span] = []
        self._t0 = 0.0
        self._token = None
        self._tracer: Optional["Tracer"] = None

    def tag(self, key: str, value: Any) -> "Span":
        self.tags[key] = value
        return self

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "spanId": self.span_id,
            "parentId": self.parent.span_id if self.parent is not None else None,
            "startTime": self.start_time,
            "durationMs": round((self.duration or 0.0) * 1000.0, 4),
            "tags": dict(self.tags),
        }
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    # -- context manager ------------------------------------------------------

    def __enter__(self) -> "Span":
        # semantic instant, not latency: virtual-clock traces carry virtual time
        self.start_time = timesource.now()
        self._token = _CURRENT.set(self)
        # duration through the same pluggable source family: a virtual-clock
        # trace must not mix virtual timestamps with wall durations
        self._t0 = timesource.perf()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.duration = timesource.perf() - self._t0
        if exc is not None and "error" not in self.tags:
            self.tags["error"] = f"{type(exc).__name__}: {exc}"
        if self._token is not None:
            _CURRENT.reset(self._token)
        if self.parent is None and self._tracer is not None:
            self._tracer._finish_trace(self)
        return False


class _NoopSpan:
    """Shared do-nothing span: returned by disabled tracers so call
    sites never branch.  tag()/attribute writes are swallowed."""

    __slots__ = ()
    trace_id = None
    span_id = None
    tags: Dict[str, Any] = {}

    def tag(self, key: str, value: Any) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


@guarded_by("_lock", "_ring", "_finished")
class Tracer:
    """Span factory + bounded ring of completed traces.

    ``span(name)`` opens a child of the active span, or a new root (and
    therefore a new trace) when none is active.  When a root span exits,
    the whole tree is serialized and appended to the ring; optionally
    every span's duration is recorded as a tagged histogram so /metrics
    carries per-phase latency distributions without reading traces.
    """

    def __init__(
        self,
        capacity: int = 256,
        enabled: bool = True,
        metrics=None,
        record_span_metrics: bool = True,
    ):
        self.enabled = enabled
        self._ring: deque = deque(maxlen=capacity)
        # total completed traces ever — cursor for completed_since();
        # the ring holds the most recent len(_ring) of them
        self._finished = 0
        self._lock = threading.Lock()
        self._metrics = metrics
        self._record_span_metrics = record_span_metrics
        # trace-completion observers (the critical-path analyzer):
        # called with the live root Span after the tree lands in the
        # ring, outside the ring lock.  Wiring-time append only.
        self._observers: list = []

    # -- span creation --------------------------------------------------------

    def span(
        self,
        name: str,
        tags: Optional[Dict[str, Any]] = None,
        trace_id: Optional[str] = None,
    ):
        """Context manager for one phase.  ``trace_id`` is honored only
        when this span starts a new trace (no active parent)."""
        if not self.enabled:
            return NOOP_SPAN
        parent = _CURRENT.get()
        if parent is not None:
            span = Span(name, parent.trace_id, parent)
            parent.children.append(span)
        else:
            span = Span(name, trace_id or new_trace_id(), None)
            span._tracer = self
        if tags:
            span.tags.update(tags)
        return span

    # -- completed traces -----------------------------------------------------

    def _finish_trace(self, root: Span) -> None:
        trace = {
            "traceId": root.trace_id,
            "startTime": root.start_time,
            "durationMs": round((root.duration or 0.0) * 1000.0, 4),
            "root": root.to_dict(),
        }
        with self._lock:
            self._ring.append(trace)
            self._finished += 1
        if self._metrics is not None and self._record_span_metrics:
            from ..metrics import names as mnames

            stack = [root]
            while stack:
                span = stack.pop()
                self._metrics.histogram(
                    mnames.TRACE_SPAN_TIME,
                    span.duration or 0.0,
                    {mnames.TAG_SPAN: span.name},
                )
                stack.extend(span.children)
        for observer in self._observers:
            try:
                observer(root)
            except Exception:  # an observer must never break a request
                pass

    def add_observer(self, fn) -> None:
        """Register a trace-completion callback ``fn(root_span)``.
        Call at wiring time only — the list is read unlocked."""
        self._observers.append(fn)

    @property
    def completed_total(self) -> int:
        """Total traces ever completed (monotonic drain cursor)."""
        with self._lock:
            return self._finished

    def completed_since(self, cursor: int) -> Tuple[List[dict], int]:
        """Traces completed after ``cursor`` (oldest first, truncated
        to the ring's reach) and the new cursor value.  Pull-based
        alternative to add_observer, for consumers that must never run
        inside a request: the lifecycle
        ledger drains here off-thread, because for direct predicate
        calls the root span closes while the predicate lock is still
        held."""
        with self._lock:
            total = self._finished
            fresh = total - cursor
            if fresh <= 0:
                return [], total
            n = min(fresh, len(self._ring))
            if n == 0:
                return [], total
            out = list(self._ring)[-n:]
        return out, total

    def traces(self, limit: Optional[int] = None) -> List[dict]:
        """Completed traces, newest first."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        if limit is not None:
            out = out[: max(limit, 0)]
        return out

    def find_by_tag(self, key: str, value: Any) -> Optional[dict]:
        """Newest completed trace with ``tags[key] == value`` on any
        span in the tree."""
        for trace in self.traces():
            if _tree_has_tag(trace["root"], key, value):
                return trace
        return None

    def find_by_trace_id(self, trace_id: str) -> Optional[dict]:
        for trace in self.traces():
            if trace["traceId"] == trace_id:
                return trace
        return None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def _tree_has_tag(span_dict: dict, key: str, value: Any) -> bool:
    if span_dict.get("tags", {}).get(key) == value:
        return True
    return any(
        _tree_has_tag(c, key, value) for c in span_dict.get("children", ())
    )


def render_trace_text(trace: dict, events: Optional[List[Tuple[str, dict]]] = None) -> str:
    """Human-readable span tree (the /debug/schedule payload): one line
    per span with duration, indented by depth, tags inline; correlated
    events appended."""
    lines = [
        f"trace {trace['traceId']}  start={time.strftime('%Y-%m-%dT%H:%M:%S', time.gmtime(trace['startTime']))}Z"
        f"  total={trace['durationMs']:.3f}ms"
    ]

    def walk(span: dict, depth: int) -> None:
        tags = span.get("tags", {})
        tag_str = " ".join(f"{k}={v}" for k, v in sorted(tags.items(), key=lambda kv: kv[0]))
        lines.append(
            f"{'  ' * depth}- {span['name']}  {span['durationMs']:.3f}ms"
            + (f"  [{tag_str}]" if tag_str else "")
        )
        for child in span.get("children", ()):
            walk(child, depth + 1)

    walk(trace["root"], 1)
    if events:
        lines.append("events:")
        for name, values in events:
            lines.append(f"  - {name} {values}")
    return "\n".join(lines) + "\n"


# module-level default (swappable for tests; the server wires its own)
default_tracer = Tracer()
