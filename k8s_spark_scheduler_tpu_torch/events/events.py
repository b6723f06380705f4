"""Structured event log (reference ``internal/events/events.go:28-82``).

Three event types: application_scheduled, demand_created,
demand_deleted.  Events are appended to a bounded in-memory ring (for
tests/inspection) and emitted to the standard logger (the reference's
evt2log analog).

The ring carries a monotonic sequence so cursor-based consumers (the
lifecycle ledger) can drain incrementally off-thread, and per-key
secondary indexes (name, trace id) evicted in lockstep with the ring so
``by_name``/``by_trace_id`` are O(matches) instead of a full scan.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from .. import timesource

logger = logging.getLogger(__name__)

APPLICATION_SCHEDULED = "foundry.spark.scheduler.application_scheduled"
DEMAND_CREATED = "foundry.spark.scheduler.demand_created"
DEMAND_DELETED = "foundry.spark.scheduler.demand_deleted"


@dataclass
class Event:
    name: str
    values: Dict[str, Any]
    # semantic instant through the pluggable time source
    timestamp: float = field(default_factory=timesource.now)
    # trace of the scheduling request that emitted this event ("" when
    # emitted outside any traced request): joins the event ring to
    # GET /traces and the request log without grepping timestamps
    trace_id: str = ""


class EventLog:
    def __init__(self, capacity: int = 4096):
        self._capacity = capacity
        self._events: deque[Event] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # total appends ever — the ring holds events with sequence in
        # (_seq - len(_events), _seq]; consumers cursor on this
        self._seq = 0
        # secondary indexes, evicted in lockstep with the ring: each
        # bucket is a deque in insertion order, so the ring's oldest
        # event is also the leftmost entry of its buckets
        self._by_name: Dict[str, deque] = {}
        self._by_trace: Dict[str, deque] = {}
        # optional wakeup Events set on every emit (outside the lock),
        # so the lifecycle ledger drains on activity instead of polling
        self._wakeups: Tuple[Any, ...] = ()

    def emit(self, name: str, **values: Any) -> None:
        from ..tracing import current_trace_id

        event = Event(name, values, trace_id=current_trace_id() or "")
        with self._lock:
            if len(self._events) == self._capacity:
                self._unindex_oldest()
            self._events.append(event)
            self._seq += 1
            self._by_name.setdefault(event.name, deque()).append(event)
            if event.trace_id:
                self._by_trace.setdefault(event.trace_id, deque()).append(
                    event
                )
            wakeups = self._wakeups
        for wakeup in wakeups:
            wakeup.set()
        if event.trace_id:
            logger.info("%s traceId=%s %s", name, event.trace_id, values)
        else:
            logger.info("%s %s", name, values)

    def _unindex_oldest(self) -> None:
        """Drop the about-to-be-evicted ring head from its index
        buckets (insertion order makes it each bucket's leftmost)."""
        old = self._events[0]
        bucket = self._by_name.get(old.name)
        if bucket:
            bucket.popleft()
            if not bucket:
                del self._by_name[old.name]
        if old.trace_id:
            bucket = self._by_trace.get(old.trace_id)
            if bucket:
                bucket.popleft()
                if not bucket:
                    del self._by_trace[old.trace_id]

    def attach_wakeup(self, event) -> None:
        """Add a wakeup Event set on every emit.  Multi-listener:
        appends rather than replaces (wiring-time call)."""
        with self._lock:
            self._wakeups = self._wakeups + (event,)

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def all(self) -> List[Event]:
        with self._lock:
            return list(self._events)

    def by_name(self, name: str) -> List[Event]:
        with self._lock:
            bucket = self._by_name.get(name)
            return list(bucket) if bucket else []

    def by_trace_id(self, trace_id: str) -> List[Event]:
        if not trace_id:
            return []
        with self._lock:
            bucket = self._by_trace.get(trace_id)
            return list(bucket) if bucket else []

    def events_since(self, seq: int) -> Tuple[List[Event], int]:
        """Events appended after ``seq`` (oldest first, truncated to
        the ring's reach) and the current sequence to cursor on."""
        with self._lock:
            total = self._seq
            fresh = total - seq
            if fresh <= 0:
                return [], total
            n = min(fresh, len(self._events))
            if n == 0:
                return [], total
            events = list(self._events)[-n:]
        return events, total


# module-level default sink (swappable for tests)
default_event_log = EventLog()


def emit_application_scheduled(
    instance_group: str,
    spark_app_id: str,
    pod_name: str,
    pod_namespace: str,
    driver_resources,
    executor_resources,
    min_executor_count: int,
    max_executor_count: int,
    event_log: EventLog | None = None,
) -> None:
    """events.go:34-58."""
    from ..tracing import current_trace_id

    (event_log or default_event_log).emit(
        APPLICATION_SCHEDULED,
        traceId=current_trace_id() or "",
        instanceGroup=instance_group,
        sparkAppID=spark_app_id,
        podName=pod_name,
        podNamespace=pod_namespace,
        driverCPU=driver_resources.cpu.serialize(),
        driverMemory=driver_resources.memory.serialize(),
        driverNvidiaGPUs=driver_resources.nvidia_gpu.serialize(),
        executorCPU=executor_resources.cpu.serialize(),
        executorMemory=executor_resources.memory.serialize(),
        executorNvidiaGPUs=executor_resources.nvidia_gpu.serialize(),
        minExecutorCount=min_executor_count,
        maxExecutorCount=max_executor_count,
    )


def emit_demand_created(demand, event_log: EventLog | None = None) -> None:
    (event_log or default_event_log).emit(
        DEMAND_CREATED,
        demandName=demand.name,
        demandNamespace=demand.namespace,
        instanceGroup=demand.spec.instance_group,
    )


def emit_demand_deleted(demand, source: str, event_log: EventLog | None = None) -> None:
    (event_log or default_event_log).emit(
        DEMAND_DELETED,
        demandName=demand.name,
        demandNamespace=demand.namespace,
        instanceGroup=demand.spec.instance_group,
        source=source,
    )
