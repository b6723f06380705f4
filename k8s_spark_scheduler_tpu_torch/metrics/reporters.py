"""Periodic metric reporters (reference internal/metrics/{usage,queue,
cache,resourcereservations,softreservations,informer}.go).

One background thread ticks every ``TICK_INTERVAL_SECONDS`` (30s,
metrics.go:89) and reports:
- per-node / per-instance-group reserved resource usage (usage.go:53-114)
- pending-pod lifecycle ages p50/p95/max per phase (queue.go:59-158),
  with stuck-pod logging past 12h (queue.go:160-172)
- cache vs API-server drift (cache.go:64-126)
- unbound reservation resource totals (resourcereservations.go:40-80)
- soft reservation counts + executors lacking reservations
  (softreservations.go:50-104)
- async write queue depths (inflight counts)
- the registry's own per-name label-set cardinality
- the resilience kit's journal depth and write-back recovery nudge
- the contention observatory's lock telemetry, drained into histograms

The reference package's kernel jit-cache reporter has no counterpart
here: this package has no jit cache, and builds each kernel once per
process.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from .. import timesource
from ..scheduler import labels as L
from ..types.resources import Resources
from . import names
from .registry import MetricsRegistry
from ..analysis.guarded import guarded_by

logger = logging.getLogger(__name__)


def _percentile(sorted_values: List[float], q: float) -> float:
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1, max(0, int(q * len(sorted_values))))
    return sorted_values[idx]


@guarded_by("_delay_lock", "_delays")
class ReporterSet:
    def __init__(self, server, tick_seconds: float = names.TICK_INTERVAL_SECONDS):
        self._server = server
        self._tick = tick_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # informer delay (informer.go:33-51): event-delivery lag of fresh
        # pod adds, sampled per tick
        self._delays: List[float] = []
        self._delay_lock = threading.Lock()
        server.pod_informer.add_event_handler(on_add=self._sample_informer_delay)

    def _sample_informer_delay(self, pod) -> None:
        created = pod.creation_timestamp
        if not created:
            return
        lag = max(timesource.now() - created, 0.0)
        if lag < 300.0:  # only fresh pods are a meaningful delay signal
            with self._delay_lock:
                self._delays.append(lag)
                if len(self._delays) > 4096:
                    del self._delays[:2048]

    @property
    def metrics(self) -> MetricsRegistry:
        return self._server.metrics

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True, name="metric-reporters")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def _loop(self) -> None:
        while not self._stop.wait(self._tick):
            self.report_once()

    def report_once(self) -> None:
        waste = getattr(self._server, "waste_reporter", None)
        if waste is not None:
            try:
                waste.cleanup_metric_cache()
            except Exception:
                logger.exception("waste cache cleanup failed")
        for fn in (
            self.report_resource_usage,
            self.report_pod_lifecycle,
            self.report_cache_drift,
            self.report_unbound_reservations,
            self.report_soft_reservations,
            self.report_queue_depths,
            self.report_informer_delay,
            self.report_registry_series,
            self.report_resilience,
            self.report_contention,
        ):
            try:
                fn()
            except Exception:
                logger.exception("reporter %s failed", fn.__name__)

    # -- usage.go -----------------------------------------------------------

    def report_resource_usage(self) -> None:
        server = self._server
        usage = server.resource_reservation_manager.get_reserved_resources()
        nodes = {n.name: n for n in server.node_informer.list()}
        group_label = server.install.instance_group_label
        for node_name, res in usage.items():
            node = nodes.get(node_name)
            group = node.labels.get(group_label, "") if node else ""
            tags = {names.TAG_HOST: node_name, names.TAG_INSTANCE_GROUP: group}
            self.metrics.gauge(names.RESOURCE_USAGE_CPU, res.cpu.milli_value() / 1000.0, tags)
            self.metrics.gauge(names.RESOURCE_USAGE_MEMORY, float(res.memory.value()), tags)
            self.metrics.gauge(
                names.RESOURCE_USAGE_NVIDIA_GPUS, float(res.nvidia_gpu.value()), tags
            )

    # -- queue.go -----------------------------------------------------------

    def report_pod_lifecycle(self) -> None:
        server = self._server
        now = timesource.now()
        pending_ages: List[float] = []
        for pod in server.pod_informer.list():
            if not L.is_spark_scheduler_pod(pod):
                continue
            if pod.node_name == "" and pod.meta.deletion_timestamp is None:
                age = now - pod.creation_timestamp
                pending_ages.append(age)
                if age > names.STUCK_POD_LOG_THRESHOLD_SECONDS:
                    logger.warning(
                        "pod stuck in pending for over 12h: %s/%s",
                        pod.namespace,
                        pod.name,
                    )
        pending_ages.sort()
        tags = {names.TAG_LIFECYCLE: "queued"}
        self.metrics.gauge(names.LIFECYCLE_COUNT, float(len(pending_ages)), tags)
        self.metrics.gauge(names.LIFECYCLE_AGE_P50, _percentile(pending_ages, 0.5), tags)
        self.metrics.gauge(names.LIFECYCLE_AGE_P95, _percentile(pending_ages, 0.95), tags)
        self.metrics.gauge(
            names.LIFECYCLE_AGE_MAX, pending_ages[-1] if pending_ages else 0.0, tags
        )

    # -- cache.go drift -----------------------------------------------------

    def report_cache_drift(self) -> None:
        server = self._server
        cached = {(rr.namespace, rr.name) for rr in server.resource_reservation_cache.list()}
        stored = {
            (rr.namespace, rr.name) for rr in server.api.list("ResourceReservation")
        }
        self.metrics.gauge(names.CACHED_OBJECT_COUNT, float(len(cached)))
        drift = len(cached.symmetric_difference(stored))
        self.metrics.gauge(names.CACHED_OBJECT_DRIFT, float(drift))

    # -- resourcereservations.go (unbound totals) ---------------------------

    def report_unbound_reservations(self) -> None:
        server = self._server
        pods = {
            (p.namespace, p.name): p
            for p in server.pod_informer.list()
            if not L.is_pod_terminated(p)
        }
        unbound_total = Resources.zero()
        for rr in server.resource_reservation_cache.list():
            for reservation_name, reservation in rr.spec.reservations.items():
                pod_name = rr.status.pods.get(reservation_name)
                if pod_name is None or (rr.namespace, pod_name) not in pods:
                    unbound_total = unbound_total.add(reservation.resources_value())
        self.metrics.gauge(
            names.UNBOUND_CPU_RESERVATIONS, unbound_total.cpu.milli_value() / 1000.0
        )
        self.metrics.gauge(
            names.UNBOUND_MEMORY_RESERVATIONS, float(unbound_total.memory.value())
        )
        self.metrics.gauge(
            names.UNBOUND_NVIDIA_GPU_RESERVATIONS, float(unbound_total.nvidia_gpu.value())
        )

    # -- softreservations.go ------------------------------------------------

    def report_soft_reservations(self) -> None:
        server = self._server
        store = server.soft_reservation_store
        self.metrics.gauge(names.SOFT_RESERVATION_COUNT, float(store.get_application_count()))
        self.metrics.gauge(
            names.SOFT_RESERVATION_EXECUTOR_COUNT,
            float(store.get_active_extra_executor_count()),
        )
        # executors bound to nodes but absent from both hard and soft stores
        count = 0
        for pod in server.pod_informer.list():
            if (
                L.is_spark_scheduler_executor_pod(pod)
                and pod.node_name != ""
                and not L.is_pod_terminated(pod)
                and not server.resource_reservation_manager.pod_has_reservation(pod)
            ):
                count += 1
        self.metrics.gauge(names.EXECUTORS_WITH_NO_RESERVATION_COUNT, float(count))

    def report_informer_delay(self) -> None:
        with self._delay_lock:
            delays, self._delays = self._delays, []
        if delays:
            delays.sort()
            self.metrics.gauge(names.POD_INFORMER_DELAY, _percentile(delays, 0.5))
            self.metrics.gauge(names.POD_INFORMER_DELAY_MAX, delays[-1])

    # -- queue depths -------------------------------------------------------

    def report_queue_depths(self) -> None:
        server = self._server
        for i, depth in enumerate(server.resource_reservation_cache.inflight_queue_lengths()):
            self.metrics.gauge(
                names.INFLIGHT_REQUEST_COUNT,
                float(depth),
                {names.TAG_QUEUE_INDEX: str(i), "objectType": "resourcereservations"},
            )
        for i, depth in enumerate(server.demand_cache.inflight_queue_lengths()):
            self.metrics.gauge(
                names.INFLIGHT_REQUEST_COUNT,
                float(depth),
                {names.TAG_QUEUE_INDEX: str(i), "objectType": "demands"},
            )

    # -- registry self-observability -----------------------------------------

    def report_registry_series(self) -> None:
        """Per-metric label-set cardinality (…tpu.metrics.registry.
        series, tagged metric=): the canary that catches a label
        explosion — e.g. a high-cardinality capacity tag — before the
        Prometheus scrape does.  One series per catalog name, so the
        canary itself stays O(#metric names)."""
        published = []
        for name, series in self.metrics.series_stats().items():
            if name == names.METRICS_REGISTRY_SERIES:
                continue  # never self-count: the gauge would ratchet
            tags = {"metric": name}
            published.append(tags)
            self.metrics.gauge(
                names.METRICS_REGISTRY_SERIES, float(series), tags
            )
        # a metric name that vanished from the registry (e.g. pruned
        # capacity gauges) must not keep exporting its last, too-high
        # series count — the canary tracks the registry, not history
        self.metrics.prune_gauges(names.METRICS_REGISTRY_SERIES, published)

    # -- resilience ----------------------------------------------------------

    def report_resilience(self) -> None:
        """Degraded-mode gauges + the periodic write-back recovery nudge:
        when journaled reservation intents exist and the breaker's probe
        window is due, put one back on the queue so recovery doesn't wait
        for organic write traffic.  Skipped under a virtual clock — a
        test driving time itself drives recovery too."""
        kit = getattr(self._server, "resilience", None)
        if kit is None:
            return
        self.metrics.gauge(names.RESILIENCE_GATE_INFLIGHT, float(kit.gate.in_flight))
        self.metrics.gauge(names.RESILIENCE_JOURNAL_DEPTH, float(kit.journal.depth()))
        # refresh the health-state gauge with the REAL serving state —
        # defaulting serving=True here would flap the gauge to "ready"
        # mid-boot between unready readiness-probe samples
        serving = (
            self._server.informer_factory.wait_for_cache_sync()
            and self._server.warmup_complete()
        )
        kit.health.state(serving=serving)
        if not timesource.is_virtual():
            self._server.resource_reservation_cache.nudge_recovery()

    # -- contention -----------------------------------------------------------

    def report_contention(self) -> None:
        """Drain the lock-telemetry pending buffers into wait/hold
        histograms.  TimedLock never publishes from the lock path (the
        registry's own lock is a TimedLock — publishing there would
        recurse), so the reporter tick is the drain point."""
        from ..contention import locktime

        if locktime.active():
            locktime.publish(self.metrics)
