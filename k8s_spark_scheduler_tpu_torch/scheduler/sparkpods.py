"""Spark pod lister: FIFO queue view + annotation parsing
(reference ``internal/extender/sparkpods.go``)."""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..kube.informer import Informer
from ..types.objects import Pod
from ..types.resources import NodeGroupResources, Resources
from ..utils.quantity import Quantity
from . import labels as L


@dataclass
class SparkApplicationResources:
    """internal/types SparkApplicationResources."""

    driver_resources: Resources
    executor_resources: Resources
    min_executor_count: int
    max_executor_count: int


class AnnotationError(ValueError):
    pass


def spark_resources(pod: Pod) -> SparkApplicationResources:
    """Parse the app's resource annotations (sparkpods.go:73-137).

    Error cases mirror the reference: bad DA boolean, missing
    executor-count without DA, missing DA min/max with DA, missing
    driver/executor cpu/mem, unparseable quantity.
    """
    annotations = pod.annotations
    da_raw = annotations.get(L.DYNAMIC_ALLOCATION_ENABLED)
    dynamic_allocation_enabled = False
    if da_raw is not None:
        if da_raw.lower() in ("true", "1", "t"):
            dynamic_allocation_enabled = True
        elif da_raw.lower() in ("false", "0", "f"):
            dynamic_allocation_enabled = False
        else:
            raise AnnotationError(
                "annotation DynamicAllocationEnabled could not be parsed as a boolean"
            )

    parsed: Dict[str, Quantity] = {}
    for key in (
        L.DRIVER_CPU,
        L.DRIVER_MEMORY,
        L.DRIVER_NVIDIA_GPUS,
        L.EXECUTOR_CPU,
        L.EXECUTOR_MEMORY,
        L.EXECUTOR_NVIDIA_GPUS,
        L.EXECUTOR_COUNT,
        L.DA_MIN_EXECUTOR_COUNT,
        L.DA_MAX_EXECUTOR_COUNT,
    ):
        value = annotations.get(key)
        if value is None:
            if key in (L.DRIVER_NVIDIA_GPUS, L.EXECUTOR_NVIDIA_GPUS):
                continue  # optional: GPUs not required
            if not dynamic_allocation_enabled and key == L.EXECUTOR_COUNT:
                raise AnnotationError(
                    "annotation ExecutorCount is required when DynamicAllocationEnabled is false"
                )
            if dynamic_allocation_enabled and key in (
                L.DA_MIN_EXECUTOR_COUNT,
                L.DA_MAX_EXECUTOR_COUNT,
            ):
                raise AnnotationError(
                    f"annotation {key} is required when DynamicAllocationEnabled is true"
                )
            if key in (L.EXECUTOR_COUNT, L.DA_MIN_EXECUTOR_COUNT, L.DA_MAX_EXECUTOR_COUNT):
                continue  # not needed in this mode
            raise AnnotationError(f"annotation {key} is missing from driver")
        try:
            parsed[key] = Quantity(value)
        except ValueError:
            raise AnnotationError(
                f"annotation {key} does not have a parseable value {value}"
            ) from None

    if dynamic_allocation_enabled:
        min_executor_count = parsed[L.DA_MIN_EXECUTOR_COUNT].value()
        max_executor_count = parsed[L.DA_MAX_EXECUTOR_COUNT].value()
    else:
        min_executor_count = parsed[L.EXECUTOR_COUNT].value()
        max_executor_count = min_executor_count

    zero = Quantity(0)
    return SparkApplicationResources(
        driver_resources=Resources(
            parsed[L.DRIVER_CPU], parsed[L.DRIVER_MEMORY], parsed.get(L.DRIVER_NVIDIA_GPUS, zero)
        ),
        executor_resources=Resources(
            parsed[L.EXECUTOR_CPU],
            parsed[L.EXECUTOR_MEMORY],
            parsed.get(L.EXECUTOR_NVIDIA_GPUS, zero),
        ),
        min_executor_count=min_executor_count,
        max_executor_count=max_executor_count,
    )


# (uid, resourceVersion) → (SparkApplicationResources, AppDemand) |
# AnnotationError.  Annotations are immutable per resource version, and
# the FIFO pass re-reads the same ~queue-depth pods on EVERY Filter
# request — without this cache, Quantity re-parsing alone cost
# ~200ms/request at the 10k-node × 1k-queue shape.  The AppDemand
# instance is STABLE across requests so the tensorize layer can stash
# its exact base-unit rows on it (tensorize._app_base_rows).
_SPARK_RESOURCES_CACHE: OrderedDict = OrderedDict()
_SPARK_RESOURCES_CACHE_MAX = 16384
_spark_resources_lock = threading.Lock()


def _cache_lookup(pod: Pod):
    key = (pod.meta.uid, pod.meta.resource_version)
    if not key[0]:
        return None, None  # no identity to key on
    with _spark_resources_lock:
        hit = _SPARK_RESOURCES_CACHE.get(key)
        if hit is not None:
            _SPARK_RESOURCES_CACHE.move_to_end(key)
    return key, hit


def _cache_store(key, value) -> None:
    with _spark_resources_lock:
        _SPARK_RESOURCES_CACHE[key] = value
        while len(_SPARK_RESOURCES_CACHE) > _SPARK_RESOURCES_CACHE_MAX:
            _SPARK_RESOURCES_CACHE.popitem(last=False)


def _cached_entry(pod: Pod):
    """(SparkApplicationResources, AppDemand) for the pod's current
    version, parsed at most once; AnnotationErrors are cached too (a bad
    annotation stays bad for that version) and re-raised fresh."""
    from ..ops.sparkapp import AppDemand

    key, hit = _cache_lookup(pod)
    if hit is None:
        try:
            sar = spark_resources(pod)
            demand = AppDemand(
                sar.driver_resources,
                sar.executor_resources,
                sar.min_executor_count,
            )
            # precompute the exact tensor rows BEFORE the instance is
            # shared: request threads then only read the stash, so the
            # tensorize-layer lazy fallback never writes to a shared
            # AppDemand from concurrent requests (ADVICE r4 #3)
            from ..ops.tensorize import _app_base_rows

            _app_base_rows(demand)
            hit = (sar, demand)
        except AnnotationError as err:
            hit = err
        if key is not None:
            _cache_store(key, hit)
    if isinstance(hit, AnnotationError):
        raise AnnotationError(*hit.args)
    return hit


def spark_resources_cached(pod: Pod) -> SparkApplicationResources:
    """``spark_resources`` memoized by (uid, resourceVersion)."""
    return _cached_entry(pod)[0]


def spark_app_demand_cached(pod: Pod):
    """(SparkApplicationResources, stable AppDemand) for the pod's
    current version — the FIFO queue loops use this so per-app tensor
    rows are computed once per pod version, not once per request."""
    return _cached_entry(pod)


def spark_resource_usage(
    driver_resources: Resources,
    executor_resources: Resources,
    driver_node: str,
    executor_nodes: List[str],
) -> NodeGroupResources:
    """sparkpods.go:139-146.

    QUIRK (reference behavior): per-node entries are *assigned*, not
    accumulated — a node hosting N executors contributes one executor's
    worth, and a driver node that also hosts executors is counted as
    executors only.  The FIFO pass subtracts this, so preserving it is
    required for decision parity.
    """
    usage: NodeGroupResources = {}
    usage[driver_node] = driver_resources
    for node in executor_nodes:
        usage[node] = executor_resources
    return usage


class SparkPodLister:
    """sparkpods.go:36-71 + driver lookups."""

    def __init__(self, pod_informer: Informer, instance_group_label: str):
        self._informer = pod_informer
        self._instance_group_label = instance_group_label
        # (informer revision, pending drivers sorted by creation time) —
        # the FIFO pass re-derives this view on every Filter request; at
        # a 1k-deep queue the raw list+filter+sort cost ~9ms/request
        self._pending_cache = (-1, [])

    @property
    def informer(self) -> Informer:
        return self._informer

    def list(self, namespace: Optional[str] = None, label_selector=None) -> List[Pod]:
        return self._informer.list(namespace=namespace, label_selector=label_selector)

    def list_earlier_drivers(self, driver: Pod) -> List[Pod]:
        """Unscheduled drivers in the same instance group, targeted at the
        same scheduler, created strictly earlier, sorted by creation time
        (sparkpods.go:45-71).  The driver-independent part (pending
        drivers, time-sorted) is cached per informer revision."""
        # keyed on the driver-role bucket revision: executor pod churn
        # (the dominant event stream) leaves the cache valid
        rev = self._informer.selector_revision(L.SPARK_ROLE_LABEL, L.DRIVER)
        cached_rev, pending = self._pending_cache
        if cached_rev != rev:
            drivers = self._informer.list(
                label_selector={L.SPARK_ROLE_LABEL: L.DRIVER}
            )
            pending = [
                p
                for p in drivers
                if p.node_name == "" and p.meta.deletion_timestamp is None
            ]
            pending.sort(key=lambda p: p.creation_timestamp)
            self._pending_cache = (rev, pending)
        cut = driver.creation_timestamp
        return [
            p
            for p in pending
            if p.creation_timestamp < cut
            and p.scheduler_name == driver.scheduler_name
            and L.match_pod_instance_group(p, driver, self._instance_group_label)
        ]

    def get_driver_pod_for_executor(self, executor: Pod) -> Optional[Pod]:
        return self.get_driver_pod(
            executor.labels.get(L.SPARK_APP_ID_LABEL, ""), executor.namespace
        )

    def get_driver_pod(self, app_id: str, namespace: str) -> Optional[Pod]:
        """sparkpods.go:152-159 (exactly one match or None)."""
        drivers = self._informer.list(
            namespace=namespace,
            label_selector={L.SPARK_APP_ID_LABEL: app_id, L.SPARK_ROLE_LABEL: L.DRIVER},
        )
        if len(drivers) != 1:
            return None
        return drivers[0]
