"""Install-time configuration (reference ``config/config.go:24-84``).

The reference binds ``var/conf/install.yml`` into the Install struct; we
accept the same shape from a dict (the server CLI parses JSON).

The keys are those of the reference package's ``Install.from_dict``, so
its configs load unchanged.  Subsystems this package does not have yet
(ROADMAP A) are refused when a config would turn them on: a key that
enables one raises ``ValueError`` naming the ROADMAP item, a key that
leaves it off is accepted, and an unknown key raises too — no key is
dropped without a word.  A config that omits a key gets the reference's
default, and one of those defaults turns a subsystem ON that this
package lacks (contention defaults to enabled): ``Install.reference_only``
names each such subsystem, and the server logs one warning for each at
start.  Resilience (always on, as in the reference), provenance (on by
default), delta-solve (default true), class aggregation (``classes``),
the capacity observatory (``capacity``) and the lifecycle ledger with
its SLO engine (``lifecycle``), all enabled by default, are this
package's own: they load with the reference's keys and defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from . import compat
from .ops.nodesort import LabelPriorityOrder
from .scheduler.labels import DEFAULT_INSTANCE_GROUP_LABEL


@dataclass
class FifoConfig:
    """config.go:58-64: enforce FIFO only after a driver is older than
    this (seconds), per instance group."""

    default_enforce_after_pod_age: float = 0.0
    enforce_after_pod_age_by_instance_group: Dict[str, float] = field(default_factory=dict)


@dataclass
class AsyncClientConfig:
    """config.go:72-77."""

    max_retry_count: int = 5


# the reference's kernel-lane health keys: they load (a reference config
# works unchanged) and configure nothing, since no kernel lane here is
# ever demoted to a host lane
_LANE_KEYS = ("lane-failure-threshold", "lane-cooloff-seconds", "lane-latency-budget-seconds")
_RESILIENCE_KEYS = {
    "request-deadline-seconds",
    "deadline-margin-seconds",
    "admission-max-waiters",
    "breaker-failure-threshold",
    "breaker-cooloff-seconds",
    "journal-path",
    "journal-compact-fraction",
    "journal-compact-min-records",
    *_LANE_KEYS,
}
_PROVENANCE_KEYS = {
    "enabled",
    "ring-size",
    "recorder-size",
    "bundle-dir",
    "max-bundle-nodes",
    "parity-check-interval",
    "trigger-min-interval-seconds",
}


@dataclass
class ResilienceConfig:
    """Overload protection / degraded mode (resilience/).

    ``request_deadline_seconds`` mirrors kube-scheduler's extender
    ``httpTimeout`` (examples/extender.yml: 30s); the server answers
    fail-fast ``deadline_margin_seconds`` before the caller hangs up.
    """

    request_deadline_seconds: float = 30.0
    deadline_margin_seconds: float = 1.0
    # concurrent /predicates requests admitted (holding + queued on the
    # extender lock) before excess requests are shed with a retriable
    # failure
    admission_max_waiters: int = 16
    # consecutive API-server write failures before the write-back
    # breaker opens and diverts reservation writes to the intent journal
    breaker_failure_threshold: int = 5
    breaker_cooloff_seconds: float = 30.0
    # durable JSONL intent journal; None keeps intents in memory only
    # (still replayed on in-process recovery, lost on process death)
    journal_path: Optional[str] = None
    # journal compaction: rewrite the file to pending-only once dead
    # records (acked / superseded puts + ack markers) exceed this
    # fraction of the file, but never below the record floor
    journal_compact_fraction: float = 0.5
    journal_compact_min_records: int = 64
    # the reference's lane-* keys this config carried (they configure
    # nothing here; the wiring says so once)
    lane_keys: Tuple[str, ...] = ()

    @staticmethod
    def from_dict(d: dict) -> "ResilienceConfig":
        _check_keys(d, _RESILIENCE_KEYS, "resilience")
        return ResilienceConfig(
            request_deadline_seconds=d.get("request-deadline-seconds", 30.0),
            deadline_margin_seconds=d.get("deadline-margin-seconds", 1.0),
            admission_max_waiters=d.get("admission-max-waiters", 16),
            breaker_failure_threshold=d.get("breaker-failure-threshold", 5),
            breaker_cooloff_seconds=d.get("breaker-cooloff-seconds", 30.0),
            journal_path=d.get("journal-path"),
            journal_compact_fraction=d.get("journal-compact-fraction", 0.5),
            journal_compact_min_records=d.get("journal-compact-min-records", 64),
            lane_keys=tuple(key for key in _LANE_KEYS if key in d),
        )


@dataclass
class ProvenanceConfig:
    """Decision provenance (provenance/): unschedulability explainer,
    shortfall telemetry, anomaly flight recorder.

    Diagnostic only — decisions are identical enabled or disabled.
    ``bundle_dir`` (or the ``SCHED_PROVENANCE_DIR`` env var) is where
    trigger-fired flight-recorder bundles persist; None keeps the
    bundle ring in memory only.  ``parity_check_interval`` is the
    warm≠cold delta-solve guard: every Nth warm hit re-solves the queue
    with the stateless cold pass and fires the flight recorder on a
    divergence (0 = off)."""

    enabled: bool = True
    ring_size: int = 128
    recorder_size: int = 8
    bundle_dir: Optional[str] = None
    max_bundle_nodes: int = 4096
    parity_check_interval: int = 0
    # per-trigger persist debounce (seconds): an overload-driven trigger
    # storm writes one bundle file per trigger type per interval, not
    # one per failed request
    trigger_min_interval_seconds: float = 30.0

    @staticmethod
    def from_dict(d: dict) -> "ProvenanceConfig":
        _check_keys(d, _PROVENANCE_KEYS, "provenance")
        return ProvenanceConfig(
            enabled=d.get("enabled", True),
            ring_size=d.get("ring-size", 128),
            recorder_size=d.get("recorder-size", 8),
            bundle_dir=d.get("bundle-dir"),
            max_bundle_nodes=d.get("max-bundle-nodes", 4096),
            parity_check_interval=d.get("parity-check-interval", 0),
            trigger_min_interval_seconds=d.get("trigger-min-interval-seconds", 30.0),
        )


_CLASSES_KEYS = {"enabled", "min-nodes"}


@dataclass
class ClassesConfig:
    """Equivalence-class node aggregation (state/classindex.py): the
    O(1) class-digest warm tier of the delta-solve engine.

    Decisions are byte-identical enabled or disabled, so ``enabled`` is
    an operator kill switch, not a semantics switch.  ``min_nodes`` is
    where the reference starts class-compressed stepping; this package
    steps node by node at every size (ROADMAP A.3b) and logs one warning
    when a session reaches it."""

    enabled: bool = True
    min_nodes: int = 20000

    @staticmethod
    def from_dict(d: dict) -> "ClassesConfig":
        _check_keys(d, _CLASSES_KEYS, "classes")
        return ClassesConfig(
            enabled=d.get("enabled", True),
            min_nodes=d.get("min-nodes", 20000),
        )


_CAPACITY_KEYS = {
    "enabled",
    "ring-size",
    "debounce-seconds",
    "interval-seconds",
    "max-shapes",
    "max-group-zones",
    "max-queue",
}


@dataclass
class CapacityConfig:
    """Capacity observatory (capacity/): fragmentation/headroom
    analytics, queue-pressure forecasts, and the ``/state/capacity``
    timeline.  Diagnostic only — no scheduling decision consumes an
    observatory output.

    Sampling is change-triggered (the state layer's ChangeFeed wakes
    the sampler thread, debounced) with ``interval_seconds`` as the
    idle-heartbeat fallback.  Cardinality caps bound both the probe
    cost and the label sets the headroom gauge can emit."""

    enabled: bool = True
    ring_size: int = 256
    debounce_seconds: float = 0.25
    interval_seconds: float = 15.0
    max_shapes: int = 16
    max_group_zones: int = 16
    max_queue: int = 64

    @staticmethod
    def from_dict(d: dict) -> "CapacityConfig":
        _check_keys(d, _CAPACITY_KEYS, "capacity")
        return CapacityConfig(
            enabled=d.get("enabled", True),
            ring_size=d.get("ring-size", 256),
            debounce_seconds=d.get("debounce-seconds", 0.25),
            interval_seconds=d.get("interval-seconds", 15.0),
            max_shapes=d.get("max-shapes", 16),
            max_group_zones=d.get("max-group-zones", 16),
            max_queue=d.get("max-queue", 64),
        )


_LIFECYCLE_KEYS = {
    "enabled",
    "ring-size",
    "debounce-seconds",
    "interval-seconds",
    "window-scale",
    "sample-cap",
    "objectives",
}


@dataclass
class LifecycleConfig:
    """Gang lifecycle ledger + SLO engine (lifecycle/): per-application
    state machine, burn-rate objectives, and the ``/slo`` +
    ``/lifecycle`` scorecard endpoints.  Diagnostic only — no
    scheduling decision consumes a ledger or SLO output.

    Draining is change-triggered (EventLog emits and the state layer's
    ChangeFeed wake the ledger thread, debounced) with
    ``interval_seconds`` as the idle-heartbeat fallback.
    ``window_scale`` multiplies every SLO alert window (1 h/5 m and
    6 h/30 m) so short virtual-clock timelines can compress the policy
    without changing the algebra; ``objectives`` overrides
    per-objective ``target``/``threshold`` (keys: time_to_admit,
    filter_latency, eviction_waste, fairness_gap)."""

    enabled: bool = True
    ring_size: int = 2048
    debounce_seconds: float = 0.05
    interval_seconds: float = 5.0
    window_scale: float = 1.0
    sample_cap: int = 4096
    objectives: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: dict) -> "LifecycleConfig":
        _check_keys(d, _LIFECYCLE_KEYS, "lifecycle")
        return LifecycleConfig(
            enabled=d.get("enabled", True),
            ring_size=d.get("ring-size", 2048),
            debounce_seconds=d.get("debounce-seconds", 0.05),
            interval_seconds=d.get("interval-seconds", 5.0),
            window_scale=d.get("window-scale", 1.0),
            sample_cap=d.get("sample-cap", 4096),
            objectives=d.get("objectives", {}),
        )


@dataclass
class ConversionWebhookConfig:
    """Where the apiserver would reach the CRD conversion webhook
    (conversionwebhook/resource_reservation.go:44-98): the
    ResourceReservation CRD's conversion stanza names this service, and
    the server answers ``POST /convert``."""

    service_namespace: str = "spark"
    service_name: str = "spark-scheduler"
    service_port: int = 443
    path: str = "/convert"
    ca_bundle_file: Optional[str] = None


# subsystems of the reference package not in this one: config key →
# (the reference's default for its "enabled" flag, ROADMAP item).  A
# section turns its subsystem on when its "enabled" (or that default)
# is true.
_UNPORTED_SECTIONS = {
    "contention": (True, "ROADMAP A.6.7 (contention observatory)"),
    "policy": (False, "ROADMAP A.6.5 (scheduling policy)"),
    "ha": (False, "ROADMAP A.6.6 (HA failover)"),
    "concurrent": (False, "ROADMAP A.4 (concurrent admission)"),
}
# what the reference runs on a config that omits every key and this
# package lacks: each unported section enabled by default —
# (subsystem, ROADMAP item) pairs
REFERENCE_DEFAULT_ONLY: Tuple[Tuple[str, str], ...] = tuple(
    (key, item) for key, (default_on, item) in _UNPORTED_SECTIONS.items() if default_on
)

_KNOWN_KEYS = {
    "fifo",
    "fifo-config",
    "qps",
    "burst",
    "binpack",
    "should-schedule-dynamically-allocated-executors-in-same-az",
    "instance-group-label",
    "async-client",
    "unschedulable-pod-timeout-seconds",
    "driver-prioritized-node-label",
    "executor-prioritized-node-label",
    "resource-reservation-crd-annotations",
    "conversion-webhook",
    "strict-reference-parity",
    "delta-solve",
    "resilience",
    "provenance",
    "classes",
    "capacity",
    "lifecycle",
    *_UNPORTED_SECTIONS,
}
_FIFO_KEYS = {"default-enforce-after-pod-age-seconds", "enforce-after-pod-age-by-instance-group"}
_ASYNC_CLIENT_KEYS = {"max-retry-count"}
_WEBHOOK_KEYS = {
    "service-namespace": "service_namespace",
    "service-name": "service_name",
    "service-port": "service_port",
    "path": "path",
    "ca-bundle-file": "ca_bundle_file",
}


def _check_keys(d: dict, known, where: str) -> None:
    unknown = sorted(set(d) - set(known))
    if unknown:
        raise ValueError(f"unknown {where} key(s): {', '.join(unknown)}")


def _refuse_unported(d: dict) -> None:
    for key, (default_enabled, item) in _UNPORTED_SECTIONS.items():
        section = d.get(key)
        if section is not None and section.get("enabled", default_enabled):
            raise ValueError(
                f"install key {key!r} turns on a subsystem this package does not have: {item}; "
                f'set "{key}": {{"enabled": false}} or leave the key out'
            )


def _reference_only(d: dict) -> Tuple[Tuple[str, str], ...]:
    """The subsystems the reference package would run on config ``d``
    that this package does not have (``d`` already passed
    ``_refuse_unported``, so each comes from an omitted key)."""
    return tuple(
        (key, item)
        for key, item in REFERENCE_DEFAULT_ONLY
        if key not in d
    )


@dataclass
class Install:
    """config.go:24-47."""

    fifo: bool = False
    fifo_config: FifoConfig = field(default_factory=FifoConfig)
    qps: float = 0.0
    burst: int = 0
    binpack_algo: str = "distribute-evenly"
    should_schedule_dynamically_allocated_executors_in_same_az: bool = False
    instance_group_label: str = DEFAULT_INSTANCE_GROUP_LABEL
    async_client: AsyncClientConfig = field(default_factory=AsyncClientConfig)
    unschedulable_pod_timeout_seconds: float = 600.0
    driver_prioritized_node_label: Optional[LabelPriorityOrder] = None
    executor_prioritized_node_label: Optional[LabelPriorityOrder] = None
    resource_reservation_crd_annotations: Dict[str, str] = field(default_factory=dict)
    conversion_webhook: Optional[ConversionWebhookConfig] = None
    # replicate the reference's accidental-but-load-bearing behaviors
    # (see compat.py for the list); off = corrected semantics
    strict_reference_parity: bool = compat.DEFAULT_STRICT
    # incremental delta-solve engine (ops/deltasolve.py): device-resident
    # solver sessions + prefix-feasibility reuse; on by default, as in
    # the reference (decisions are identical on or off)
    delta_solve: bool = True
    # overload protection (no switch: always on, as in the reference)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    provenance: ProvenanceConfig = field(default_factory=ProvenanceConfig)
    # class-digest warm tier (state/classindex.py, ops/deltasolve.py)
    classes: ClassesConfig = field(default_factory=ClassesConfig)
    # capacity observatory: fragmentation/headroom analytics and the
    # /state/capacity timeline (capacity/) — diagnostic only
    capacity: CapacityConfig = field(default_factory=CapacityConfig)
    # gang lifecycle ledger + SLO burn-rate engine (lifecycle/) —
    # diagnostic only
    lifecycle: LifecycleConfig = field(default_factory=LifecycleConfig)
    # subsystems the reference would run on this config and this package
    # lacks, as (subsystem, ROADMAP item); from_dict derives it from the
    # keys given, a directly built Install has the reference's defaults
    reference_only: Tuple[Tuple[str, str], ...] = REFERENCE_DEFAULT_ONLY

    @staticmethod
    def from_dict(d: dict) -> "Install":
        _check_keys(d, _KNOWN_KEYS, "install")
        _refuse_unported(d)
        fifo_cfg = d.get("fifo-config", {})
        _check_keys(fifo_cfg, _FIFO_KEYS, "fifo-config")
        async_cfg = d.get("async-client", {})
        _check_keys(async_cfg, _ASYNC_CLIENT_KEYS, "async-client")
        wh = d.get("conversion-webhook")
        if wh is not None:
            _check_keys(wh, _WEBHOOK_KEYS, "conversion-webhook")
        driver_label = d.get("driver-prioritized-node-label")
        executor_label = d.get("executor-prioritized-node-label")
        return Install(
            fifo=d.get("fifo", False),
            fifo_config=FifoConfig(
                default_enforce_after_pod_age=fifo_cfg.get(
                    "default-enforce-after-pod-age-seconds", 0.0
                ),
                enforce_after_pod_age_by_instance_group=fifo_cfg.get(
                    "enforce-after-pod-age-by-instance-group", {}
                ),
            ),
            qps=d.get("qps", 0.0),
            burst=d.get("burst", 0),
            binpack_algo=d.get("binpack", "distribute-evenly"),
            should_schedule_dynamically_allocated_executors_in_same_az=d.get(
                "should-schedule-dynamically-allocated-executors-in-same-az", False
            ),
            # back-compat default (cmd/server.go:67-71)
            instance_group_label=d.get("instance-group-label", DEFAULT_INSTANCE_GROUP_LABEL),
            async_client=AsyncClientConfig(max_retry_count=async_cfg.get("max-retry-count", 5)),
            unschedulable_pod_timeout_seconds=d.get("unschedulable-pod-timeout-seconds", 600.0),
            driver_prioritized_node_label=(
                LabelPriorityOrder(driver_label["name"], driver_label["descending-priority-values"])
                if driver_label
                else None
            ),
            executor_prioritized_node_label=(
                LabelPriorityOrder(
                    executor_label["name"], executor_label["descending-priority-values"]
                )
                if executor_label
                else None
            ),
            resource_reservation_crd_annotations=d.get("resource-reservation-crd-annotations", {}),
            # only present keys are passed so the dataclass defaults stay
            # the single source of truth
            conversion_webhook=(
                ConversionWebhookConfig(
                    **{_WEBHOOK_KEYS[key]: value for key, value in wh.items()}
                )
                if wh is not None
                else None
            ),
            strict_reference_parity=d.get("strict-reference-parity", compat.DEFAULT_STRICT),
            delta_solve=d.get("delta-solve", True),
            resilience=ResilienceConfig.from_dict(d.get("resilience") or {}),
            provenance=ProvenanceConfig.from_dict(d.get("provenance") or {}),
            classes=ClassesConfig.from_dict(d.get("classes") or {}),
            capacity=CapacityConfig.from_dict(d.get("capacity") or {}),
            lifecycle=LifecycleConfig.from_dict(d.get("lifecycle") or {}),
            reference_only=_reference_only(d),
        )
