"""Install-time configuration (reference ``config/config.go:24-84``).

The reference binds ``var/conf/install.yml`` into the Install struct; we
accept the same shape from a dict (the server CLI parses JSON).

The keys are those of the reference package's ``Install.from_dict``, so
its configs load unchanged.  Subsystems this package does not have yet
(ROADMAP A) are refused when a config would turn them on: a key that
enables one raises ``ValueError`` naming the ROADMAP item, a key that
leaves it off is accepted, and an unknown key raises too — no key is
dropped without a word.  Two settings are read but configure nothing
here yet, and the server logs so at start: ``conversion-webhook`` (no
``/convert`` webhook is served) and ``unschedulable-pod-timeout-seconds``
(no unschedulable-pod marker runs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

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


@dataclass
class ConversionWebhookConfig:
    """Where the apiserver would reach the CRD conversion webhook
    (conversionwebhook/resource_reservation.go:44-98).  Read for the
    reference's config shape; this package serves no webhook yet."""

    service_namespace: str = "spark"
    service_name: str = "spark-scheduler"
    service_port: int = 443
    path: str = "/convert"
    ca_bundle_file: Optional[str] = None


# subsystems of the reference package not in this one: config key →
# (the reference's default for its "enabled" flag, ROADMAP item).  A
# section turns its subsystem on when its "enabled" (or that default)
# is true; "resilience" has no switch in the reference (always on), so
# any "resilience" section configures a subsystem that is missing here.
_UNPORTED_SECTIONS = {
    "provenance": (True, "ROADMAP A.8 (provenance)"),
    "capacity": (True, "ROADMAP A.8 (capacity observatory)"),
    "contention": (True, "ROADMAP A.8 (contention observatory)"),
    "policy": (False, "ROADMAP A.8 (scheduling policy)"),
    "ha": (False, "ROADMAP A.8 (HA failover)"),
    "lifecycle": (True, "ROADMAP A.8 (lifecycle ledger and SLO engine)"),
    "concurrent": (False, "ROADMAP A.5 (concurrent admission)"),
    "classes": (True, "ROADMAP A.5 (equivalence-class aggregation)"),
}
_RESILIENCE_ITEM = "ROADMAP A.8 (resilience kit)"
_DELTA_SOLVE_ITEM = "ROADMAP A.5 (delta-solve)"

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
    if "resilience" in d:
        raise ValueError(
            f"install key 'resilience' configures a subsystem this package does not have: "
            f"{_RESILIENCE_ITEM}"
        )
    if d.get("delta-solve", False):
        raise ValueError(f"install key 'delta-solve' is true, and this package has no {_DELTA_SOLVE_ITEM}")


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
    # the incremental delta-solve engine is not in this package yet
    # (ROADMAP A.5): only False is accepted
    delta_solve: bool = False

    def __post_init__(self):
        if self.delta_solve:
            raise ValueError(f"delta_solve=True needs {_DELTA_SOLVE_ITEM}, not in this package")

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
            delta_solve=d.get("delta-solve", False),
        )
