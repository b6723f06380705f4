"""Labels/annotations contract + pod classification helpers.

internal/common/constants.go:17-51, internal/common/utils/pods.go,
internal/podspec.go.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..types.objects import Pod

SPARK_SCHEDULER_NAME = "spark-scheduler"
SPARK_ROLE_LABEL = "spark-role"
SPARK_APP_ID_LABEL = "spark-app-id"
DRIVER = "driver"
EXECUTOR = "executor"

DRIVER_CPU = "spark-driver-cpu"
DRIVER_MEMORY = "spark-driver-mem"
DRIVER_NVIDIA_GPUS = "spark-driver-nvidia.com/gpu"
EXECUTOR_CPU = "spark-executor-cpu"
EXECUTOR_MEMORY = "spark-executor-mem"
EXECUTOR_NVIDIA_GPUS = "spark-executor-nvidia.com/gpu"
DYNAMIC_ALLOCATION_ENABLED = "spark-dynamic-allocation-enabled"
EXECUTOR_COUNT = "spark-executor-count"
DA_MIN_EXECUTOR_COUNT = "spark-dynamic-allocation-min-executor-count"
DA_MAX_EXECUTOR_COUNT = "spark-dynamic-allocation-max-executor-count"

# default instance-group label with back-compat fallback
# (cmd/server.go:67-71)
DEFAULT_INSTANCE_GROUP_LABEL = "resource_channel"


def is_spark_scheduler_pod(pod: Pod) -> bool:
    """utils/pods.go:29-33: has a spark role and targets our scheduler."""
    return bool(pod.labels.get(SPARK_ROLE_LABEL)) and pod.scheduler_name == SPARK_SCHEDULER_NAME


def is_spark_scheduler_executor_pod(pod: Pod) -> bool:
    """utils/pods.go:36-40."""
    return is_spark_scheduler_pod(pod) and pod.labels.get(SPARK_ROLE_LABEL) == EXECUTOR


def is_pod_terminated(pod: Pod) -> bool:
    """utils/pods.go:69-75: at least one container status, all terminated."""
    return pod.is_terminated()


def find_instance_group_from_pod_spec(pod: Pod, instance_group_label: str) -> Tuple[str, bool]:
    """internal/podspec.go:29-53: instance group from nodeSelector or
    required node affinity."""
    value = pod.node_selector.get(instance_group_label)
    if value is not None:
        return value, True
    values = pod.node_affinity.get(instance_group_label)
    if values:
        return values[0], True
    for term in pod.affinity_terms:
        for key, operator, term_values in term:
            if key == instance_group_label and operator == "In" and term_values:
                return term_values[0], True
    return "", False


def match_pod_instance_group(pod_a: Pod, pod_b: Pod, instance_group_label: str) -> bool:
    """internal/podspec.go:22-26."""
    group_a, ok_a = find_instance_group_from_pod_spec(pod_a, instance_group_label)
    group_b, ok_b = find_instance_group_from_pod_spec(pod_b, instance_group_label)
    return ok_a and ok_b and group_a == group_b


def on_pod_scheduled(old: Optional[Pod], new: Pod) -> bool:
    """utils/pods.go:78-103 transition detector: pod just got a node."""
    if new.node_name == "":
        return False
    return old is None or old.node_name == ""
