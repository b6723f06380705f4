"""Declarative scenario spec: cluster shape + workload + faults; a copy
of the reference package's ``sim/scenario.py`` (same keys, defaults and
validation messages).

A scenario is a plain dict (usually a JSON file under ``examples/sim/``)
so runs are reviewable, diffable artifacts:

.. code-block:: json

    {
      "name": "chaos",
      "seed": 42,
      "duration": 1800,
      "retry_interval": 15,
      "cluster": {"nodes": 8, "cpu": "16", "memory": "32Gi",
                  "zones": ["zone1", "zone2"]},
      "binpack_algo": "tightly-pack",
      "fifo": true,
      "workload": {"process": "poisson", "rate_per_min": 2,
                   "executors": {"min": 1, "max": 6},
                   "dynamic_fraction": 0.3,
                   "lifetime": {"min": 120, "max": 600}},
      "autoscaler": {"enabled": true, "delay": 45, "max_nodes": 24},
      "faults": [
        {"at": 600, "kind": "node_kill", "count": 2},
        {"at": 800, "kind": "node_cordon", "count": 1},
        {"at": 1000, "kind": "executor_storm", "apps": 2},
        {"at": 1200, "kind": "failover"}
      ]
    }

Fault catalog (all deterministic under the scenario seed):

- ``node_kill``: delete ``count`` nodes (oldest scaled-up last); pods
  bound there die — the driver's death tears the whole app down via
  owner GC, executor deaths leave unbound reservations that replacement
  executors must re-claim;
- ``node_cordon`` / ``node_uncordon``: flip ``unschedulable`` on
  ``count`` nodes;
- ``executor_storm``: kill ``fraction`` of bound executors across up to
  ``apps`` applications simultaneously and submit replacements — the
  soft-reservation tombstone race;
- ``failover``: wipe the (intentionally unpersisted) soft-reservation
  store and run ``scheduler/failover.py`` reconciliation, as a fresh
  leader would;
- ``apiserver_outage``: for ``duration`` virtual seconds every CRD
  write from the scheduler's async client fails — the write-back
  breaker opens and reservation intents divert to the journal; at the
  window's end the runner injects the recovery signal and the journal
  replays (resilience/);
- ``apiserver_latency``: for ``duration`` virtual seconds every CRD
  write's FIRST attempt per key fails with a retriable timeout (the
  client-observed shape of a latency spike); retries land, so the
  breaker sees interleaved failures without a hard outage;
- ``kernel_fault``: for ``duration`` virtual seconds every device
  lane entry of the extender (the tensor driver lane and the metadata
  lane of a ``tpu-batch*`` queue solver) raises
  ``ops.registry.KernelFault``.  The reference demotes the lane to its
  host path there; this package has no lane to demote to (a kernel
  fault answers 500), so the Filter fails and the runner records its
  outcome as ``error`` — kube-scheduler's view of a 500: the pod stays
  pending and is retried next round.  A policy without a device lane
  meets no fault;
- ``priority_storm``: submit ``count`` fresh applications in the
  fault's ``band`` (default ``high``) at the fault instant — on a
  saturated cluster this exercises the policy engine's queue-jumping
  and gang-atomic preemption path (policy/);
- ``leader_crash``: a rival replica steals the leadership lease at
  epoch+1 — the resident fabric observes its deposition, every fenced
  write path starts refusing (diverting intents to the journal), and
  when the rival's lease expires at the window's end the resident
  re-acquires at epoch+2 and runs full takeover reconciliation (ha/);
- ``lease_partition``: for ``duration`` virtual seconds every Lease
  write fails (the leader is partitioned from the coordination API) —
  renewals lapse, ``is_leader()`` self-demotes on TTL, and the fabric
  re-elects once the partition heals.

A scenario may also carry a ``policy`` dict (the ``Install.policy``
kebab-case keys from ``config.PolicyConfig.from_dict``); when present
the simulator wires the full policy engine into the harness and the
auditor arms the I-P1..I-P4 policy invariants.  An ``ha`` dict (the
``Install.ha`` kebab-case keys from ``config.HAConfig.from_dict``)
wires the HA fabric — lease election + fencing + takeover
reconciliation — stepped deterministically on the virtual clock
(``background`` is forced off), and arms the I-H1..I-H3 audits.
A ``classes`` dict (the ``Install.classes`` kebab-case keys from
``config.ClassesConfig.from_dict``) overrides the equivalence-class
aggregation config — the class-churn scenarios force ``min-nodes: 0``
so cordon/uncordon faults exercise live class-membership flips at any
fleet size.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

FAULT_KINDS = {
    "node_kill",
    "node_cordon",
    "node_uncordon",
    "executor_storm",
    "failover",
    "apiserver_outage",
    "apiserver_latency",
    "kernel_fault",
    "priority_storm",
    "leader_crash",
    "lease_partition",
}


class ScenarioError(ValueError):
    """Actionable scenario validation failure (raised up front by
    ``Scenario.from_dict`` instead of a deep runner traceback)."""


_SCENARIO_KEYS = {
    "name", "seed", "duration", "retry_interval", "binpack_algo",
    "fifo", "cluster", "workload", "autoscaler", "faults",
    "unschedulable_scan_interval", "policy", "ha", "concurrent",
    "classes",
}
_CLUSTER_KEYS = {"nodes", "cpu", "memory", "gpu", "zones", "instance_group"}
_AUTOSCALER_KEYS = {
    "enabled", "delay", "max_nodes", "node_cpu", "node_memory", "node_gpu",
}
_FAULT_KEYS = {"at", "kind", "count", "apps", "fraction", "duration", "band"}
_WORKLOAD_KEYS = {
    "trace", "process", "rate_per_min", "executors", "dynamic_fraction",
    "lifetime", "instance_group", "band_weights", "tenants", "band",
    "tenant", "burst_interval", "burst_size", "burst_offset",
    "peak_rate_per_min", "period",
}
_WORKLOAD_PROCESSES = {"poisson", "burst", "diurnal"}


def _check_block(path: str, block, known: set) -> Dict:
    if not isinstance(block, dict):
        raise ScenarioError(
            f"{path}: expected an object, got {type(block).__name__}"
        )
    unknown = set(block) - known
    if unknown:
        raise ScenarioError(
            f"{path}: unknown keys {sorted(unknown)} (known: {sorted(known)})"
        )
    return block


def _check_number(path: str, value, lo=None) -> None:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ScenarioError(f"{path}: expected a number, got {value!r}")
    if lo is not None and value < lo:
        raise ScenarioError(f"{path}: must be >= {lo}, got {value!r}")


def _validate_workload(block: Dict) -> None:
    _check_block("scenario.workload", block, _WORKLOAD_KEYS)
    if block.get("trace") is not None and not isinstance(block["trace"], str):
        raise ScenarioError(
            f"scenario.workload.trace: expected a path string, got {block['trace']!r}"
        )
    process = block.get("process", "poisson")
    if process not in _WORKLOAD_PROCESSES:
        raise ScenarioError(
            f"scenario.workload.process: unknown process {process!r} "
            f"(known: {sorted(_WORKLOAD_PROCESSES)})"
        )
    for key, bounds in (("executors", (1, None)), ("lifetime", (0, None))):
        sub = block.get(key)
        if sub is None:
            continue
        sub = _check_block(f"scenario.workload.{key}", sub, {"min", "max"})
        for edge in ("min", "max"):
            if edge in sub:
                _check_number(f"scenario.workload.{key}.{edge}", sub[edge], lo=bounds[0] if edge == "min" else None)
        if "min" in sub and "max" in sub and sub["max"] < sub["min"]:
            raise ScenarioError(
                f"scenario.workload.{key}: max {sub['max']} < min {sub['min']}"
            )
    if "dynamic_fraction" in block:
        _check_number("scenario.workload.dynamic_fraction", block["dynamic_fraction"], lo=0.0)
        if block["dynamic_fraction"] > 1.0:
            raise ScenarioError(
                f"scenario.workload.dynamic_fraction: must be <= 1.0, "
                f"got {block['dynamic_fraction']!r}"
            )


def _validate_faults(faults) -> None:
    if not isinstance(faults, list):
        raise ScenarioError(
            f"scenario.faults: expected a list, got {type(faults).__name__}"
        )
    for i, f in enumerate(faults):
        if not isinstance(f, dict):
            raise ScenarioError(
                f"scenario.faults[{i}]: expected an object, got {type(f).__name__}"
            )
        unknown = set(f) - _FAULT_KEYS
        if unknown:
            raise ScenarioError(
                f"scenario.faults[{i}]: unknown keys {sorted(unknown)} "
                f"(known: {sorted(_FAULT_KEYS)})"
            )
        if "kind" not in f:
            raise ScenarioError(f"scenario.faults[{i}]: missing required key 'kind'")
        if f["kind"] not in FAULT_KINDS:
            raise ScenarioError(
                f"scenario.faults[{i}].kind: unknown fault kind {f['kind']!r} "
                f"(known: {sorted(FAULT_KINDS)})"
            )
        if "at" not in f:
            raise ScenarioError(f"scenario.faults[{i}]: missing required key 'at'")
        _check_number(f"scenario.faults[{i}].at", f["at"], lo=0)


@dataclass
class ClusterSpec:
    nodes: int = 4
    cpu: str = "16"
    memory: str = "32Gi"
    gpu: str = "0"
    zones: List[str] = field(default_factory=lambda: ["zone1"])
    instance_group: str = "batch-medium-priority"


@dataclass
class AutoscalerSpec:
    enabled: bool = False
    delay: float = 0.0
    max_nodes: Optional[int] = None
    node_cpu: str = "16"
    node_memory: str = "32Gi"
    node_gpu: str = "0"


@dataclass
class FaultSpec:
    at: float
    kind: str
    count: int = 1
    apps: int = 1
    fraction: float = 0.5
    # window length (virtual seconds) for the windowed faults:
    # apiserver_outage / apiserver_latency / kernel_fault
    duration: float = 60.0
    # priority band stamped onto priority_storm submissions
    band: str = "high"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; known: {sorted(FAULT_KINDS)}")


@dataclass
class Scenario:
    name: str = "scenario"
    seed: int = 0
    duration: float = 600.0
    # how often pending pods are retried (kube-scheduler's backoff
    # analog) and the autoscaler pump granularity, virtual seconds
    retry_interval: float = 15.0
    binpack_algo: str = "tightly-pack"
    fifo: bool = True
    cluster: ClusterSpec = field(default_factory=ClusterSpec)
    workload: Dict = field(default_factory=dict)
    autoscaler: AutoscalerSpec = field(default_factory=AutoscalerSpec)
    faults: List[FaultSpec] = field(default_factory=list)
    # deterministic unschedulable-marker sweeps (0 disables)
    unschedulable_scan_interval: float = 0.0
    # Install.policy overrides (kebab-case, PolicyConfig.from_dict);
    # empty = policy engine disabled, byte-identical FIFO
    policy: Dict = field(default_factory=dict)
    # Install.ha overrides (kebab-case, HAConfig.from_dict); empty =
    # no fabric.  background is forced off — the sim steps elections
    # on the virtual clock
    ha: Dict = field(default_factory=dict)
    # Install.concurrent overrides (kebab-case,
    # ConcurrentConfig.from_dict); empty = serial admission.  When
    # enabled, every sim Filter routes through the concurrent engine's
    # speculate→FIFO-commit path — decisions must stay byte-identical
    # to the serial run of the same scenario
    concurrent: Dict = field(default_factory=dict)
    # Install.classes overrides (kebab-case, ClassesConfig.from_dict);
    # empty = the Install defaults (enabled, min-nodes 20000).  Set
    # {"enabled": true, "min-nodes": 0} to force class-compressed
    # solves regardless of fleet size — the class-churn scenarios do,
    # so cordon/uncordon faults flip live class memberships
    classes: Dict = field(default_factory=dict)

    @staticmethod
    def from_dict(d: Dict) -> "Scenario":
        if not isinstance(d, dict):
            raise ScenarioError(
                f"scenario: expected an object, got {type(d).__name__}"
            )
        d = dict(d)
        unknown = set(d) - _SCENARIO_KEYS
        if unknown:
            raise ScenarioError(
                f"scenario: unknown keys {sorted(unknown)} "
                f"(known: {sorted(_SCENARIO_KEYS)})"
            )
        for key in ("duration", "retry_interval", "seed"):
            if key in d:
                _check_number(f"scenario.{key}", d[key], lo=0)
        cluster_d = _check_block("scenario.cluster", d.pop("cluster", {}), _CLUSTER_KEYS)
        if "nodes" in cluster_d:
            _check_number("scenario.cluster.nodes", cluster_d["nodes"], lo=0)
        autoscaler_d = _check_block(
            "scenario.autoscaler", d.pop("autoscaler", {}), _AUTOSCALER_KEYS
        )
        faults_d = d.pop("faults", [])
        _validate_faults(faults_d)
        _validate_workload(d.get("workload", {}))
        for key in ("policy", "ha", "concurrent", "classes"):
            if key in d and not isinstance(d[key], dict):
                raise ScenarioError(
                    f"scenario.{key}: expected an object, got {type(d[key]).__name__}"
                )
        cluster = ClusterSpec(**cluster_d)
        autoscaler = AutoscalerSpec(**autoscaler_d)
        faults = [FaultSpec(**f) for f in faults_d]
        faults.sort(key=lambda f: (f.at, f.kind))
        return Scenario(cluster=cluster, autoscaler=autoscaler, faults=faults, **d)

    @staticmethod
    def from_file(path: str) -> "Scenario":
        with open(path) as f:
            return Scenario.from_dict(json.load(f))

    def to_dict(self) -> Dict:
        from dataclasses import asdict

        return asdict(self)
