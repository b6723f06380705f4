"""Wire (de)serialization + CRD version conversion.

Covers the reference's k8s JSON shapes for the extender protocol and the
ResourceReservation v1beta1 ↔ v1beta2 conversion
(lib/pkg/apis/sparkscheduler/v1beta1/conversion_resource_reservation.go:
the v1beta1 schema is flat {Node, CPU, Memory}; lossless round-trips
keep a JSON copy of the full v1beta2 spec in the
``sparkscheduler.palantir.com/reservation-spec`` annotation), plus
Demand v1alpha1 ↔ v1alpha2 (flat resources vs resource list).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Any, Dict, List

from ..analysis import racecheck
from ..analysis.guarded import guarded_by
from ..utils.quantity import Quantity
from .extenderapi import ExtenderArgs, ExtenderFilterResult
from .objects import (
    Container,
    Demand,
    DemandSpec,
    DemandStatus,
    DemandUnit,
    Node,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodCondition,
    Reservation,
    ResourceReservation,
    ResourceReservationSpec,
    ResourceReservationStatus,
)
from .resources import RESOURCE_CPU, RESOURCE_MEMORY, Resources

GROUP_NAME = "sparkscheduler.palantir.com"
RESERVATION_SPEC_ANNOTATION_KEY = GROUP_NAME + "/reservation-spec"


# ---------------------------------------------------------------------------
# ObjectMeta
# ---------------------------------------------------------------------------


def ts_to_rfc3339(ts: float) -> str:
    """k8s metav1.Time wire form (UTC, second precision)."""
    import datetime

    return (
        datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%SZ")
    )


def _ts_from_wire(value) -> float:
    """Accept the embedded wire's float timestamps AND k8s RFC3339."""
    if value is None:
        return 0.0
    if isinstance(value, (int, float)):
        return float(value)
    import datetime

    try:
        return float(value)
    except (TypeError, ValueError):
        pass
    try:
        return datetime.datetime.strptime(
            str(value), "%Y-%m-%dT%H:%M:%SZ"
        ).replace(tzinfo=datetime.timezone.utc).timestamp()
    except ValueError:
        return 0.0


def meta_to_dict(meta: ObjectMeta) -> dict:
    """Embedded-wire form (float timestamps); the REST backend converts
    to real k8s RFC3339 in one place (restbackend._k8s_wire)."""
    out: Dict[str, Any] = {
        "name": meta.name,
        "namespace": meta.namespace,
        "labels": dict(meta.labels),
        "annotations": dict(meta.annotations),
        "creationTimestamp": meta.creation_timestamp,
        "resourceVersion": str(meta.resource_version),
        "uid": meta.uid,
    }
    if meta.owner_references:
        out["ownerReferences"] = [
            {
                "apiVersion": "v1",
                "kind": ref.kind,
                "name": ref.name,
                "uid": ref.uid,
                "controller": ref.controller,
            }
            for ref in meta.owner_references
        ]
    if meta.deletion_timestamp is not None:
        out["deletionTimestamp"] = meta.deletion_timestamp
    return out


def meta_from_dict(d: dict) -> ObjectMeta:
    rv_raw = d.get("resourceVersion", 0)
    try:
        rv = int(rv_raw)
    except (TypeError, ValueError):
        rv = 0
    deletion = d.get("deletionTimestamp")
    return ObjectMeta(
        name=d.get("name", ""),
        namespace=d.get("namespace", "default"),
        labels=dict(d.get("labels") or {}),
        annotations=dict(d.get("annotations") or {}),
        creation_timestamp=_ts_from_wire(d.get("creationTimestamp")),
        deletion_timestamp=_ts_from_wire(deletion) if deletion is not None else None,
        resource_version=rv,
        uid=d.get("uid", ""),
        owner_references=[
            OwnerReference(
                kind=ref.get("kind", ""),
                name=ref.get("name", ""),
                uid=ref.get("uid", ""),
                controller=bool(ref.get("controller", True)),
            )
            for ref in d.get("ownerReferences") or []
        ],
    )


# ---------------------------------------------------------------------------
# Pod (k8s core/v1 subset used by the extender protocol)
# ---------------------------------------------------------------------------


def pod_from_dict(d: dict) -> Pod:
    meta = meta_from_dict(d.get("metadata") or {})
    spec = d.get("spec") or {}
    status = d.get("status") or {}

    affinity = (spec.get("affinity") or {}).get("nodeAffinity") or {}
    required = affinity.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    affinity_terms: List[list] = []
    for term in required.get("nodeSelectorTerms") or []:
        parsed_term = [
            (expr.get("key", ""), expr.get("operator"), list(expr.get("values") or []))
            for expr in term.get("matchExpressions") or []
        ]
        if parsed_term:
            affinity_terms.append(parsed_term)
    # the simple In-map convenience view (instance-group extraction) is
    # only sound for a single all-In term
    node_affinity: Dict[str, List[str]] = {}
    if len(affinity_terms) == 1 and all(op == "In" for _, op, _ in affinity_terms[0]):
        node_affinity = {k: v for k, _, v in affinity_terms[0]}
        affinity_terms = []

    def _containers(key: str) -> List[Container]:
        out = []
        for c in spec.get(key) or []:
            requests = (c.get("resources") or {}).get("requests") or {}
            out.append(
                Container(name=c.get("name", "main"), requests=Resources.from_dict(requests))
            )
        return out

    conditions = {}
    for c in status.get("conditions") or []:
        ctype = c.get("type", "")
        conditions[ctype] = PodCondition(
            type=ctype,
            status=c.get("status", ""),
            reason=c.get("reason", ""),
            message=c.get("message", ""),
            transition_time=_ts_from_wire(c.get("lastTransitionTime")),
        )
    container_terminated = [
        "terminated" in ((cs.get("state") or {}))
        for cs in status.get("containerStatuses") or []
    ]

    return Pod(
        meta=meta,
        scheduler_name=spec.get("schedulerName", ""),
        node_name=spec.get("nodeName", ""),
        node_selector=dict(spec.get("nodeSelector") or {}),
        node_affinity=node_affinity,
        affinity_terms=affinity_terms,
        containers=_containers("containers"),
        # init containers count toward pod requests — max(sum, each init)
        # (reference overhead.go:195-209); dropping them under-counts
        # overhead for pods with large init steps
        init_containers=_containers("initContainers"),
        phase=status.get("phase", "Pending"),
        container_terminated=container_terminated,
        conditions=conditions,
    )


def pod_to_dict(pod: Pod) -> dict:
    if pod.affinity_terms:
        terms = [
            {
                "matchExpressions": [
                    {"key": k, "operator": op, "values": list(values)}
                    for k, op, values in term
                ]
            }
            for term in pod.affinity_terms
        ]
    elif pod.node_affinity:
        terms = [
            {
                "matchExpressions": [
                    {"key": k, "operator": "In", "values": v}
                    for k, v in pod.node_affinity.items()
                ]
            }
        ]
    else:
        terms = []

    def _containers_to_dicts(containers) -> list:
        return [
            {"name": c.name, "resources": {"requests": c.requests.to_dict()}}
            for c in containers
        ]

    spec = {
        "schedulerName": pod.scheduler_name,
        "nodeName": pod.node_name,
        "nodeSelector": dict(pod.node_selector),
        "affinity": {
            "nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": terms
                }
            }
        }
        if terms
        else {},
        "containers": _containers_to_dicts(pod.containers),
    }
    if pod.init_containers:
        spec["initContainers"] = _containers_to_dicts(pod.init_containers)
    status: Dict[str, Any] = {"phase": pod.phase}
    if pod.conditions:
        status["conditions"] = [
            {
                "type": c.type,
                "status": c.status,
                "reason": c.reason,
                "message": c.message,
                "lastTransitionTime": c.transition_time,
            }
            for c in pod.conditions.values()
        ]
    if pod.container_terminated:
        status["containerStatuses"] = [
            {"state": {"terminated": {}} if t else {"running": {}}}
            for t in pod.container_terminated
        ]
    return {
        "metadata": meta_to_dict(pod.meta),
        "spec": spec,
        "status": status,
    }


# ---------------------------------------------------------------------------
# Node (k8s core/v1 subset the scheduler reads:
# status.allocatable, spec.unschedulable, the Ready condition)
# ---------------------------------------------------------------------------


def node_to_dict(node: Node) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": meta_to_dict(node.meta),
        "spec": {"unschedulable": node.unschedulable} if node.unschedulable else {},
        "status": {
            "allocatable": node.allocatable.to_dict(),
            "conditions": [
                {"type": "Ready", "status": "True" if node.ready else "False"}
            ],
        },
    }


def node_from_dict(d: dict) -> Node:
    status = d.get("status") or {}
    ready = False
    for c in status.get("conditions") or []:
        if c.get("type") == "Ready":
            ready = c.get("status") == "True"
    return Node(
        meta=meta_from_dict(d.get("metadata") or {}),
        allocatable=Resources.from_dict(status.get("allocatable") or {}),
        unschedulable=bool((d.get("spec") or {}).get("unschedulable", False)),
        ready=ready,
    )


# ---------------------------------------------------------------------------
# Extender protocol
# ---------------------------------------------------------------------------


def extender_args_from_dict(d: dict) -> ExtenderArgs:
    return ExtenderArgs(
        pod=pod_from_dict(d.get("Pod") or d.get("pod") or {}),
        node_names=intern_node_names(
            list(d.get("NodeNames") or d.get("nodeNames") or [])
        ),
    )


# -- node-name interning + response-buffer reuse ------------------------------
#
# kube-scheduler sends the SAME candidate node-name list (10k strings,
# ~200KB of JSON) on every Filter request, and the extender's failure
# responses serialize a FailedNodes map over that same list with one
# shared message.  Interning the parsed list gives every downstream
# consumer a stable tuple object: identity-keyed caches (the uniform
# failure-response encoder below) become exact, the per-request garbage
# of 10k strings disappears, and the fast-path prep key's candidate
# tuple is shared instead of rebuilt.  Correctness never rests on the
# fingerprint: a candidate is returned only after a full element-wise
# compare (C-speed list/tuple equality), so a fingerprint collision
# costs a compare, not a wrong candidate list.


@guarded_by("_lock", "_entries", "hits", "misses")
class NodeNamesInterner:
    """Bounded exact-verified intern pool for candidate node-name lists.

    Bounded on BOTH axes: at most MAX_ENTRIES distinct fingerprints, and
    at most MAX_PER_BUCKET variants per fingerprint — interior node
    churn that keeps (len, first, last, middle) stable must rotate a
    bucket, not grow it."""

    MAX_ENTRIES = 8
    MAX_PER_BUCKET = 4

    def __init__(self):
        self._lock = threading.Lock()
        # fingerprint → list of interned tuples sharing it
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.metrics = None  # optional registry, set by server wiring

    @staticmethod
    def _fingerprint(names) -> tuple:
        n = len(names)
        if n == 0:
            return (0,)
        return (n, names[0], names[-1], names[n // 2])

    def intern(self, names: list) -> tuple:
        incoming = tuple(names)
        fp = self._fingerprint(incoming)
        hit = None
        with self._lock:
            racecheck.note_access(self, "_entries")
            bucket = self._entries.get(fp)
            if bucket is not None:
                self._entries.move_to_end(fp)
                for cand in bucket:
                    # exact verification — the fingerprint only routes
                    if cand == incoming:
                        hit = cand
                        break
            if hit is not None:
                self.hits += 1
            else:
                if bucket is None:
                    bucket = []
                    self._entries[fp] = bucket
                bucket.append(incoming)
                while len(bucket) > self.MAX_PER_BUCKET:
                    bucket.pop(0)
                self.misses += 1
                while len(self._entries) > self.MAX_ENTRIES:
                    self._entries.popitem(last=False)
        # metrics outside the intern lock (registry has its own)
        self._count("hit" if hit is not None else "miss")
        return hit if hit is not None else incoming

    def _count(self, kind: str) -> None:
        m = self.metrics
        if m is not None:
            from ..metrics import names as mnames

            m.counter(
                mnames.SERDE_INTERN_HITS
                if kind == "hit"
                else mnames.SERDE_INTERN_MISSES
            )

    def size(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._entries.values())


names_interner = NodeNamesInterner()


def intern_node_names(names: list) -> tuple:
    return names_interner.intern(names)


@guarded_by("_lock", "_cache")
class UniformFailureEncoder:
    """Reusable encoded-response buffers for uniform all-nodes failures.

    A Filter failure answers ``{node: message for node in candidates}``
    — at 10k candidates that is ~2-5 ms of json.dumps per response, for
    bytes that are identical across every request sharing the (interned
    candidate tuple, message) pair.  Entries pin the names tuple they
    were built for and verify identity on hit, so an id() recycled
    after eviction can never alias."""

    MAX_ENTRIES = 16

    def __init__(self):
        self._lock = threading.Lock()
        # (id(names), message) → (names, encoded bytes)
        self._cache: OrderedDict = OrderedDict()

    def encode(self, names: tuple, message: str, error: str = "") -> bytes:
        key = (id(names), message, error)
        with self._lock:
            racecheck.note_access(self, "_cache")
            hit = self._cache.get(key)
            if hit is not None and hit[0] is names:
                self._cache.move_to_end(key)
                return hit[1]
        encoded = json.dumps(
            {
                "NodeNames": None,
                "FailedNodes": {n: message for n in names} or None,
                "Error": error or None,
            }
        ).encode()
        with self._lock:
            racecheck.note_access(self, "_cache")
            self._cache[key] = (names, encoded)
            while len(self._cache) > self.MAX_ENTRIES:
                self._cache.popitem(last=False)
        return encoded

    def size(self) -> int:
        with self._lock:
            return len(self._cache)


uniform_failure_encoder = UniformFailureEncoder()


def encode_extender_filter_result(result: ExtenderFilterResult) -> bytes:
    """Encoded response body, served from the reusable buffer pool when
    the result is a uniform all-nodes failure over an interned candidate
    tuple (ExtenderFilterResult.uniform_failure, set by the extender's
    failure paths); a fresh dumps otherwise."""
    uniform = getattr(result, "uniform_failure", None)
    if (
        uniform is not None
        and isinstance(uniform[0], tuple)
        and len(result.failed_nodes) == len(uniform[0])
        and not result.node_names
    ):
        names, message = uniform
        return uniform_failure_encoder.encode(names, message, result.error)
    return json.dumps(result.to_dict()).encode()


# ---------------------------------------------------------------------------
# ResourceReservation v1beta2 (storage) + v1beta1 (served)
# ---------------------------------------------------------------------------


def rr_spec_to_dict_v1beta2(spec: ResourceReservationSpec) -> dict:
    return {
        "reservations": {
            name: {
                "node": res.node,
                "resources": {k: q.serialize() for k, q in res.resources.items()},
            }
            for name, res in spec.reservations.items()
        }
    }


def rr_spec_from_dict_v1beta2(d: dict) -> ResourceReservationSpec:
    reservations = {}
    for name, r in (d.get("reservations") or {}).items():
        reservations[name] = Reservation(
            node=r.get("node", ""),
            resources={k: Quantity(v) for k, v in (r.get("resources") or {}).items()},
        )
    return ResourceReservationSpec(reservations=reservations)


def rr_to_dict_v1beta2(rr: ResourceReservation) -> dict:
    return {
        "apiVersion": f"{GROUP_NAME}/v1beta2",
        "kind": "ResourceReservation",
        "metadata": meta_to_dict(rr.meta),
        "spec": rr_spec_to_dict_v1beta2(rr.spec),
        "status": {"pods": dict(rr.status.pods)},
    }


def rr_from_dict_v1beta2(d: dict) -> ResourceReservation:
    return ResourceReservation(
        meta=meta_from_dict(d.get("metadata") or {}),
        spec=rr_spec_from_dict_v1beta2(d.get("spec") or {}),
        status=ResourceReservationStatus(pods=dict((d.get("status") or {}).get("pods") or {})),
    )


def rr_to_dict_v1beta1(rr: ResourceReservation) -> dict:
    """ConvertFrom (v1beta2 → v1beta1), conversion_resource_reservation.go:
    86-121: flat {node,cpu,memory} reservations + full v1beta2 spec JSON
    kept in the reservation-spec annotation for lossless round trips."""
    meta = meta_to_dict(rr.meta)
    annotations = dict(meta.get("annotations") or {})
    annotations[RESERVATION_SPEC_ANNOTATION_KEY] = json.dumps(
        rr_spec_to_dict_v1beta2(rr.spec), sort_keys=True
    )
    meta["annotations"] = annotations
    return {
        "apiVersion": f"{GROUP_NAME}/v1beta1",
        "kind": "ResourceReservation",
        "metadata": meta,
        "spec": {
            "reservations": {
                name: {
                    "node": res.node,
                    "cpu": res.resources.get(RESOURCE_CPU, Quantity(0)).serialize(),
                    "memory": res.resources.get(RESOURCE_MEMORY, Quantity(0)).serialize(),
                }
                for name, res in rr.spec.reservations.items()
            }
        },
        "status": {"pods": dict(rr.status.pods)},
    }


def rr_from_dict_v1beta1(d: dict) -> ResourceReservation:
    """ConvertTo (v1beta1 → v1beta2), conversion_resource_reservation.go:
    28-83: base values from the flat struct; any extra resource
    dimensions (e.g. GPU) recovered from the reservation-spec annotation;
    the annotation itself is dropped from the converted object."""
    meta = meta_from_dict(d.get("metadata") or {})
    annotation_json = meta.annotations.pop(RESERVATION_SPEC_ANNOTATION_KEY, None)

    reservations: Dict[str, Reservation] = {}
    for name, r in ((d.get("spec") or {}).get("reservations") or {}).items():
        reservations[name] = Reservation(
            node=r.get("node", ""),
            resources={
                RESOURCE_CPU: Quantity(r.get("cpu", "0")),
                RESOURCE_MEMORY: Quantity(r.get("memory", "0")),
            },
        )

    if annotation_json:
        try:
            annotation_spec = rr_spec_from_dict_v1beta2(json.loads(annotation_json))
        except (ValueError, TypeError):
            annotation_spec = None
        if annotation_spec is not None:
            for name, annotation_res in annotation_spec.reservations.items():
                existing = reservations.get(name)
                if existing is None:
                    continue
                for resource_name, quantity in annotation_res.resources.items():
                    if resource_name not in existing.resources:
                        existing.resources[resource_name] = quantity

    return ResourceReservation(
        meta=meta,
        spec=ResourceReservationSpec(reservations=reservations),
        status=ResourceReservationStatus(pods=dict((d.get("status") or {}).get("pods") or {})),
    )


def convert_rr(obj: dict, desired_api_version: str) -> dict:
    """Webhook conversion entry: any served version → desired version."""
    api_version = obj.get("apiVersion", "")
    if api_version == desired_api_version:
        return obj
    if api_version.endswith("v1beta1"):
        hub = rr_from_dict_v1beta1(obj)
    elif api_version.endswith("v1beta2"):
        hub = rr_from_dict_v1beta2(obj)
    else:
        raise ValueError(f"unknown apiVersion {api_version}")
    if desired_api_version.endswith("v1beta2"):
        return rr_to_dict_v1beta2(hub)
    if desired_api_version.endswith("v1beta1"):
        return rr_to_dict_v1beta1(hub)
    raise ValueError(f"unknown desired apiVersion {desired_api_version}")


# ---------------------------------------------------------------------------
# Demand v1alpha2 (storage) + v1alpha1
# ---------------------------------------------------------------------------

SCALER_GROUP = "scaler.palantir.com"


def demand_to_dict_v1alpha2(demand: Demand) -> dict:
    return {
        "apiVersion": f"{SCALER_GROUP}/v1alpha2",
        "kind": "Demand",
        "metadata": meta_to_dict(demand.meta),
        "spec": {
            "units": [
                {
                    "resources": u.resources.to_dict(),
                    "count": u.count,
                    "podNamesByNamespace": {k: list(v) for k, v in u.pod_names_by_namespace.items()},
                }
                for u in demand.spec.units
            ],
            "instanceGroup": demand.spec.instance_group,
            "isLongLived": demand.spec.is_long_lived,
            "enforceSingleZoneScheduling": demand.spec.enforce_single_zone_scheduling,
            "zone": demand.spec.zone,
        },
        "status": {
            "phase": demand.status.phase,
            "lastTransitionTime": demand.status.last_transition_time,
            "fulfilledZone": demand.status.fulfilled_zone,
        },
    }


def demand_from_dict_v1alpha2(d: dict) -> Demand:
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    units = [
        DemandUnit(
            resources=Resources.from_dict(u.get("resources") or {}),
            count=int(u.get("count", 0)),
            pod_names_by_namespace={
                k: list(v) for k, v in (u.get("podNamesByNamespace") or {}).items()
            },
        )
        for u in spec.get("units") or []
    ]
    return Demand(
        meta=meta_from_dict(d.get("metadata") or {}),
        spec=DemandSpec(
            units=units,
            instance_group=spec.get("instanceGroup", ""),
            is_long_lived=bool(spec.get("isLongLived", False)),
            enforce_single_zone_scheduling=bool(spec.get("enforceSingleZoneScheduling", False)),
            zone=spec.get("zone"),
        ),
        status=DemandStatus(
            phase=status.get("phase", ""),
            last_transition_time=float(status.get("lastTransitionTime") or 0.0),
            fulfilled_zone=status.get("fulfilledZone"),
        ),
    )


def demand_to_dict_v1alpha1(demand: Demand) -> dict:
    """v1alpha1 units use flat cpu/memory fields (types_demand.go v1alpha1)."""
    d = demand_to_dict_v1alpha2(demand)
    d["apiVersion"] = f"{SCALER_GROUP}/v1alpha1"
    for u, unit in zip(d["spec"]["units"], demand.spec.units):
        resources = u.pop("resources")
        u["cpu"] = resources[RESOURCE_CPU]
        u["memory"] = resources[RESOURCE_MEMORY]
    return d


def demand_from_dict_v1alpha1(d: dict) -> Demand:
    converted = json.loads(json.dumps(d))
    for u in (converted.get("spec") or {}).get("units") or []:
        u["resources"] = {
            RESOURCE_CPU: u.pop("cpu", "0"),
            RESOURCE_MEMORY: u.pop("memory", "0"),
        }
    return demand_from_dict_v1alpha2(converted)
