"""Event-driven integer-tensor mirror of cluster state — the steady-state
fast path for `binpack: tpu-batch` at 10k-node scale.

The reference recomputes its scheduling snapshot from scratch on every
Filter request: GetReservedResources walks every reservation
(resourcereservations.go:258-263), GetOverhead walks every pod on every
candidate node (overhead.go:120-153), and NodeSchedulingMetadataForNodes
re-derives availability per node (resources.go:61-100) — all in
arbitrary-precision quantity arithmetic.  That is O(cluster) of host
work per request, which caps honest end-to-end latency long before the
device solve does.

This cache keeps the same state as O(delta)-updated int64 arrays:

- nodes: allocatable/zone/labels/ready from node informer events;
- reservation usage: per-node deltas from ResourceReservationCache and
  SoftReservationStore change observers (this process is the sole
  writer of both, so the mirror is exact);
- overhead: a pod table (requests, node, scheduler flag) from pod
  informer events plus a reserved-pod-name set maintained from the
  same reservation observers; per-request overhead is one vectorized
  segment-sum.

Exactness: every quantity is converted to base units once, at event
time; anything not exactly representable poisons the affected row and
``snapshot()`` reports exact=False so the caller falls back to the
Quantity path.  Decisions from this snapshot are bit-identical to the
slow path (tests/test_tensor_snapshot.py proves it on randomized
mutation sequences).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..analysis import racecheck
from ..analysis.guarded import guarded_by
from ..ops.tensorize import _resources_to_base
from ..scheduler import labels as L
from ..scheduler.overhead import pod_to_resources
from ..types.objects import Node, Pod
from ..types.resources import ZONE_LABEL, ZONE_LABEL_PLACEHOLDER
from .classindex import ClassIndex
from .store import (
    DELTA_NODE,
    DELTA_NODE_STRUCTURE,
    DELTA_POD,
    DELTA_RESERVATION,
    DELTA_SOFT_RESERVATION,
    ChangeFeed,
)

_GROW = 256


@dataclass
class TensorSnapshot:
    """A point-in-time view (copies — safe to use off-lock)."""

    names: List[str]                 # [N] node names
    allocatable: np.ndarray          # [N, 3] int64
    usage: np.ndarray                # [N, 3] int64 (hard + soft reservations)
    overhead: np.ndarray             # [N, 3] int64 (non-reservation pods)
    zone_names: List[str]
    zone_id: np.ndarray              # [N] int32
    ready: np.ndarray                # [N] bool
    unschedulable: np.ndarray        # [N] bool
    labels: List[Dict[str, str]]     # [N]
    exact: bool
    # nodes referenced by ≥1 (hard or soft) reservation — i.e. nodes that
    # would have an entry in GetReservedResources' usage map.  The
    # reschedule path's double-overhead quirk (resource.go:638-643)
    # applies only to such nodes, entry-ness included zero-valued
    # reservations, so a resource-row test cannot stand in for it.
    res_entries: np.ndarray          # [N] bool
    # lexicographic rank of each node's name among live nodes — an int
    # sort key equivalent to sorting the names themselves, maintained on
    # topology changes so per-request orderings never sort object arrays
    name_rank: np.ndarray            # [N] int64

    # (maintainer instance, structure revision): changes whenever the
    # node TABLE changes (add/remove/labels/zone/ready/unschedulable —
    # not usage), letting per-request consumers cache structure-derived
    # work (ops/fast_path._build_prep) across Filter requests
    structure_key: tuple = (-1, -1)

    # (maintainer instance, change-feed sequence): changes on EVERY
    # mutation the mirror absorbs — an equal content_key across two
    # snapshots proves their contents are identical, so consumers
    # (ops/deltasolve.py) can skip even the content compare
    content_key: tuple = (-1, -1)

    # (maintainer instance, XOR node-content digest) from the class
    # index (state/classindex.py): equal digests across snapshots of
    # the same mirror imply equal node rows up to 64-bit collisions —
    # the delta-solve engine's O(1) warm-basis tier between content_key
    # equality and the O(N) row compare.  Survives same-content churn
    # (a reserve+release pair cancels in the XOR) that content_key,
    # which counts every mutation, cannot.
    class_digest: tuple = (-1, -1)

    # class-structure revision: bumps only when the class MULTISET
    # changes, so class-derived caches survive same-class node churn
    class_rev: int = -1

    _name_index: Optional[Dict[str, int]] = None

    @property
    def avail(self) -> np.ndarray:
        return self.allocatable - self.usage - self.overhead

    @property
    def schedulable(self) -> np.ndarray:
        return self.allocatable - self.overhead

    @property
    def name_index(self) -> Dict[str, int]:
        """name → row, built once per snapshot (C-speed dict(zip))."""
        if self._name_index is None:
            self._name_index = dict(zip(self.names, range(len(self.names))))
        return self._name_index


_INSTANCE_SEQ = itertools.count()


@guarded_by("_lock", "_node_slot", "_pod_slot")
class TensorSnapshotCache:
    def __init__(self, node_informer, pod_informer, rr_cache, soft_store):
        self._lock = threading.RLock()
        self._exact = True
        # cache-instance id + structure revision (see TensorSnapshot.
        # structure_key); instance ids are process-unique so revisions
        # from different maintainers can never alias in consumer caches
        self._instance_id = next(_INSTANCE_SEQ)
        self._structure_rev = 0
        # snapshot()'s structure-derived parts, keyed by _structure_rev
        self._struct_cache = None
        # monotonic typed-delta feed: every mutation this mirror absorbs
        # publishes one delta (under the mirror lock, so a snapshot
        # taken under the same lock sees a consistent sequence); the
        # delta-solve engine keys its warm-path checks on the sequence
        self.feed = ChangeFeed()
        # equivalence-class index (state/classindex.py): every node mutation below
        # renotes its one slot, keeping the class multiset, revision and
        # XOR content digest O(1)-current off the same deltas
        self.classes = ClassIndex()

        # node table
        self._node_slot: Dict[str, int] = {}
        self._node_names: List[Optional[str]] = []
        self._free_nodes: List[int] = []
        self._alloc = np.zeros((0, 3), dtype=np.int64)
        self._usage = np.zeros((0, 3), dtype=np.int64)
        self._res_count = np.zeros(0, dtype=np.int64)
        self._name_rank = np.zeros(0, dtype=np.int64)
        self._names_dirty = True
        self._node_overhead = np.zeros((0, 3), dtype=np.int64)
        self._zone_id = np.zeros(0, dtype=np.int32)
        self._ready = np.zeros(0, dtype=bool)
        self._unsched = np.zeros(0, dtype=bool)
        self._labels: List[Dict[str, str]] = []
        self._zone_names: List[str] = []
        self._zone_index: Dict[str, int] = {}
        # usage destined for nodes we don't (yet) know
        self._orphan_usage: Dict[str, np.ndarray] = {}
        self._orphan_res_count: Dict[str, int] = {}

        # pod table (for overhead)
        self._pod_slot: Dict[Tuple[str, str], int] = {}
        self._pod_requests = np.zeros((0, 3), dtype=np.int64)
        # node NAME per pod slot (resolved to a node slot at recompute
        # time: slots are reused on node churn and pods can be observed
        # before their node, so a stored slot index would go stale)
        self._pod_node_name: List[str] = []
        self._pod_active = np.zeros(0, dtype=bool)
        self._free_pods: List[int] = []
        # pods currently holding a reservation: (ns, name) from RR
        # status.pods; soft reservations track bare pod names (the
        # reference's soft lookup ignores namespace,
        # softreservations.go:133-151)
        self._reserved_pods: Set[Tuple[str, str]] = set()
        self._soft_reserved_names: Dict[str, int] = {}
        self._pod_key_of_slot: Dict[int, Tuple[str, str]] = {}
        self._pods_dirty = False

        node_informer.add_event_handler(
            on_add=self._on_node, on_update=lambda o, n: self._on_node(n),
            on_delete=self._on_node_delete,
        )
        pod_informer.add_event_handler(
            on_add=self._on_pod, on_update=lambda o, n: self._on_pod(n),
            on_delete=self._on_pod_delete,
        )
        rr_cache.add_change_observer(self._on_rr_change)
        soft_store.add_change_observer(self._on_soft_change)

    # -- node events ---------------------------------------------------------

    def _zone_of(self, labels: Dict[str, str]) -> int:
        zone = labels.get(ZONE_LABEL, ZONE_LABEL_PLACEHOLDER)
        idx = self._zone_index.get(zone)
        if idx is None:
            idx = len(self._zone_names)
            self._zone_index[zone] = idx
            self._zone_names.append(zone)
        return idx

    def _grow_nodes(self) -> int:
        n = len(self._node_names)
        extra = _GROW
        self._alloc = np.vstack([self._alloc, np.zeros((extra, 3), np.int64)])
        self._usage = np.vstack([self._usage, np.zeros((extra, 3), np.int64)])
        self._res_count = np.concatenate([self._res_count, np.zeros(extra, np.int64)])
        self._name_rank = np.concatenate([self._name_rank, np.zeros(extra, np.int64)])
        self._node_overhead = np.vstack(
            [self._node_overhead, np.zeros((extra, 3), np.int64)]
        )
        self._zone_id = np.concatenate([self._zone_id, np.zeros(extra, np.int32)])
        self._ready = np.concatenate([self._ready, np.zeros(extra, bool)])
        self._unsched = np.concatenate([self._unsched, np.zeros(extra, bool)])
        self._node_names.extend([None] * extra)
        self._labels.extend([{} for _ in range(extra)])
        self._free_nodes.extend(range(n + extra - 1, n - 1, -1))
        return self._free_nodes.pop()

    def _on_node(self, node: Node) -> None:
        with self._lock:
            racecheck.note_access(self, "_node_slot")
            slot = self._node_slot.get(node.name)
            new_zone = self._zone_of(node.labels)
            if slot is None or (
                self._labels[slot] != node.labels
                or self._zone_id[slot] != new_zone
                or bool(self._ready[slot]) != node.ready
                or bool(self._unsched[slot]) != node.unschedulable
            ):
                # structural change only: allocatable/status heartbeats
                # must not invalidate structure-keyed consumer caches
                self._structure_rev += 1
                self.feed.publish(DELTA_NODE_STRUCTURE, node.name)
            else:
                self.feed.publish(DELTA_NODE, node.name)
            if slot is None:
                slot = self._free_nodes.pop() if self._free_nodes else self._grow_nodes()
                self._node_slot[node.name] = slot
                self._node_names[slot] = node.name
                self._names_dirty = True
                pending = self._orphan_usage.pop(node.name, None)
                self._usage[slot] = pending if pending is not None else 0
                self._res_count[slot] = self._orphan_res_count.pop(node.name, 0)
            row, exact = _resources_to_base(node.allocatable)
            if not exact:
                self._exact = False
            self._alloc[slot] = row
            self._zone_id[slot] = new_zone
            self._ready[slot] = node.ready
            self._unsched[slot] = node.unschedulable
            self._labels[slot] = dict(node.labels)
            self._note_class(slot, labels=node.labels)

    def _on_node_delete(self, node: Node) -> None:
        with self._lock:
            racecheck.note_access(self, "_node_slot")
            self._structure_rev += 1
            self.feed.publish(DELTA_NODE_STRUCTURE, node.name)
            slot = self._node_slot.pop(node.name, None)
            if slot is None:
                return
            # park any remaining usage so a node re-add restores it
            if self._usage[slot].any():
                self._orphan_usage[node.name] = self._usage[slot].copy()
            if self._res_count[slot]:
                self._orphan_res_count[node.name] = int(self._res_count[slot])
            self._node_names[slot] = None
            self._names_dirty = True
            self._alloc[slot] = 0
            self._usage[slot] = 0
            self._res_count[slot] = 0
            self._node_overhead[slot] = 0
            self._ready[slot] = False
            self._labels[slot] = {}
            self._free_nodes.append(slot)
            self._pods_dirty = True
            self.classes.drop_node(slot)

    def _note_class(self, slot: int,
                    labels: Optional[Dict[str, str]] = None) -> None:
        """Mirror one slot's full row into the equivalence-class index
        (O(1); callers hold ``self._lock``).  Overhead is recomputed
        lazily at snapshot() — until then the index sees the previous
        overhead row, and _recompute_overhead re-notes whatever changed,
        so by the time snapshot() stamps class_digest the index is
        consistent with the rows it hands out."""
        name = self._node_names[slot]
        if name is None:
            return
        overhead = (
            self._node_overhead[slot]
            if slot < len(self._node_overhead)
            else np.zeros(3, np.int64)
        )
        self.classes.note_node(
            slot,
            name,
            self._alloc[slot],
            self._usage[slot],
            overhead,
            int(self._zone_id[slot]),
            bool(self._ready[slot]),
            bool(self._unsched[slot]),
            res_count=int(self._res_count[slot]),
            labels=labels,
        )

    # -- reservation usage ---------------------------------------------------

    def _apply_usage(self, node: str, row: np.ndarray, sign: int) -> None:
        # each call is one reservation contribution: the entry count
        # tracks whether the node would appear in GetReservedResources'
        # usage map at all (even with zero-valued rows)
        # like the usage row, the count is NOT clamped: a transient
        # minus-before-plus imbalance must cancel exactly when the
        # matching event arrives, or entry-ness would desync from the
        # reserved-resources map permanently
        slot = self._node_slot.get(node)
        if slot is not None:
            self._usage[slot] += sign * row
            self._res_count[slot] += sign
            self._note_class(slot)
        else:
            current = self._orphan_usage.get(node)
            if current is None:
                current = np.zeros(3, np.int64)
            self._orphan_usage[node] = current + sign * row
            self._orphan_res_count[node] = self._orphan_res_count.get(node, 0) + sign

    @staticmethod
    def _rr_rows(rr) -> Dict[str, np.ndarray]:
        """node → summed base-unit rows for one reservation object."""
        rows: Dict[str, np.ndarray] = {}
        for reservation in rr.spec.reservations.values():
            row, _ = _resources_to_base(reservation.resources_value())
            arr = rows.get(reservation.node)
            if arr is None:
                rows[reservation.node] = np.array(row, np.int64)
            else:
                rows[reservation.node] = arr + np.array(row, np.int64)
        return rows

    def _on_rr_change(self, old, new) -> None:
        with self._lock:
            if old is not None:
                for node, row in self._rr_rows(old).items():
                    self._apply_usage(node, row, -1)
                for pod_name in old.status.pods.values():
                    self._reserved_pods.discard((old.namespace, pod_name))
            if new is not None:
                for reservation in new.spec.reservations.values():
                    _, e = _resources_to_base(reservation.resources_value())
                    if not e:
                        self._exact = False
                for node, row in self._rr_rows(new).items():
                    self._apply_usage(node, row, +1)
                for pod_name in new.status.pods.values():
                    self._reserved_pods.add((new.namespace, pod_name))
            self._pods_dirty = True
            ref = new if new is not None else old
            self.feed.publish(
                DELTA_RESERVATION, ref.name if ref is not None else None
            )

    def _on_soft_change(self, node: str, resources, sign: int, pod_name: str) -> None:
        with self._lock:
            row, exact = _resources_to_base(resources)
            if not exact:
                self._exact = False
            self._apply_usage(node, np.array(row, np.int64), sign)
            count = self._soft_reserved_names.get(pod_name, 0) + sign
            if count <= 0:
                self._soft_reserved_names.pop(pod_name, None)
            else:
                self._soft_reserved_names[pod_name] = count
            self._pods_dirty = True
            self.feed.publish(DELTA_SOFT_RESERVATION, pod_name)

    # -- pod table (overhead) ------------------------------------------------

    def _grow_pods(self) -> int:
        n = len(self._pod_active)
        extra = _GROW
        self._pod_requests = np.vstack([self._pod_requests, np.zeros((extra, 3), np.int64)])
        self._pod_node_name.extend([""] * extra)
        self._pod_active = np.concatenate([self._pod_active, np.zeros(extra, bool)])
        self._free_pods.extend(range(n + extra - 1, n - 1, -1))
        return self._free_pods.pop()

    def _on_pod(self, pod: Pod) -> None:
        with self._lock:
            racecheck.note_access(self, "_pod_slot")
            key = (pod.namespace, pod.name)
            slot = self._pod_slot.get(key)
            if pod.node_name == "":
                if slot is not None:
                    self._pod_active[slot] = False
                    self._pods_dirty = True
                    self.feed.publish(DELTA_POD, pod.name)
                # a nodeless pod the mirror never tracked changes no
                # state: queued-driver heartbeats must not churn the
                # content sequence (they arrive on every Filter cycle)
                return
            if slot is None:
                slot = self._free_pods.pop() if self._free_pods else self._grow_pods()
                self._pod_slot[key] = slot
                self._pod_key_of_slot[slot] = key
            row, exact = _resources_to_base(pod_to_resources(pod))
            if not exact:
                self._exact = False
            self._pod_requests[slot] = row
            self._pod_node_name[slot] = pod.node_name
            self._pod_active[slot] = True
            self.feed.publish(DELTA_POD, pod.name)
            if pod.labels.get(L.SPARK_ROLE_LABEL) == L.EXECUTOR and pod.is_terminated():
                # terminated pods keep informer entries but the reference
                # counts them via the lister; overhead counts any pod whose
                # entry exists — parity is with overhead.go which relies on
                # delete events, so keep the pod until deletion
                pass
            self._pods_dirty = True

    def _on_pod_delete(self, pod: Pod) -> None:
        with self._lock:
            racecheck.note_access(self, "_pod_slot")
            slot = self._pod_slot.pop((pod.namespace, pod.name), None)
            if slot is not None:
                self._pod_active[slot] = False
                self._pod_node_name[slot] = ""
                self._pod_key_of_slot.pop(slot, None)
                self._free_pods.append(slot)
                self._pods_dirty = True
            was_reserved = (pod.namespace, pod.name) in self._reserved_pods
            self._reserved_pods.discard((pod.namespace, pod.name))
            if slot is not None or was_reserved:
                self.feed.publish(DELTA_POD, pod.name)

    # -- snapshot ------------------------------------------------------------

    def _recompute_overhead(self) -> None:
        n_nodes = len(self._node_names)
        overhead = np.zeros((n_nodes, 3), dtype=np.int64)
        active = np.flatnonzero(self._pod_active)
        if len(active):
            # reserved pods don't count (overhead.go:139-141; soft
            # reservations match by bare pod name like the reference)
            mask = np.fromiter(
                (
                    (key := self._pod_key_of_slot.get(int(slot), ("", ""))) not in self._reserved_pods
                    and key[1] not in self._soft_reserved_names
                    for slot in active
                ),
                dtype=bool,
                count=len(active),
            )
            counted = active[mask]
            node_idx = np.fromiter(
                (
                    self._node_slot.get(self._pod_node_name[int(slot)], -1)
                    for slot in counted
                ),
                dtype=np.int64,
                count=len(counted),
            )
            ok = node_idx >= 0
            np.add.at(overhead, node_idx[ok], self._pod_requests[counted][ok])
        old = self._node_overhead
        if len(old) < n_nodes:
            pad = np.zeros((n_nodes - len(old), 3), np.int64)
            old = np.vstack([old, pad]) if len(old) else pad
        changed = np.flatnonzero((old[:n_nodes] != overhead).any(axis=1))
        self._node_overhead = overhead
        self._pods_dirty = False
        # overhead shifted under some nodes: bring their class-index rows
        # up to date (class KEY never depends on overhead, so this only
        # refreshes content hashes — class_rev is untouched)
        for slot in changed:
            self._note_class(int(slot))

    def _recompute_name_ranks(self) -> None:
        live = [i for i, name in enumerate(self._node_names) if name is not None]
        order = sorted(live, key=lambda i: self._node_names[i])
        for rank, slot in enumerate(order):
            self._name_rank[slot] = rank
        self._names_dirty = False

    def snapshot(self) -> TensorSnapshot:
        with self._lock:
            if self._pods_dirty:
                self._recompute_overhead()
            if self._names_dirty:
                self._recompute_name_ranks()
            # structure-derived parts (the Python-loop costs: live-slot
            # scan + 10k-element name/label lists) are cached per
            # structure revision — every mutation of names, labels,
            # zones, ready or unschedulable bumps _structure_rev
            # (_on_node/_on_node_delete), so a cache hit can only serve
            # identical structure.  The cached numpy rows are .copy()s,
            # never views, so later in-place maintainer writes (which
            # bump the rev) cannot reach snapshots already handed out.
            sc = self._struct_cache
            if sc is None or sc[0] != self._structure_rev:
                live = [
                    i for i, name in enumerate(self._node_names) if name is not None
                ]
                idx = np.array(live, dtype=np.int64)
                if len(idx) == 0:
                    idx = np.zeros(0, dtype=np.int64)
                sc = (
                    self._structure_rev,
                    idx,
                    [self._node_names[i] for i in live],
                    # label dicts are replaced (never mutated) on node
                    # events, so sharing the references is safe
                    [self._labels[i] for i in live],
                    list(self._zone_names),
                    self._zone_id[idx].copy(),
                    self._ready[idx].copy(),
                    self._unsched[idx].copy(),
                    self._name_rank[idx].copy(),
                )
                self._struct_cache = sc
            _, idx, names, labels, zone_names, zone_id, ready, unsched, ranks = sc
            return TensorSnapshot(
                names=names,
                allocatable=self._alloc[idx].copy(),
                usage=self._usage[idx].copy(),
                overhead=self._node_overhead[idx].copy()
                if len(self._node_overhead) >= len(self._node_names)
                else np.zeros((len(names), 3), np.int64),
                zone_names=zone_names,
                zone_id=zone_id,
                ready=ready,
                unschedulable=unsched,
                labels=labels,
                exact=self._exact,
                res_entries=self._res_count[idx] > 0,  # comparison allocates fresh
                name_rank=ranks,
                structure_key=(self._instance_id, self._structure_rev),
                # feed.seq is stable here: every publisher holds this
                # mirror's lock, which snapshot() also holds
                content_key=(self._instance_id, self.feed.seq),
                # all class-index mutators run under this lock too, so
                # the digest/rev pair is consistent with the rows above
                class_digest=(self._instance_id, self.classes.digest),
                class_rev=self.classes.class_rev,
            )
