"""Bounded per-decision provenance records.

One :class:`DecisionRecord` per scheduling decision — small (names,
keys, verdict, optional shortfall decomposition; never tensor data) —
kept in a bounded ring indexed by pod name.  ``GET /explain/<pod>`` and
the enriched ``/debug/schedule/<pod>`` serve from here.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .explain import ShortfallInfo


@dataclass
class DecisionRecord:
    """What one Filter decision was, and why."""

    pod: str
    namespace: str = "default"
    role: str = ""
    instance_group: str = ""
    trace_id: Optional[str] = None
    t: float = 0.0                    # timesource (virtual in the sim)
    outcome: str = ""
    node: str = ""
    # lane that served the queue pass: "cuda" / "cuda-minfrag" (the CUDA
    # kernels) or "torch" / "torch-minfrag" (their plain versions on the
    # CPU), where the reference says native / xla / pallas
    lane: str = ""
    policy: str = ""
    content_key: Optional[Tuple] = None  # snapshot content key at solve time
    feed_seq: Optional[int] = None       # change-feed sequence at solve time
    queue_len: int = 0                   # earlier drivers ahead of this one
    queue_slice: Tuple[str, ...] = ()    # first earlier-driver pod names
    earlier_infeasible: Tuple[int, ...] = ()  # blocked earlier queue positions
    shortfall: Optional[ShortfallInfo] = None
    message: str = ""
    bundle_seq: Optional[int] = None  # flight-recorder bundle holding arrays

    def to_dict(self) -> dict:
        out = {
            "pod": self.pod,
            "namespace": self.namespace,
            "role": self.role,
            "instanceGroup": self.instance_group,
            "traceId": self.trace_id,
            "t": self.t,
            "outcome": self.outcome,
            "node": self.node or None,
            "lane": self.lane or None,
            "policy": self.policy or None,
            "contentKey": list(self.content_key) if self.content_key else None,
            "feedSeq": self.feed_seq,
            "queueLength": self.queue_len,
            "queueSlice": list(self.queue_slice),
            "earlierInfeasible": list(self.earlier_infeasible),
            "shortfall": self.shortfall.to_dict() if self.shortfall else None,
            "message": self.message or None,
            "bundleSeq": self.bundle_seq,
        }
        return out


class ProvenanceRing:
    """Bounded decision-record ring with a latest-per-pod index.

    The ring bounds total memory; the index keeps O(1) ``/explain``
    lookups and is pruned as records fall off the ring (an evicted
    record's pod entry is dropped only if it still points at the evicted
    record — a newer decision for the same pod keeps its entry)."""

    def __init__(self, capacity: int = 128):
        self._lock = threading.Lock()
        self._capacity = max(1, int(capacity))
        self._ring: deque = deque()
        self._by_pod: "OrderedDict[str, DecisionRecord]" = OrderedDict()
        self.recorded = 0

    @staticmethod
    def _key(namespace: str, pod: str) -> str:
        return f"{namespace}/{pod}"

    def record(self, rec: DecisionRecord) -> None:
        key = self._key(rec.namespace, rec.pod)
        with self._lock:
            self._ring.append(rec)
            self._by_pod[key] = rec
            self._by_pod.move_to_end(key)
            self.recorded += 1
            while len(self._ring) > self._capacity:
                old = self._ring.popleft()
                old_key = self._key(old.namespace, old.pod)
                if self._by_pod.get(old_key) is old:
                    del self._by_pod[old_key]

    def latest_for_pod(self, pod: str) -> Optional[DecisionRecord]:
        """Lookup by ``namespace/pod``, or by bare pod name (newest
        match across namespaces — the convenience form the
        ``/explain/<pod>`` endpoint serves; pass ``ns/pod`` to
        disambiguate same-named pods in a multi-tenant cluster)."""
        with self._lock:
            if "/" in pod:
                return self._by_pod.get(pod)
            suffix = "/" + pod
            for key in reversed(self._by_pod):
                if key.endswith(suffix):
                    return self._by_pod[key]
            return None

    def recent(self, limit: int = 20) -> List[DecisionRecord]:
        with self._lock:
            items = list(self._ring)
        return items[-max(0, int(limit)):][::-1]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "size": len(self._ring),
                "capacity": self._capacity,
                "recorded": self.recorded,
                "indexed_pods": len(self._by_pod),
            }
