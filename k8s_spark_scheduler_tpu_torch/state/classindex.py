"""Node equivalence-class index (Firmament/Borg-style aggregation), a
copy of the reference package's ``state/classindex.py``.  In the
reference it is the state-layer companion of the native
class-compressed solver; here it serves the delta-solve engine's
class-digest warm tier (``ops/deltasolve.py``), whose sessions step by
class with their own partition (``ops/class_kernel.py``).

Real fleets have a few dozen machine shapes, so the 100k-node table
collapses to a small set of classes.  This index maintains, O(1) per
ChangeFeed delta (a node mutation touches one class, never a row scan):

- the class multiset keyed by (rounded capacity vector, label
  signature, AZ, schedulability) with per-class multiplicities — the
  capacity observatory's per-class analytics and the ``tpu.classes.*``
  gauges read it;
- ``class_rev`` — bumped whenever the class MULTISET changes (a node
  changes class, appears, or disappears), so consumers can cache
  class-derived work across same-class node churn;
- ``digest`` — an XOR-combination of one 64-bit hash per node over the
  node's FULL content (name, allocatable, usage, overhead, zone,
  ready, unschedulable, label signature).  XOR makes the digest
  order-independent and self-cancelling under churn, so maintaining it
  is O(1) per delta.  Equal digests across two snapshots of the same
  mirror (same structure revision) imply equal rows up to 64-bit
  collisions — the delta-solve engine uses it as an O(1) warm-basis
  tier ahead of the O(N) row compare, and its existing warm≠cold
  parity guard audits the conclusion.

Hashes use the process-seeded builtin ``hash`` (tuple hashing is C
speed); digests are only ever compared within one process, and the
``(instance, digest)`` pairing on snapshots keeps different mirrors
from aliasing.

Thread-safety: the owning TensorSnapshotCache calls every mutator under
its own lock, but the index carries its own lock so readers of its
stats need not enter the mirror's critical section.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..analysis import racecheck
from ..analysis.guarded import guarded_by

# class-key capacity rounding: quantities inside one bucket are the
# same machine shape for analytics purposes (base units are cpu milli /
# mem bytes / gpu milli — see ops/tensorize.py)
CPU_BUCKET_MILLI = 500          # half a core
MEM_BUCKET_BYTES = 1 << 30      # 1 GiB
GPU_BUCKET_MILLI = 1000         # whole accelerators


def labels_signature(labels: Dict[str, str]) -> int:
    """Order-independent stable-within-process label signature."""
    return hash(tuple(sorted(labels.items())))


@guarded_by("_lock", "_slots")
class ClassIndex:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        # class key -> multiplicity
        self._counts: Dict[tuple, int] = {}
        # node slot -> (class key, content hash, labels signature)
        self._slots: Dict[int, Tuple[tuple, int, int]] = {}
        self._digest = 0
        self._rev = 0

    # -- keys ----------------------------------------------------------------

    @staticmethod
    def _key(alloc_row, zone: int, ready: bool, unsched: bool,
             labels_sig: int) -> tuple:
        return (
            int(alloc_row[0]) // CPU_BUCKET_MILLI,
            int(alloc_row[1]) // MEM_BUCKET_BYTES,
            int(alloc_row[2]) // GPU_BUCKET_MILLI,
            labels_sig,
            int(zone),
            bool(ready) and not bool(unsched),
        )

    @staticmethod
    def _content_hash(name: str, alloc_row, usage_row, overhead_row,
                      zone: int, ready: bool, unsched: bool,
                      labels_sig: int, res_count: int) -> int:
        return hash((
            name,
            int(alloc_row[0]), int(alloc_row[1]), int(alloc_row[2]),
            int(usage_row[0]), int(usage_row[1]), int(usage_row[2]),
            int(overhead_row[0]), int(overhead_row[1]), int(overhead_row[2]),
            int(zone), bool(ready), bool(unsched), labels_sig,
            int(res_count),
        ))

    # -- maintenance (one call per ChangeFeed delta) -------------------------

    def note_node(self, slot: int, name: str, alloc_row, usage_row,
                  overhead_row, zone: int, ready: bool, unsched: bool,
                  res_count: int = 0,
                  labels: Optional[Dict[str, str]] = None) -> None:
        """(Re)index one node slot.  ``labels=None`` reuses the cached
        label signature (usage/overhead deltas never change labels, and
        recomputing the signature would make them O(labels))."""
        with self._lock:
            racecheck.note_access(self, "_slots")
            prev = self._slots.get(slot)
            if labels is not None:
                sig = labels_signature(labels)
            elif prev is not None:
                sig = prev[2]
            else:
                sig = labels_signature({})
            key = self._key(alloc_row, zone, ready, unsched, sig)
            h = self._content_hash(
                name, alloc_row, usage_row, overhead_row, zone, ready,
                unsched, sig, res_count,
            )
            if prev is not None:
                prev_key, prev_hash, _ = prev
                if prev_key != key:
                    self._retire_key(prev_key)
                    self._admit_key(key)
                self._digest ^= prev_hash
            else:
                self._admit_key(key)
            self._digest ^= h
            self._slots[slot] = (key, h, sig)

    def drop_node(self, slot: int) -> None:
        with self._lock:
            racecheck.note_access(self, "_slots")
            prev = self._slots.pop(slot, None)
            if prev is None:
                return
            self._retire_key(prev[0])
            self._digest ^= prev[1]

    def _admit_key(self, key: tuple) -> None:
        self._counts[key] = self._counts.get(key, 0) + 1
        self._rev += 1

    def _retire_key(self, key: tuple) -> None:
        n = self._counts.get(key, 0) - 1
        if n <= 0:
            self._counts.pop(key, None)
        else:
            self._counts[key] = n
        self._rev += 1

    # -- reads ---------------------------------------------------------------

    @property
    def digest(self) -> int:
        with self._lock:
            return self._digest

    @property
    def class_rev(self) -> int:
        with self._lock:
            return self._rev

    def stats(self) -> Tuple[int, int, float]:
        """(class count, node count, compression ratio nodes/classes)."""
        with self._lock:
            n_classes = len(self._counts)
            n_nodes = len(self._slots)
            ratio = (n_nodes / n_classes) if n_classes else 1.0
            return n_classes, n_nodes, ratio

    def class_sizes(self) -> Dict[tuple, int]:
        """Copy of the class multiset (key -> multiplicity)."""
        with self._lock:
            return dict(self._counts)
