"""Write-through object store + sharded unique write queue.

Reproduces ``internal/cache/store/`` exactly: an ObjectStore whose Put
preserves the currently-known resourceVersion (store.go:51-59), an
OverrideResourceVersionIfNewer that folds informer truth back in by
numeric comparison (store.go:62-76), and a sharded queue that dedupes
inflight create/update requests per key while always enqueuing deletes
(queue.go:58-92), with fnv32a shard selection so writes for the same
object serialize (queue.go:123-128).
"""

from __future__ import annotations

import queue as _queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..types.objects import APIObject

Key = Tuple[str, str]  # (namespace, name)


def key_of(obj: APIObject) -> Key:
    return (obj.namespace, obj.name)


CREATE = "create"
UPDATE = "update"
DELETE = "delete"


@dataclass(frozen=True)
class Request:
    """store/request.go:33-69."""

    key: Key
    type: str
    retry_count: int = 0

    def with_incremented_retry_count(self) -> "Request":
        return Request(self.key, self.type, self.retry_count + 1)


def create_request(obj: APIObject) -> Request:
    return Request(key_of(obj), CREATE)


def update_request(obj: APIObject) -> Request:
    return Request(key_of(obj), UPDATE)


def delete_request(key: Key) -> Request:
    return Request(key, DELETE)


class ObjectStore:
    """Thread-safe map[(ns,name)] → object (store.go:27-130).

    Content observers fire (old, new) under the lock on every semantic
    content change (insert, replace, delete) — resourceVersion-only bumps
    don't notify.  Downstream incremental mirrors (the tensor snapshot)
    hang off these, so they see exactly what the store sees, including
    inserts that arrive through informer folds.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._store: Dict[Key, APIObject] = {}
        self._observers = []

    def add_content_observer(self, fn) -> None:
        """Registers fn(old, new) and synchronously replays the current
        contents as (None, obj) so late-constructed mirrors see state
        seeded before they existed (e.g. lister-seeded reservations on
        restart)."""
        with self._lock:
            self._observers.append(fn)
            snapshot = list(self._store.values())
        for obj in snapshot:
            try:
                fn(None, obj)
            except Exception:
                import logging

                logging.getLogger(__name__).exception("store observer replay failed")

    def _notify(self, old: Optional[APIObject], new: Optional[APIObject]) -> None:
        for fn in self._observers:
            try:
                fn(old, new)
            except Exception:
                import logging

                logging.getLogger(__name__).exception("store observer failed")

    def put(self, obj: APIObject) -> None:
        """Store obj, preserving the currently-known resourceVersion: this
        process is the sole writer, so local RV is authoritative
        (store.go:51-59)."""
        with self._lock:
            key = key_of(obj)
            current = self._store.get(key)
            if current is not None:
                obj.meta.resource_version = current.meta.resource_version
            self._store[key] = obj
            self._notify(current, obj)

    def override_resource_version_if_newer(self, obj: APIObject) -> bool:
        """Fold an externally-observed object in: only bump our RV if the
        external one is numerically newer (store.go:62-76)."""
        with self._lock:
            key = key_of(obj)
            current = self._store.get(key)
            if current is None:
                self._store[key] = obj
                self._notify(None, obj)
                return True
            is_newer = current.meta.resource_version < obj.meta.resource_version
            if is_newer:
                current.meta.resource_version = obj.meta.resource_version
            return is_newer

    def put_if_absent(self, obj: APIObject) -> bool:
        with self._lock:
            key = key_of(obj)
            if key in self._store:
                return False
            self._store[key] = obj
            self._notify(None, obj)
            return True

    def fold_resource_version(self, obj: APIObject) -> bool:
        """override_resource_version_if_newer WITHOUT the insert-when-
        absent behavior, as one atomic operation: used by the async client
        after a successful write so a concurrent delete can never be
        resurrected by the fold (check-then-act under the store lock)."""
        with self._lock:
            current = self._store.get(key_of(obj))
            if current is None:
                return False
            if current.meta.resource_version < obj.meta.resource_version:
                current.meta.resource_version = obj.meta.resource_version
                return True
            return False

    def get(self, key: Key) -> Optional[APIObject]:
        with self._lock:
            return self._store.get(key)

    def delete(self, key: Key) -> None:
        with self._lock:
            old = self._store.pop(key, None)
            if old is not None:
                self._notify(old, None)

    def list(self) -> List[APIObject]:
        with self._lock:
            return list(self._store.values())


# -- change feed --------------------------------------------------------------
#
# Typed delta kinds published by the state layer's incremental mirrors
# (the tensor snapshot publishes one per mutation it absorbs).  An
# unchanged sequence number proves NOTHING changed (the snapshot's
# content_key); the typed ring behind ``kinds_since`` is the
# introspection surface — what moved between two snapshots.

DELTA_RESERVATION = "reservation"
DELTA_SOFT_RESERVATION = "soft-reservation"
DELTA_NODE = "node"
DELTA_NODE_STRUCTURE = "node-structure"
DELTA_POD = "pod"


class ChangeFeed:
    """Monotonic, bounded feed of typed state deltas.

    ``publish`` assigns the next sequence number under the lock; the
    sequence is the feed's only truth — consumers cache the seq they
    last verified against and treat an unchanged seq as proof of an
    unchanged world.  ``kinds_since`` answers "which delta kinds landed
    after seq" from a bounded ring, or ``None`` once seq has fallen off
    the ring; it exists for introspection (tests, debugging a cold
    solve), not invalidation — the engine's content compare already
    subsumes kind-level filtering."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._seq = 0
        # (seq, kind, key) — key is a debugging affordance, never
        # consulted for invalidation decisions
        self._ring: Deque[Tuple[int, str, Optional[str]]] = deque(
            maxlen=capacity
        )
        # optional wakeup Events set on every publish: the capacity
        # sampler and lifecycle ledger park on them so work happens
        # only on state change (Event.set is lock-free and idempotent
        # — safe under the publisher's mirror lock)
        self._wakeups: Tuple[Any, ...] = ()

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def attach_wakeup(self, event) -> None:
        """Add a wakeup Event set on every publish.  Multi-listener:
        appends rather than replaces (wiring-time call)."""
        with self._lock:
            self._wakeups = self._wakeups + (event,)

    def publish(self, kind: str, key: Optional[str] = None) -> int:
        with self._lock:
            self._seq += 1
            self._ring.append((self._seq, kind, key))
            seq = self._seq
            wakeups = self._wakeups
        for wakeup in wakeups:
            wakeup.set()
        return seq

    def kinds_since(self, seq: int):
        """frozenset of delta kinds with sequence > seq, or None when
        the ring no longer reaches back that far."""
        with self._lock:
            if seq >= self._seq:
                return frozenset()
            oldest = self._ring[0][0] if self._ring else self._seq + 1
            if seq + 1 < oldest:
                return None
            return frozenset(k for s, k, _ in self._ring if s > seq)


def fnv32a(data: bytes) -> int:
    """FNV-1a 32-bit (hash/fnv), used for shard affinity."""
    h = 0x811C9DC5
    for b in data:
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


# maximum queued requests per shard before producers block / TryAdd fails
# (queue.go:22-27)
ASYNC_REQUEST_BUFFER_SIZE = 100


class ShardedUniqueQueue:
    """queue.go:34-128.

    Consumers receive zero-arg callables; invoking one releases the key's
    inflight marker and returns the Request — the store holds the latest
    object, the queue only records "there is a pending write".
    """

    def __init__(self, buckets: int, buffer_size: int = ASYNC_REQUEST_BUFFER_SIZE):
        self._queues: List[_queue.Queue] = [_queue.Queue(maxsize=buffer_size) for _ in range(buckets)]
        self._inflight: set[Key] = set()
        self._lock = threading.Lock()

    def add_if_absent(self, r: Request) -> None:
        """Blocking enqueue; dedupes create/update, never deletes
        (queue.go:63-68)."""
        added = self._add_to_inflight_if_absent(r.key)
        if added or r.type == DELETE:
            self._get_queue(r).put(self._release_func(r))

    def try_add_if_absent(self, r: Request) -> bool:
        """Non-blocking; False only when the shard is full (queue.go:74-92)."""
        added = self._add_to_inflight_if_absent(r.key)
        if added or r.type == DELETE:
            try:
                self._get_queue(r).put_nowait(self._release_func(r))
                return True
            except _queue.Full:
                if added:
                    self._delete_from_inflight(r.key)
                return False
        return True

    def get_consumers(self) -> List[_queue.Queue]:
        return list(self._queues)

    def queue_lengths(self) -> List[int]:
        return [q.qsize() for q in self._queues]

    def _get_queue(self, r: Request) -> _queue.Queue:
        return self._queues[self._bucket(r.key)]

    def _release_func(self, r: Request) -> Callable[[], Request]:
        def release() -> Request:
            self._delete_from_inflight(r.key)
            return r

        return release

    def _bucket(self, key: Key) -> int:
        return fnv32a(key[0].encode() + key[1].encode()) % len(self._queues)

    def _add_to_inflight_if_absent(self, key: Key) -> bool:
        with self._lock:
            if key in self._inflight:
                return False
            self._inflight.add(key)
            return True

    def _delete_from_inflight(self, key: Key) -> None:
        with self._lock:
            self._inflight.discard(key)
