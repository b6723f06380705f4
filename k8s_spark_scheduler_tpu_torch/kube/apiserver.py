"""Embedded state-store server: the framework's L1 substrate.

Plays the role the Kubernetes API server plays for the reference
(SURVEY §2.10: informers in, rate-limited writes out).  It is a
thread-safe, resource-versioned object store with watch fan-out:

- every mutation bumps a global monotonically-increasing
  ``resourceVersion`` (like etcd's revision);
- updates require the caller's object to carry the current
  resourceVersion, else :class:`ConflictError` (optimistic concurrency,
  the contract the async write-back client's 409 path exercises);
- watchers receive (event_type, object) callbacks post-commit;
- namespaces can be marked terminating to reproduce the reference's
  create-refused path (async.go:88-91).

In production deployments the same interface can be backed by a real
k8s API server or etcd; tests and the single-process runtime use this
in-memory implementation (the reference's tests do the same with fake
clientsets, extendertest/extender_test_utils.go:70-72).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from ..types.objects import APIObject
from ..analysis.guarded import guarded_by
from .errors import (
    AlreadyExistsError,
    ConflictError,
    NamespaceTerminatingError,
    NotFoundError,
)

WatchHandler = Callable[[str, APIObject], None]

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@guarded_by("_lock", "_objects", "_uid_counts", "_owner_index", "_watchers", "_terminating_namespaces", "_crds")
class APIServer:
    """In-memory resource-versioned object store with watch fan-out."""

    def __init__(self):
        self._lock = threading.RLock()
        self._rv = 0
        # kind → {(namespace, name) → object}
        self._objects: Dict[str, Dict[Tuple[str, str], APIObject]] = defaultdict(dict)
        # uid → live-object count, maintained by create/delete: the
        # dangling-owner check used to rebuild a set over EVERY stored
        # object per create (O(cluster) on the async write-back threads —
        # ~4ms of stolen GIL per reservation at 10k nodes)
        self._uid_counts: Dict[str, int] = {}
        # owner uid → {(kind, ns, name)} of dependents: owner-reference
        # GC used to scan every stored object per delete (O(cluster) —
        # the app-finished flow deletes pods constantly)
        self._owner_index: Dict[str, set] = {}
        self._watchers: Dict[str, List[WatchHandler]] = defaultdict(list)
        self._terminating_namespaces: set[str] = set()
        # registered CRD kinds → established flag
        self._crds: Dict[str, dict] = {}
        # write-fault hook (tests, the chip smoke's write-back outage):
        # fn(op, kind, namespace, name) -> Optional[Exception]; a returned
        # exception is raised BEFORE the mutation commits, exactly as a
        # real API server refusing/timing out a write
        self._write_fault = None

    def set_write_fault(self, fn) -> None:
        self._write_fault = fn

    def _check_write_fault(self, op: str, kind: str, namespace: str, name: str) -> None:
        fn = self._write_fault
        if fn is not None:
            err = fn(op, kind, namespace, name)
            if err is not None:
                raise err

    @property
    def resource_version(self) -> int:
        """The current global revision (etcd's header revision analog);
        list responses must carry this even when empty, so a watch
        resumed from a list never silently skips a truncated history."""
        with self._lock:
            return self._rv

    # -- namespace lifecycle ------------------------------------------------

    def mark_namespace_terminating(self, namespace: str) -> None:
        with self._lock:
            self._terminating_namespaces.add(namespace)

    # -- CRD registry (stands in for apiextensions) --------------------------

    def create_crd(self, name: str, spec: dict) -> None:
        with self._lock:
            if name in self._crds:
                raise AlreadyExistsError(f"crd {name} already exists")
            self._crds[name] = dict(spec, established=spec.get("established", True))

    def update_crd(self, name: str, spec: dict) -> None:
        with self._lock:
            if name not in self._crds:
                raise NotFoundError(f"crd {name} not found")
            established = self._crds[name].get("established", True)
            self._crds[name] = dict(spec, established=spec.get("established", established))

    def get_crd(self, name: str) -> Optional[dict]:
        with self._lock:
            crd = self._crds.get(name)
            return dict(crd) if crd is not None else None

    def delete_crd(self, name: str) -> None:
        with self._lock:
            self._crds.pop(name, None)

    def set_crd_established(self, name: str, established: bool) -> None:
        with self._lock:
            if name in self._crds:
                self._crds[name]["established"] = established

    def crd_established(self, name: str) -> bool:
        with self._lock:
            crd = self._crds.get(name)
            return bool(crd and crd.get("established"))

    # -- object CRUD ---------------------------------------------------------

    def create(self, obj: APIObject) -> APIObject:
        self._check_write_fault("create", obj.KIND, obj.namespace, obj.name)
        with self._lock:
            kind = obj.KIND
            key = (obj.namespace, obj.name)
            if obj.namespace in self._terminating_namespaces:
                raise NamespaceTerminatingError(obj.namespace)
            if key in self._objects[kind]:
                raise AlreadyExistsError(f"{kind} {key} already exists")
            stored = obj.deepcopy()
            stored.meta.ensure_identity()
            self._rv += 1
            stored.meta.resource_version = self._rv
            self._objects[kind][key] = stored
            if stored.meta.uid:
                self._uid_counts[stored.meta.uid] = (
                    self._uid_counts.get(stored.meta.uid, 0) + 1
                )
            self._index_owners(stored, kind, key, add=True)
            out = stored.deepcopy()
            dangling = self._has_dangling_owner(stored)
        self._notify(kind, ADDED, stored)
        if dangling:
            # an object created with owner references to an already-dead
            # owner: real k8s GC collects it shortly after; collecting it
            # immediately keeps state deterministic when an async
            # write-back create races the owner's deletion
            try:
                self._delete_impl(kind, key[0], key[1])
            except NotFoundError:
                pass
        return out

    def _has_dangling_owner(self, obj: APIObject) -> bool:
        if not obj.meta.owner_references:
            return False
        return any(
            ref.uid and ref.uid not in self._uid_counts
            for ref in obj.meta.owner_references
        )

    def _index_owners(self, obj: APIObject, kind: str, key, add: bool) -> None:
        entry = (kind, key[0], key[1])
        for ref in obj.meta.owner_references:
            if not ref.uid:
                continue
            if add:
                self._owner_index.setdefault(ref.uid, set()).add(entry)  # schedlint: disable=LK001 -- private helper, every caller holds _lock (see callers)
            else:
                deps = self._owner_index.get(ref.uid)
                if deps is not None:
                    deps.discard(entry)
                    if not deps:
                        del self._owner_index[ref.uid]  # schedlint: disable=LK001 -- private helper, every caller holds _lock (see callers)

    def update(self, obj: APIObject) -> APIObject:
        self._check_write_fault("update", obj.KIND, obj.namespace, obj.name)
        with self._lock:
            kind = obj.KIND
            key = (obj.namespace, obj.name)
            current = self._objects[kind].get(key)
            if current is None:
                raise NotFoundError(f"{kind} {key} not found")
            if obj.meta.resource_version != current.meta.resource_version:
                raise ConflictError(
                    f"{kind} {key}: resourceVersion mismatch "
                    f"(have {obj.meta.resource_version}, want {current.meta.resource_version})"
                )
            stored = obj.deepcopy()
            stored.meta.uid = current.meta.uid
            stored.meta.creation_timestamp = current.meta.creation_timestamp
            self._rv += 1
            stored.meta.resource_version = self._rv
            self._objects[kind][key] = stored
            # owner references may change across an update
            self._index_owners(current, kind, key, add=False)
            self._index_owners(stored, kind, key, add=True)
            out = stored.deepcopy()
        self._notify(kind, MODIFIED, stored)
        return out

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._check_write_fault("delete", kind, namespace, name)
        self._delete_impl(kind, namespace, name)

    def _delete_impl(self, kind: str, namespace: str, name: str) -> None:
        # server-side deletes (owner GC, dangling-owner collection) come
        # here directly: they model the API server's own machinery, which
        # a client-write fault (apiserver_outage) never interrupts
        with self._lock:
            key = (namespace, name)
            current = self._objects[kind].pop(key, None)
            if current is None:
                raise NotFoundError(f"{kind} {key} not found")
            if current.meta.uid:
                n = self._uid_counts.get(current.meta.uid, 0) - 1
                if n > 0:
                    self._uid_counts[current.meta.uid] = n
                else:
                    self._uid_counts.pop(current.meta.uid, None)
            self._index_owners(current, kind, key, add=False)
            # deletes advance the revision too (as in etcd) so the DELETED
            # event is strictly newer than any prior MODIFIED for this key
            self._rv += 1
            current.meta.resource_version = self._rv
        self._notify(kind, DELETED, current)
        self._garbage_collect_owned(current)

    def get(self, kind: str, namespace: str, name: str) -> APIObject:
        with self._lock:
            current = self._objects[kind].get((namespace, name))
            if current is None:
                raise NotFoundError(f"{kind} ({namespace}, {name}) not found")
            return current.deepcopy()

    def list(self, kind: str, namespace: Optional[str] = None) -> List[APIObject]:
        with self._lock:
            return [
                o.deepcopy()
                for (ns, _), o in self._objects[kind].items()
                if namespace is None or ns == namespace
            ]

    # -- watch ---------------------------------------------------------------

    def watch(self, kind: str, handler: WatchHandler, replay: bool = True) -> None:
        """Register a watch handler; replays existing objects as ADDED
        (list+watch semantics) unless replay=False."""
        with self._lock:
            self._watchers[kind].append(handler)
            snapshot = list(self._objects[kind].values()) if replay else []
        for obj in snapshot:
            handler(ADDED, obj.deepcopy())

    def _notify(self, kind: str, event: str, obj: APIObject) -> None:
        with self._lock:
            handlers = list(self._watchers[kind])
        for handler in handlers:
            handler(event, obj.deepcopy())

    def _garbage_collect_owned(self, owner: APIObject) -> None:
        """Owner-reference GC: deleting an owner cascades to dependents
        (the reference relies on k8s GC via ownerReferences,
        resourcereservations.go:515, demand.go:162-164).  Served from
        the owner index — the full-store scan per delete was O(cluster)
        and the app-finished flow deletes pods constantly."""
        owner_uid = owner.meta.uid
        if not owner_uid:
            return
        with self._lock:
            to_delete = list(self._owner_index.get(owner_uid, ()))
        for kind, ns, name in to_delete:
            try:
                self._delete_impl(kind, ns, name)
            except NotFoundError:
                pass
