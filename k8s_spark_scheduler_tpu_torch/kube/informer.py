"""Shared informers + listers over the embedded API server.

The reference's read path is client-go shared informers (watch + 30s
resync, cmd/server.go:91-92); handlers get add/update/delete events and
listers serve label-selected reads from the informer's local store.  This
module reproduces that shape: an :class:`Informer` keeps a local mirror
fed by watch events and dispatches to registered handlers; a
:class:`Lister` reads the mirror.

Event delivery is synchronous with the mutation (the embedded server
commits before notifying), which is strictly *fresher* than client-go's
eventually-consistent delivery — any reconcile logic correct under the
reference's staleness is correct here.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..types.objects import APIObject
from .apiserver import ADDED, APIServer, DELETED, MODIFIED
from ..analysis import racecheck
from ..analysis.guarded import guarded_by

Handler = Callable[[APIObject], None]
UpdateHandler = Callable[[APIObject, APIObject], None]


@guarded_by("_lock", "_store", "_indexes", "_last_rv", "_selector_revs")
class Informer:
    """A shared informer for one kind."""

    # bound on remembered last-seen resourceVersions for departed objects
    # (guards against a late stale MODIFIED resurrecting a deleted object)
    _TOMBSTONE_LIMIT = 16384
    # bound on per-(label, value) selector revision stamps (unbounded-
    # value labels like spark-app-id would otherwise leak one entry per
    # application for the life of the process)
    _SELECTOR_REVS_LIMIT = 16384

    def __init__(self, api: APIServer, kind: str, index_labels: Tuple[str, ...] = ()):
        self._api = api
        self.kind = kind
        self._lock = threading.RLock()
        self._store: Dict[Tuple[str, str], APIObject] = {}
        # secondary indexes: label key → label value → set of store keys;
        # turns the reference's O(all pods) label-selector scans
        # (client-go listers re-filter on every call) into O(result)
        self._index_labels = tuple(index_labels)
        self._indexes: Dict[str, Dict[str, set]] = {k: {} for k in self._index_labels}
        # key → highest resourceVersion ever delivered; events are globally
        # ordered by rv at the server, so delivery races are filtered here
        self._last_rv: Dict[Tuple[str, str], int] = {}
        self._add_handlers: List[Handler] = []
        self._update_handlers: List[UpdateHandler] = []
        self._delete_handlers: List[Handler] = []
        self._synced = False
        # bumped on every applied event — consumers key derived-view
        # caches on it, directly or via selector_revision (client-go's
        # informer cache has no analog; our hot paths re-derive views
        # per request without it)
        self.revision = 0
        # finer-grained: per indexed (label key, value) revisions, so a
        # view over one label bucket (e.g. spark-role=driver) is not
        # invalidated by churn in other buckets (executor pod events).
        # Values are global-revision stamps (monotone even across the
        # bounded prune below); unindexed keys fall back to the global
        # revision so a consumer cache can never silently freeze.
        self._selector_revs: Dict[Tuple[str, str], int] = {}
        # floor returned for missing buckets: bumped to the global
        # revision whenever _selector_revs is pruned, so a cleared
        # bucket can never read a value a consumer might have cached
        # (0 would repeat across clears and freeze a stale view)
        self._selector_floor = 0

    def start(self) -> None:
        self._api.watch(self.kind, self._on_event)
        self._synced = True

    def has_synced(self) -> bool:
        return self._synced

    def _on_event(self, event: str, obj: APIObject) -> None:
        key = (obj.namespace, obj.name)
        with self._lock:
            racecheck.note_access(self, "_store")
            # drop out-of-order deliveries: the server's rv is a global
            # monotonic commit order, so a lower rv is a stale event
            rv = obj.meta.resource_version
            if rv <= self._last_rv.get(key, -1):
                return
            self._last_rv[key] = rv
            self.revision += 1
            if len(self._last_rv) > self._TOMBSTONE_LIMIT:
                # prune entries for objects we no longer mirror
                self._last_rv = {
                    k: v for k, v in self._last_rv.items() if k in self._store
                }
            old = self._store.get(key)
            if event == DELETED:
                self._store.pop(key, None)
            else:
                self._store[key] = obj
            for label_key, index in self._indexes.items():
                if old is not None:
                    old_value = old.labels.get(label_key)
                    if old_value is not None:
                        bucket = index.get(old_value)
                        if bucket is not None:
                            bucket.discard(key)
                            if not bucket:
                                del index[old_value]
                if event != DELETED:
                    value = obj.labels.get(label_key)
                    if value is not None:
                        index.setdefault(value, set()).add(key)
                touched = set()
                if old is not None and old.labels.get(label_key) is not None:
                    touched.add(old.labels[label_key])
                if event != DELETED and obj.labels.get(label_key) is not None:
                    touched.add(obj.labels[label_key])
                for v in touched:
                    # stamp with the global revision: monotone and
                    # collision-free even after a prune (a pruned bucket
                    # reads 0, then restarts above any stamp a consumer
                    # could have cached)
                    self._selector_revs[(label_key, v)] = self.revision
                if len(self._selector_revs) > self._SELECTOR_REVS_LIMIT:
                    # unbounded-value labels (spark-app-id) would leak an
                    # entry per app forever; a full clear is safe because
                    # the floor rises to the current revision — strictly
                    # above every stamp a consumer could have cached
                    self._selector_revs.clear()
                    self._selector_floor = self.revision
            add_handlers = list(self._add_handlers)
            update_handlers = list(self._update_handlers)
            delete_handlers = list(self._delete_handlers)
        if event == ADDED:
            for h in add_handlers:
                h(obj)
        elif event == MODIFIED:
            for h in update_handlers:
                h(old, obj)
            if old is None:  # replayed as modify before sync: treat as add
                for h in add_handlers:
                    h(obj)
        elif event == DELETED:
            for h in delete_handlers:
                h(obj)

    def add_event_handler(
        self,
        on_add: Optional[Handler] = None,
        on_update: Optional[UpdateHandler] = None,
        on_delete: Optional[Handler] = None,
        filter_func: Optional[Callable[[APIObject], bool]] = None,
    ) -> None:
        """client-go FilteringResourceEventHandler equivalent."""

        def wrap_add(obj):
            if on_add and (filter_func is None or filter_func(obj)):
                on_add(obj)

        def wrap_update(old, new):
            if on_update and (filter_func is None or filter_func(new)):
                on_update(old, new)

        def wrap_delete(obj):
            if on_delete and (filter_func is None or filter_func(obj)):
                on_delete(obj)

        with self._lock:
            if on_add:
                self._add_handlers.append(wrap_add)
            if on_update:
                self._update_handlers.append(wrap_update)
            if on_delete:
                self._delete_handlers.append(wrap_delete)
            snapshot = list(self._store.values()) if on_add else []
        # client-go semantics: a late-registered handler receives synthetic
        # ADD events for everything already in the store, so components
        # wired after the informer started (overhead computer, stores) see
        # pre-existing objects
        for obj in snapshot:
            wrap_add(obj)

    # -- lister interface ----------------------------------------------------

    def selector_revision(self, label_key: str, value: str) -> int:
        """Revision of one indexed label bucket: changes only when an
        event touched an object carrying (label_key, value).  For a key
        the informer does NOT index, falls back to the global revision —
        coarser invalidation, but a derived-view cache can never freeze
        on a permanently-stale bucket."""
        with self._lock:
            if label_key not in self._indexes:
                return self.revision
            return self._selector_revs.get((label_key, value), self._selector_floor)

    def list(
        self,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[APIObject]:
        with self._lock:
            # serve from a secondary index when one covers the selector
            candidates = None
            if label_selector:
                for k, v in label_selector.items():
                    if k in self._indexes:
                        keys = self._indexes[k].get(v, set())
                        candidates = [self._store[key] for key in keys if key in self._store]
                        break
            pool = candidates if candidates is not None else self._store.values()
            out = []
            for obj in pool:
                if namespace is not None and obj.namespace != namespace:
                    continue
                if label_selector and any(
                    obj.labels.get(k) != v for k, v in label_selector.items()
                ):
                    continue
                out.append(obj)
            return out

    def get(self, namespace: str, name: str) -> Optional[APIObject]:
        with self._lock:
            return self._store.get((namespace, name))

    def list_with_predicate(self, predicate: Callable[[APIObject], bool]) -> List[APIObject]:
        """utils.ListWithPredicate (internal/common/utils/pods.go:110-128)."""
        with self._lock:
            return [o for o in self._store.values() if predicate(o)]


@guarded_by("_lock", "_informers")
class InformerFactory:
    """Shared-informer factory: one informer per kind."""

    def __init__(self, api: APIServer):
        self._api = api
        self._informers: Dict[str, Informer] = {}
        self._lock = threading.Lock()

    def informer(self, kind: str, index_labels: Tuple[str, ...] = ()) -> Informer:
        with self._lock:
            inf = self._informers.get(kind)
            if inf is None:
                inf = Informer(self._api, kind, index_labels=index_labels)
                self._informers[kind] = inf
            elif index_labels and set(index_labels) - set(inf._index_labels):
                raise ValueError(
                    f"informer for {kind} already created without indexes "
                    f"{set(index_labels) - set(inf._index_labels)}; create the "
                    "indexed informer first"
                )
            return inf

    def start(self) -> None:
        with self._lock:
            informers = list(self._informers.values())
        for inf in informers:
            if not inf.has_synced():
                inf.start()

    def wait_for_cache_sync(self) -> bool:
        return all(inf.has_synced() for inf in self._informers.values())
