"""Generic single-writer write-back cache + async client.

The write path of the reference (internal/cache/cache.go + async.go):
mutations hit the local store synchronously and enqueue a write; N
worker threads per cached type drain the sharded queue and replay the
writes against the API server with bounded retries, inline 409-conflict
resolution, and namespace-terminating detection.  Informer events only
fold resourceVersions back in (external creates/updates are ignored —
this process is the sole writer) and deletes remove from the store.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

logger = logging.getLogger(__name__)

from ..kube import conflict as kconflict
from ..kube import errors as kerrors
from ..kube.apiserver import APIServer
from ..kube.informer import Informer
from ..tracing import spans as tracing
from ..types.objects import APIObject
from .store import (
    CREATE,
    DELETE,
    ObjectStore,
    Request,
    ShardedUniqueQueue,
    UPDATE,
    create_request,
    delete_request,
    key_of,
    update_request,
)


class AlreadyExistsInCacheError(Exception):
    pass


class NotInCacheError(Exception):
    pass


class WriteBackCache:
    """cache.go:32-125."""

    def __init__(self, queue: ShardedUniqueQueue, object_store: ObjectStore, informer: Informer):
        self._queue = queue
        self._store = object_store
        informer.add_event_handler(
            on_add=self._try_override_rv,
            on_update=lambda old, new: self._try_override_rv(new),
            on_delete=self._on_delete,
        )

    def create(self, obj: APIObject) -> None:
        with tracing.child_span(
            "state.writeback.enqueue", {"op": "create", "kind": obj.KIND}
        ):
            if not self._store.put_if_absent(obj):
                raise AlreadyExistsInCacheError(f"object {key_of(obj)} already exists")
            self._queue.add_if_absent(create_request(obj))

    def get(self, namespace: str, name: str) -> Optional[APIObject]:
        return self._store.get((namespace, name))

    def update(self, obj: APIObject) -> None:
        with tracing.child_span(
            "state.writeback.enqueue", {"op": "update", "kind": obj.KIND}
        ):
            if self._store.get(key_of(obj)) is None:
                raise NotInCacheError(f"object {key_of(obj)} does not exist")
            self._store.put(obj)
            self._queue.add_if_absent(update_request(obj))

    def delete(self, namespace: str, name: str) -> None:
        with tracing.child_span("state.writeback.enqueue", {"op": "delete"}):
            key = (namespace, name)
            self._store.delete(key)
            self._queue.add_if_absent(delete_request(key))

    def list(self) -> List[APIObject]:
        return self._store.list()

    def _try_override_rv(self, obj: APIObject) -> None:
        self._store.override_resource_version_if_newer(obj)

    def _on_delete(self, obj: APIObject) -> None:
        self._store.delete(key_of(obj))


class TypedClient:
    """cache.Client (async.go:38-44): kind-scoped CRUD against the API
    server (or any backend with the same surface)."""

    def __init__(self, api: APIServer, kind: str):
        self._api = api
        self._kind = kind

    def create(self, obj: APIObject) -> APIObject:
        return self._api.create(obj)

    def update(self, obj: APIObject) -> APIObject:
        return self._api.update(obj)

    def delete(self, namespace: str, name: str) -> None:
        self._api.delete(self._kind, namespace, name)

    def get(self, namespace: str, name: str) -> APIObject:
        return self._api.get(self._kind, namespace, name)


class AsyncClient:
    """async.go:44-163: per-shard worker threads draining the queue.

    Each request replays the store's latest object against the API
    server with bounded retries (re-enqueued non-blocking), inline
    409-conflict resolution and namespace-terminating detection; a
    create that exhausts its retries leaves the local store, so reads
    stay honest with what was admitted (reconciliation repairs later).
    """

    def __init__(
        self,
        client: TypedClient,
        queue: ShardedUniqueQueue,
        object_store: ObjectStore,
        max_retry_count: int = 5,
        metrics=None,
        kind: str = "",
        registry=None,
    ):
        self._client = client
        self._queue = queue
        self._store = object_store
        self._max_retry_count = max_retry_count
        self._metrics = metrics
        self._kind = kind
        # full metrics registry (conflict-retry counter); the `metrics`
        # param above is the per-request outcome marker, kept separate
        # for reference parity
        self._registry = registry
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def run(self) -> None:
        for i, q in enumerate(self._queue.get_consumers()):
            t = threading.Thread(target=self._run_worker, args=(q,), daemon=True, name=f"async-{i}")
            t.start()
            self._threads.append(t)

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)

    def _run_worker(self, q) -> None:
        import queue as pyqueue

        while not self._stop.is_set():
            try:
                request_getter = q.get(timeout=0.05)
            except pyqueue.Empty:
                continue
            r: Request = request_getter()
            try:
                if r.type == CREATE:
                    self._do_create(r)
                elif r.type == UPDATE:
                    self._do_update(r)
                elif r.type == DELETE:
                    self._do_delete(r)
            except Exception:
                # worker must survive anything, but a failure reaching here
                # is a programming error (client errors are handled in the
                # per-request handlers) — surface it
                logger.exception("async write-back worker failed on %s %s", r.type, r.key)
                self._mark(r, "worker_error")

    # -- request handlers (async.go:77-137) ---------------------------------

    def _do_create(self, r: Request) -> None:
        obj = self._store.get(r.key)
        if obj is None:
            return  # deleted while queued: no write happened
        self._mark(r, "request")
        try:
            result = self._client.create(obj)
        except kerrors.AlreadyExistsError:
            # idempotent replay: the create already landed (a write that
            # succeeded just as its response was lost) — fold the server
            # copy's RV and treat as success, never as a duplicate write
            try:
                current = self._client.get(r.key[0], r.key[1])
            except Exception as get_err:
                self._maybe_retry(r, get_err)
                return
            self._store.fold_resource_version(current)
            return
        except Exception as err:
            if kerrors.is_namespace_terminating(err):
                self._store.delete(r.key)
                return
            if not self._maybe_retry(r, err):
                self._store.delete(r.key)
            return
        # fold the result's RV in atomically, never resurrecting a key
        # deleted (e.g. by owner GC) while the create was in flight
        self._store.fold_resource_version(result)

    def _do_update(self, r: Request) -> None:
        obj = self._store.get(r.key)
        if obj is None:
            return  # deleted while queued: no write happened
        self._mark(r, "request")

        def attempt():
            current = self._store.get(r.key)
            if current is None:
                return None  # deleted locally mid-retry: intent is moot
            return self._client.update(current)

        def refresh() -> bool:
            # refresh RV from the server and rebase (async.go:111-120);
            # False (key folded away locally) aborts the loop
            new_obj = self._client.get(r.key[0], r.key[1])
            return self._store.fold_resource_version(new_obj)

        try:
            result = kconflict.run_with_conflict_retry(
                attempt, refresh, kind=self._kind, metrics=self._registry
            )
        except kerrors.NotFoundError:
            # the server authoritatively lacks the object (owner GC beat
            # this update): resurrecting a GC'd object would undo a
            # deliberate delete.  Bounded retry while the informer's
            # delete catches up locally, then drop.
            if r.retry_count >= self._max_retry_count:
                self._mark(r, "dropped_not_found")
            else:
                self._mark(r, "retry")
                self._queue.try_add_if_absent(r.with_incremented_retry_count())
            return
        except Exception as err:
            # includes a ConflictError re-raised after the retry budget
            self._maybe_retry(r, err)
            return
        if result is not None:
            self._store.fold_resource_version(result)

    def _do_delete(self, r: Request) -> None:
        self._mark(r, "request")
        try:
            self._client.delete(r.key[0], r.key[1])
        except kerrors.NotFoundError:
            return  # already deleted: the intent is satisfied
        except Exception as err:
            self._maybe_retry(r, err)

    def _maybe_retry(self, r: Request, err: Exception) -> bool:
        """async.go:139-154: bounded retries, re-enqueued non-blocking.
        Returns True when the intent is still queued, False when it was
        dropped."""
        logger.warning("write-back %s %s failed: %s", r.type, r.key, err)
        if r.retry_count >= self._max_retry_count:
            self._mark(r, "dropped_max_retries")
            return False
        self._mark(r, "retry")
        if not self._queue.try_add_if_absent(r.with_incremented_retry_count()):
            self._mark(r, "dropped_queue_full")
            return False
        return True

    def _mark(self, r: Request, what: str) -> None:
        if self._metrics is not None:
            self._metrics.mark(what, r.type)
