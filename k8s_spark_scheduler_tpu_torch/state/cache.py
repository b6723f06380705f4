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

from ..ha import crashpoint
from ..ha.fencing import StaleEpochError
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
    409-conflict resolution and namespace-terminating detection; without
    a journal, a create that exhausts its retries leaves the local store,
    so reads stay honest with what was admitted (reconciliation repairs
    later).

    With a circuit ``breaker`` + intent ``journal`` attached (the
    resilience layer; reservation cache only), repeated write failures
    open the breaker and requests are *diverted* to the journal instead
    of burning retries against a dead API server — and, critically,
    instead of being dropped at max retries.  The journal is replayed
    through this same queue when a probe write succeeds (breaker closes)
    or a recovery nudge arrives.

    ``owners`` (the pod informer, or None) is where an object's owner pod
    is looked up before a NotFound update re-creates an object the server
    never acknowledged (``_never_landed``): with the owner gone, the
    update is dropped as an owner GC's, as the reference drops it.
    """

    def __init__(
        self,
        client: TypedClient,
        queue: ShardedUniqueQueue,
        object_store: ObjectStore,
        max_retry_count: int = 5,
        metrics=None,
        breaker=None,
        journal=None,
        kind: str = "",
        to_wire=None,
        registry=None,
        owners=None,
    ):
        self._client = client
        self._owners = owners
        self._queue = queue
        self._store = object_store
        self._max_retry_count = max_retry_count
        self._metrics = metrics
        self._breaker = breaker
        self._journal = journal
        self._kind = kind
        self._to_wire = to_wire
        # full metrics registry (conflict-retry counter); the `metrics`
        # param above is the per-request outcome marker, kept separate
        # for reference parity
        self._registry = registry
        # HA fencing gate (ha/fencing.FencedWriter), installed by server
        # wiring when the fabric is enabled: every API mutation is
        # refused with StaleEpochError once this replica is deposed
        self.fence_gate = None
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
                self._handle(r)
            finally:
                # a request stays in flight until its write is handled,
                # not only until a worker takes it off the queue
                # (ShardedUniqueQueue.queue_lengths counts unfinished
                # tasks): a quiesce must not return mid-write
                q.task_done()

    def _handle(self, r: Request) -> None:
        try:
            if self._breaker is not None and not self._breaker.allow():
                # breaker open and no probe due: don't touch the API
                # server at all — preserve the intent and move on
                self._divert(r, "journaled_breaker_open")
                return
            if r.type == CREATE:
                self._do_create(r)
            elif r.type == UPDATE:
                self._do_update(r)
            elif r.type == DELETE:
                self._do_delete(r)
        except StaleEpochError as fe:
            # deposed leader: the write is refused, never dropped —
            # divert the intent to the journal so the successor's
            # takeover replay owns it.  Not a breaker signal (the
            # server was never touched).
            logger.warning(
                "fenced write refused: %s %s (%s)", r.type, r.key, fe
            )
            self._release_probe()
            self._divert(r, "journaled_fenced")
        except Exception:
            # worker must survive anything, but a failure reaching here
            # is a programming error (client errors are handled in the
            # per-request handlers) — surface it
            logger.exception("async write-back worker failed on %s %s", r.type, r.key)
            try:
                self._release_probe()  # never wedge recovery on a bug
                self._mark(r, "worker_error")
            except Exception:
                pass

    def _pre_commit(self, r: Request) -> None:
        """HA fence + crash-injection gate before any API mutation.
        Raises StaleEpochError (worker loop diverts the intent to the
        journal) or SimulatedCrash (BaseException — the crash matrix's
        kill -9).  Disabled cost: two attribute reads."""
        gate = self.fence_gate
        if gate is not None:
            gate.check(f"writeback.{r.type}")
        crashpoint.maybe_crash(crashpoint.WRITEBACK_PRE_COMMIT)

    def _post_commit(self) -> None:
        gate = self.fence_gate
        if gate is not None:
            gate.commit()
        crashpoint.maybe_crash(crashpoint.WRITEBACK_POST_COMMIT)

    # -- request handlers (async.go:77-137) ---------------------------------

    def _do_create(self, r: Request) -> None:
        obj = self._store.get(r.key)
        if obj is None:
            self._release_probe()  # deleted while queued: no write happened
            return
        self._mark(r, "request")
        self._pre_commit(r)
        try:
            result = self._client.create(obj)
        except kerrors.AlreadyExistsError:
            # idempotent replay: the create already landed (a journaled
            # intent re-applied after a restart, or a write that
            # succeeded just as its response was lost) — fold the server
            # copy's RV and treat as success, never as a duplicate write
            try:
                current = self._client.get(r.key[0], r.key[1])
            except Exception as get_err:
                self._on_write_failure(r, get_err)
                return
            self._store.fold_resource_version(current)
            self._on_write_ok(r)
            return
        except Exception as err:
            if kerrors.is_namespace_terminating(err):
                self._store.delete(r.key)
                self._ack_journal(r)
                return
            if not self._on_write_failure(r, err) and self._journal is None:
                self._store.delete(r.key)
            return
        # fold the result's RV in atomically, never resurrecting a key
        # deleted (e.g. by owner GC) while the create was in flight
        self._store.fold_resource_version(result)
        self._post_commit()
        self._on_write_ok(r)

    def _do_update(self, r: Request) -> None:
        obj = self._store.get(r.key)
        if obj is None:
            self._release_probe()  # deleted while queued: no write happened
            return
        self._mark(r, "request")
        self._pre_commit(r)

        def attempt():
            current = self._store.get(r.key)
            if current is None:
                return None  # deleted locally mid-retry: intent is moot
            return self._client.update(current)

        def refresh() -> bool:
            # refresh RV from the server and rebase (async.go:111-120);
            # a conflict means the server is alive — never a breaker
            # signal.  False (key folded away locally) aborts the loop.
            new_obj = self._client.get(r.key[0], r.key[1])
            return self._store.fold_resource_version(new_obj)

        try:
            result = kconflict.run_with_conflict_retry(
                attempt, refresh, kind=self._kind, metrics=self._registry
            )
        except kerrors.NotFoundError:
            if (
                self._journal is not None
                and r.key in self._journal.pending_keys()
            ) or (self._never_landed(r.key) and self._owners_alive(r.key)):
                # the object's create was collapsed into this update and
                # never landed — upsert it.  Either the intent was
                # journaled while diverted (latest-wins per key), or a
                # failed create's retry found this update already queued
                # for the key (the unique queue keeps one request a key)
                # and the server has never acknowledged the object.  The
                # store holds the full newest content; _do_create acks
                # any pending intent (create and update share the upsert
                # ack class).
                self._do_create(Request(r.key, CREATE, r.retry_count))
                return
            # the server authoritatively lacks the object (owner GC beat
            # this update): a response from a LIVE server, so never a
            # breaker signal, and not a journalable intent either —
            # resurrecting a GC'd object would undo a deliberate delete.
            # Bounded retry while the informer's delete catches up
            # locally, then drop (the pre-resilience semantics).
            self._release_probe()
            if r.retry_count >= self._max_retry_count:
                self._mark(r, "dropped_not_found")
            else:
                self._mark(r, "retry")
                self._queue.try_add_if_absent(r.with_incremented_retry_count())
            return
        except Exception as err:
            # includes a ConflictError re-raised after the retry budget:
            # route through the normal failure taxonomy (journal/retry)
            self._on_write_failure(r, err)
            return
        if result is None:
            self._release_probe()  # vanished locally: no write landed
            return
        self._store.fold_resource_version(result)
        self._post_commit()
        self._on_write_ok(r)

    def _do_delete(self, r: Request) -> None:
        self._mark(r, "request")
        self._pre_commit(r)
        try:
            self._client.delete(r.key[0], r.key[1])
        except kerrors.NotFoundError:
            self._on_write_ok(r)  # already deleted: the intent is satisfied
            return
        except Exception as err:
            self._on_write_failure(r, err)
            return
        self._post_commit()
        self._on_write_ok(r)

    def _never_landed(self, key) -> bool:
        """True when the server has never acknowledged the local object:
        no create response and no informer event has folded a
        resourceVersion into it (the store keeps the known one across
        local puts), so a NotFound for it is taken as a create that never
        landed, not an owner GC.  A create that did land but whose
        response was lost (a client timeout) reads the same; if an owner
        GC deleted it before the informer's events reached the store,
        ``_owners_alive`` tells the two apart."""
        obj = self._store.get(key)
        return obj is not None and not obj.meta.resource_version

    def _owners_alive(self, key) -> bool:
        """Whether every pod the local object names as its owner is still
        in the owner store (same name and uid).  An owner GC deletes the
        object only after its owner is gone, so a missing owner means a
        NotFound is the GC's: the update must not re-create the object.
        True without an owner store or owner references."""
        obj = self._store.get(key)
        if self._owners is None or obj is None:
            return True
        for ref in obj.meta.owner_references:
            if ref.kind != "Pod":
                continue
            pod = self._owners.get(obj.meta.namespace, ref.name)
            if pod is None or (ref.uid and pod.meta.uid != ref.uid):
                return False
        return True

    # -- resilience hooks ----------------------------------------------------

    def _release_probe(self) -> None:
        """A request granted by breaker.allow() ended without any write
        reaching the server — free the (possible) half-open probe slot so
        recovery can't wedge on an aborted probe."""
        if self._breaker is not None:
            self._breaker.release_probe()

    def _on_write_ok(self, r: Request) -> None:
        self._ack_journal(r)
        if self._breaker is not None and self._breaker.record_success():
            # a probe write just closed the breaker: replay everything
            # that was diverted while it was open
            self.replay_journal()

    def _on_write_failure(self, r: Request, err: Exception) -> bool:
        """Route a failed write: breaker accounting, then divert-or-retry.
        Returns True when the intent is preserved (retrying or journaled),
        False when it was dropped."""
        if self._breaker is not None:
            self._breaker.record_failure()
            if not self._breaker.probe_due() and self._breaker.state != "closed":
                # open with no probe window: stop hammering the server
                self._divert(r, "journaled_write_failed")
                return self._journal is not None
        return self._maybe_retry(r, err)

    def _divert(self, r: Request, what: str) -> None:
        """Preserve the intent in the journal instead of writing.  With
        no journal configured this degrades to the historical drop
        semantics (creates leave the local store so reads stay honest
        with what was admitted; reconciliation repairs later)."""
        if self._journal is None:
            self._mark(r, "dropped_no_journal")
            if r.type == CREATE:
                self._store.delete(r.key)
            return
        obj = self._store.get(r.key)
        if r.type in (CREATE, UPDATE) and obj is None:
            return  # deleted while queued: intent is moot
        wire = None
        if obj is not None and self._to_wire is not None:
            try:
                wire = self._to_wire(obj)
            except Exception:
                logger.exception("failed to serialize %s for the intent journal", r.key)
        self._journal.record(r.type, self._kind, r.key[0], r.key[1], wire)
        self._mark(r, what)

    def _ack_journal(self, r: Request) -> None:
        if self._journal is not None:
            try:
                self._journal.ack(r.type, r.key[0], r.key[1])
            except StaleEpochError:
                # deposed between the write landing and the ack: leave
                # the intent pending — the successor's replay is
                # idempotent, losing the ack is safe; losing the intent
                # would not be
                logger.warning("fenced journal ack refused for %s", r.key)

    def replay_journal(self) -> int:
        """Re-enqueue every pending journaled intent through the normal
        write path.  Idempotent: creates that already landed fold via
        AlreadyExists, deletes via NotFound; intents whose object was
        GC'd locally are acked as moot.  Returns the number enqueued."""
        if self._journal is None:
            return 0
        enqueued = 0
        for intent in self._journal.pending():
            key = (intent["ns"], intent["name"])
            op = intent["op"]
            if op in (CREATE, UPDATE) and self._store.get(key) is None:
                self._journal.ack(op, key[0], key[1])
                continue
            if self._queue.try_add_if_absent(Request(key, op)):
                enqueued += 1
            else:
                break  # shard full: the next nudge picks the rest up
        return enqueued

    def nudge_recovery(self, force: bool = False) -> int:
        """Periodic/explicit recovery poke: when journaled intents exist
        and a write could land (breaker closed, or a probe window is
        due — or ``force``, the explicit 'server is back' signal), put
        them back on the queue.  While the breaker stays open only one
        intent is enqueued (the probe); its success closes the breaker,
        which replays the rest."""
        if self._journal is None or self._journal.depth() == 0:
            return 0
        if self._breaker is None or self._breaker.state == "closed":
            return self.replay_journal()
        if force:
            self._breaker.trip_half_open()
        elif not self._breaker.probe_due():
            return 0
        for intent in self._journal.pending():
            key = (intent["ns"], intent["name"])
            op = intent["op"]
            if op in (CREATE, UPDATE) and self._store.get(key) is None:
                self._journal.ack(op, key[0], key[1])
                continue
            return 1 if self._queue.try_add_if_absent(Request(key, op)) else 0
        return 0

    def _maybe_retry(self, r: Request, err: Exception) -> bool:
        """async.go:139-154: bounded retries, re-enqueued non-blocking.
        With a journal attached, exhausted retries divert instead of
        dropping — a reservation intent is never lost."""
        logger.warning("write-back %s %s failed: %s", r.type, r.key, err)
        if r.retry_count >= self._max_retry_count:
            if self._journal is not None:
                self._divert(r, "journaled_max_retries")
                return True
            self._mark(r, "dropped_max_retries")
            return False
        self._mark(r, "retry")
        enqueued = self._queue.try_add_if_absent(r.with_incremented_retry_count())
        if not enqueued:
            if self._journal is not None:
                self._divert(r, "journaled_queue_full")
                return True
            self._mark(r, "dropped_queue_full")
            return False
        return True

    def _mark(self, r: Request, what: str) -> None:
        if self._metrics is not None:
            self._metrics.mark(what, r.type)
