"""Typed write-back caches: ResourceReservations and Demands.

internal/cache/resourcereservations.go (5 writer shards, seeds from the
lister at boot) and demands.go + safedemands.go (the Safe wrapper no-ops
until the Demand CRD exists, then lazily constructs the cache when the
LazyDemandInformer fires).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from ..analysis.guarded import guarded_by
from ..kube.apiserver import APIServer
from ..kube.crd import DEMAND_CRD_NAME
from ..kube.informer import Informer, InformerFactory
from ..types.objects import Demand, ResourceReservation
from .cache import AsyncClient, TypedClient, WriteBackCache
from .store import ObjectStore, ShardedUniqueQueue

RESERVATION_WRITER_SHARDS = 5  # resourcereservations.go:29-34
DEMAND_WRITER_SHARDS = 5


class ResourceReservationCache:
    """internal/cache/resourcereservations.go:40-138.

    on_change(old, new) observers fire on every local mutation and on
    informer deletes (old/new None for create/delete) — the tensor
    snapshot cache uses them to maintain usage deltas incrementally.
    """

    def __init__(
        self,
        api: APIServer,
        informer: Informer,
        max_retry_count: int = 5,
        rate_bucket=None,
        breaker=None,
        journal=None,
        registry=None,
        owners=None,
    ):
        self._queue = ShardedUniqueQueue(RESERVATION_WRITER_SHARDS)
        self._store = ObjectStore()
        # seed from the lister so state survives restarts
        # (resourcereservations.go:53-60)
        for obj in informer.list():
            self._store.put_if_absent(obj)
        self._informer = informer
        self._cache = WriteBackCache(self._queue, self._store, informer)
        client = TypedClient(api, ResourceReservation.KIND)
        if rate_bucket is not None:
            from ..kube.ratelimit import RateLimitedClient

            client = RateLimitedClient(client, rate_bucket)
        from ..types import serde

        self._journal = journal
        self._async = AsyncClient(
            client,
            self._queue,
            self._store,
            max_retry_count,
            breaker=breaker,
            journal=journal,
            kind=ResourceReservation.KIND,
            to_wire=serde.rr_to_dict_v1beta2,
            registry=registry,
            owners=owners,
        )

    def install_fence(self, gate) -> None:
        """HA wiring: fence every reservation write-back (and journal
        ack) behind the given :class:`~..ha.fencing.FencedWriter`, and
        stamp journal records with the holder's epoch."""
        self._async.fence_gate = gate
        if self._journal is not None:
            self._journal.fence_gate = gate
            self._journal.epoch_source = gate.fence.epoch

    def add_change_observer(self, fn) -> None:
        """fn(old, new) on every semantic content change of the LOCAL
        store — local writes, informer deletes, and informer inserts
        alike (store-level observation, so incremental mirrors can never
        drift from what reads observe)."""
        self._store.add_content_observer(fn)

    def run(self) -> None:
        self._async.run()

    def stop(self) -> None:
        self._async.stop()

    def create(self, rr: ResourceReservation) -> None:
        self._cache.create(rr)

    def update(self, rr: ResourceReservation) -> None:
        self._cache.update(rr)

    def delete(self, namespace: str, name: str) -> None:
        self._cache.delete(namespace, name)

    def get(self, namespace: str, name: str) -> Optional[ResourceReservation]:
        return self._cache.get(namespace, name)

    def list(self) -> List[ResourceReservation]:
        return self._cache.list()

    def inflight_queue_lengths(self) -> List[int]:
        return self._queue.queue_lengths()

    # -- resilience: intent-journal recovery ---------------------------------

    def journal_depth(self) -> int:
        return self._journal.depth() if self._journal is not None else 0

    def nudge_recovery(self, force: bool = False) -> int:
        """Re-enqueue journaled reservation intents when a write could
        land again (see AsyncClient.nudge_recovery)."""
        return self._async.nudge_recovery(force=force)

    def recover_from_journal(self) -> int:
        """Failover replay: apply intents journaled by a PREVIOUS
        scheduler instance against this instance's lister-seeded store,
        or at a takeover, this replica's own intents diverted while it
        was deposed.  Exactly-once at the CRD level: intents whose write
        already landed (the lister saw the object) — or whose object has
        since been GC'd — are acked without a write; only
        genuinely-unlanded intents are enqueued.  Returns the number of intents enqueued."""
        if self._journal is None or self._journal.depth() == 0:
            return 0
        from ..types import serde
        from .store import create_request, update_request

        enqueued = 0
        for intent in self._journal.pending():
            if intent.get("kind") not in (None, ResourceReservation.KIND):
                # defense: a journal file shared with another intent
                # class (the reference's policy evictions) must not be
                # replayed as reservation writes — foreign kinds are
                # left pending for their own recoverer
                continue
            key = (intent["ns"], intent["name"])
            op = intent["op"]
            existing = self._store.get(key)
            if op == "delete":
                if existing is not None:
                    self._cache.delete(key[0], key[1])
                    enqueued += 1
                else:
                    self._journal.ack(op, key[0], key[1])
                continue
            if op == "create" and existing is not None:
                if self._informer.get(key[0], key[1]) is not None:
                    # landed before the old instance died; lister seeded it
                    self._journal.ack(op, key[0], key[1])
                else:
                    # a warm replica's own diverted create (a deposed
                    # leader re-elected): its store holds an object the
                    # API server never received — write it.  The
                    # reference acks this intent unwritten (ROADMAP C.5)
                    self._queue.add_if_absent(create_request(existing))
                    enqueued += 1
                continue
            wire = intent.get("obj")
            if not wire:
                self._journal.ack(op, key[0], key[1])
                continue
            obj = serde.rr_from_dict_v1beta2(wire)
            if existing is None:
                # covers updates whose create was collapsed into them
                # while diverted: recreate from the journaled wire copy.
                # If the owning driver died meanwhile, the API server's
                # dangling-owner GC collects the recreated object.
                self._store.put_if_absent(obj)
                self._queue.add_if_absent(create_request(obj))
            else:
                # the old instance was the sole writer: its journaled
                # content is the newest intended state
                self._store.put(obj)
                self._queue.add_if_absent(update_request(obj))
            enqueued += 1
        return enqueued


class DemandCache:
    """internal/cache/demands.go:40-117."""

    def __init__(
        self,
        api: APIServer,
        informer: Informer,
        max_retry_count: int = 5,
        rate_bucket=None,
        registry=None,
        owners=None,
    ):
        self._queue = ShardedUniqueQueue(DEMAND_WRITER_SHARDS)
        self._store = ObjectStore()
        for obj in informer.list():
            self._store.put_if_absent(obj)
        self._cache = WriteBackCache(self._queue, self._store, informer)
        client = TypedClient(api, Demand.KIND)
        if rate_bucket is not None:
            from ..kube.ratelimit import RateLimitedClient

            client = RateLimitedClient(client, rate_bucket)
        self._async = AsyncClient(
            client,
            self._queue,
            self._store,
            max_retry_count,
            kind=Demand.KIND,
            registry=registry,
            owners=owners,
        )

    def install_fence(self, gate) -> None:
        self._async.fence_gate = gate

    def run(self) -> None:
        self._async.run()

    def stop(self) -> None:
        self._async.stop()

    def create(self, demand: Demand) -> None:
        self._cache.create(demand)

    def delete(self, namespace: str, name: str) -> None:
        self._cache.delete(namespace, name)

    def get(self, namespace: str, name: str) -> Optional[Demand]:
        return self._cache.get(namespace, name)

    def list(self) -> List[Demand]:
        return self._cache.list()

    def inflight_queue_lengths(self) -> List[int]:
        return self._queue.queue_lengths()


@guarded_by("_callback_lock", "_callbacks")
class LazyDemandInformer:
    """internal/crd/demand_informer.go:40-138: polls for the Demand CRD to
    become Established, then starts the informer and signals ready."""

    def __init__(
        self,
        api: APIServer,
        informer_factory: InformerFactory,
        poll_interval: float = 60.0,
    ):
        self._api = api
        self._factory = informer_factory
        self._poll_interval = poll_interval
        self._ready = threading.Event()
        self._stop = threading.Event()
        self._callbacks: List[Callable[[], None]] = []
        self._callback_lock = threading.Lock()
        self._informer: Optional[Informer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._check_crd():
            self._become_ready()
            return
        self._thread = threading.Thread(target=self._poll, daemon=True, name="lazy-demand-informer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def ready(self) -> bool:
        return self._ready.is_set()

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        return self._ready.wait(timeout)

    def on_ready(self, callback: Callable[[], None]) -> None:
        with self._callback_lock:
            if not self._ready.is_set():
                self._callbacks.append(callback)
                return
        callback()

    def informer(self) -> Optional[Informer]:
        return self._informer

    def _poll(self) -> None:
        while not self._ready.is_set():
            if self._check_crd():
                self._become_ready()
                return
            if self._stop.wait(self._poll_interval):
                return

    def _check_crd(self) -> bool:
        return self._api.crd_established(DEMAND_CRD_NAME)

    def _become_ready(self) -> None:
        informer = self._factory.informer(Demand.KIND)
        if not informer.has_synced():
            informer.start()
        self._informer = informer
        # run callbacks BEFORE signalling ready: a waiter woken by
        # wait_ready() must observe downstream constructions (e.g. the
        # SafeDemandCache delegate) already in place.  The callback lock
        # closes the register-vs-become-ready race: anyone who saw
        # ready=False under the lock is in the list we drain here.
        while True:
            with self._callback_lock:
                callbacks, self._callbacks = self._callbacks, []
                if not callbacks:
                    self._ready.set()
                    return
            for callback in callbacks:
                callback()


@guarded_by("_lock", "_delegate")
class SafeDemandCache:
    """internal/cache/safedemands.go:31-127: degrades to a no-op until the
    Demand CRD exists."""

    def __init__(
        self,
        lazy_informer: LazyDemandInformer,
        api: APIServer,
        max_retry_count: int = 5,
        rate_bucket=None,
        registry=None,
        owners=None,
    ):
        self._lazy = lazy_informer
        self._owners = owners
        self._api = api
        self._max_retry_count = max_retry_count
        self._rate_bucket = rate_bucket
        self._registry = registry
        self._delegate: Optional[DemandCache] = None
        self._lock = threading.Lock()
        self._fence_gate = None
        lazy_informer.on_ready(self._construct)

    def install_fence(self, gate) -> None:
        """HA wiring; applied immediately when the delegate exists, or
        at lazy construction otherwise."""
        with self._lock:
            self._fence_gate = gate
            if self._delegate is not None:
                self._delegate.install_fence(gate)

    def _construct(self) -> None:
        with self._lock:
            if self._delegate is None:
                cache = DemandCache(
                    self._api,
                    self._lazy.informer(),
                    self._max_retry_count,
                    rate_bucket=self._rate_bucket,
                    registry=self._registry,
                    owners=self._owners,
                )
                if self._fence_gate is not None:
                    cache.install_fence(self._fence_gate)
                cache.run()
                self._delegate = cache

    def crd_exists(self) -> bool:
        if self._delegate is not None:
            return True
        return self._lazy.ready()

    def create(self, demand: Demand) -> None:
        if self._delegate is not None:
            self._delegate.create(demand)

    def delete(self, namespace: str, name: str) -> None:
        if self._delegate is not None:
            self._delegate.delete(namespace, name)

    def get(self, namespace: str, name: str) -> Optional[Demand]:
        if self._delegate is not None:
            return self._delegate.get(namespace, name)
        return None

    def list(self) -> List[Demand]:
        if self._delegate is not None:
            return self._delegate.list()
        return []

    def stop(self) -> None:
        if self._delegate is not None:
            self._delegate.stop()

    def inflight_queue_lengths(self) -> List[int]:
        if self._delegate is not None:
            return self._delegate.inflight_queue_lengths()
        return []
