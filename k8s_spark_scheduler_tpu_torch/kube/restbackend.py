"""Real-cluster backend: the embedded APIServer interface served by a
Kubernetes API server over REST.

The rest of the framework (informers, write-back caches, CRD ensure,
the unschedulable marker) is written against the embedded
``kube/apiserver.py`` interface; this class implements that same
interface with client-go-equivalent behavior (SURVEY §2.10 L1):

- **reads**: per-kind list+watch loops on background threads feeding
  the registered handlers — bookmarks keep the resourceVersion fresh,
  HTTP 410 triggers a relist, stream drops reconnect with backoff
  (the reflector loop of ``cmd/server.go:91-127``);
- **writes**: plain REST with the k8s Status error taxonomy mapped to
  ``kube/errors.py`` so the async write-back's 409/terminating-namespace
  handling (``state/cache.py``, ref ``async.go:88-96,111-123``) works
  unchanged;
- **CRDs**: apiextensions/v1 objects translated to/from the embedded
  registry's spec-dict form, with Established read from status
  conditions (``internal/crd/utils.go:32-151``).

Watch event objects convert through ``types/serde.py``; unknown kinds
raise early rather than silently serving nothing.  The kinds are those
the scheduler reads and writes: Pod, Node, ResourceReservation v1beta2
and Demand v1alpha2 (no coordination Lease: nothing in this package
elects a leader).
"""

from __future__ import annotations

import logging
import random
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..types import serde
from ..types.objects import APIObject, Demand, Node, Pod, ResourceReservation
from .apiserver import ADDED, DELETED, MODIFIED
from .errors import NotFoundError
from .restclient import ClusterConfig, GoneError, RestClient

logger = logging.getLogger(__name__)

WatchHandler = Callable[[str, APIObject], None]

CRD_BASE = "/apis/apiextensions.k8s.io/v1/customresourcedefinitions"

# watch-reconnect backoff: full jitter over an exponentially-growing
# window, capped.  Full jitter (AWS architecture blog shape) desynchronizes
# a fleet of watchers hammering a recovering API server; both error paths
# (stream drop AND relist failure) MUST draw from the same distribution —
# a jitterless path re-synchronizes the herd on exactly the retries that
# matter most.
WATCH_BACKOFF_INITIAL_S = 0.2
WATCH_BACKOFF_CAP_S = 30.0


def watch_backoff_delay(backoff: float, rng=random) -> float:
    """One full-jitter delay draw: uniform over [0, min(backoff, cap)]."""
    return rng.uniform(0.0, min(backoff, WATCH_BACKOFF_CAP_S))


def next_watch_backoff(backoff: float) -> float:
    """The window for the NEXT retry: doubled, capped."""
    return min(backoff * 2, WATCH_BACKOFF_CAP_S)


@dataclass
class _Resource:
    kind: str
    base: str  # e.g. /api/v1 or /apis/<group>/<version>
    plural: str
    namespaced: bool
    to_wire: Callable[[APIObject], dict]
    from_wire: Callable[[dict], APIObject]

    def path(self, namespace: Optional[str] = None, name: Optional[str] = None) -> str:
        p = self.base
        if self.namespaced and namespace is not None:
            p += f"/namespaces/{namespace}"
        p += f"/{self.plural}"
        if name is not None:
            p += f"/{name}"
        return p


def _pod_to_wire(pod: Pod) -> dict:
    d = serde.pod_to_dict(pod)
    d["apiVersion"] = "v1"
    d["kind"] = "Pod"
    return d


_RESOURCES: Dict[str, _Resource] = {
    Pod.KIND: _Resource(
        Pod.KIND, "/api/v1", "pods", True, _pod_to_wire, serde.pod_from_dict
    ),
    Node.KIND: _Resource(
        Node.KIND, "/api/v1", "nodes", False, serde.node_to_dict, serde.node_from_dict
    ),
    ResourceReservation.KIND: _Resource(
        ResourceReservation.KIND,
        "/apis/sparkscheduler.palantir.com/v1beta2",
        "resourcereservations",
        True,
        serde.rr_to_dict_v1beta2,
        serde.rr_from_dict_v1beta2,
    ),
    Demand.KIND: _Resource(
        Demand.KIND,
        "/apis/scaler.palantir.com/v1alpha2",
        "demands",
        True,
        serde.demand_to_dict_v1alpha2,
        serde.demand_from_dict_v1alpha2,
    ),
}


def _k8s_wire(obj_dict: dict) -> dict:
    """Adapt the embedded wire form to real k8s wire shape — the ONE
    place float timestamps become RFC3339 (metadata timestamps and pod
    condition transition times; metav1.Time rejects JSON numbers), and
    server-assigned identity fields are stripped when empty."""
    meta = obj_dict.get("metadata") or {}
    for key in ("creationTimestamp", "deletionTimestamp"):
        v = meta.get(key)
        if isinstance(v, (int, float)):
            if v:
                meta[key] = serde.ts_to_rfc3339(float(v))
            else:
                meta.pop(key, None)
    for cond in (obj_dict.get("status") or {}).get("conditions") or []:
        t = cond.get("lastTransitionTime")
        if isinstance(t, (int, float)):
            if t:
                cond["lastTransitionTime"] = serde.ts_to_rfc3339(float(t))
            else:
                cond.pop("lastTransitionTime", None)
    if not meta.get("resourceVersion") or meta.get("resourceVersion") == "0":
        meta.pop("resourceVersion", None)
    if not meta.get("uid"):
        meta.pop("uid", None)
    return obj_dict


class _KindWatch:
    """One reflector: list → replay → stream, shared by all handlers of
    a kind."""

    def __init__(self, backend: "RestAPIServer", resource: _Resource):
        self.backend = backend
        self.resource = resource
        self.handlers: List[WatchHandler] = []
        self.lock = threading.Lock()
        self.stop_event = threading.Event()
        self.thread: Optional[threading.Thread] = None
        # local mirror so late handlers can replay without a relist
        self.mirror: Dict[tuple, APIObject] = {}
        self.resource_version = "0"

    def add_handler(self, handler: WatchHandler, replay: bool) -> None:
        with self.lock:
            started = self.thread is not None
            if started:
                snapshot = list(self.mirror.values()) if replay else []
                self.handlers.append(handler)
        if started:
            for obj in snapshot:
                handler(ADDED, obj.deepcopy())
            return
        # first handler: synchronous list (so callers observe list+watch
        # semantics like the embedded server), then start the stream
        items = self._list_and_prime()
        with self.lock:
            self.handlers.append(handler)
        if replay:
            for obj in items:
                handler(ADDED, obj.deepcopy())
        self.thread = threading.Thread(
            target=self._run, name=f"watch-{self.resource.kind}", daemon=True
        )
        self.thread.start()

    def _list_and_prime(self) -> List[APIObject]:
        data = self.backend.client.request("GET", self.resource.path())
        self.resource_version = (data.get("metadata") or {}).get(
            "resourceVersion", "0"
        )
        items = [self.resource.from_wire(item) for item in data.get("items") or []]
        with self.lock:
            self.mirror = {(o.namespace, o.name): o for o in items}
        return items

    def _dispatch(self, event: str, obj: APIObject) -> None:
        with self.lock:
            key = (obj.namespace, obj.name)
            if event == DELETED:
                self.mirror.pop(key, None)
            else:
                self.mirror[key] = obj
            handlers = list(self.handlers)
        for handler in handlers:
            try:
                handler(event, obj.deepcopy())
            except Exception:
                logger.exception("watch handler failed for %s", self.resource.kind)

    def _run(self) -> None:
        backoff = WATCH_BACKOFF_INITIAL_S
        while not self.stop_event.is_set():
            try:
                for etype, wire in self.backend.client.watch(
                    self.resource.path(),
                    self.resource_version,
                    stop=self.stop_event,
                ):
                    backoff = WATCH_BACKOFF_INITIAL_S
                    if etype == "BOOKMARK":
                        rv = (wire.get("metadata") or {}).get("resourceVersion")
                        if rv:
                            self.resource_version = rv
                        continue
                    obj = self.resource.from_wire(wire)
                    self.resource_version = str(obj.meta.resource_version)
                    self._dispatch(etype, obj)
                # clean stream end (server-side timeout): resume from the
                # last seen rv
            except GoneError:
                # 410: our rv fell out of the server's watch window —
                # relist and synthesize events against the mirror
                # (client-go's reflector + DeltaFIFO Replace equivalent)
                try:
                    self._relist_and_diff()
                except Exception:
                    logger.exception("relist after 410 failed; backing off")
                    self.stop_event.wait(watch_backoff_delay(backoff))
                    backoff = next_watch_backoff(backoff)
            except Exception:
                if self.stop_event.is_set():
                    return
                logger.exception(
                    "watch stream for %s dropped; reconnecting", self.resource.kind
                )
                self.stop_event.wait(watch_backoff_delay(backoff))
                backoff = next_watch_backoff(backoff)

    def _relist_and_diff(self) -> None:
        with self.lock:
            before = dict(self.mirror)
        data = self.backend.client.request("GET", self.resource.path())
        self.resource_version = (data.get("metadata") or {}).get("resourceVersion", "0")
        items = [self.resource.from_wire(item) for item in data.get("items") or []]
        after = {(o.namespace, o.name): o for o in items}
        for key, obj in after.items():
            old = before.get(key)
            if old is None:
                self._dispatch(ADDED, obj)
            elif old.meta.resource_version != obj.meta.resource_version:
                self._dispatch(MODIFIED, obj)
        for key, obj in before.items():
            if key not in after:
                self._dispatch(DELETED, obj)

    def stop(self) -> None:
        self.stop_event.set()


class RestAPIServer:
    """APIServer-interface adapter over a real Kubernetes API server."""

    def __init__(self, config: ClusterConfig):
        self.client = RestClient(config)
        self._watches: Dict[str, _KindWatch] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _resource(kind: str) -> _Resource:
        res = _RESOURCES.get(kind)
        if res is None:
            raise ValueError(f"kind {kind!r} has no REST mapping")
        return res

    # -- object CRUD (apiserver.py signatures) -------------------------------

    def create(self, obj: APIObject) -> APIObject:
        res = self._resource(obj.KIND)
        wire = _k8s_wire(res.to_wire(obj))
        out = self.client.request(
            "POST", res.path(obj.namespace if res.namespaced else None), body=wire
        )
        return res.from_wire(out)

    def update(self, obj: APIObject) -> APIObject:
        res = self._resource(obj.KIND)
        wire = _k8s_wire(res.to_wire(obj))
        # updates MUST carry the caller's resourceVersion for optimistic
        # concurrency (the 409 path state/cache.py resolves inline)
        wire.setdefault("metadata", {})["resourceVersion"] = str(
            obj.meta.resource_version
        )
        path = res.path(obj.namespace if res.namespaced else None, obj.name)
        # the scheduler's only Pod mutation is the unschedulable marker's
        # condition write (unschedulablepods.go:168-180) — pod status is
        # a subresource on a real apiserver, a spec-path PUT would
        # silently drop it
        if obj.KIND == Pod.KIND:
            path += "/status"
        out = self.client.request("PUT", path, body=wire)
        return res.from_wire(out)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        res = self._resource(kind)
        self.client.request(
            "DELETE", res.path(namespace if res.namespaced else None, name)
        )

    def get(self, kind: str, namespace: str, name: str) -> APIObject:
        res = self._resource(kind)
        out = self.client.request(
            "GET", res.path(namespace if res.namespaced else None, name)
        )
        return res.from_wire(out)

    def list(self, kind: str, namespace: Optional[str] = None) -> List[APIObject]:
        res = self._resource(kind)
        out = self.client.request(
            "GET", res.path(namespace if res.namespaced else None)
        )
        return [res.from_wire(item) for item in out.get("items") or []]

    # -- watch ---------------------------------------------------------------

    def watch(self, kind: str, handler: WatchHandler, replay: bool = True) -> None:
        res = self._resource(kind)
        with self._lock:
            kw = self._watches.get(kind)
            if kw is None:
                kw = _KindWatch(self, res)
                self._watches[kind] = kw
        kw.add_handler(handler, replay)

    def stop(self) -> None:
        with self._lock:
            watches = list(self._watches.values())
        for kw in watches:
            kw.stop()

    # alias used by server shutdown paths
    close = stop

    # -- CRD registry (apiextensions/v1) -------------------------------------

    @staticmethod
    def _crd_to_wire(name: str, spec: dict) -> dict:
        group = spec.get("group", "")
        plural = spec.get("plural", name.split(".", 1)[0])
        wire: dict = {
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "CustomResourceDefinition",
            "metadata": {"name": name, "annotations": dict(spec.get("annotations") or {})},
            "spec": {
                "group": group,
                "scope": "Namespaced",
                "names": {
                    "plural": plural,
                    "singular": plural.rstrip("s"),
                    "kind": spec.get("kind")
                    or plural.rstrip("s").title().replace("-", ""),
                    "shortNames": list(spec.get("short_names") or []),
                },
                "versions": [
                    {
                        "name": v["name"],
                        "served": bool(v.get("served", True)),
                        "storage": bool(v.get("storage", False)),
                        "schema": {
                            "openAPIV3Schema": {
                                "type": "object",
                                "x-kubernetes-preserve-unknown-fields": True,
                            }
                        },
                    }
                    for v in spec.get("versions") or []
                ],
            },
        }
        conversion = spec.get("conversion")
        if conversion:
            wire["spec"]["conversion"] = conversion
        return wire

    @staticmethod
    def _crd_from_wire(wire: dict) -> dict:
        spec = wire.get("spec") or {}
        names = spec.get("names") or {}
        conditions = (wire.get("status") or {}).get("conditions") or []
        established = any(
            c.get("type") == "Established" and c.get("status") == "True"
            for c in conditions
        )
        return {
            "group": spec.get("group", ""),
            "plural": names.get("plural", ""),
            "short_names": list(names.get("shortNames") or []),
            "versions": [
                {
                    "name": v.get("name"),
                    "served": bool(v.get("served")),
                    "storage": bool(v.get("storage")),
                }
                for v in spec.get("versions") or []
            ],
            "annotations": dict(
                (wire.get("metadata") or {}).get("annotations") or {}
            ),
            "conversion": spec.get("conversion"),
            "established": established,
        }

    def create_crd(self, name: str, spec: dict) -> None:
        self.client.request("POST", CRD_BASE, body=self._crd_to_wire(name, spec))

    def update_crd(self, name: str, spec: dict) -> None:
        # two replicas ensuring the CRD at boot race on this PUT; resolve
        # 409s through the shared conflict-retry discipline
        from .conflict import run_with_conflict_retry

        state = {"rv": ""}

        def refresh() -> bool:
            current = self.client.request("GET", f"{CRD_BASE}/{name}")
            state["rv"] = (current.get("metadata") or {}).get("resourceVersion", "")
            return True

        def attempt():
            wire = self._crd_to_wire(name, spec)
            wire["metadata"]["resourceVersion"] = state["rv"]
            return self.client.request("PUT", f"{CRD_BASE}/{name}", body=wire)

        refresh()
        run_with_conflict_retry(attempt, refresh, kind="CustomResourceDefinition")

    def get_crd(self, name: str) -> Optional[dict]:
        try:
            return self._crd_from_wire(self.client.request("GET", f"{CRD_BASE}/{name}"))
        except NotFoundError:
            return None

    def delete_crd(self, name: str) -> None:
        try:
            self.client.request("DELETE", f"{CRD_BASE}/{name}")
        except NotFoundError:
            pass

    def crd_established(self, name: str) -> bool:
        crd = self.get_crd(name)
        return bool(crd and crd.get("established"))
