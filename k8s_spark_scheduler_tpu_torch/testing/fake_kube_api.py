"""Recorded-wire fake Kubernetes API server.

Speaks the REST + watch subset of the k8s API over real HTTP, backed by
the embedded ``kube/apiserver.py`` store — so the REST backend
(``kube/restbackend.py``) can be exercised against genuine wire shapes
(metav1.Status errors, JSON-lines watch streams, 410 Gone after history
truncation, apiextensions/v1 CRDs) without a cluster.  The reference
takes the equivalent shortcut with client-go fake clientsets
(``extendertest/extender_test_utils.go:70-72``); this fake goes one
layer lower so the HTTP client, serde, and reflector loops are under
test too.

Supported surface:
- core/v1 pods (namespaced) and nodes (cluster-scoped)
- sparkscheduler.palantir.com/v1beta2 resourcereservations
- scaler.palantir.com/v1alpha2 demands
- apiextensions.k8s.io/v1 customresourcedefinitions (status carries the
  Established condition from the embedded registry)
- ``?watch=1`` streams with resourceVersion resume and configurable
  event-history retention: a resume RV older than retained history gets
  410 Gone (exercising the backend's relist-and-diff path)
"""

from __future__ import annotations

import json
import re
import threading
from collections import defaultdict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from ..kube import apiserver as emb
from ..kube.errors import (
    AlreadyExistsError,
    APIError,
    ConflictError,
    NamespaceTerminatingError,
    NotFoundError,
)
from ..kube.restbackend import _RESOURCES, RestAPIServer

_PATHS = {
    ("", "v1", "pods"): "Pod",
    ("", "v1", "nodes"): "Node",
    ("sparkscheduler.palantir.com", "v1beta2", "resourcereservations"): "ResourceReservation",
    ("scaler.palantir.com", "v1alpha2", "demands"): "Demand",
}

_ITEM_RE = re.compile(
    r"^/(?:api/(?P<corev>v1)|apis/(?P<group>[^/]+)/(?P<ver>[^/]+))"
    r"(?:/namespaces/(?P<ns>[^/]+))?"
    r"/(?P<plural>[^/]+)"
    r"(?:/(?P<name>[^/]+))?"
    r"(?:/(?P<sub>status))?$"
)


def _status(code: int, reason: str, message: str, details: Optional[dict] = None) -> dict:
    out = {
        "apiVersion": "v1",
        "kind": "Status",
        "status": "Failure",
        "code": code,
        "reason": reason,
        "message": message,
    }
    if details:
        out["details"] = details
    return out


def _error_to_status(err: Exception) -> Tuple[int, dict]:
    if isinstance(err, NamespaceTerminatingError):
        return 403, _status(
            403, "Forbidden", err.message, details={"name": err.namespace}
        )
    if isinstance(err, NotFoundError):
        return 404, _status(404, "NotFound", str(err))
    if isinstance(err, AlreadyExistsError):
        return 409, _status(409, "AlreadyExists", str(err))
    if isinstance(err, ConflictError):
        return 409, _status(409, "Conflict", str(err))
    if isinstance(err, APIError):
        return 500, _status(500, err.reason, err.message)
    return 500, _status(500, "InternalError", str(err))


class FakeKubeAPI:
    """HTTP facade over an embedded APIServer store."""

    def __init__(
        self,
        api: Optional[emb.APIServer] = None,
        history_limit: int = 4096,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.api = api or emb.APIServer()
        self.history_limit = history_limit
        # per kind: deque of (rv, event type, wire dict); oldest retained
        # rv marks the 410 horizon
        self._history: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=history_limit)
        )
        self._oldest: Dict[str, int] = defaultdict(int)
        self._subscribers: Dict[str, List] = defaultdict(list)
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        for kind in _RESOURCES:
            self.api.watch(kind, self._make_recorder(kind), replay=True)

        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY, as a real API server sets it: a response goes
            # out as two writes (headers, then body), and on a kept-alive
            # connection Nagle would hold the body until the client's
            # delayed ACK of the headers, about 40 ms a request
            disable_nagle_algorithm = True

            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                fake._handle_http(self, "GET")

            def do_POST(self):
                fake._handle_http(self, "POST")

            def do_PUT(self):
                fake._handle_http(self, "PUT")

            def do_DELETE(self):
                fake._handle_http(self, "DELETE")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    @property
    def host(self) -> str:
        addr, port = self._httpd.server_address[:2]
        return f"http://{addr}:{port}"

    def start(self) -> "FakeKubeAPI":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fake-kube-api", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()  # unblock streaming watch handler threads
        self._httpd.shutdown()
        self._httpd.server_close()

    def client_backend(self, qps: float = 0.0, burst: int = 0) -> RestAPIServer:
        from ..kube.restclient import ClusterConfig

        return RestAPIServer(ClusterConfig(host=self.host, qps=qps, burst=burst))

    # -- event recording -----------------------------------------------------

    def _make_recorder(self, kind: str):
        res = _RESOURCES[kind]

        def record(event: str, obj):
            wire = res.to_wire(obj)
            rv = obj.meta.resource_version
            with self._lock:
                hist = self._history[kind]
                if len(hist) == hist.maxlen and hist:
                    self._oldest[kind] = hist[0][0]
                hist.append((rv, event, wire))
                subs = list(self._subscribers[kind])
            for q in subs:
                q.append((rv, event, wire))

        return record

    # -- request dispatch ----------------------------------------------------

    def _handle_http(self, req: BaseHTTPRequestHandler, method: str) -> None:
        try:
            split = urlsplit(req.path)
            params = {k: v[0] for k, v in parse_qs(split.query).items()}
            path = split.path
            if path.startswith("/apis/apiextensions.k8s.io/v1/customresourcedefinitions"):
                self._handle_crd(req, method, path)
                return
            m = _ITEM_RE.match(path)
            kind = None
            if m:
                group = m.group("group") or ""
                version = m.group("corev") or m.group("ver")
                kind = _PATHS.get((group, version, m.group("plural")))
            if kind is None:
                self._send(req, 404, _status(404, "NotFound", f"no route {path}"))
                return
            res = _RESOURCES[kind]
            ns, name = m.group("ns"), m.group("name")
            body = self._read_body(req)

            if method == "GET" and name is None and params.get("watch") == "1":
                self._serve_watch(req, kind, params)
                return
            if method == "GET" and name is None:
                self._serve_list(req, kind, ns)
                return
            if method == "GET":
                # cluster-scoped objects live under the store's default
                # namespace key (ObjectMeta.namespace defaults to it)
                obj = self.api.get(kind, ns or "default", name)
                self._send(req, 200, res.to_wire(obj))
                return
            if method == "POST":
                obj = res.from_wire(body)
                if res.namespaced and ns:
                    obj.meta.namespace = ns
                out = self.api.create(obj)
                self._send(req, 201, res.to_wire(out))
                return
            if method == "PUT":
                obj = res.from_wire(body)
                if res.namespaced and ns:
                    obj.meta.namespace = ns
                if m.group("sub") == "status":
                    # real subresource semantics: only status fields move,
                    # the stored spec wins (metadata rv still gates)
                    current = self.api.get(kind, obj.namespace, obj.name)
                    merged = current.deepcopy()
                    merged.meta.resource_version = obj.meta.resource_version
                    if kind == "Pod":
                        merged.phase = obj.phase
                        merged.conditions = obj.conditions
                        merged.container_terminated = obj.container_terminated
                    else:
                        merged.status = obj.status
                    obj = merged
                out = self.api.update(obj)
                self._send(req, 200, res.to_wire(out))
                return
            if method == "DELETE":
                self.api.delete(kind, ns or "default", name)
                self._send(req, 200, _status(200, "", "deleted"))
                return
            self._send(req, 405, _status(405, "MethodNotAllowed", method))
        except BrokenPipeError:
            pass
        except Exception as err:  # wire every failure as a k8s Status
            code, status = _error_to_status(err)
            try:
                self._send(req, code, status)
            except BrokenPipeError:
                pass

    def _handle_crd(self, req, method: str, path: str) -> None:
        name = path.rsplit("/", 1)[1] if path.count("/") > 4 else None
        body = self._read_body(req)
        if method == "GET" and name:
            spec = self.api.get_crd(name)
            if spec is None:
                self._send(req, 404, _status(404, "NotFound", f"crd {name} not found"))
                return
            self._send(req, 200, self._crd_wire(name, spec))
            return
        if method == "POST":
            name = (body.get("metadata") or {}).get("name", "")
            spec = RestAPIServer._crd_from_wire(body)
            # Established is server-side state, not client input: the
            # wire the client POSTs has no status, and a real cluster
            # establishes shortly after create — let the embedded
            # registry's auto-establish model that
            spec.pop("established", None)
            self.api.create_crd(name, spec)
            self._send(req, 201, self._crd_wire(name, self.api.get_crd(name)))
            return
        if method == "PUT" and name:
            spec = RestAPIServer._crd_from_wire(body)
            spec.pop("established", None)
            self.api.update_crd(name, spec)
            self._send(req, 200, self._crd_wire(name, self.api.get_crd(name)))
            return
        if method == "DELETE" and name:
            self.api.delete_crd(name)
            self._send(req, 200, _status(200, "", "deleted"))
            return
        self._send(req, 405, _status(405, "MethodNotAllowed", method))

    @staticmethod
    def _crd_wire(name: str, spec: dict) -> dict:
        wire = RestAPIServer._crd_to_wire(name, spec)
        wire["status"] = {
            "conditions": [
                {
                    "type": "Established",
                    "status": "True" if spec.get("established") else "False",
                }
            ]
        }
        return wire

    # -- list / watch --------------------------------------------------------

    def _serve_list(self, req, kind: str, ns: Optional[str]) -> None:
        res = _RESOURCES[kind]
        objs = self.api.list(kind, ns if res.namespaced else None)
        # the GLOBAL revision, like a real apiserver (empty lists
        # included) — a watch resumed from it detects truncated history
        # via 410 instead of silently skipping events
        rv = self.api.resource_version
        body = {
            "apiVersion": "v1",
            "kind": f"{kind}List",
            "metadata": {"resourceVersion": str(rv)},
            "items": [res.to_wire(o) for o in objs],
        }
        self._send(req, 200, body)

    def _serve_watch(self, req, kind: str, params: dict) -> None:
        try:
            since = int(params.get("resourceVersion") or 0)
        except ValueError:
            since = 0
        timeout = float(params.get("timeoutSeconds") or 300)
        res = _RESOURCES[kind]
        with self._lock:
            if since and since < self._oldest[kind]:
                code, status = 410, _status(
                    410, "Expired", f"too old resource version: {since}"
                )
            else:
                code = 200
                q: deque = deque()
                self._subscribers[kind].append(q)
                if since or not self._oldest[kind]:
                    # resume after `since`; from 0 too while the history
                    # is whole: a LIST of a store never written reports
                    # revision 0, and the events between that LIST and
                    # this watch must reach the client (a real API
                    # server never reports 0)
                    backlog = [h for h in self._history[kind] if h[0] > since]
                else:
                    backlog = None  # resolved below, outside the lock
        if code == 410:
            self._send(req, 410, status)
            return
        if backlog is None:
            # rv=0 semantics (real apiserver): synthetic ADDED events for
            # the CURRENT state, then follow live — never a truncated
            # history replay.  The subscriber attached above, so events
            # racing this list are deduped by the rv>sent filter.
            objs = self.api.list(kind)
            baseline = self.api.resource_version
            backlog = [
                (baseline, emb.ADDED, res.to_wire(o)) for o in objs
            ]
            since = 0
        try:
            req.send_response(200)
            req.send_header("Content-Type", "application/json")
            # stream: no Content-Length; HTTP/1.0-style close delimits it
            req.send_header("Connection", "close")
            req.end_headers()
            deadline = threading.Event()

            def write(rv: int, etype: str, wire: dict) -> None:
                line = json.dumps({"type": etype, "object": wire}) + "\n"
                req.wfile.write(line.encode())
                req.wfile.flush()

            sent = since
            for rv, etype, wire in backlog:
                write(rv, etype, wire)
                sent = max(sent, rv)
            import time as _time

            end = _time.monotonic() + timeout
            while _time.monotonic() < end and not self._stopping.is_set():
                while q:
                    rv, etype, wire = q.popleft()
                    if rv > sent:
                        write(rv, etype, wire)
                        sent = max(sent, rv)
                deadline.wait(0.02)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            with self._lock:
                try:
                    self._subscribers[kind].remove(q)
                except ValueError:
                    pass

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _read_body(req) -> dict:
        length = int(req.headers.get("Content-Length") or 0)
        if not length:
            return {}
        return json.loads(req.rfile.read(length).decode() or "{}")

    def _send(self, req, code: int, body: dict) -> None:
        payload = json.dumps(body).encode()
        req.send_response(code)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(payload)))
        req.end_headers()
        req.wfile.write(payload)
