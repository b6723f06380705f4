"""Kubernetes REST client: kubeconfig/in-cluster auth, rate-limited
writes, k8s Status→error mapping, and streaming watches.

This is the real-cluster L1 substrate the reference builds with
client-go (``cmd/clients.go:30-76``: kubeconfig path or in-cluster
config, QPS/Burst rate limits applied to every clientset).  Stdlib-only:
``http.client`` over an ``ssl.SSLContext``; no external dependencies.

Error mapping follows the k8s ``metav1.Status`` contract the scheduler's
write-back layer reacts to (``state/cache.py``): HTTP 409 with reason
``AlreadyExists`` vs ``Conflict``, 404 ``NotFound``, 403 with the
namespace-terminating cause (``async.go:88-96,160-163``).
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import ssl
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple
from urllib.parse import urlencode, urlsplit

from .errors import (
    AlreadyExistsError,
    APIError,
    ConflictError,
    ForbiddenError,
    NamespaceTerminatingError,
    NotFoundError,
)
from .ratelimit import TokenBucket

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


@dataclass
class ClusterConfig:
    """Connection + auth material for one API server."""

    host: str  # e.g. https://10.0.0.1:6443
    ca_file: Optional[str] = None
    ca_data: Optional[bytes] = None  # PEM
    client_cert_file: Optional[str] = None
    client_key_file: Optional[str] = None
    bearer_token: Optional[str] = None
    # re-read periodically: bound service-account tokens rotate (~1h);
    # a static copy would 401 forever after expiry (client-go reloads
    # the projected token file the same way)
    bearer_token_file: Optional[str] = None
    insecure_skip_verify: bool = False
    # client-side write rate limits (clients.go:53-54)
    qps: float = 0.0
    burst: int = 0

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.host.startswith("https"):
            return None
        ctx = ssl.create_default_context()
        if self.insecure_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        elif self.ca_file:
            ctx.load_verify_locations(cafile=self.ca_file)
        elif self.ca_data:
            ctx.load_verify_locations(cadata=self.ca_data.decode())
        if self.client_cert_file:
            ctx.load_cert_chain(self.client_cert_file, self.client_key_file)
        return ctx


def in_cluster_config(qps: float = 0.0, burst: int = 0) -> ClusterConfig:
    """Pod-mounted service account (the reference's rest.InClusterConfig
    leg, clients.go:37-44)."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if not host:
        raise RuntimeError(
            "not running in-cluster: KUBERNETES_SERVICE_HOST is unset"
        )
    token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
    ca_path = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
    with open(token_path) as f:
        f.read()  # fail fast when the mount is missing/unreadable
    return ClusterConfig(
        host=f"https://{host}:{port}",
        ca_file=ca_path if os.path.exists(ca_path) else None,
        bearer_token_file=token_path,
        qps=qps,
        burst=burst,
    )


def load_kubeconfig(
    path: Optional[str] = None,
    context: Optional[str] = None,
    qps: float = 0.0,
    burst: int = 0,
) -> ClusterConfig:
    """Parse a kubeconfig file (the reference's
    clientcmd.BuildConfigFromFlags leg, clients.go:38-43).  YAML needs
    the optional pyyaml extra; JSON kubeconfigs work without it."""
    path = path or os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")
    with open(path) as f:
        raw = f.read()
    try:
        cfg = json.loads(raw)
    except json.JSONDecodeError:
        try:
            import yaml
        except ImportError as err:
            raise RuntimeError(
                f"kubeconfig {path} is YAML but pyyaml is not installed "
                "(pip install 'tpu-gang-scheduler[yaml]')"
            ) from err
        cfg = yaml.safe_load(raw)

    ctx_name = context or cfg.get("current-context")
    ctx = next(
        (c["context"] for c in cfg.get("contexts", []) if c.get("name") == ctx_name),
        None,
    )
    if ctx is None:
        raise RuntimeError(f"kubeconfig context {ctx_name!r} not found in {path}")
    cluster = next(
        (
            c["cluster"]
            for c in cfg.get("clusters", [])
            if c.get("name") == ctx.get("cluster")
        ),
        None,
    )
    user = next(
        (u["user"] for u in cfg.get("users", []) if u.get("name") == ctx.get("user")),
        {},
    )
    if cluster is None:
        raise RuntimeError(f"kubeconfig cluster {ctx.get('cluster')!r} not found")

    def _inline_or_file(data_key: str, file_key: str, source: dict) -> Optional[str]:
        """base64 inline data wins over file paths, matching client-go."""
        data = source.get(data_key)
        if data:
            f = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
            f.write(base64.b64decode(data))
            f.close()
            return f.name
        return source.get(file_key)

    return ClusterConfig(
        host=cluster.get("server", ""),
        ca_file=_inline_or_file("certificate-authority-data", "certificate-authority", cluster),
        insecure_skip_verify=bool(cluster.get("insecure-skip-tls-verify", False)),
        client_cert_file=_inline_or_file("client-certificate-data", "client-certificate", user),
        client_key_file=_inline_or_file("client-key-data", "client-key", user),
        bearer_token=user.get("token"),
        bearer_token_file=user.get("tokenFile"),
        qps=qps,
        burst=burst,
    )


def _error_from_status(code: int, body: bytes) -> APIError:
    """metav1.Status → the error taxonomy state/cache.py handles."""
    try:
        status = json.loads(body.decode() or "{}")
    except json.JSONDecodeError:
        status = {}
    reason = status.get("reason", "")
    message = status.get("message", "") or f"HTTP {code}"
    if code == 404 or reason == "NotFound":
        return NotFoundError(message)
    if code == 409:
        if reason == "AlreadyExists":
            return AlreadyExistsError(message)
        return ConflictError(message)
    if code == 403:
        if "because it is being terminated" in message or reason == "NamespaceTerminating":
            ns = (status.get("details") or {}).get("name", "")
            return NamespaceTerminatingError(ns or message)
        return ForbiddenError(message)
    err = APIError(message)
    err.code = code
    return err


class GoneError(APIError):
    """HTTP 410: the watch resourceVersion is too old — relist."""

    reason = "Gone"


class RestClient:
    """Thin requester with per-host connection reuse and a write-side
    token bucket (QPS/Burst, ratelimit.py — reads are unthrottled, like
    client-go's default which throttles the whole clientset; we scope it
    to mutations where the scheduler's burst actually lands)."""

    def __init__(self, config: ClusterConfig):
        self.config = config
        split = urlsplit(config.host)
        self._netloc = split.netloc
        self._https = split.scheme == "https"
        self._ssl = config.ssl_context()
        self._bucket = (
            TokenBucket(config.qps, config.burst) if config.qps > 0 else None
        )
        self._local = threading.local()
        self._token_lock = threading.Lock()
        self._token: Optional[str] = config.bearer_token
        self._token_read_at = 0.0

    # -- connection handling -------------------------------------------------

    # a pooled connection idle past this is assumed dropped server-side
    # and is replaced BEFORE sending — mutations are never blind-retried
    # (a replayed POST that actually landed turns into AlreadyExists,
    # which the write-back cache would mis-handle as a permanent failure)
    _IDLE_RECONNECT_S = 30.0

    def _conn(self, fresh_for_write: bool = False) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        last_used = getattr(self._local, "conn_used_at", 0.0)
        if conn is not None and fresh_for_write and (
            time.monotonic() - last_used > self._IDLE_RECONNECT_S
        ):
            conn.close()
            conn = None
        if conn is None:
            conn = self._new_conn()
            self._local.conn = conn
        self._local.conn_used_at = time.monotonic()
        return conn

    def _new_conn(self) -> http.client.HTTPConnection:
        if self._https:
            return http.client.HTTPSConnection(
                self._netloc, context=self._ssl, timeout=30
            )
        return http.client.HTTPConnection(self._netloc, timeout=30)

    _TOKEN_REFRESH_S = 60.0

    def _bearer(self) -> Optional[str]:
        if not self.config.bearer_token_file:
            return self._token
        with self._token_lock:
            now = time.monotonic()
            if now - self._token_read_at >= self._TOKEN_REFRESH_S:
                try:
                    with open(self.config.bearer_token_file) as f:
                        self._token = f.read().strip()
                    self._token_read_at = now
                except OSError:
                    pass  # keep the last good token; retry next window
            return self._token

    def _headers(self) -> Dict[str, str]:
        headers = {"Accept": "application/json", "Content-Type": "application/json"}
        token = self._bearer()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        return headers

    # -- request -------------------------------------------------------------

    def request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        params: Optional[Dict[str, str]] = None,
    ) -> dict:
        if params:
            path = f"{path}?{urlencode(params)}"
        mutating = method in ("POST", "PUT", "PATCH", "DELETE")
        if self._bucket is not None and mutating:
            self._bucket.acquire()
        payload = json.dumps(body).encode() if body is not None else None
        # GETs are idempotent: one silent retry on a stale keep-alive
        # conn.  Mutations get a pre-emptively fresh connection instead
        # of a retry — replaying a POST/PUT that may have landed would
        # corrupt write-back state (see _IDLE_RECONNECT_S).
        attempts = (0, 1) if not mutating else (0,)
        for attempt in attempts:
            conn = self._conn(fresh_for_write=mutating)
            try:
                conn.request(method, path, body=payload, headers=self._headers())
                resp = conn.getresponse()
                data = resp.read()
                break
            except (http.client.HTTPException, ConnectionError, OSError):
                self._local.conn = None
                if attempt == attempts[-1]:
                    raise
        if resp.status == 410:
            raise GoneError(data.decode(errors="replace")[:200])
        if resp.status >= 400:
            raise _error_from_status(resp.status, data)
        return json.loads(data.decode() or "{}")

    # -- watch ---------------------------------------------------------------

    def watch(
        self,
        path: str,
        resource_version: str,
        timeout_seconds: int = 300,
        stop: Optional[threading.Event] = None,
    ) -> Iterator[Tuple[str, dict]]:
        """Yield (event type, object dict) from a streaming watch.  Runs
        on a DEDICATED connection (never the pooled one — the stream
        holds it for minutes).  Raises GoneError on 410 so the caller
        relists (the reference relies on client-go's reflector doing the
        same, cmd/server.go:91-127)."""
        params = {
            "watch": "1",
            "resourceVersion": resource_version,
            "allowWatchBookmarks": "true",
            "timeoutSeconds": str(timeout_seconds),
        }
        conn = self._new_conn()
        try:
            conn.timeout = timeout_seconds + 30
            conn.request(
                "GET", f"{path}?{urlencode(params)}", headers=self._headers()
            )
            resp = conn.getresponse()
            if resp.status == 410:
                raise GoneError("watch expired")
            if resp.status >= 400:
                raise _error_from_status(resp.status, resp.read())
            buf = b""
            while stop is None or not stop.is_set():
                chunk = resp.read1(65536)
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    event = json.loads(line)
                    etype = event.get("type", "")
                    obj = event.get("object") or {}
                    if etype == "ERROR":
                        # metav1.Status in the stream: 410 shows up here
                        if obj.get("code") == 410 or obj.get("reason") == "Expired":
                            raise GoneError(obj.get("message", "watch expired"))
                        raise _error_from_status(int(obj.get("code") or 500), line)
                    yield etype, obj
        finally:
            conn.close()
