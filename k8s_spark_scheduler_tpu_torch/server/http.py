"""HTTP surface: the kube-scheduler extender protocol + ops endpoints.

- ``POST /predicates`` — ExtenderArgs JSON in, ExtenderFilterResult out
  (reference cmd/endpoints.go:28-42).  A bad payload answers 400; an
  error inside the Filter (a kernel build, launch or solve failure
  among them) answers 500 — it is never turned into a decision.
- ``GET /status/liveness`` / ``GET /status/readiness`` — management
  probes (witchcraft server equivalents, examples/extender.yml:142-151);
  readiness answers 503 until the caches are synced and the kernel
  warmup has finished without error
- ``GET /metrics`` — metrics registry snapshot as JSON
- ``GET /traces`` — recent completed span trees (tracing/spans.py ring)
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from ..tracing import spans as tracing
from ..types import serde
from .wiring import Server

logger = logging.getLogger(__name__)

# inbound X-Trace-Id must be propagation-safe before it is echoed into
# response headers and log lines: bounded length, trace-id charset only
# (hex/alnum plus the separators zipkin-style ids use).  Anything else —
# control characters, log-injection payloads, unbounded blobs — is
# replaced with a fresh id.
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")


def sanitize_trace_id(raw: Optional[str]) -> str:
    if raw and _TRACE_ID_RE.match(raw):
        return raw
    return tracing.new_trace_id()


class _ExtenderHTTPD(ThreadingHTTPServer):
    # socketserver defaults to a 5-connection listen backlog; a
    # kube-scheduler burst (or parallel probes) overflows that and the
    # kernel resets connections
    request_queue_size = 128
    # server_close() joins the per-request handler threads
    daemon_threads = False


class _Handler(BaseHTTPRequestHandler):
    server_version = "tpu-gang-scheduler"
    scheduler: Optional[Server] = None
    # per-connection socket timeout (applied by BaseHTTPRequestHandler.
    # setup): bounds slow reads so a stalled peer only ties up its own
    # worker thread.  The kube-scheduler extender client gives up after
    # 30s (examples/extender.yml httpTimeout), so 65s is a safe bound.
    timeout = 65

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("http: " + fmt, *args)

    def _send_bytes(self, code: int, data: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        trace = getattr(self, "_trace", None)
        if trace is not None:
            trace_id, t0 = trace
            self.send_header("X-Trace-Id", trace_id)
            logger.info(
                "request traceId=%s path=%s status=%d durationMs=%.1f",
                trace_id,
                self.path,
                code,
                (time.perf_counter() - t0) * 1000.0,
            )
            span = tracing.current_span()
            if span is not None:
                span.tag("status", code)
        # close the root span BEFORE the response bytes go out: a client
        # that sees the response must be able to retrieve the trace from
        # /traces immediately (the do_* finally is only a backstop for
        # handlers that die before responding)
        self._finish_trace()
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code: int, payload: dict) -> None:
        self._send_bytes(code, json.dumps(payload).encode(), "application/json")

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b"{}"
        return json.loads(raw or b"{}")

    def do_GET(self):
        # GET endpoints (probes, /metrics scrapes, /traces polls) keep
        # the trace-id header + request log line but do NOT open a root
        # span: recording them would churn scheduling decisions out of
        # the bounded trace ring
        self._begin_trace(open_span=False)
        try:
            self._handle_get()
        finally:
            self._finish_trace()

    def _handle_get(self):
        split = urlsplit(self.path)
        path, query = split.path, parse_qs(split.query)
        if path == "/status/liveness":
            self._send_json(200, {"status": "up"})
        elif path == "/status/readiness":
            serving = (
                self.scheduler is not None
                and self.scheduler.informer_factory.wait_for_cache_sync()
                # kernel warmup still building (or failed): admitting
                # traffic now would put the nvcc build on the first
                # Filter requests, or serve a kernel that does not run
                and self.scheduler.warmup_complete()
            )
            self._send_json(200 if serving else 503, {"ready": serving})
        elif path == "/metrics" and self.scheduler is not None:
            self._send_json(200, self.scheduler.metrics.snapshot())
        elif path == "/traces" and self.scheduler is not None:
            limit = None
            try:
                limit = int(query.get("limit", [""])[0])
            except (ValueError, IndexError):
                pass
            self._send_json(200, {"traces": self.scheduler.tracer.traces(limit=limit)})
        else:
            self._send_json(404, {"error": "not found"})

    def _begin_trace(self, open_span: bool = True):
        # request tracing (the reference's witchcraft request log / trc1
        # analog): a trace id per request, echoed in the response header
        # and the request log line with the handler duration.  The
        # inbound header is sanitized before it can reach a header or
        # log line; the root span carries the whole handler.
        trace_id = sanitize_trace_id(self.headers.get("X-Trace-Id"))
        self._trace = (trace_id, time.perf_counter())
        tracer = self.scheduler.tracer if self.scheduler is not None else None
        self._root_span = None
        if open_span and tracer is not None and tracer.enabled:
            self._root_span = tracer.span("http.request", {"path": self.path}, trace_id=trace_id)
            self._root_span.__enter__()

    def _finish_trace(self):
        span = getattr(self, "_root_span", None)
        if span is not None:
            span.__exit__(None, None, None)
            self._root_span = None

    def do_POST(self):
        self._begin_trace()
        try:
            self._handle_post()
        finally:
            self._finish_trace()

    def _handle_post(self):
        if self.path != "/predicates":
            self._send_json(404, {"error": "not found"})
            return
        try:
            with tracing.child_span("http.read"):
                body = self._read_json()
        except ValueError as err:  # json.JSONDecodeError and bad lengths
            self._send_json(400, {"error": f"bad json: {err}"})
            return
        if not isinstance(body, dict):
            self._send_json(400, {"error": "body must be a JSON object"})
            return
        if self.scheduler is None:
            self._send_json(503, {"error": "scheduler not ready"})
            return
        try:
            # at the 10k-node shape the ExtenderArgs parse and the
            # FailedNodes encode are a large share of the handler
            with tracing.child_span("serde.decode"):
                args = serde.extender_args_from_dict(body)
        except (KeyError, TypeError, ValueError, AttributeError) as err:
            self._send_json(400, {"error": f"bad ExtenderArgs: {err}"})
            return
        try:
            result = self.scheduler.extender.predicate(args)
        except Exception as err:  # the request boundary: report, never decide
            logger.exception("predicate failed for %s/%s", args.pod.namespace, args.pod.name)
            self._send_json(500, {"error": f"predicate failed: {type(err).__name__}: {err}"})
            return
        # encoded uniform failures come from a reusable buffer pool
        # (serde.encode_extender_filter_result) — the 10k-entry
        # FailedNodes map serializes once per (candidates, message)
        with tracing.child_span("serde.encode"):
            encoded = serde.encode_extender_filter_result(result)
        self._send_bytes(200, encoded, "application/json")


class ExtenderHTTPServer:
    """The serving process: extender endpoints on the main port."""

    def __init__(self, scheduler: Optional[Server], port: int = 0, host: str = ""):
        # host="" binds all interfaces: kube-scheduler dials the pod IP,
        # not loopback
        handler = type("BoundHandler", (_Handler,), {"scheduler": scheduler})
        self._httpd = _ExtenderHTTPD((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="extender-http"
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
