"""HTTP surface: the kube-scheduler extender protocol + ops endpoints.

- ``POST /predicates`` — ExtenderArgs JSON in, ExtenderFilterResult out
  (reference cmd/endpoints.go:28-42), behind the admission gate and the
  request deadline (resilience/): a request beyond the gate's capacity
  is shed at once with a retriable all-nodes failure, and one that
  outlives kube-scheduler's httpTimeout answers fail-fast.  A bad
  payload answers 400; an error inside the Filter (a kernel build,
  launch or solve failure among them) answers 500 — it is never turned
  into a decision.
- ``POST /convert`` — CRD ConversionReview webhook
  (internal/conversionwebhook/resource_reservation.go:33-98; also served
  standalone with ``webhook_only``, mirroring the
  spark-scheduler-conversion-webhook module)
- ``GET /status/liveness`` / ``GET /status/readiness`` — management
  probes (witchcraft server equivalents, examples/extender.yml:142-151);
  readiness answers 503 until the caches are synced and the kernel
  warmup has finished without error (always ready in webhook-only mode),
  with the tri-state health body (ready / degraded / unready and the
  resilience components) once a scheduler is wired
- ``GET /metrics`` — metrics registry snapshot: JSON by default,
  Prometheus text exposition when the Accept header asks for
  ``text/plain``/openmetrics or ``?format=prometheus`` is passed, the
  exemplar-carrying OpenMetrics flavour only on ``?format=openmetrics``
- ``GET /traces`` — recent completed span trees (tracing/spans.py ring)
- ``GET /explain/<pod>`` — the pod's last decision record (provenance/):
  queue slice, verdicts and, for a refusal, the shortfall and blockers
- ``GET /debug/schedule/<pod>`` — the pod's last decision trace as a text
  span tree, its events, and the provenance summary
- ``GET /state/capacity`` (``?group=``, ``?zone=``, ``?ns=``),
  ``/state/capacity/history?limit=N`` and ``/state/capacity/diff?from=&to=``
  — the capacity observatory's cluster-state timeline (capacity/)
- ``GET /slo`` — the scorecard: per-objective multi-window burn-rate
  status + lifecycle summary (lifecycle/scorecard.py)
- ``GET /lifecycle`` / ``GET /lifecycle/<app>`` — the gang lifecycle
  ledger: per-application phase machine with queue-wait / solve-tenure
  durations and eviction causes (lifecycle/)
- ``GET /debug/contention`` (``?lock=``) — per-lock wait/hold
  percentiles, holder attribution, and top blockers
  (contention/locktime.py)
- ``GET /debug/criticalpath`` (``?limit=N``) — per-request latency
  decomposition: gate-queue / lock-wait / serde / solve / write-back
  (contention/criticalpath.py)
- ``GET /policy/state`` — policy-engine state: priority bands, tenant
  dominant shares, recent evictions with reasons (policy/engine.py);
  ``{"enabled": false}`` without an engine
- ``GET /status/ha`` — the HA fabric's state (ha/): identity, leader,
  epoch, fence counters, the lease and the last takeover's
  reconciliation report; ``{"enabled": false}`` with HA off.  With HA
  on, readiness answers 503 on a replica that does not hold the lease
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlsplit

from ..metrics import prometheus as prom
from ..resilience import AdmissionShed
from ..resilience import deadline as req_deadline
from ..tracing import spans as tracing
from ..types import serde
from ..types.extenderapi import ExtenderFilterResult
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


def convert_review(body: dict) -> dict:
    """Handle a ConversionReview: convert every object to the desired
    apiVersion (conversion webhook contract)."""
    request = body.get("request") or {}
    uid = request.get("uid", "")
    desired = request.get("desiredAPIVersion", "")
    converted = []
    try:
        for obj in request.get("objects") or []:
            converted.append(serde.convert_rr(obj, desired))
        result = {"status": "Success"}
    except Exception as err:  # conversion failures are reported, not raised
        logger.exception("conversion failed")
        converted = []
        result = {"status": "Failed", "message": str(err)}
    return {
        "apiVersion": body.get("apiVersion", "apiextensions.k8s.io/v1"),
        "kind": "ConversionReview",
        "response": {"uid": uid, "convertedObjects": converted, "result": result},
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "tpu-gang-scheduler"
    scheduler: Optional[Server] = None
    webhook_only: bool = False
    # per-connection socket timeout (applied by BaseHTTPRequestHandler.
    # setup): bounds slow reads AND the deferred TLS handshake so a
    # stalled peer only ties up its own worker thread, and only briefly.
    # The kube-scheduler extender client gives up after 30s
    # (examples/extender.yml httpTimeout), so 65s is a safe bound.
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

    def _send_text(self, code: int, text: str, content_type: str) -> None:
        self._send_bytes(code, text.encode(), content_type)

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
        path, query = self._split_path()
        if path == "/status/liveness":
            self._send_json(200, {"status": "up"})
        elif path == "/status/readiness":
            serving = self.webhook_only or (
                self.scheduler is not None
                and self.scheduler.informer_factory.wait_for_cache_sync()
                # kernel warmup still building (or failed): admitting
                # traffic now would put the nvcc build on the first
                # Filter requests, or serve a kernel that does not run
                and self.scheduler.warmup_complete()
                # HA standby: a replica that does not hold the lease
                # must not receive Filter traffic — its fenced write
                # paths would refuse every decision's write-back anyway
                and (self.scheduler.ha is None or self.scheduler.ha.is_leader())
            )
            if self.scheduler is None:  # webhook-only: no scheduler to report on
                self._send_json(200 if serving else 503, {"ready": serving})
                return
            # tri-state: unready answers 503 (don't route here yet);
            # degraded still answers 200 — a replica serving correct
            # decisions with reduced machinery must NOT be pulled from
            # rotation (that turns overload into an outage) — with the
            # component breakdown in the body for operators
            report = self.scheduler.resilience.health.report(serving=serving)
            report["ready"] = serving
            self._send_json(200 if serving else 503, report)
        elif path == "/metrics" and self.scheduler is not None:
            fmt = self._metrics_format(query)
            if fmt == "openmetrics":
                self._send_text(
                    200,
                    prom.render(self.scheduler.metrics, openmetrics=True),
                    prom.CONTENT_TYPE_OPENMETRICS,
                )
            elif fmt == "prometheus":
                self._send_text(200, prom.render(self.scheduler.metrics), prom.CONTENT_TYPE)
            else:
                self._send_json(200, self.scheduler.metrics.snapshot())
        elif path == "/traces" and self.scheduler is not None:
            limit = None
            try:
                limit = int(query.get("limit", [""])[0])
            except (ValueError, IndexError):
                pass
            self._send_json(200, {"traces": self.scheduler.tracer.traces(limit=limit)})
        elif path.startswith("/debug/schedule/") and self.scheduler is not None:
            self._handle_debug_schedule(unquote(path[len("/debug/schedule/"):]))
        elif path.startswith("/explain/") and self.scheduler is not None:
            self._handle_explain(unquote(path[len("/explain/"):]))
        elif path.startswith("/state/capacity") and self.scheduler is not None:
            self._handle_capacity(path, query)
        elif path == "/debug/contention" and self.scheduler is not None:
            self._handle_debug_contention(query)
        elif path == "/debug/criticalpath" and self.scheduler is not None:
            self._handle_debug_criticalpath(query)
        elif path == "/slo" and self.scheduler is not None:
            self._handle_slo()
        elif path == "/policy/state" and self.scheduler is not None:
            self._handle_policy_state()
        elif (path == "/lifecycle" or path.startswith("/lifecycle/")) and self.scheduler is not None:
            self._handle_lifecycle(unquote(path[len("/lifecycle"):]).lstrip("/"))
        elif path == "/status/ha" and self.scheduler is not None:
            fabric = self.scheduler.ha
            if fabric is None:
                self._send_json(200, {"enabled": False})
                return
            out = {"enabled": True}
            out.update(fabric.status())
            self._send_json(200, out)
        else:
            self._send_json(404, {"error": "not found"})

    def _handle_policy_state(self) -> None:
        """Policy-engine operator surface (policy/engine.py): configured
        bands with observation counts, per-tenant dominant shares, and
        the recent-evictions ring with reasons."""
        engine = self.scheduler.policy
        if engine is None:
            self._send_json(200, {"enabled": False})
            return
        self._send_json(200, engine.state())

    def _split_path(self):
        parts = urlsplit(self.path)
        return parts.path, parse_qs(parts.query)

    def _handle_debug_contention(self, query) -> None:
        """Lock wait/hold telemetry (contention/locktime.py): per-lock
        reservoir percentiles, holder-phase attribution, and the
        top-blocker table.  ``?lock=<name>`` filters to one lock site.
        Reading also drains pending samples into the metrics registry
        so a scrape right after stays fresh."""
        keeper = self.scheduler.contention
        if keeper is None:
            self._send_json(200, {"enabled": False, "locks": []})
            return
        name = query.get("lock", [None])[0] if query.get("lock") else None
        keeper.publish(self.scheduler.metrics)
        self._send_json(200, {"enabled": True, "locks": keeper.snapshot(name_filter=name)})

    def _handle_debug_criticalpath(self, query) -> None:
        """Per-request latency decomposition (contention/
        criticalpath.py): which segment — gate-queue, lock-wait, serde,
        solve, write-back — the milliseconds went to, summarized over
        the recent-request ring.  ``?limit=N`` appends the N newest
        per-request records."""
        analyzer = self.scheduler.criticalpath
        if analyzer is None:
            self._send_json(200, {"enabled": False, "requests": 0})
            return
        out = {"enabled": True}
        out.update(analyzer.summary())
        try:
            limit = int(query.get("limit", [""])[0])
        except (ValueError, IndexError):
            limit = 0
        if limit:
            out["recent"] = analyzer.recent(limit=limit)
        self._send_json(200, out)

    def _handle_slo(self) -> None:
        """The live scorecard: burn-rate status per objective plus the
        lifecycle summary, in the reference's scorecard schema
        (lifecycle/scorecard.py)."""
        slo = self.scheduler.slo
        ledger = self.scheduler.lifecycle
        if slo is None:
            self._send_json(404, {"error": "slo engine not enabled"})
            return
        if ledger is not None:
            # freshen: pull any pending cursor work before reporting
            # (same on-demand pattern as /state/capacity)
            ledger.maybe_drain(trigger="http")
        from ..lifecycle import build_scorecard

        self._send_json(200, build_scorecard(ledger, slo, meta={"source": "server"}))

    def _handle_lifecycle(self, app_id: str) -> None:
        """``/lifecycle`` — ledger summary + per-gang brief list;
        ``/lifecycle/<app>`` — one gang's full record (phase
        timestamps, queue wait, solve tenure, eviction cause, epochs,
        correlated trace ids)."""
        ledger = self.scheduler.lifecycle
        if ledger is None:
            self._send_json(404, {"error": "lifecycle ledger not enabled"})
            return
        ledger.maybe_drain(trigger="http")
        if not app_id:
            self._send_json(200, {"summary": ledger.summary(), "gangs": ledger.records_brief()})
            return
        record = ledger.record(app_id)
        if record is None:
            self._send_json(404, {"error": f"no lifecycle record for app {app_id!r}"})
            return
        self._send_json(200, record)

    def _handle_capacity(self, path: str, query) -> None:
        """Capacity observatory (capacity/observatory.py):

        - ``GET /state/capacity`` — the latest cluster-state sample
          (sampled on demand when the feed moved since the last one).
          ``?group=`` / ``?zone=`` filter the per-group entries,
          ``?ns=`` filters the queued-driver forecasts.
        - ``GET /state/capacity/history?limit=N`` — the timeline ring,
          newest first.
        - ``GET /state/capacity/diff?from=&to=`` — what changed between
          two timeline sequences (exact keys; history lists them)."""
        sampler = self.scheduler.capacity
        if sampler is None:
            self._send_json(404, {"error": "capacity observatory not enabled"})
            return

        def q1(key):
            vals = query.get(key)
            return vals[0] if vals else None

        if path == "/state/capacity":
            # serve fresh state without waiting for the background
            # debounce: O(1) when the feed hasn't moved
            sampler.maybe_sample(trigger="http")
            latest = sampler.latest()
            if latest is None:
                self._send_json(200, {"samples": 0, "capacity": None})
                return
            out = latest.to_dict()
            group, zone, ns = q1("group"), q1("zone"), q1("ns")
            if group is not None or zone is not None:
                out["groups"] = {
                    combo: entry
                    for combo, entry in out["groups"].items()
                    if (group is None or combo.split("|")[0] == group)
                    and (zone is None or combo.split("|", 1)[1] == zone)
                }
                if group is not None:
                    out["tenants"] = {g: t for g, t in out["tenants"].items() if g == group}
            if ns is not None:
                out["queue"] = [e for e in out["queue"] if e.get("namespace") == ns]
            self._send_json(200, out)
        elif path == "/state/capacity/history":
            limit = None
            try:
                limit = int(q1("limit") or "")
            except ValueError:
                pass
            history = sampler.history(limit=limit)
            self._send_json(
                200,
                {
                    "samples": [s.to_dict() for s in history],
                    "ring": sampler.stats()["ring"],
                    "ringCapacity": sampler.stats()["ring_capacity"],
                },
            )
        elif path == "/state/capacity/diff":
            try:
                from_seq = int(q1("from") or "")
                to_seq = int(q1("to") or "")
            except ValueError:
                self._send_json(400, {"error": "usage: /state/capacity/diff?from=<seq>&to=<seq>"})
                return
            diff = sampler.diff(from_seq, to_seq)
            if diff is None:
                self._send_json(
                    404,
                    {
                        "error": "sequence not in the timeline ring",
                        "available": [s.seq for s in sampler.history()],
                    },
                )
                return
            self._send_json(200, diff)
        else:
            self._send_json(404, {"error": "not found"})

    def _handle_explain(self, pod_name: str) -> None:
        """Why was this pod's last scheduling decision what it was:
        the provenance record — snapshot keys, queue slice, verdicts,
        and for refusals the tightest-dimension shortfall + blocker set
        (provenance/tracker.py).  Accepts a bare pod name (newest match
        across namespaces) or ``<namespace>/<pod>`` to disambiguate."""
        tracker = self.scheduler.provenance
        if tracker is None:
            self._send_json(404, {"error": "provenance not enabled"})
            return
        if not pod_name:
            self._send_json(400, {"error": "usage: /explain/<pod-name>"})
            return
        record = tracker.explain(pod_name)
        if record is None:
            self._send_json(
                404,
                {
                    "error": f"no recorded decision for pod {pod_name!r}",
                    "ringSize": tracker.stats()["ring"]["size"],
                },
            )
            return
        self._send_json(200, record)

    def _handle_debug_schedule(self, pod_name: str) -> None:
        """Explain the last scheduling decision for a pod: the newest
        trace tagged pod=<name> rendered as a text span tree, with the
        event-ring records of the same trace appended, and the decision-
        provenance record (shortfall + blockers) when one exists."""
        tracer = self.scheduler.tracer
        if not tracer.enabled or not pod_name:
            self._send_json(404, {"error": "tracing not enabled"})
            return
        trace = tracer.find_by_tag("pod", pod_name)
        if trace is None:
            self._send_text(
                404,
                f"no recorded scheduling decision for pod {pod_name!r} "
                f"(ring holds {len(tracer)} traces)\n",
                "text/plain; charset=utf-8",
            )
            return
        events = [
            (e.name, e.values)
            for e in self.scheduler.event_log.by_trace_id(trace["traceId"])
        ]
        text = tracing.render_trace_text(trace, events)
        tracker = self.scheduler.provenance
        if tracker is not None:
            record = tracker.explain(pod_name, source="debug")
            if record is not None:
                text += "\nprovenance:\n"
                summary = record.get("summary")
                if summary:
                    text += f"  why: {summary}\n"
                for key in (
                    "outcome", "lane", "policy", "feedSeq", "queueLength",
                    "bundleSeq",
                ):
                    if record.get(key) is not None:
                        text += f"  {key}: {record[key]}\n"
        self._send_text(200, text, "text/plain; charset=utf-8")

    def _metrics_format(self, query) -> str:
        """"openmetrics" (exemplar-carrying text), "prometheus" (plain
        0.0.4 text), or "json" (the default snapshot).

        The exemplar flavour is EXPLICIT opt-in (?format=openmetrics),
        never Accept-negotiated: it is pragmatic rather than strictly
        OpenMetrics-valid (exemplars ride on summary ``_count`` lines;
        counter samples keep their plain-text names), so routing it to
        a client whose Accept demands strict OpenMetrics would fail its
        whole scrape.  Any Accept mentioning openmetrics or text/plain
        gets the plain 0.0.4 text every Prometheus parses."""
        fmt = query.get("format", [""])[0] if query.get("format") else ""
        if fmt:
            if fmt == "openmetrics":
                return "openmetrics"
            return "prometheus" if fmt in ("prometheus", "text") else "json"
        accept = self.headers.get("Accept") or ""
        if "text/plain" in accept or "openmetrics" in accept:
            return "prometheus"
        return "json"

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
        if self.path not in ("/predicates", "/convert") or (
            self.webhook_only and self.path != "/convert"
        ):
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
        if self.path == "/convert":
            self._send_json(200, convert_review(body))
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
            result = self._predicate_guarded(args)
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

    def _predicate_guarded(self, args):
        """Run the Filter under overload protection: a request deadline
        derived from kube-scheduler's httpTimeout (checked at phase
        boundaries inside the extender) and the bounded admission gate.
        Shed requests answer immediately with a retriable all-nodes
        failure — an extender protocol failure would abort the whole
        scheduling cycle, a failed-nodes response just requeues the pod."""
        # the concurrent admission engine (concurrent/engine.py) is a
        # drop-in for extender.predicate: speculative solve on THIS
        # request thread, then a FIFO-ordered commit through the serial
        # extender — decisions stay byte-identical to serial operation
        engine = self.scheduler.concurrent
        predicate = engine.predicate if engine is not None else self.scheduler.extender.predicate
        kit = self.scheduler.resilience
        try:
            t_gate = time.perf_counter()
            with kit.gate.admit():
                span = tracing.current_span()
                if span is not None:
                    span.tags["gateWaitMs"] = round(
                        (time.perf_counter() - t_gate) * 1000.0, 4
                    )
                with req_deadline.bind(kit.request_timeout):
                    return predicate(args)
        except AdmissionShed:
            span = tracing.current_span()
            if span is not None:
                # the extender never ran, so nothing else stamps the
                # pod identity — without these tags the shed trace is
                # unfindable via /debug/schedule/<pod>
                span.tag("pod", args.pod.name)
                span.tag("namespace", args.pod.namespace)
                span.tag("outcome", "shed")
            # a shed is a real terminal verdict for this Filter attempt:
            # it leaves a provenance DecisionRecord (`/explain` answers
            # "why did my app not start?" for sheds too) and a lifecycle
            # `shed` phase mark
            tracker = self.scheduler.provenance
            if tracker is not None:
                tracker.record_shed(args.pod)
            ledger = self.scheduler.lifecycle
            if ledger is not None:
                ledger.mark_shed(args.pod)
            message = "scheduler overloaded; retry"
            return ExtenderFilterResult(
                failed_nodes={n: message for n in args.node_names},
                uniform_failure=(args.node_names, message),
            )


class ExtenderHTTPServer:
    """The serving process: extender endpoints on the main port, or only
    the conversion webhook (``webhook_only``, no scheduler)."""

    def __init__(
        self,
        scheduler: Optional[Server],
        port: int = 0,
        webhook_only: bool = False,
        host: str = "",
        tls_cert_file: Optional[str] = None,
        tls_key_file: Optional[str] = None,
    ):
        # host="" binds all interfaces: kube-scheduler and the apiserver
        # webhook dial the pod IP, not loopback
        handler = type(
            "BoundHandler",
            (_Handler,),
            {"scheduler": scheduler, "webhook_only": webhook_only},
        )
        self._httpd = _ExtenderHTTPD((host, port), handler)
        if tls_cert_file:
            # the apiserver only calls conversion webhooks over HTTPS
            # with a CA it trusts (ref conversionwebhook/resource_
            # reservation.go:44-98); kube-scheduler extenders support
            # enableHTTPS + tlsConfig the same way
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert_file, tls_key_file)
            # do_handshake_on_connect=False: the handshake must NOT run
            # inside accept() in the single serve_forever thread — a peer
            # that connects and never sends a ClientHello would wedge the
            # whole server.  Deferred, the handshake happens on first read
            # inside the per-connection worker thread, bounded by the
            # handler's socket timeout.
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True, do_handshake_on_connect=False
            )
        self.tls = bool(tls_cert_file)
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
