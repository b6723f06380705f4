"""ProvenanceTracker: the per-extender decision-provenance facade.

Owns the record ring, the flight recorder, and the per-request capture
slot the solver lanes fill.  The extender drives the lifecycle under its
predicate lock:

    begin_decision(pod, …)     # request context: queue slice, snapshot keys
    <solver lane calls capture(SolveArtifacts)>
    refusal_detail(kind)       # on failure: explain → message suffix
    finish_decision(outcome)   # record + bundle ring + metrics

HTTP threads only READ (``explain``/``recent``/``stats``) through the
ring's own lock.  With ``enabled=False`` the extender never calls any
of this and the solver capture sinks stay ``None`` — zero cost.
"""

from __future__ import annotations

import logging
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import racecheck
from ..analysis.guarded import guarded_by
from .. import timesource
from ..metrics import names as mnames
from ..tracing import spans as tracing
from .explain import DIM_NAMES, ShortfallInfo, explain_refusal, shortfall_message
from .records import DecisionRecord, ProvenanceRing
from .recorder import FlightRecorder

logger = logging.getLogger(__name__)

# queue names kept on a record (full queues run to 1k+ apps; the record
# ring must stay small)
_QUEUE_SLICE = 8


@dataclass
class SolveArtifacts:
    """One queue solve, captured by reference (no copies): the arrays a
    replay or explain needs.  The solver's whole-queue lane
    (``TpuFifoSolver.solve_tensor``) and the delta-solve session
    (``DeltaSolveEngine``, whose verdicts cover the whole queue whatever
    position it resumed from) capture; Quantity-path decisions record
    without artifacts.  The driver indices and the availability
    after the queue stay the launch's device tensors (no later launch
    writes them); they reach the host only when a bundle is persisted."""

    policy_code: int
    lane: str
    basis: np.ndarray         # [Nb, 3] int32 availability at position 0
    driver_rank: np.ndarray   # [Nb] int32
    exec_ok: np.ndarray       # [Nb] bool
    packed: np.ndarray        # [na, 8] int32 (earlier apps + current last)
    n_earlier: int
    feasible: np.ndarray      # [>= n_earlier] bool verdicts (host)
    didx: Optional[object] = None  # [>= n_earlier] int32 tensor or array
    resume: int = 0
    avail_after: Optional[object] = None  # [Nb, 3] int32 tensor or array
    scale: Optional[np.ndarray] = None   # [3] int64 tensorize scale
    node_names: Sequence[str] = ()
    zone_names: Sequence[str] = ()
    zone_id: Optional[np.ndarray] = None
    skip_allowed: Sequence[bool] = ()
    content_key: Optional[Tuple] = None
    feed_seq: Optional[int] = None
    queue_names: Tuple[str, ...] = ()
    # where the explainer replays the queue: the solver's device
    device: Optional[torch.device] = None

    def memo_sig(self) -> int:
        """Signature of the inputs the refusal explain depends on BEYOND
        the snapshot content key: the candidate-node subset and the
        skip_allowed vector.  kube-scheduler node sampling rotates
        NodeNames between attempts without any state delta, and the
        subset lands in the exec_ok / driver_rank masks (node_names
        spans EVERY affinity-matching node, the same for any subset —
        see _pack_current's domain note), so those mask bytes are what
        the signature must cover; fifo age gating flips skip_allowed
        purely with time.  Hash, not tuple — the memo key must not pin
        per-request arrays."""
        sig = getattr(self, "_memo_sig", None)
        if sig is None:
            sig = hash((
                tuple(self.node_names),
                np.asarray(self.exec_ok, dtype=np.uint8).tobytes(),
                np.asarray(self.driver_rank, dtype=np.int32).tobytes(),
                tuple(bool(s) for s in self.skip_allowed),
            ))
            self._memo_sig = sig
        return sig

    def zone_of(self, node_index: int) -> str:
        if self.zone_id is None or not (0 <= node_index < len(self.zone_id)):
            return ""
        z = int(self.zone_id[node_index])
        if 0 <= z < len(self.zone_names):
            return self.zone_names[z]
        return ""

    def first_blocked_earlier(self) -> Optional[int]:
        """First enforced earlier driver whose verdict is infeasible —
        the FAILURE_EARLIER_DRIVER refusal's explain target."""
        feas = np.asarray(self.feasible, dtype=bool)[: self.n_earlier]
        skip = np.asarray(
            list(self.skip_allowed)[: self.n_earlier]
            if len(self.skip_allowed)
            else np.zeros(self.n_earlier, dtype=bool)
        ).astype(bool)
        blocked = np.flatnonzero(~feas & ~skip)
        if len(blocked):
            return int(blocked[0])
        return None


@guarded_by("_pending_lock", "_pending", "_explain_cache", "_last_trigger")
class ProvenanceTracker:
    """See module docstring.  Thread model: lifecycle methods run under
    the extender's predicate lock (one decision at a time); the pending
    slot still takes its own lock because triggers (breaker open) can
    fire from write-back threads concurrently."""

    def __init__(
        self,
        enabled: bool = True,
        ring_size: int = 128,
        recorder_size: int = 8,
        bundle_dir: Optional[str] = None,
        max_bundle_nodes: int = 4096,
        metrics=None,
        trigger_min_interval: float = 30.0,
    ):
        self.enabled = enabled
        self._metrics = metrics
        self.ring = ProvenanceRing(capacity=ring_size)
        if bundle_dir is None:
            bundle_dir = os.environ.get("SCHED_PROVENANCE_DIR") or None
        self.recorder = FlightRecorder(
            capacity=recorder_size,
            out_dir=bundle_dir,
            max_nodes=max_bundle_nodes,
            metrics=metrics,
        )
        self._pending_lock = threading.Lock()
        self._pending: Optional[dict] = None
        # refusal-explain memo: kube-scheduler requeues a Pending pod
        # against UNCHANGED cluster state far more often than the state
        # changes, and each explain replays the whole queue.  The key is
        # exact: any node/pod/reservation mutation bumps the change feed
        # and with it the snapshot content_key, so a hit can only serve
        # a byte-identical decision's explanation.
        self._explain_cache: "OrderedDict" = OrderedDict()
        # per-trigger persist debounce: a deadline storm during overload
        # must not serialize+write near-identical bundle files per failed
        # request while the predicate lock is held — one persist per
        # trigger type per interval captures the same forensic state
        self.trigger_min_interval = float(trigger_min_interval)
        self._last_trigger: dict = {}
        self.triggers_suppressed = 0
        self.parity_mismatches = 0

    # -- lifecycle (extender, under the predicate lock) ----------------------

    def begin_decision(
        self,
        pod,
        role: str = "",
        queue_names: Sequence[str] = (),
        content_key: Optional[Tuple] = None,
        feed_seq: Optional[int] = None,
    ) -> None:
        with self._pending_lock:
            racecheck.note_access(self, "_pending")
            self._pending = {
                "pod": pod.name,
                "namespace": pod.namespace,
                "role": role,
                "queue_names": tuple(queue_names),
                "content_key": content_key,
                "feed_seq": feed_seq,
                "artifacts": None,
                "shortfall": None,
                "message": "",
            }

    def note_context(
        self,
        queue_names: Optional[Sequence[str]] = None,
        content_key: Optional[Tuple] = None,
        feed_seq: Optional[int] = None,
    ) -> None:
        """Attach request context discovered after begin_decision (the
        earlier-driver queue slice, the snapshot keys)."""
        with self._pending_lock:
            racecheck.note_access(self, "_pending")
            p = self._pending
            if p is None:
                return
            if queue_names is not None:
                p["queue_names"] = tuple(queue_names)
            if content_key is not None:
                p["content_key"] = content_key
            if feed_seq is not None:
                p["feed_seq"] = feed_seq

    def pending_shortfall(self):
        """The memoized ShortfallInfo of the decision in flight (None
        until a refusal has been explained) — the policy engine reads
        its ``blockers`` list as the victim-candidate seed."""
        with self._pending_lock:
            racecheck.note_access(self, "_pending")
            p = self._pending
            return p.get("shortfall") if p else None

    def capture(self, artifacts: SolveArtifacts) -> None:
        """The solver lanes' capture sink (engine + solve_tensor)."""
        with self._pending_lock:
            racecheck.note_access(self, "_pending")
            p = self._pending
            if p is None:
                return
            if not artifacts.queue_names:
                artifacts.queue_names = p["queue_names"]
            if artifacts.content_key is None:
                artifacts.content_key = p["content_key"]
            if artifacts.feed_seq is None:
                artifacts.feed_seq = p["feed_seq"]
            p["artifacts"] = artifacts

    EXPLAIN_CACHE_SIZE = 64

    def refusal_detail(self, kind: str) -> str:
        """Explain the pending refusal; returns the message suffix for
        the FailedNodes map ("" when no detail is available).  kind:
        "earlier-driver" | "fit".

        Cost control: an explain replays the queue (one queue-kernel
        launch over twice the queue's length) on the request path, so
        results are memoized by (pod, kind,
        snapshot content_key) — a requeue storm of Pending pods against
        unchanged cluster state explains each refusal ONCE per state
        change, not once per retry."""
        with self._pending_lock:
            p = self._pending
            art = p["artifacts"] if p else None
        if art is None:
            return ""
        cache_key = None
        if art.content_key is not None and p is not None:
            # namespace included: same-named drivers in different
            # namespaces are different gangs with different demands
            cache_key = (
                p["namespace"], p["pod"], kind, art.content_key,
                art.memo_sig(),
            )
            with self._pending_lock:
                racecheck.note_access(self, "_explain_cache")
                hit = self._explain_cache.get(cache_key)
                if hit is not None:
                    self._explain_cache.move_to_end(cache_key)
            if hit is not None:
                info, msg = hit
                self._count_explain("refusal-cached")
                if info is not None:
                    with self._pending_lock:
                        racecheck.note_access(self, "_pending")
                        if self._pending is p:
                            p["shortfall"] = info
                    self._publish_shortfall(info)
                return msg
        if kind == "earlier-driver":
            target = art.first_blocked_earlier()
        else:
            target = art.n_earlier if art.packed.shape[0] > art.n_earlier else None
        if target is None:
            return ""
        try:
            info = explain_refusal(art, target)
        except Exception:
            logger.exception("provenance explain failed (diagnostic only)")
            info = None
        self._count_explain("refusal")
        msg = shortfall_message(info) if info is not None else ""
        if cache_key is not None:
            with self._pending_lock:
                racecheck.note_access(self, "_explain_cache")
                self._explain_cache[cache_key] = (info, msg)
                while len(self._explain_cache) > self.EXPLAIN_CACHE_SIZE:
                    self._explain_cache.popitem(last=False)
        if info is None:
            return ""
        with self._pending_lock:
            racecheck.note_access(self, "_pending")
            if self._pending is p and p is not None:
                p["shortfall"] = info
        self._publish_shortfall(info)
        return msg

    def finish_decision(
        self,
        outcome: str,
        node: str = "",
        lane: str = "",
        policy: str = "",
        instance_group: str = "",
        message: str = "",
    ) -> None:
        with self._pending_lock:
            racecheck.note_access(self, "_pending")
            p = self._pending
            self._pending = None
        if p is None:
            return
        art: Optional[SolveArtifacts] = p["artifacts"]
        bundle_seq = None
        earlier_infeasible: Tuple[int, ...] = ()
        if art is not None:
            if art.didx is not None:
                bundle_seq = self.recorder.note(art, p["pod"], outcome)
            feas = np.asarray(art.feasible, dtype=bool)[: art.n_earlier]
            earlier_infeasible = tuple(
                int(i) for i in np.flatnonzero(~feas)[:_QUEUE_SLICE]
            )
        rec = DecisionRecord(
            pod=p["pod"],
            namespace=p["namespace"],
            role=p["role"],
            instance_group=instance_group,
            trace_id=tracing.current_trace_id(),
            t=timesource.now(),
            outcome=outcome,
            node=node,
            lane=(art.lane if art is not None else lane),
            policy=policy,
            content_key=(art.content_key if art is not None else p["content_key"]),
            feed_seq=(art.feed_seq if art is not None else p["feed_seq"]),
            queue_len=len(p["queue_names"]),
            queue_slice=tuple(p["queue_names"][:_QUEUE_SLICE]),
            earlier_infeasible=earlier_infeasible,
            shortfall=p["shortfall"],
            message=message,
            bundle_seq=bundle_seq,
        )
        self.ring.record(rec)
        if self._metrics is not None:
            self._metrics.gauge(
                mnames.PROVENANCE_RECORDS, float(len(self.ring))
            )
            if p["shortfall"] is not None:
                self._metrics.histogram(
                    mnames.PROVENANCE_BLOCKERS,
                    float(p["shortfall"].blocker_count),
                )
            elif outcome == "success" and p["role"] == "driver":
                # a gang just ADMITTED: clear the shortfall gauges so a
                # resolved deficit doesn't read as permanent.  Any gang
                # still short re-asserts its shortfall on its next
                # requeue (kube-scheduler retries Pending pods
                # continuously), so the gauge converges to the truth
                # within one retry interval either way.
                for name in DIM_NAMES:
                    self._metrics.gauge(
                        mnames.PROVENANCE_SHORTFALL, 0.0, {"dim": name}
                    )

    def record_shed(self, pod) -> None:
        """An AdmissionGate shed answered this request before the
        extender ran — no begin_decision, no pending slot, no solve.
        Record the verdict directly so ``/explain`` and
        ``/debug/schedule`` can answer "why did my app not start?" for
        shed requests too (outcome ``shed``; retriable by design)."""
        if not self.enabled:
            return
        from ..scheduler import labels as L

        rec = DecisionRecord(
            pod=pod.name,
            namespace=pod.namespace,
            role=pod.labels.get(L.SPARK_ROLE_LABEL, ""),
            trace_id=tracing.current_trace_id(),
            t=timesource.now(),
            outcome="shed",
            message="admission gate shed: scheduler overloaded; retry",
        )
        self.ring.record(rec)
        if self._metrics is not None:
            self._metrics.gauge(
                mnames.PROVENANCE_RECORDS, float(len(self.ring))
            )

    # -- triggers (any thread) -----------------------------------------------

    def on_trigger(self, trigger: str, detail: str = "") -> Optional[str]:
        """A flight-recorder trigger fired: persist the bundle ring.

        Debounced per trigger type (``trigger_min_interval``): during
        the very overload that causes deadline triggers, repeated
        persists of near-identical ring state would amplify lock hold
        time and disk churn — one file per interval records the same
        forensic evidence."""
        now = timesource.now()
        with self._pending_lock:
            racecheck.note_access(self, "_last_trigger")
            last = self._last_trigger.get(trigger)
            if last is not None and now - last < self.trigger_min_interval:
                self.triggers_suppressed += 1
                return None
        try:
            path = self.recorder.persist(trigger, detail)
        except Exception:
            logger.exception("flight-recorder persist failed (trigger %s)", trigger)
            return None
        if path is not None:
            # stamp the debounce only for a persist that actually wrote:
            # an unproductive trigger (empty ring at startup, no
            # bundle_dir) must not suppress the next real one.  Two
            # concurrent same-type triggers may both persist in the
            # window — an extra file beats a missing forensic bundle.
            with self._pending_lock:
                racecheck.note_access(self, "_last_trigger")
                self._last_trigger[trigger] = now
            logger.warning(
                "flight recorder persisted %s (trigger %s: %s)",
                path, trigger, detail,
            )
        return path

    def on_parity_mismatch(self, detail: dict) -> None:
        """The delta-solve engine's warm≠cold parity guard detected
        divergence (ops/deltasolve.py) — the one anomaly this subsystem
        exists to catch in the wild.
        ``detail`` may carry the diverging solve's artifacts (with the
        WARM verdicts recorded): noted into the recorder BEFORE
        persisting, so the bundle file contains the anomaly itself —
        replaying it cold then reproduces the divergence by
        construction, not just the decisions that preceded it."""
        self.parity_mismatches += 1
        if self._metrics is not None:
            self._metrics.counter(
                mnames.PROVENANCE_PARITY_CHECKS, {"result": "mismatch"}
            )
        artifacts = detail.pop("artifacts", None)
        if artifacts is not None:
            try:
                self.recorder.note(
                    artifacts, "parity-check", "warm-cold-parity-mismatch"
                )
            except Exception:
                logger.exception("parity artifacts could not be noted")
        self.on_trigger("warm-cold-parity", str(detail))

    def on_parity_ok(self) -> None:
        if self._metrics is not None:
            self._metrics.counter(
                mnames.PROVENANCE_PARITY_CHECKS, {"result": "ok"}
            )

    # -- read side (HTTP threads) --------------------------------------------

    def explain(self, pod_name: str, source: str = "http") -> Optional[dict]:
        self._count_explain(source)
        rec = self.ring.latest_for_pod(pod_name)
        if rec is None:
            return None
        out = rec.to_dict()
        if rec.shortfall is not None:
            out["summary"] = shortfall_message(rec.shortfall)
        return out

    def stats(self) -> dict:
        return {
            "enabled": self.enabled,
            "ring": self.ring.stats(),
            "recorder": self.recorder.stats(),
            "parity_mismatches": self.parity_mismatches,
        }

    # -- internals -----------------------------------------------------------

    def _count_explain(self, source: str) -> None:
        if self._metrics is not None:
            self._metrics.counter(
                mnames.PROVENANCE_EXPLAIN_COUNT, {"source": source}
            )

    def _publish_shortfall(self, info: ShortfallInfo) -> None:
        if self._metrics is None:
            return
        # per-dimension cluster shortfall: executors short when that
        # dimension alone were the constraint (0 for non-binding dims)
        for j, name in enumerate(DIM_NAMES):
            short = max(0, info.gang_size - int(info.dim_totals[j]))
            self._metrics.gauge(
                mnames.PROVENANCE_SHORTFALL, float(short), {"dim": name}
            )
