"""Speculative driver solves against seq-stamped snapshot bases (the
reference package's ``concurrent/speculation.py``).

A speculation is the read-only front half of the extender's tensor fast
path, executed *outside* the predicate lock on the request's own thread:
take a :class:`~..state.tensor_snapshot.TensorSnapshot` (seq-stamped,
copy-on-read, safe without the lock), assemble the earlier-drivers
queue and skip verdicts exactly as the serial path would, and run the
stateless cold tensor solve on a per-thread solver clone.  The product
is a :class:`SpeculativeVerdict`: the would-be decision plus everything
needed to prove, at commit time, that the basis did not move.

On a CUDA device the cold solve is one plain launch of the queue kernel
(``fifo_queue`` or ``fifo_queue_min_frag``) on the speculating thread's
own CUDA stream, so several speculations' kernels can be in flight at
once and none queues behind the delta session's launches on the commit
thread's stream.  The verdict leaves its thread only after that stream
is synchronised; the device tensors its solve artifacts carry are
handed to the commit thread's stream with an event wait and
``record_stream`` (:meth:`SpeculativeVerdict.hand_over`).

Revalidation (inside the predicate lock, via the extender's
``speculation_intake`` hook) is three steps, cheapest first:

1. **seq check** — ``content_key`` equality is O(1) and proves the
   mirror absorbed no mutation since the speculation;
2. **memcmp rescue** — same ``structure_key`` (node table unchanged)
   plus byte-equal avail/schedulable/res-entry arrays proves the
   content is identical even though the feed sequence moved (benign
   churn: pod events that cancel out row-wise);
3. anything else is a **conflict**: the verdict is discarded and the
   serial path's warm delta-solve runs under the lock (the bounded
   re-solve).

Either way the queue identity must also match: the earlier-apps list is
compared by object identity (``spark_app_demand_cached`` returns a
stable object per pod version, the same trick the solver's tensorize
cache uses) and the skip verdicts byte-for-byte — a queue re-order,
a new earlier driver, or a skip flip is a conflict, never a stale hit.

Footprint overlap: a speculation that would race an earlier in-flight
driver whose speculative verdict is success-shaped (its commit WILL
move the basis) is skipped up front — the optimistic bet is only taken
when it can pay.  Wasted speculation is never a correctness problem
(commit revalidates); overlap detection is purely a throughput lever.

Deadline-aware cancellation: the request deadline is checked before and
after the speculative solve; expiry abandons the in-flight speculative
work and counts ``tpu.concurrent.speculation.cancelled`` — overload
sheds speculative work instead of queueing it.

A speculation declines (no verdict, the commit runs serially) only for
the reference's reasons, each counted under its ``outcome``.  An error
of the solve itself — a kernel's build or launch, CUDA — propagates out
of the request as it would from a serial Filter: it is never turned
into a quiet serial commit."""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis.guarded import guarded_by
from ..metrics import names as mnames
from ..metrics.registry import MetricsRegistry, default_registry
from ..resilience import deadline as req_deadline
from ..scheduler import labels as L
from ..scheduler.sparkpods import (
    AnnotationError,
    spark_app_demand_cached,
    spark_resources,
)


class SpeculativeVerdict:
    """One speculative decision + its revalidation evidence."""

    __slots__ = (
        "pod_key",
        "node_names",
        "snap",
        "earlier_ids",
        "skip_allowed",
        "outcome",
        "zones",
        "artifacts",
        "will_commit",
        "ready",
        "device",
    )

    def __init__(
        self,
        pod_key,
        node_names,
        snap,
        earlier_ids,
        skip_allowed,
        outcome,
        zones,
        artifacts=None,
        ready=None,
        device=None,
    ):
        self.pod_key = pod_key
        self.node_names = node_names
        self.snap = snap
        self.earlier_ids = earlier_ids
        self.skip_allowed = skip_allowed
        self.outcome = outcome
        self.zones = zones
        # the solve artifacts the serial solver would have pushed into
        # provenance (shortfall explain, blocker set): replayed at
        # consume time so a consumed verdict's refusal message carries
        # the same enrichment a serial solve produces
        self.artifacts = artifacts
        # success-shaped: this commit will mutate the shared basis
        # (reservation write-back) — used by footprint-overlap skips
        self.will_commit = bool(
            outcome.earlier_ok
            and outcome.result is not None
            and outcome.result.has_capacity
        )
        # the CUDA event recorded on the speculation's stream after its
        # solve, and the solver's device (None on the CPU)
        self.ready = ready
        self.device = device

    def consume(
        self, driver, snap, node_names, earlier_apps, skip_allowed
    ) -> Tuple[Optional[Tuple[Any, Dict[str, str]]], str]:
        """Commit-time revalidation against the then-current basis.
        Returns ``((outcome, zones), reason)`` on a hit or
        ``(None, reason)`` on a conflict."""
        if (driver.namespace, driver.name) != self.pod_key:
            return None, "pod-mismatch"
        if tuple(node_names) != self.node_names:
            return None, "candidate-drift"
        if tuple(map(id, earlier_apps)) != self.earlier_ids:
            return None, "queue-drift"
        if tuple(skip_allowed) != self.skip_allowed:
            return None, "skip-drift"
        if snap.content_key == self.snap.content_key:
            return (self.outcome, self.zones), "seq-hit"
        if (
            snap.exact
            and self.snap.exact
            and snap.structure_key == self.snap.structure_key
            and np.array_equal(snap.avail, self.snap.avail)
            and np.array_equal(snap.schedulable, self.snap.schedulable)
            and np.array_equal(snap.res_entries, self.snap.res_entries)
        ):
            return (self.outcome, self.zones), "memcmp-hit"
        return None, "conflict"

    def hand_over(self) -> None:
        """Make the artifacts' device tensors safe on the calling
        thread's current stream: wait for the speculation's stream up to
        its solve, and tell the caching allocator the tensors are used
        there too (their blocks were allocated on the speculation's
        stream, and are not reused before this stream's work on them is
        done).  Nothing to do on the CPU."""
        if self.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.ready)
        art = self.artifacts
        if art is None:
            return
        for t in (art.didx, art.avail_after):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)


class _Flight:
    __slots__ = ("ticket", "instance_group", "will_commit")

    def __init__(self, ticket: int, instance_group: str):
        self.ticket = ticket
        self.instance_group = instance_group
        # None = still solving (unknown); True = success-shaped verdict
        # pending commit; False = refusal-shaped (basis-neutral)
        self.will_commit: Optional[bool] = None


@guarded_by("_lock", "_inflight")
class Speculator:
    """Runs speculative solves and tracks in-flight footprints."""

    def __init__(
        self,
        extender,
        metrics: MetricsRegistry | None = None,
        max_inflight: int = 8,
    ):
        self._extender = extender
        self._metrics = metrics or default_registry
        self._max_inflight = max_inflight
        self._lock = threading.Lock()
        self._inflight: Dict[int, _Flight] = {}
        # per-thread solver clone and CUDA stream: the shared queue
        # solver keeps per-call state (last_queue_lane, the
        # earlier-tensor cache), so parallel speculative solves each get
        # their own instance — same class, same policy knobs, same
        # device, therefore the same decisions
        self._local = threading.local()

    # -- bookkeeping ------------------------------------------------------

    def _decline(self, reason: str) -> None:
        self._metrics.counter(
            mnames.CONCURRENT_SPECULATION_COUNT, {"outcome": reason}
        )
        return None

    def finish(self, ticket: int) -> None:
        with self._lock:
            self._inflight.pop(ticket, None)

    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def _solver_clone(self):
        solver = getattr(self._extender.binpacker, "queue_solver", None)
        if solver is None or not hasattr(solver, "solve_tensor"):
            return None
        clone = getattr(self._local, "clone", None)
        if clone is not None and type(clone) is type(solver):
            return clone
        clone = type(solver)(
            assignment_policy=solver.assignment_policy,
            backend=solver.backend,
            strict_reference_parity=solver.strict_reference_parity,
            device=solver.device,
        )
        self._local.clone = clone
        return clone

    def _stream(self, device: torch.device):
        """This thread's CUDA stream on ``device`` (None on the CPU)."""
        if device.type != "cuda":
            return None
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = torch.cuda.Stream(device=device)
            self._local.stream = stream
        return stream

    # -- the speculation --------------------------------------------------

    def speculate(self, ticket: int, args) -> Optional[SpeculativeVerdict]:
        """Speculative fast-path solve for a driver Filter request;
        ``None`` means "no verdict — commit serially" (executor
        requests, replays, unsupported shapes, overlap skips,
        cancellations).  An error of the solve propagates."""
        ext = self._extender
        pod = args.pod
        if pod.labels.get(L.SPARK_ROLE_LABEL, "") != L.DRIVER:
            return self._decline("not-driver")
        if not getattr(ext, "_fast_path_ok", False) or ext._tensor_snapshot is None:
            return self._decline("no-fast-path")
        if ext._policy is not None:
            # the policy engine's queue hooks keep their own state; keep
            # speculation off that path — commits stay serial and exact
            return self._decline("policy-engine")
        solver = self._solver_clone()
        if solver is None:
            return self._decline("no-tensor-solver")

        instance_group, ok = L.find_instance_group_from_pod_spec(
            pod, ext._instance_group_label
        )
        if not ok:
            instance_group = ""

        # footprint overlap: an earlier in-flight driver with a
        # success-shaped verdict will move the basis when it commits —
        # our speculation would conflict anyway, so skip the solve
        with self._lock:
            if len(self._inflight) >= self._max_inflight:
                return self._decline("inflight-cap")
            for flight in self._inflight.values():
                if (
                    flight.ticket < ticket
                    and flight.instance_group == instance_group
                    and flight.will_commit
                ):
                    return self._decline("overlap")
            flight = _Flight(ticket, instance_group)
            self._inflight[ticket] = flight

        try:
            req_deadline.check("speculation-start")
        except req_deadline.DeadlineExceeded:
            self._metrics.counter(
                mnames.CONCURRENT_SPECULATION_CANCELLED,
                {"phase": "speculation-start"},
            )
            return None

        app_id = pod.labels.get(L.SPARK_APP_ID_LABEL, "")
        if ext._rrm.get_resource_reservation(app_id, pod.namespace) is not None:
            # idempotent replay: the serial path answers O(1) from the
            # reservation — nothing to speculate
            return self._decline("replay")

        from ..ops.fast_path import build_cluster_tensor
        from ..ops.sparkapp import AppDemand

        try:
            app_resources = spark_resources(pod)
        except AnnotationError:
            return self._decline("annotations")

        snap = ext._tensor_snapshot.snapshot()
        if not snap.exact:
            return self._decline("inexact")
        earlier_apps: List[Any] = []
        skip_allowed: List[bool] = []
        if ext._is_fifo:
            skip_cutoff = ext._fifo_skip_cutoff(instance_group)
            for queued in ext._earlier_drivers(pod):
                try:
                    _, demand = spark_app_demand_cached(queued)
                except AnnotationError:
                    continue
                earlier_apps.append(demand)
                skip_allowed.append(ext._skip_verdict(queued, pod, skip_cutoff))
        current = AppDemand(
            app_resources.driver_resources,
            app_resources.executor_resources,
            app_resources.min_executor_count,
        )
        built = build_cluster_tensor(
            snap,
            pod,
            args.node_names,
            driver_label_priority=ext._node_sorter.driver_label_priority,
            executor_label_priority=ext._node_sorter.executor_label_priority,
        )
        if built is None:
            return self._decline("affinity-shape")
        cluster, zones = built

        # collect the clone's solve artifacts locally (the shared solver
        # pushes them straight into provenance; a speculation must not
        # touch shared provenance state off-turn) — they replay into the
        # tracker at consume time
        captured: List[Any] = []
        prov = ext._provenance
        solver.capture_sink = captured.append if prov is not None and prov.enabled else None
        stream = self._stream(solver.device)
        ready = None
        with ext._tracer.span(
            "speculation.solve", {"pod": pod.name, "ticket": str(ticket)}
        ):
            with torch.cuda.stream(stream):
                outcome = solver.solve_tensor(
                    cluster, earlier_apps, skip_allowed, current
                )
            if stream is not None:
                ready = torch.cuda.Event()
                ready.record(stream)
                ready.synchronize()
        if not outcome.supported:
            return self._decline("unsupported")

        try:
            req_deadline.check("speculation-solved")
        except req_deadline.DeadlineExceeded:
            # the solve already ran; the request is past its deadline —
            # drop the verdict so commit answers fail-fast without
            # consuming it
            self._metrics.counter(
                mnames.CONCURRENT_SPECULATION_CANCELLED,
                {"phase": "speculation-solved"},
            )
            return None

        verdict = SpeculativeVerdict(
            (pod.namespace, pod.name),
            tuple(args.node_names),
            snap,
            tuple(map(id, earlier_apps)),
            tuple(skip_allowed),
            outcome,
            zones,
            artifacts=captured[-1] if captured else None,
            ready=ready,
            device=solver.device if ready is not None else None,
        )
        with self._lock:
            if ticket in self._inflight:
                self._inflight[ticket].will_commit = verdict.will_commit
        self._metrics.counter(
            mnames.CONCURRENT_SPECULATION_COUNT, {"outcome": "solved"}
        )
        return verdict
