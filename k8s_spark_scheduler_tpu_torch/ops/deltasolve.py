"""Incremental delta-solve engine: device-resident solver sessions +
prefix-feasibility reuse for the earlier-drivers-fit loop.  A port of the
reference package's ``ops/deltasolve.py``.

The paper's core guarantee — a driver schedules only if the whole gang
fits and every earlier driver fits first — is re-proved from scratch on
every Filter request by the cold path: the tensor build, the AZ-aware
sorts, the GCD scaling, the basis upload and a whole-queue pass.  Between
consecutive decisions almost nothing changes (the Firmament
observation), so the warm path here costs O(what changed):

- **Device-resident session** (:class:`.fifo_session.FifoSession`): the
  scaled availability basis, the driver ranks, the executor eligibility
  and the last-solved queue stay resident, keyed by the snapshot
  *structure revision* plus the request's affinity/candidate identity
  (the exact key the fast-path prep cache uses —
  ``fast_path.build_prep_keyed``).
- **Prefix-feasibility cache**: the session's queue-kernel launch leaves
  a checkpoint of the carried planes every ``stride`` queue positions;
  the next request resumes from the nearest checkpoint at or below the
  first changed queue position, in one launch of the same kernel.  The
  prefix match is verified row for row inside the session — the
  engine's bookkeeping is an optimisation, never a correctness input.

Invalidation rules (the reference's, one for one):

1. *Structure* — the session key embeds ``snap.structure_key`` and the
   candidate-list tuple; any node add/remove/relabel/cordon or a
   different candidate set simply misses the session map.
2. *Content* — a warm hit requires the idx-selected availability AND
   schedulable rows to equal the session basis exactly, in three tiers:
   the change-feed sequence (``snap.content_key``: unchanged sequence ⟹
   unchanged world), then the class digest (``state/classindex.py``: an
   XOR of per-node content hashes that cancels back under same-content
   churn), then an exact compare of the rows — churn that cancelled out
   (a probe reservation created then released) still warms.
3. *Scale* — warm reuse requires every demand row to divide the cached
   scale vector exactly and fit int32 after division; decisions are
   scale-invariant (capacities are exact integer quotients), so solving
   in the cached units is bit-identical to a fresh GCD rescale.
4. *Failover / journal replay* — replayed reservation intents flow
   through the store observers into the tensor mirror, bumping the feed
   and changing content, so rule 2 invalidates; a fresh process starts
   with an empty session map by construction.

Every miss reason is counted (``…tpu.deltasolve.warm.miss.count``) and
warm resumes record their depth (``…tpu.deltasolve.resume.depth``).

The one departure from the reference is where the engine serves.  The
reference serves only its native C++ session and stands aside on its
accelerator lane (``_solver_supported`` is False when Pallas is
selected).  This package has one lane per device and no native one, so
the engine serves every ``TpuFifoSolver`` whose policy has a whole-queue
code (tightly-pack, distribute-evenly, minimal-fragmentation) on either
device: the session's passes are the solver's own queue kernels on CUDA
and their plain versions on the CPU, and decisions equal the cold
solve's either way.  The single-AZ solvers miss ``unsupported``, as in
the reference.  As in the reference, a session loaded with
``classes_min_nodes`` nodes or more (and classes enabled) steps by node
class (``FifoSession.set_classes``: the class kernels of
``ops/class_kernel.py`` on CUDA, their plain version on the CPU), every
other session node by node; its partition rebuilds are counted into
``…tpu.classes.rebuild.count``.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis import racecheck
from ..analysis.guarded import guarded_by
from ..device import lane_of
from ..metrics import names as mnames
from ..tracing import spans as tracing
from ..tracing.profiling import default_profiler
from .fifo_session import FifoSession, solve_packed_cold
from .fifo_solver import FifoOutcome
from .tensorize import INT32_SAFE, ScaledProblem

logger = logging.getLogger(__name__)

# checkpoint stride: 1k-app queues keep ~16 live checkpoints (the session
# doubles the stride past 24, so memory stays bounded either way)
_DEFAULT_STRIDE = 64


@dataclass
class _Session:
    """One resident (cluster basis, policy) problem."""

    native: FifoSession       # the device-resident session
    policy_code: int
    avail64: np.ndarray       # [M, 3] int64 idx-selected availability basis
    sched64: np.ndarray       # [M, 3] int64 idx-selected schedulable basis
    cluster: object           # ClusterTensor built against the basis
    zones: Dict[str, str]
    scale: np.ndarray         # [3] int64
    scaled_avail: np.ndarray  # [Nb, 3] int32 (pre-queue, padded; host copy)
    driver_rank: np.ndarray   # [Nb] int32 (host copy)
    exec_ok: np.ndarray       # [Nb] bool (host copy)
    nb: int
    content_key: tuple        # snapshot content sequence last verified
    # class-digest warm tier (state/classindex.py): the XOR content
    # digest + class-structure revision of the snapshot this basis was
    # built from.  (-1, -1) = snapshot didn't carry a digest (tests
    # building bare TensorSnapshots); the tier then stands aside.
    class_digest: tuple = (-1, -1)
    class_rev: int = -1
    # class-compressed stepping (FifoSession.set_classes); last_rebuilds
    # tracks the session's partition-rebuild counter, so the engine counts
    # each rebuild once into CLASSES_REBUILD_COUNT
    use_classes: bool = False
    last_rebuilds: int = 0


@guarded_by("_lock", "_sessions", "_stats", "_resume_depths", "_parity_count")
class DeltaSolveEngine:
    """Serves the whole FIFO driver decision from resident device state
    when it can, declining (``solve`` → None) to the per-request build +
    cold solve otherwise.  Decisions are bit-identical to the cold path:
    the session's passes are launches of the same queue kernels
    (tests/test_torch_deltasolve.py replays random delta streams against
    cold solves and against the reference's engine)."""

    MAX_SESSIONS = 4

    def __init__(self, metrics=None):
        self._metrics = metrics
        self._lock = threading.Lock()
        self._sessions: OrderedDict = OrderedDict()
        self._stats = {"warm_hits": 0, "cold_solves": 0, "misses": {}}
        self._resume_depths = deque(maxlen=1024)
        # decision provenance (provenance/tracker.py): wiring points the
        # sink at ProvenanceTracker.capture when provenance is enabled.
        # None (the default) keeps the warm path entirely free of
        # capture work.  All three are set before serving starts and
        # only read here — no lock needed.
        self.capture_sink = None
        # warm≠cold parity guard: every Nth warm hit re-runs the queue
        # through the stateless cold pass and fires the flight recorder
        # on divergence.  0 = off (a full cold pass per check).
        self.parity_interval = 0
        self.parity_hooks = None  # (on_ok, on_mismatch) callables
        self._parity_count = 0
        # equivalence-class aggregation (Install.classes): the O(1)
        # digest warm tier below, and class-compressed stepping for
        # sessions of classes_min_nodes nodes or more.  Set at wiring
        # before serving starts, only read here — no lock needed.
        self.classes_enabled = True
        self.classes_min_nodes = 20000

    # -- availability --------------------------------------------------------

    @staticmethod
    def _solver_supported(solver) -> bool:
        """The session lane serves a TpuFifoSolver whose policy has a
        whole-queue code, on either device (module docstring)."""
        from .batch_solver import queue_policy_code
        from .fifo_solver import TpuFifoSolver

        return (
            isinstance(solver, TpuFifoSolver)
            and queue_policy_code(solver.assignment_policy) is not None
        )

    # -- bookkeeping ---------------------------------------------------------

    def _miss(self, reason: str) -> None:
        with self._lock:
            racecheck.note_access(self, "_stats")
            self._stats["misses"][reason] = self._stats["misses"].get(reason, 0) + 1
        if self._metrics is not None:
            self._metrics.counter(mnames.DELTASOLVE_WARM_MISSES, {"reason": reason})

    def _record_warm(self, resume: int) -> None:
        with self._lock:
            racecheck.note_access(self, "_stats")
            self._stats["warm_hits"] += 1
            self._resume_depths.append(int(resume))
        if self._metrics is not None:
            self._metrics.counter(mnames.DELTASOLVE_WARM_HITS)
            self._metrics.histogram(mnames.DELTASOLVE_RESUME_DEPTH, float(resume))

    def _record_cold(self) -> None:
        with self._lock:
            racecheck.note_access(self, "_stats")
            self._stats["cold_solves"] += 1

    def stats(self) -> dict:
        with self._lock:
            depths = sorted(self._resume_depths)
            hits = self._stats["warm_hits"]
            cold = self._stats["cold_solves"]
            digest_hits = self._stats.get("digest_hits", 0)
            misses = dict(self._stats["misses"])
            sessions = len(self._sessions)
            session_bytes = sum(s.native.mem_bytes() for s in self._sessions.values())
        total = hits + cold + sum(misses.values())
        return {
            "warm_hits": hits,
            "cold_solves": cold,
            "digest_hits": digest_hits,
            "misses": misses,
            "warm_hit_rate": (hits / total) if total else 0.0,
            "resume_depth_p50": (float(depths[len(depths) // 2]) if depths else None),
            "sessions": sessions,
            "session_bytes": session_bytes,
        }

    def latest_basis(self):
        """(node_names, avail64 [N,3] int64, exec_ok [N] bool,
        driver_rank [N] int64) of the most recently used session's
        cluster view, or None when no session is resident."""
        with self._lock:
            racecheck.note_access(self, "_sessions")
            if not self._sessions:
                return None
            sess = next(reversed(self._sessions.values()))
        c = sess.cluster
        return (
            list(c.node_names),
            np.asarray(c.avail, dtype=np.int64),
            np.asarray(c.exec_ok, dtype=bool),
            np.asarray(c.driver_rank, dtype=np.int64),
        )

    def invalidate(self) -> None:
        """Drop every session (tests / explicit failover hooks; organic
        invalidation flows through the content rules in the docstring).
        A Filter request may hold a dropped session mid-solve (solve()
        runs outside the engine lock); its tensors free once the last
        reference drops."""
        with self._lock:
            racecheck.note_access(self, "_sessions")
            self._sessions.clear()

    def _publish_gauges(self) -> None:
        if self._metrics is None:
            return
        with self._lock:
            n = len(self._sessions)
            b = sum(s.native.mem_bytes() for s in self._sessions.values())
        self._metrics.gauge(mnames.DELTASOLVE_SESSIONS, float(n))
        self._metrics.gauge(mnames.DELTASOLVE_SESSION_BYTES, float(b))

    # -- the solve -----------------------------------------------------------

    def solve(
        self,
        snap,
        driver_pod,
        candidate_names,
        node_sorter,
        earlier_apps: List,
        earlier_skip_allowed: List[bool],
        current_app,
        solver,
    ) -> Optional[Tuple[FifoOutcome, Dict[str, str]]]:
        """(FifoOutcome, node→zone map) or None when this lane cannot
        serve the request exactly (the caller then runs the per-request
        build + solve path)."""
        from .batch_solver import queue_policy_code
        from .fast_path import build_prep_keyed

        if not self._solver_supported(solver):
            self._miss("unsupported")
            return None
        policy_code = queue_policy_code(solver.assignment_policy)
        if not snap.exact:
            self._miss("inexact")
            return None

        with tracing.child_span("deltasolve.lookup") as lookup_span:
            # candidate_names passes through verbatim: on the HTTP path it
            # is the interned tuple (serde.intern_node_names), so the
            # prep/session key shares ONE string set across requests
            prep, key = build_prep_keyed(
                snap,
                driver_pod,
                candidate_names,
                node_sorter.driver_label_priority,
                node_sorter.executor_label_priority,
            )
            if key is None:
                self._miss("affinity-shape")
                return None
            skey = (key, policy_code)

            apps = solver._tensorize_with_cache(list(earlier_apps), current_app)
            if not apps.exact:
                self._miss("apps-inexact")
                return None
            n_earlier = len(earlier_apps)

            with self._lock:
                racecheck.note_access(self, "_sessions")
                sess = self._sessions.get(skey)
                if sess is not None:
                    self._sessions.move_to_end(skey)

            warm = False
            tier = "none"
            if sess is not None:
                snap_digest = getattr(snap, "class_digest", (-1, -1))
                if sess.content_key == snap.content_key:
                    warm, tier = True, "content-key"
                elif (
                    self.classes_enabled
                    and sess.class_digest != (-1, -1)
                    and snap_digest == sess.class_digest
                ):
                    # O(1) class-digest tier: the XOR node-content digest
                    # cancelled back to the session's — same-class node
                    # churn (create/release, cordon/uncordon round trips)
                    # warms without the O(N) row compare.  The digest
                    # hashes a superset of what the row compare checks,
                    # so equality ⟹ equal rows up to 64-bit XOR
                    # collisions; the warm≠cold parity guard audits it.
                    warm, tier = True, "class-digest"
                    sess.content_key = snap.content_key
                    sess.class_rev = getattr(snap, "class_rev", -1)
                    with self._lock:
                        racecheck.note_access(self, "_stats")
                        self._stats["digest_hits"] = self._stats.get("digest_hits", 0) + 1
                elif np.array_equal(snap.avail[prep.idx], sess.avail64) and np.array_equal(
                    snap.schedulable[prep.idx], sess.sched64
                ):
                    # churn cancelled out (e.g. a reservation created
                    # then released): the basis is still exact
                    warm, tier = True, "rows"
                    sess.content_key = snap.content_key
                    sess.class_digest = snap_digest
                    sess.class_rev = getattr(snap, "class_rev", -1)
            lookup_span.tag("tier", tier)

        scaled = None
        if warm:
            with tracing.child_span("deltasolve.scale"):
                scaled = self._scale_apps(apps, sess.scale, sess.nb)
            if scaled is None:
                # the cached units no longer represent these demands
                # exactly — rebuild with a fresh GCD
                warm = False

        if not warm:
            with tracing.child_span("deltasolve.cold_build"):
                sess, scaled = self._cold_build(
                    snap, driver_pod, candidate_names, node_sorter, prep, skey,
                    policy_code, apps, solver.device,
                )
            if sess is None:
                return None
            self._record_cold()

        driver_s, executor_s, count_s = scaled
        packed = np.empty((n_earlier, 8), dtype=np.int32)
        packed[:, 0:3] = driver_s[:n_earlier]
        packed[:, 3:6] = executor_s[:n_earlier]
        packed[:, 6] = count_s[:n_earlier]
        packed[:, 7] = 1

        lane = f"{lane_of(solver.device)}-session"
        solver.last_queue_lane = lane
        kernel = ("fifo_queue_min_frag" if policy_code == 2 else "fifo_queue") + ("_classes" if sess.use_classes else "")
        with tracing.child_span("fifo_gate", {"lane": lane, "earlierApps": n_earlier}) as gate_span:
            with default_profiler.profile(kernel, lane=lane, shape_key=(sess.nb, n_earlier)) as rec:
                resume, feasible, didx, avail_after = sess.native.solve(packed)
                rec.sync(avail_after)
            gate_span.tag("resumeFrom", int(resume))
            gate_span.tag("warm", warm)
            if sess.use_classes and self._metrics is not None:
                rebuilds = sess.native.class_stats()["rebuilds"]
                if rebuilds > sess.last_rebuilds:
                    self._metrics.counter(mnames.CLASSES_REBUILD_COUNT, inc=float(rebuilds - sess.last_rebuilds))
                    sess.last_rebuilds = rebuilds
            if warm:
                self._record_warm(resume)
                if self.parity_interval:
                    with self._lock:
                        racecheck.note_access(self, "_parity_count")
                        self._parity_count += 1
                        parity_due = self._parity_count % self.parity_interval == 0
                    if parity_due:
                        self._verify_parity(sess, packed, feasible, didx, avail_after)
            if self.capture_sink is not None:
                self._capture(
                    sess, snap, lane, packed, driver_s, executor_s, count_s, n_earlier,
                    feasible, didx, resume, avail_after, earlier_skip_allowed,
                )
            if n_earlier:
                blocked = ~feasible & ~np.asarray(earlier_skip_allowed, dtype=bool)
                if blocked.any():
                    gate_span.tag("earlierOk", False)
                    return FifoOutcome(supported=True, earlier_ok=False), sess.zones
            gate_span.tag("earlierOk", True)

        problem = ScaledProblem(
            avail=sess.scaled_avail,
            driver_rank=sess.driver_rank,
            exec_ok=sess.exec_ok,
            driver=driver_s,
            executor=executor_s,
            count=count_s,
            app_valid=np.ones(len(count_s), dtype=bool),
            scale=sess.scale,
            ok=True,
        )
        # the session's device tensors go to the current driver's pack
        # as they are: no round trip through the host
        outcome = solver._pack_current(
            sess.cluster, problem,
            (avail_after, sess.native.driver_rank, sess.native.exec_ok),
            n_earlier, current_app, metadata=None,
        )
        return outcome, sess.zones

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _session_artifacts(
        sess, packed, n_earlier, feasible, didx, resume, avail_after,
        lane, skip_allowed=(), content_key=None, feed_seq=None,
    ):
        """One SolveArtifacts construction from session fields, shared
        by the capture sink and the parity guard so the two bundles the
        subsystem emits can never drift apart field by field.  Arrays
        are referenced, not copied — the session's host basis arrays are
        replaced on rebuild, never mutated in place, and avail_after is a
        launch's own output tensor, which no later launch writes."""
        from ..provenance.tracker import SolveArtifacts

        return SolveArtifacts(
            policy_code=sess.policy_code,
            lane=lane,
            basis=sess.scaled_avail,
            driver_rank=sess.driver_rank,
            exec_ok=sess.exec_ok,
            packed=packed,
            n_earlier=n_earlier,
            feasible=np.asarray(feasible, dtype=bool),
            didx=np.asarray(didx, dtype=np.int32),
            resume=int(resume),
            avail_after=avail_after,
            scale=sess.scale,
            node_names=sess.cluster.node_names,
            zone_names=sess.cluster.zone_names,
            zone_id=sess.cluster.zone_id,
            skip_allowed=list(skip_allowed),
            content_key=content_key,
            feed_seq=feed_seq,
            device=sess.native.device,
        )

    def _capture(
        self, sess, snap, lane, packed, driver_s, executor_s, count_s, n_earlier,
        feasible, didx, resume, avail_after, earlier_skip_allowed,
    ) -> None:
        """Hand the decision's full session inputs + verdicts to the
        provenance sink."""
        try:
            packed_full = np.empty((n_earlier + 1, 8), dtype=np.int32)
            packed_full[:n_earlier] = packed
            packed_full[n_earlier, 0:3] = driver_s[n_earlier]
            packed_full[n_earlier, 3:6] = executor_s[n_earlier]
            packed_full[n_earlier, 6] = count_s[n_earlier]
            packed_full[n_earlier, 7] = 1
            self.capture_sink(self._session_artifacts(
                sess, packed_full, n_earlier, feasible, didx, resume, avail_after,
                lane=lane, skip_allowed=earlier_skip_allowed,
                content_key=snap.content_key, feed_seq=int(snap.content_key[1]),
            ))
        except Exception:
            logger.exception("provenance capture failed (diagnostic only)")

    def _verify_parity(self, sess, packed, feasible, didx, avail_after) -> None:
        """Warm≠cold parity guard: the stateless cold pass run on the
        same basis + queue must reproduce the session's verdicts byte
        for byte (checked in the wild).  Divergence fires the flight
        recorder.  The cold pass is a kernel launch like any other: a
        fault there raises (the Filter answers 500); only the reporting
        is diagnostic."""
        native = sess.native
        cold_f, cold_d, cold_after = solve_packed_cold(
            sess.policy_code, native.basis, native.driver_rank, native.exec_ok, packed,
            device=native.device,
        )
        try:
            feasible_equal = cold_f.tobytes() == np.asarray(feasible, dtype=bool).tobytes()
            ok = (
                feasible_equal
                and cold_d.tobytes() == np.asarray(didx, np.int32).tobytes()
                and torch.equal(cold_after, avail_after)
            )
            hooks = self.parity_hooks
            if ok:
                if hooks is not None and hooks[0] is not None:
                    hooks[0]()
                return
            detail = {
                "policy": sess.policy_code,
                "n_apps": int(packed.shape[0]),
                "feasible_equal": bool(feasible_equal),
            }
            logger.error("deltasolve warm/cold parity mismatch: %s", detail)
            if hooks is not None and hooks[1] is not None:
                # ship the DIVERGING solve itself: the persisted bundle
                # must contain the anomaly, not just the decisions that
                # preceded it
                try:
                    detail["artifacts"] = self._session_artifacts(
                        sess, packed, int(packed.shape[0]), feasible, didx, 0, avail_after,
                        lane=f"{lane_of(native.device)}-session-parity",
                    )
                except Exception:
                    pass
                hooks[1](detail)
        except Exception:
            logger.exception("parity guard failed to run (diagnostic only)")

    @staticmethod
    def _scale_apps(apps, scale: np.ndarray, nb: int):
        """(driver_s, executor_s, count_s) int32 in the session's units,
        or None when the cached scale cannot represent these demands
        exactly inside the session's numeric bounds.  Decisions are
        scale-invariant, so any exact representation matches the cold
        solve bit for bit."""
        d = apps.driver
        e = apps.executor
        if (d % scale).any() or (e % scale).any():
            return None
        ds = d // scale
        es = e // scale
        if (np.abs(ds) > INT32_SAFE).any() or (np.abs(es) > INT32_SAFE).any():
            return None
        counts = apps.count
        max_k = int(counts.max()) if counts.size else 0
        if max_k > INT32_SAFE or (max_k > 0 and nb * max_k > INT32_SAFE):
            # same int32 sum-overflow guard scale_problem applies
            return None
        return (
            ds.astype(np.int32),
            es.astype(np.int32),
            np.minimum(counts, INT32_SAFE).astype(np.int32),
        )

    def _cold_build(
        self, snap, driver_pod, candidate_names, node_sorter, prep, skey,
        policy_code, apps, device,
    ):
        """Build + load a fresh session (the full per-request path, plus
        one basis upload).  Returns (session, scaled apps) or (None, _)
        when the request can't be represented exactly at all."""
        from .batch_solver import mf_sentinel_safe
        from .fast_path import build_cluster_tensor
        from .tensorize import scale_problem

        with tracing.child_span("fast_path.build_tensor") as sp:
            built = build_cluster_tensor(
                snap,
                driver_pod,
                candidate_names,
                driver_label_priority=node_sorter.driver_label_priority,
                executor_label_priority=node_sorter.executor_label_priority,
            )
            sp.tag("exact", built is not None)
        if built is None:
            self._miss("inexact")
            return None, None
        cluster, zones = built
        with tracing.child_span("tensorize.scale"):
            problem = scale_problem(cluster, apps)
        if not problem.ok:
            self._miss("scale")
            return None, None
        if policy_code == 2 and not mf_sentinel_safe(problem.avail):
            self._miss("mf-sentinel")
            return None, None

        # reuse the evictee's session when this key is being rebuilt:
        # load() replaces all resident state and keeps its checkpoint
        # buffer.  The stale entry is POPPED before it is reloaded — if
        # anything below raises, no mapping survives whose host basis
        # disagrees with the basis now resident (the next request
        # cold-builds).
        with self._lock:
            racecheck.note_access(self, "_sessions")
            prior = self._sessions.pop(skey, None)
        native = prior.native if prior is not None else FifoSession(device=device)
        with tracing.child_span("deltasolve.load"):
            native.load(
                problem.avail, problem.driver_rank, problem.exec_ok, policy_code,
                stride=_DEFAULT_STRIDE,
            )
        nb = int(problem.avail.shape[0])
        # class-compressed stepping at scale (the reference's rule);
        # always set, so a reused evictee never keeps the previous mode
        use_classes = self.classes_enabled and nb >= self.classes_min_nodes
        native.set_classes(use_classes)
        na = apps.driver.shape[0]
        sess = _Session(
            native=native,
            policy_code=policy_code,
            avail64=snap.avail[prep.idx],
            sched64=snap.schedulable[prep.idx],
            cluster=cluster,
            zones=zones,
            scale=problem.scale.astype(np.int64),
            scaled_avail=problem.avail,
            driver_rank=problem.driver_rank,
            exec_ok=problem.exec_ok,
            nb=nb,
            content_key=snap.content_key,
            class_digest=getattr(snap, "class_digest", (-1, -1)),
            class_rev=getattr(snap, "class_rev", -1),
            use_classes=use_classes,
        )
        with self._lock:
            racecheck.note_access(self, "_sessions")
            self._sessions[skey] = sess  # stale entry already popped above
            while len(self._sessions) > self.MAX_SESSIONS:
                # evictees are dropped, not closed: another thread's
                # in-flight solve may still hold one
                self._sessions.popitem(last=False)
        self._publish_gauges()
        # the scaled app block comes straight from the cold scaling
        scaled = (
            problem.driver[:na],
            problem.executor[:na],
            problem.count[:na],
        )
        return sess, scaled
