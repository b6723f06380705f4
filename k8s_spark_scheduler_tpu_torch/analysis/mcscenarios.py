"""Model-check scenario corpus over the scheduler's guarded components.

These are the components concurrent admission puts under real
concurrency: the tensor mirror's :class:`~..state.store.ChangeFeed`
(warm-path invalidation truth), the
:class:`~..ops.deltasolve.DeltaSolveEngine` session map (eviction vs.
in-flight solves), the :class:`~..resilience.journal.IntentJournal`
(divert → replay exactly-once), the
:class:`~..resilience.gate.AdmissionGate` (bounded in-flight
accounting), and the :class:`~..capacity.observatory.CapacitySampler`
(background sampling vs. HTTP freshen).  Each scenario is small — two
to four threads, a handful of operations — because the model checker
pays per interleaving; the point is *exhaustiveness over schedules*,
not volume.

Every scenario asserts its component's core invariant on every explored
schedule AND runs under a fresh race detector (lockset + happens-before
+ lock-order), so a pass means: on every interleaving within the
preemption bound, the invariant held and no access pair was unordered.

``python -m k8s_spark_scheduler_tpu_torch.analysis.modelcheck`` runs this
corpus; ``tests/test_torch_modelcheck.py`` runs it at a reduced budget
on the CPU.  ``corpus(device)`` places the device components (the
capacity sampler's probe programs) on ``device``: None means CUDA, and
raises without a card.  When adding a scenario, keep every thread body deterministic
(no wall clock, no unseeded randomness — schedlint enforces this) and
synchronize only through tracked locks, ``note_access`` checkpoints,
or the cooperative primitives in :mod:`.modelcheck`.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np

from ..device import DeviceLike, resolve_device
from . import racecheck
from .guarded import guarded_by
from .modelcheck import CoopEvent, Scenario, checkpoint

# ---------------------------------------------------------------------------
# 1. ChangeFeed: publish → wakeup ordering + sequence monotonicity
# ---------------------------------------------------------------------------


def _changefeed_scenario() -> Scenario:
    from ..state.store import DELTA_NODE, DELTA_RESERVATION, ChangeFeed

    class State:
        def __init__(self):
            self.feed = ChangeFeed(capacity=64)
            self.wakeup = CoopEvent()
            self.feed.attach_wakeup(self.wakeup)
            self.observed: List[int] = []

    def setup():
        return State()

    def threads(st: State):
        def publisher_a():
            st.feed.publish(DELTA_RESERVATION, "app-a")
            st.feed.publish(DELTA_NODE, "node-1")

        def publisher_b():
            st.feed.publish(DELTA_RESERVATION, "app-b")

        def waiter():
            st.wakeup.wait()
            # publish happens-before the wakeup: at least one delta must
            # be visible once the event fires
            seq = st.feed.seq
            assert seq >= 1, "woke before any publish was visible"
            kinds = st.feed.kinds_since(0)
            assert kinds is not None and len(kinds) >= 1

        def reader():
            last = 0
            for _ in range(3):
                seq = st.feed.seq
                assert seq >= last, f"feed seq went backwards {last}→{seq}"
                st.observed.append(seq)
                last = seq
                checkpoint("between-reads")

        return [
            ("pub-a", publisher_a),
            ("pub-b", publisher_b),
            ("waiter", waiter),
            ("reader", reader),
        ]

    def final(st: State):
        assert st.feed.seq == 3, f"lost publishes: seq={st.feed.seq}"
        assert st.observed == sorted(st.observed)

    return Scenario(
        name="changefeed-publish-wakeup",
        setup=setup,
        threads=threads,
        final=final,
        description="feed sequence is monotone, no publish is lost, and "
        "the wakeup event never fires before its publish is visible",
    )


# ---------------------------------------------------------------------------
# 2. Mirror lockstep: the delta-solve warm check's O(1) truth
# ---------------------------------------------------------------------------


def _mirror_warm_check_scenario() -> Scenario:
    """The engine's warm path rests on one property of the tensor
    mirror: the content sequence and the content move in lockstep under
    the mirror lock, so *unchanged seq ⟹ unchanged world*.  Model the
    mirror as (data, feed) mutated under one lock — exactly
    TensorSnapshotCache's discipline — and a warm-checking reader that
    caches (seq, data) and later revalidates."""
    from ..state.store import DELTA_RESERVATION, ChangeFeed

    @guarded_by("_lock", "data")
    class Mirror:
        def __init__(self):
            self._lock = threading.RLock()
            self.feed = ChangeFeed(capacity=64)
            self.data = 0

        def read(self):
            with self._lock:
                return self.data, self.feed.seq

    def mutate(mirror: Mirror):
        with mirror._lock:
            racecheck.note_access(mirror, "data")
            mirror.data += 1
            mirror.feed.publish(DELTA_RESERVATION, "r")

    class State:
        def __init__(self):
            self.mirror = Mirror()

    def setup():
        return State()

    def threads(st: State):
        def writer():
            for _ in range(2):
                mutate(st.mirror)

        def warm_reader():
            data1, seq1 = st.mirror.read()
            assert data1 == seq1, "content and sequence out of lockstep"
            checkpoint("warm-window")
            # the O(1) warm check: an unchanged sequence proves the
            # content is unchanged — (data, seq) must be read as one
            # consistent pair (the engine compares the seq inside the
            # snapshot's content_key, never a separately-read one)
            data2, seq2 = st.mirror.read()
            if seq2 == seq1:
                assert data2 == data1, (
                    f"seq unchanged ({seq1}) but content moved "
                    f"{data1}→{data2}: warm check unsound"
                )

        return [
            ("writer", writer),
            ("warm-a", warm_reader),
            ("warm-b", warm_reader),
        ]

    def invariant(st: State):
        data, seq = st.mirror.read()
        assert data == seq, f"lockstep broken: data={data} seq={seq}"

    return Scenario(
        name="mirror-seq-warm-check",
        setup=setup,
        threads=threads,
        invariant=invariant,
        description="unchanged ChangeFeed seq implies unchanged mirror "
        "content on every interleaving (the delta-solve warm-path axiom)",
    )


# ---------------------------------------------------------------------------
# 3. IntentJournal: divert vs. replay, no lost intents
# ---------------------------------------------------------------------------


def _journal_scenario() -> Scenario:
    from ..resilience.journal import IntentJournal

    class State:
        def __init__(self):
            self.journal = IntentJournal(path=None)
            self.recorded: List[str] = []
            self.acked: List[str] = []

    def setup():
        return State()

    def threads(st: State):
        def divert():
            for name in ("app-a", "app-b"):
                st.journal.record("create", "rr", "ns", name, {"n": name})
                st.recorded.append(name)

        def divert_deletes():
            st.journal.record("delete", "rr", "ns", "app-c", None)
            st.recorded.append("app-c")

        def replay():
            # the recovery loop's shape: read pending, replay each, ack
            for rec in st.journal.pending():
                if st.journal.ack(rec["op"], rec["ns"], rec["name"]):
                    st.acked.append(rec["name"])

        return [
            ("divert", divert),
            ("divert-del", divert_deletes),
            ("replay", replay),
        ]

    def invariant(st: State):
        # an intent is never both acked and still pending
        pending = {name for _, name in st.journal.pending_keys()}
        for name in st.acked:
            assert name not in pending, f"{name} acked but still pending"

    def final(st: State):
        pending = {name for _, name in st.journal.pending_keys()}
        for name in st.recorded:
            assert name in pending or name in st.acked, (
                f"lost intent: {name} neither pending nor acked"
            )

    return Scenario(
        name="journal-divert-replay",
        setup=setup,
        threads=threads,
        invariant=invariant,
        final=final,
        description="every diverted intent is exactly-once: still "
        "pending or acked, never lost, on every interleaving",
    )


# ---------------------------------------------------------------------------
# 4. AdmissionGate: bounded in-flight accounting
# ---------------------------------------------------------------------------


def _gate_scenario() -> Scenario:
    from ..resilience.gate import AdmissionGate

    class State:
        def __init__(self):
            self.gate = AdmissionGate(max_waiters=2)
            self.admitted = 0
            self.shed = 0

    def setup():
        return State()

    def threads(st: State):
        def request():
            if st.gate.try_enter():
                st.admitted += 1
                checkpoint("holding-admission")
                st.gate.leave()
            else:
                st.shed += 1

        return [(f"req-{i}", request) for i in range(3)]

    def invariant(st: State):
        inflight = st.gate.in_flight
        assert 0 <= inflight <= st.gate.max_waiters, (
            f"in_flight {inflight} outside [0, {st.gate.max_waiters}]"
        )

    def final(st: State):
        assert st.gate.in_flight == 0, "gate leaked an admission"
        assert st.admitted + st.shed == 3
        assert st.gate.shed_total == st.shed

    return Scenario(
        name="admission-gate",
        setup=setup,
        threads=threads,
        invariant=invariant,
        final=final,
        description="in-flight count stays within [0, max] and every "
        "request is exactly one of admitted/shed on every interleaving",
    )


# ---------------------------------------------------------------------------
# 5. DeltaSolveEngine: session eviction vs. bookkeeping vs. invalidate
# ---------------------------------------------------------------------------


class _FakeNativeSession:
    """Stands in for the device-resident FifoSession: the engine only
    calls mem_bytes() under its lock, and eviction must tolerate another
    thread still holding a reference (evictees are dropped, not
    closed)."""

    def __init__(self):
        self.closed = False

    def mem_bytes(self) -> int:
        assert not self.closed, "mem_bytes on a closed session"
        return 1024


def _engine_scenario() -> Scenario:
    from ..ops.deltasolve import DeltaSolveEngine, _Session

    def _fake_session() -> "_Session":
        zero = np.zeros((1, 3), dtype=np.int64)
        return _Session(
            native=_FakeNativeSession(), policy_code=0, avail64=zero,
            sched64=zero, cluster=None, zones={},
            scale=np.ones(3, dtype=np.int64),
            scaled_avail=np.zeros((1, 3), dtype=np.int32),
            driver_rank=np.zeros(1, dtype=np.int32),
            exec_ok=np.zeros(1, dtype=bool), nb=1, content_key=(0, 0),
        )

    class State:
        def __init__(self):
            self.engine = DeltaSolveEngine(metrics=None)

    def insert(eng: DeltaSolveEngine, key):
        """_cold_build's session-map update, verbatim idiom: pop the
        stale entry, rebuild off-lock, insert + evict over the cap."""
        with eng._lock:
            racecheck.note_access(eng, "_sessions")
            eng._sessions.pop(key, None)
        sess = _fake_session()  # the off-lock rebuild window
        checkpoint("rebuild-window")
        with eng._lock:
            racecheck.note_access(eng, "_sessions")
            eng._sessions[key] = sess
            while len(eng._sessions) > eng.MAX_SESSIONS:
                eng._sessions.popitem(last=False)

    def setup():
        return State()

    def threads(st: State):
        def builder_a():
            for key in ("k0", "k1", "k2"):
                insert(st.engine, key)

        def builder_b():
            for key in ("k2", "k3", "k4"):
                insert(st.engine, key)

        def bookkeeper():
            st.engine._miss("content")
            st.engine._record_warm(resume=3)
            stats = st.engine.stats()
            assert stats["warm_hits"] >= 1
            assert stats["misses"].get("content", 0) >= 1

        def invalidator():
            st.engine.invalidate()
            # builders may re-insert immediately after the clear, so the
            # post-state is only bounded, never exactly empty
            stats = st.engine.stats()
            assert 0 <= stats["sessions"] <= st.engine.MAX_SESSIONS

        return [
            ("builder-a", builder_a),
            ("builder-b", builder_b),
            ("bookkeeper", bookkeeper),
            ("invalidate", invalidator),
        ]

    def invariant(st: State):
        stats = st.engine.stats()
        assert stats["sessions"] <= st.engine.MAX_SESSIONS, (
            f"LRU cap breached: {stats['sessions']}"
        )
        assert stats["session_bytes"] == stats["sessions"] * 1024

    return Scenario(
        name="deltasolve-eviction",
        setup=setup,
        threads=threads,
        invariant=invariant,
        description="concurrent session rebuilds, eviction, stats and "
        "invalidate keep the session map bounded and consistent",
    )


# ---------------------------------------------------------------------------
# 6. CapacitySampler: background sampling vs. HTTP freshen
# ---------------------------------------------------------------------------


def _sampler_scenario(device) -> Scenario:
    from ..capacity.observatory import CapacitySampler
    from ..state.store import DELTA_RESERVATION, ChangeFeed
    from ..state.tensor_snapshot import TensorSnapshot

    class FakeCache:  # schedlint: disable=LK004 -- scenario fixture: the lock is tracked via racecheck.track_extra_lock in setup
        """Two-node snapshot source with the mirror's (data, seq)
        lockstep discipline."""

        def __init__(self):
            self._lock = threading.Lock()
            self.feed = ChangeFeed(capacity=64)
            self._usage = 0

        def mutate(self):
            with self._lock:
                self._usage += 1
                self.feed.publish(DELTA_RESERVATION, "r")

        def snapshot(self) -> TensorSnapshot:
            with self._lock:
                usage = self._usage
                seq = self.feed.seq
            alloc = np.full((2, 3), 4_000, dtype=np.int64)
            used = np.zeros((2, 3), dtype=np.int64)
            used[0, 0] = usage
            return TensorSnapshot(
                names=["node-0", "node-1"],
                allocatable=alloc,
                usage=used,
                overhead=np.zeros((2, 3), dtype=np.int64),
                zone_names=["az-a"],
                zone_id=np.zeros(2, dtype=np.int32),
                ready=np.ones(2, dtype=bool),
                unschedulable=np.zeros(2, dtype=bool),
                labels=[{}, {}],
                exact=True,
                res_entries=np.zeros(2, dtype=bool),
                name_rank=np.arange(2, dtype=np.int64),
                structure_key=(0, 0),
                content_key=(0, seq),
            )

    class State:
        def __init__(self):
            self.cache = FakeCache()
            self.sampler = CapacitySampler(
                self.cache, debounce_seconds=0.0, device=device,
            )
            if device.type == "cuda":
                # the sampler makes its probe stream at its first sample,
                # in a controlled thread: start the CUDA context and the
                # stream here, on the orchestrator, so the controlled
                # threads only launch (a context start-up inside a
                # schedule would stall it for seconds)
                with self.sampler._on_stream():
                    pass
            # the sample mutex is the freshen-vs-background serializer
            # and the fake cache's lock guards its (data, seq) lockstep;
            # track both so the scheduler can interleave across them
            # instead of deadlocking on raw locks
            racecheck.track_extra_lock(self.sampler, "_sample_mutex")
            racecheck.track_extra_lock(self.cache, "_lock")

    def setup():
        return State()

    def threads(st: State):
        def publisher():
            st.cache.mutate()
            st.cache.mutate()

        def background():
            st.sampler.maybe_sample(trigger="feed")

        def http_freshen():
            st.sampler.sample_now(trigger="manual")

        return [
            ("publisher", publisher),
            ("background", background),
            ("freshen", http_freshen),
        ]

    def invariant(st: State):
        timeline = st.sampler.timeline()
        seqs = [s.seq for s in timeline]
        assert seqs == sorted(seqs), f"timeline seqs out of order: {seqs}"
        assert len(seqs) == len(set(seqs)), f"duplicate timeline key: {seqs}"

    def final(st: State):
        stats = st.sampler.stats()
        assert stats["lock_violations"] == 0
        # an unchanged-seq re-sample REPLACES its timeline entry rather
        # than appending, so samples may exceed distinct timeline keys —
        # but never the other way around
        assert stats["samples"] >= len(st.sampler.timeline())
        assert stats["samples"] >= 1

    return Scenario(
        name="capacity-sampler-freshen",
        setup=setup,
        threads=threads,
        invariant=invariant,
        final=final,
        description="background sampling, HTTP freshen and feed "
        "publishes keep the timeline ordered and duplicate-free",
    )


# ---------------------------------------------------------------------------
# 7. PreemptionCoordinator: admission vs. commit vs. failover replay
# ---------------------------------------------------------------------------


def _preemption_scenario() -> Scenario:
    """Concurrent admission, a preemption commit, and a failover
    recover() replaying a predecessor's pending evict intent.  The
    exactly-once contract under every interleaving: no lost eviction
    (every intent executed and acked — journal drains), no double-evict
    (no pod is ever successfully deleted twice), and admission of an
    uninvolved app is never disturbed."""
    from ..kube.errors import NotFoundError
    from ..policy.preempt import EVICT_KIND, PreemptionCoordinator
    from ..policy.victims import VictimCandidate, VictimPlan

    @guarded_by("_lock", "pods", "rrs", "pod_deletes")
    class Cluster:
        """Pod + RR state shared by the fake api and rr_cache views;
        counts SUCCESSFUL deletes per pod — the double-evict witness."""

        def __init__(self):
            self._lock = threading.Lock()
            self.pods = {"app-a-driver", "app-a-exec-1", "app-b-driver", "app-b-exec-1"}
            self.rrs = {"app-a", "app-b"}
            self.pod_deletes: dict = {}

    def delete_pod(cluster: Cluster, name: str) -> None:
        with cluster._lock:
            racecheck.note_access(cluster, "pods")
            racecheck.note_access(cluster, "pod_deletes")
            if name not in cluster.pods:
                raise NotFoundError(f"pod {name}")
            cluster.pods.remove(name)
            cluster.pod_deletes[name] = cluster.pod_deletes.get(name, 0) + 1

    def delete_rr(cluster: Cluster, name: str) -> None:
        with cluster._lock:
            racecheck.note_access(cluster, "rrs")
            if name not in cluster.rrs:
                raise NotFoundError(f"rr {name}")
            cluster.rrs.remove(name)

    def add_rr(cluster: Cluster, name: str) -> None:
        with cluster._lock:
            racecheck.note_access(cluster, "rrs")
            cluster.rrs.add(name)

    class FakeAPI:
        def __init__(self, cluster):
            self._cluster = cluster

        def delete(self, kind, ns, name):
            delete_pod(self._cluster, name)

    class FakeRRCache:
        def __init__(self, cluster):
            self._cluster = cluster

        def delete(self, ns, name):
            delete_rr(self._cluster, name)

    def _plan(app: str) -> VictimPlan:
        return VictimPlan(
            preemptor_app="storm-001",
            preemptor_band="high",
            victims=[
                VictimCandidate(
                    namespace="ns", app_id=app, band="low", band_rank=0,
                    tenant="t", created=1.0,
                    freed=np.zeros((1, 3), dtype=np.int64),
                    pods=[f"{app}-driver", f"{app}-exec-1"],
                )
            ],
            whatif_ms=0.0,
            lane="numpy",
        )

    class State:
        def __init__(self):
            self.cluster = Cluster()
            self.coordinator = PreemptionCoordinator(
                api=FakeAPI(self.cluster), rr_cache=FakeRRCache(self.cluster)
            )
            # the predecessor instance journaled app-a's eviction and
            # crashed before executing it: a pending intent recover()
            # must replay exactly once
            self.coordinator._journal.record(
                "delete", EVICT_KIND, "ns", "app-a",
                {"pods": ["app-a-driver", "app-a-exec-1"], "reason": "crashed",
                 "preemptor": "storm-000", "band": "low", "tenant": "t"},
            )

    def setup():
        return State()

    def threads(st: State):
        def active_commit():
            st.coordinator.commit(_plan("app-b"))

        def standby_recover():
            st.coordinator.recover()

        def admitter():
            add_rr(st.cluster, "app-c")
            checkpoint("post-admission")
            snap = st.coordinator.state()
            assert snap["evictionsTotal"] >= 0

        return [
            ("commit", active_commit),
            ("recover", standby_recover),
            ("admitter", admitter),
        ]

    def invariant(st: State):
        with st.cluster._lock:
            deletes = dict(st.cluster.pod_deletes)
        for pod, n in deletes.items():
            assert n <= 1, f"double-evict: pod {pod} successfully deleted {n}x"

    def final(st: State):
        # no lost eviction: every intent executed and acked
        assert st.coordinator.journal_depth() == 0, "evict intent left pending"
        with st.cluster._lock:
            pods, rrs = set(st.cluster.pods), set(st.cluster.rrs)
        assert not pods, f"victim pods survived eviction: {sorted(pods)}"
        assert rrs == {"app-c"}, f"expected only the admitted app's RR, got {sorted(rrs)}"
        evicted = {e["app"] for e in st.coordinator.state()["recent"]}
        assert evicted == {"app-a", "app-b"}, f"evicted set wrong: {sorted(evicted)}"

    return Scenario(
        name="preemption-commit-vs-recover",
        setup=setup,
        threads=threads,
        invariant=invariant,
        final=final,
        description="concurrent admission, preemption commit and failover "
        "replay: no lost eviction, no double-evict, journal drains on "
        "every interleaving",
    )


# ---------------------------------------------------------------------------
# 8. Fencing: lease steal vs. renewal observation vs. in-flight write-back
# ---------------------------------------------------------------------------


def _fencing_scenario() -> Scenario:
    """The split-brain triangle (ha/fencing.py): a rival CAS-steals the
    lease at epoch 2 while the resident leader (epoch 1) has write-backs
    in flight and its renewal loop is racing to observe the steal.  The
    contract under every interleaving: a write whose read-through peek
    already saw epoch 2 refuses deterministically; a commit may straddle
    the steal only when the lease moved *between* its peek and its
    commit (the irreducible in-flight window), and the fence's
    stale-commit witness counts at most those straddlers — it never
    invents one.  Once deposition is observed, every later check
    refuses."""
    from ..ha.fencing import FencedWriter, FenceState, StaleEpochError

    @guarded_by("_lock", "epoch")
    class LeaseView:
        """The coordination lease as the read-through sees it."""

        def __init__(self):
            self._lock = threading.Lock()
            self.epoch = 1

    def peek(lease: LeaseView) -> LeaseView:
        with lease._lock:
            racecheck.note_access(lease, "epoch")
            view = LeaseView.__new__(LeaseView)
            view.epoch = lease.epoch
            return view

    def steal(lease: LeaseView, epoch: int) -> None:
        with lease._lock:
            racecheck.note_access(lease, "epoch")
            lease.epoch = epoch

    class State:
        def __init__(self):
            self.lease = LeaseView()
            self.fence = FenceState()
            self.fence.grant(1)
            self.writer = FencedWriter(self.fence, lease_reader=lambda: peek(self.lease))
            self._lock = threading.Lock()
            self.committed: List[int] = []
            self.refused = 0
            # commits whose peek→commit window straddled the steal
            self.straddled = 0

    def setup():
        return State()

    def threads(st: State):
        def write(op: str):
            try:
                epoch = st.writer.check(op)
            except StaleEpochError:
                with st._lock:
                    st.refused += 1
                return
            checkpoint("pre-commit")  # the in-flight window
            st.writer.commit()
            # deposition is monotone (no re-grant in this scenario), so
            # "deposed now" is a sound upper bound for "deposed when
            # note_commit ran" — every fence-counted straddler is
            # counted here too, never the reverse
            deposed = st.fence.deposed()
            with st._lock:
                st.committed.append(epoch)
                if deposed:
                    st.straddled += 1

        def rival():
            # the rival's CAS lands on the lease object first; the
            # resident only learns of it via a peek or a renewal
            steal(st.lease, 2)

        def renewer():
            # the renewal round observing whatever the lease holds now
            st.fence.observe(peek(st.lease).epoch)

        return [
            ("write-a", lambda: write("writeback.create")),
            ("write-b", lambda: write("writeback.update")),
            ("rival", rival),
            ("renewer", renewer),
        ]

    def invariant(st: State):
        with st._lock:
            committed = list(st.committed)
        for epoch in committed:
            assert epoch == 1, f"write committed at unheld epoch {epoch}"

    def final(st: State):
        with st._lock:
            decided = len(st.committed) + st.refused
            straddled = st.straddled
        # the witness only counts commits that really straddled the
        # steal (asserted post-quiesce: mid-flight the bookkeeping and
        # the fence counter are updated at different instants)
        assert st.fence.stale_commits() <= straddled, (
            f"fence counted {st.fence.stale_commits()} stale commits but "
            f"only {straddled} straddled the steal"
        )
        assert decided == 2, f"a write was neither committed nor refused ({decided}/2)"
        # the steal always lands; once anything has observed it, every
        # subsequent check must refuse — probe it
        assert st.fence.observe(peek(st.lease).epoch), "deposition not visible"
        try:
            st.writer.check("writeback.probe")
        except StaleEpochError:
            pass
        else:
            raise AssertionError("check passed after deposition was observed")

    return Scenario(
        name="fencing-steal-vs-writeback",
        setup=setup,
        threads=threads,
        invariant=invariant,
        final=final,
        description="lease steal vs. renewal observation vs. in-flight "
        "write-back: commits only at the held epoch, refusals are "
        "deterministic once deposition is visible, and the stale-commit "
        "witness never over-counts, on every interleaving",
    )


# ---------------------------------------------------------------------------
# 9. CommitGate: linearizable FIFO under speculate/conflict/abort/recommit
# ---------------------------------------------------------------------------


def _concurrent_commit_scenario() -> Scenario:
    """The concurrent admission engine's ordering contract
    (concurrent/commitgate.py): requests speculate against a
    seq-stamped basis in parallel, then commit strictly in ticket
    order.  Aborts (deadline expiry before the turn) must not stall the
    queue; a commit whose speculative basis moved must observe that at
    revalidation (conflict → re-solve) — never consume the stale
    verdict.  FIFO among committed requests is the linearizability the
    scenario proves over every explored interleaving."""
    from ..concurrent.commitgate import CommitGate
    from .modelcheck import CoopEvent

    @guarded_by("_lock", "basis_seq", "commit_log", "aborted")
    class State:
        def __init__(self):
            # CoopEvent so a parked turn stays visible to the
            # cooperative scheduler (a raw Event.wait would read as a
            # stuck schedule)
            self.gate = CommitGate(event_factory=CoopEvent)
            self._lock = threading.Lock()
            # the shared basis, stood in by its ChangeFeed sequence:
            # success-shaped commits bump it (the reservation
            # write-back); refusals leave it alone
            self.basis_seq = 0
            self.commit_log: List[tuple] = []  # (ticket, reason), commit order
            self.aborted: List[int] = []

    def setup():
        return State()

    def threads(st: State):
        def request(abort: bool, mutates: bool):
            ticket = st.gate.ticket()
            committed = False
            try:
                # the speculative solve: an off-lock snapshot read of
                # the basis, concurrent with every other request's
                with st._lock:
                    racecheck.note_access(st, "basis_seq")
                    spec_seq = st.basis_seq
                checkpoint("speculated")
                if abort:
                    # deadline expired before the turn: retire without
                    # committing — later tickets must skip this one
                    with st._lock:
                        racecheck.note_access(st, "aborted")
                        st.aborted.append(ticket)
                    return
                st.gate.await_turn(ticket)
                # the commit: revalidate the speculation against the
                # then-current basis — O(1) seq check, conflict → re-solve
                with st._lock:
                    racecheck.note_access(st, "basis_seq")
                    racecheck.note_access(st, "commit_log")
                    reason = "seq-hit" if st.basis_seq == spec_seq else "conflict"
                    st.commit_log.append((ticket, reason))
                    if mutates:
                        st.basis_seq += 1
                committed = True
            finally:
                st.gate.retire(ticket, committed)

        return [
            ("commit-a", lambda: request(False, True)),
            ("commit-b", lambda: request(False, False)),
            ("abort-c", lambda: request(True, False)),
            ("commit-d", lambda: request(False, True)),
        ]

    def invariant(st: State):
        with st._lock:
            log = list(st.commit_log)
        tickets = [t for t, _ in log]
        assert tickets == sorted(tickets), (
            f"commits out of FIFO ticket order: {tickets}"
        )

    def final(st: State):
        with st._lock:
            log = list(st.commit_log)
            aborted = list(st.aborted)
        tickets = [t for t, _ in log]
        assert tickets == sorted(tickets), f"final order not FIFO: {tickets}"
        assert len(log) == 3, f"expected 3 commits, got {log}"
        assert len(aborted) == 1, f"expected 1 abort, got {aborted}"
        assert not set(tickets) & set(aborted), "a ticket both committed and aborted"
        stats = st.gate.stats()
        assert stats["committed"] == 3 and stats["aborted"] == 1
        assert stats["head"] == stats["issued"] == 4, (
            f"gate head did not drain: {stats}"
        )

    return Scenario(
        name="concurrent-commit-fifo",
        setup=setup,
        threads=threads,
        invariant=invariant,
        final=final,
        description="speculate/conflict/abort/recommit through the "
        "commit gate: commits land strictly in ticket order, aborts "
        "never stall the queue, and the gate drains to head==issued on "
        "every interleaving",
    )


# ---------------------------------------------------------------------------
# 10. ClassIndex: concurrent class rebuild vs. the digest warm check
# ---------------------------------------------------------------------------


def _class_rebuild_scenario() -> Scenario:
    """The class-digest warm tier rests on two ClassIndex properties
    under concurrency: *unchanged class revision ⟹ unchanged class
    multiset* (the delta-solve invalidation key never lies), and the
    incrementally maintained index equals a from-scratch rebuild of the
    authoritative rows at every instant — so a rebuild racing a
    warm-checking reader can never expose a divergent partition.  Both
    (rev, content) reads happen under the mirror lock, exactly
    TensorSnapshotCache.snapshot()'s discipline."""
    from ..state.classindex import ClassIndex

    big = np.array([8000, 16 << 30, 0], dtype=np.int64)
    small = np.array([4000, 8 << 30, 0], dtype=np.int64)
    zero = np.zeros(3, dtype=np.int64)

    @guarded_by("_lock", "rows")
    class Holder:
        """Authoritative rows + the incremental index, one lock — the
        tensor mirror's discipline in miniature."""

        def __init__(self):
            self._lock = threading.RLock()
            self.classes = ClassIndex()
            # slot -> (alloc, usage)
            self.rows = {}
            for slot, alloc in ((0, big), (1, big), (2, small)):
                note(self, slot, alloc, zero)

        def snap(self):
            """(rev, digest, class multiset) as ONE consistent triple."""
            with self._lock:
                return (
                    self.classes.class_rev,
                    self.classes.digest,
                    self.classes.class_sizes(),
                )

    def note(holder: Holder, slot, alloc, usage):
        with holder._lock:
            racecheck.note_access(holder, "rows")
            holder.rows[slot] = (alloc, usage)
            holder.classes.note_node(
                slot, f"n{slot}", alloc, usage, zero, 0, True, False,
                labels={},
            )

    def rebuild(holder: Holder):
        """From-scratch partition of the current authoritative rows
        (what a cold class rebuild computes), plus the incremental
        index's answer at the same instant."""
        with holder._lock:
            racecheck.note_access(holder, "rows")
            fresh = ClassIndex()
            for slot, (alloc, usage) in holder.rows.items():
                fresh.note_node(
                    slot, f"n{slot}", alloc, usage, zero, 0, True,
                    False, labels={},
                )
            return fresh.class_sizes(), holder.classes.class_sizes()

    class State:
        def __init__(self):
            self.holder = Holder()

    def setup():
        return State()

    def threads(st: State):
        def key_churner():
            # slot 1 migrates between classes: every move MUST bump rev
            note(st.holder, 1, small, zero)
            note(st.holder, 1, big, zero)

        def usage_churner():
            # content-only churn on slot 2: digest flips and cancels,
            # rev must never move on its account
            used = zero.copy()
            used[0] = 100
            note(st.holder, 2, small, used)
            note(st.holder, 2, small, zero)

        def warm_reader():
            rev1, dig1, sizes1 = st.holder.snap()
            checkpoint("warm-window")
            rev2, dig2, sizes2 = st.holder.snap()
            if rev2 == rev1:
                assert sizes2 == sizes1, (
                    f"rev unchanged ({rev1}) but the class multiset "
                    f"moved {sizes1} → {sizes2}: warm tier unsound"
                )
            if dig2 == dig1:
                # digest covers a superset of the multiset: equal digest
                # must come with an equal partition too
                assert sizes2 == sizes1, (
                    f"digest unchanged but multiset moved "
                    f"{sizes1} → {sizes2}"
                )

        def rebuilder():
            fresh, incremental = rebuild(st.holder)
            assert fresh == incremental, (
                f"incremental index diverged from a cold rebuild: "
                f"{incremental} vs {fresh}"
            )

        return [
            ("key-churn", key_churner),
            ("usage-churn", usage_churner),
            ("warm-a", warm_reader),
            ("rebuild", rebuilder),
        ]

    def invariant(st: State):
        fresh, incremental = rebuild(st.holder)
        assert fresh == incremental, (
            f"incremental {incremental} != rebuilt {fresh}"
        )

    def final(st: State):
        rev, _, sizes = st.holder.snap()
        # both churners restored their slots: back to the initial
        # partition {big: 2, small: 1}, with the rev recording that the
        # multiset was disturbed along the way
        assert sorted(sizes.values()) == [1, 2], sizes
        assert rev >= 2, f"key churn never bumped the revision: {rev}"

    return Scenario(
        name="class-rebuild-warm-check",
        setup=setup,
        threads=threads,
        invariant=invariant,
        final=final,
        description="unchanged class revision implies an unchanged class "
        "multiset on every interleaving of key churn, usage churn, and a "
        "concurrent from-scratch rebuild (the class-digest warm-tier "
        "axiom)",
    )


def corpus(device: DeviceLike = None) -> List[Scenario]:
    dev = resolve_device(device)
    return [
        _changefeed_scenario(),
        _mirror_warm_check_scenario(),
        _journal_scenario(),
        _gate_scenario(),
        _engine_scenario(),
        _sampler_scenario(dev),
        _preemption_scenario(),
        _fencing_scenario(),
        _concurrent_commit_scenario(),
        _class_rebuild_scenario(),
    ]
