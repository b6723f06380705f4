"""The port's race detectors (analysis/racecheck.py: Eraser lockset +
happens-before vector clocks + the lock-order graph) against the JAX
package's, and the port's ``@guarded_by`` declarations against the
reference's.

The cases of the reference's tests/test_racecheck.py run on the port's
detector: a seeded race in a fixture class is caught by both detectors,
the lock-disciplined twin stays clean, lock-order cycles are recorded,
and the two detectors disagree in exactly the documented directions.
The same seeded scenarios run through both packages' detectors (one at a
time, never both active) give the same report kinds and counts.  Every
guarded class of a ported module declares the reference's lock and
fields, every field a port ``note_access`` names is declared, and a
harness sequence with the capacity sampler, the lifecycle ledger and
the write-back workers live runs clean under the port's detector."""

import ast
import importlib
import os
import threading
import time

import numpy as np
import pytest

from k8s_spark_scheduler_tpu.analysis import guarded as jax_guarded
from k8s_spark_scheduler_tpu.analysis import racecheck as jax_racecheck
from k8s_spark_scheduler_tpu_torch.analysis import guarded as port_guarded
from k8s_spark_scheduler_tpu_torch.analysis import racecheck
from k8s_spark_scheduler_tpu_torch.analysis.guarded import guarded_by, guarded_fields
from k8s_spark_scheduler_tpu_torch.metrics import names as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG = os.path.join(REPO, "k8s_spark_scheduler_tpu")
PORT_PKG = os.path.join(REPO, "k8s_spark_scheduler_tpu_torch")


def _fixtures(guarded_by, rc):
    """(RacyCounter, SafeCounter, LockHolder) decorated with one
    package's ``guarded_by`` and instrumented through its racecheck."""

    @guarded_by("_lock", "counts")
    class RacyCounter:
        """Deliberately buggy: declares the guard but never takes it."""

        def __init__(self):
            self._lock = threading.Lock()
            self.counts = {}

        def bump(self, key):
            rc.note_access(self, "counts")
            value = self.counts.get(key, 0)
            self.counts[key] = value + 1

    @guarded_by("_lock", "counts")
    class SafeCounter:
        def __init__(self):
            self._lock = threading.Lock()
            self.counts = {}

        def bump(self, key):
            with self._lock:
                rc.note_access(self, "counts")
                value = self.counts.get(key, 0)
                self.counts[key] = value + 1

    @guarded_by("_lock")
    class LockHolder:
        def __init__(self):
            self._lock = threading.RLock()

    return RacyCounter, SafeCounter, LockHolder


RacyCounter, SafeCounter, LockHolder = _fixtures(guarded_by, racecheck)


@pytest.fixture
def detector():
    assert not jax_racecheck.active(), "never run both packages' detectors at once"
    det = racecheck.enable(racecheck.RaceDetector())
    try:
        yield det
    finally:
        racecheck.disable()


def _hammer(*counters, threads=4, iters=300):
    def work():
        for _ in range(iters):
            for c in counters:
                c.bump("k")

    ts = [threading.Thread(target=work, name=f"hammer-{i}") for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def test_seeded_race_is_caught_and_safe_twin_is_clean(detector):
    racy, safe = RacyCounter(), SafeCounter()
    _hammer(racy, safe)
    racy_reports = [r for r in detector.races if "RacyCounter" in r.owner]
    safe_reports = [r for r in detector.races if "SafeCounter" in r.owner]
    assert racy_reports, "the seeded race went undetected"
    assert racy_reports[0].field == "counts"
    assert len(racy_reports[0].threads) >= 2
    assert safe_reports == [], "lock-disciplined writes misreported as a race"


def test_single_threaded_unlocked_writes_are_not_races(detector):
    racy = RacyCounter()
    for _ in range(100):
        racy.bump("k")
    assert detector.races == []  # Eraser's exclusive state: one thread only


def test_lock_order_cycle_recorded(detector):
    a, b = LockHolder(), LockHolder()
    with a._lock:
        with b._lock:
            pass
    assert detector.lock_order_violations == []
    with b._lock:
        with a._lock:
            pass
    assert len(detector.lock_order_violations) == 1
    assert "LockHolder._lock" in str(detector.lock_order_violations[0])
    assert not detector.clean()


def test_rlock_reentrancy_does_not_self_cycle(detector):
    a = LockHolder()
    with a._lock:
        with a._lock:
            pass
    assert detector.lock_order_violations == []
    # the held set is empty again afterwards
    assert detector.held_lock_names() == frozenset()


def test_note_access_is_noop_when_disabled():
    assert not racecheck.active()
    racy = RacyCounter()
    _hammer(racy, threads=2, iters=50)  # must not blow up or record anything


def test_instances_created_before_enable_are_skipped(detector):
    # construct with the detector DISABLED: its lock is untracked and
    # its accesses must be ignored rather than misreported as lock-free
    racecheck.disable()
    stale = SafeCounter()
    racecheck.enable(detector)
    _hammer(stale, threads=2, iters=50)
    assert detector.races == []


def test_instances_from_another_detector_are_skipped(detector):
    # instrument under detector A, then judge under a fresh detector B:
    # A's tracked lock reports to A's held stacks, so B must skip the
    # instance entirely rather than see correctly-locked writes as
    # lock-free
    safe = SafeCounter()
    assert isinstance(safe._lock, racecheck.TrackedLock)
    fresh = racecheck.enable(racecheck.RaceDetector())
    try:
        _hammer(safe, threads=2, iters=50)
        assert fresh.races == []
    finally:
        racecheck.enable(detector)  # restore so the fixture disables it


def test_tracked_lock_locked_protocol(detector):
    holder = LockHolder()  # RLock-backed: no .locked() before Python 3.14
    assert holder._lock.locked() is False
    with holder._lock:
        assert holder._lock.locked() is True
    assert holder._lock.locked() is False


def test_guarded_registry_exposes_declarations():
    lock_attr, fields = guarded_fields(SafeCounter)
    assert lock_attr == "_lock"
    assert fields == ("counts",)
    assert guarded_fields(dict) == ("", ())


def test_tracked_lock_wraps_on_construction(detector):
    holder = LockHolder()
    assert isinstance(holder._lock, racecheck.TrackedLock)
    assert holder._schedlint_tracked
    # acquire/release protocol still works through the proxy
    assert holder._lock.acquire(blocking=False)
    holder._lock.release()


def test_report_lines_roundtrip(detector):
    racy = RacyCounter()
    _hammer(racy, threads=2)
    lines = detector.report_lines()
    assert any("unprotected shared write" in line for line in lines)


# -- happens-before (vector clock) detector -----------------------------------


def test_seeded_race_also_caught_by_hb_and_safe_twin_hb_clean(detector):
    racy, safe = RacyCounter(), SafeCounter()
    _hammer(racy, safe)
    assert any("RacyCounter" in r.owner for r in detector.hb_races), (
        "the vector-clock detector missed the seeded race"
    )
    assert not any("SafeCounter" in r.owner for r in detector.hb_races), (
        "lock-ordered writes misreported as an HB race"
    )


def _write_then_read(rc, holder):
    """A single writer and an unsynchronized reader, ordered in real
    time only (an Event, which is no happens-before edge)."""
    ready = threading.Event()

    def writer():
        rc.note_access(holder, "counts", write=True)
        holder.counts["k"] = 1
        ready.set()

    def reader():
        ready.wait()
        rc.note_access(holder, "counts", write=False)

    _run_pair(writer, reader, "w", "r")


def _channel_handoff(rc, holder):
    handed = threading.Event()

    def first_owner():
        rc.note_access(holder, "counts")
        holder.counts["k"] = 1
        rc.hb_publish("handoff")
        handed.set()

    def second_owner():
        handed.wait()
        rc.hb_observe("handoff")
        rc.note_access(holder, "counts")
        holder.counts["k"] = 2

    _run_pair(first_owner, second_owner, "owner-1", "owner-2")


def _handoff_snapshot(rc, holder, delivered: bool):
    handed = threading.Event()
    box = {}

    def producer():
        rc.note_access(holder, "counts")
        holder.counts["k"] = 1
        snapshot = rc.hb_snapshot()
        if delivered:
            box["snap"] = snapshot
        handed.set()

    def consumer():
        handed.wait()
        if delivered:
            rc.hb_join(box["snap"])
        rc.note_access(holder, "counts")
        holder.counts["k"] = 2

    _run_pair(producer, consumer, "producer", "consumer")


def _run_pair(first, second, n1, n2):
    t1 = threading.Thread(target=first, name=n1)
    t2 = threading.Thread(target=second, name=n2)
    t1.start()
    t2.start()
    t1.join()
    t2.join()


def test_unsynchronized_write_read_is_hb_race_but_lockset_silent(detector):
    """Eraser only reports on shared-MODIFIED, so a single writer with an
    unsynchronized reader is invisible to the lockset; the vector clocks
    see the unordered pair — the 'missed ordering race' class."""
    _write_then_read(racecheck, RacyCounter())
    assert detector.races == [], "lockset should not fire on write→read"
    assert len(detector.hb_races) == 1
    report = detector.hb_races[0]
    assert {report.first_write, report.second_write} == {True, False}
    assert "unordered with" in str(report)


def test_channel_handoff_is_hb_clean_but_lockset_noise(detector):
    """A publish/observe-synchronized handoff: two threads write the
    field with an empty lockset (Eraser false-positives) but the channel
    edge orders them (HB stays clean) — the 'handoff noise' class."""
    _channel_handoff(racecheck, RacyCounter())
    assert detector.hb_races == [], "\n".join(detector.report_lines())
    assert len(detector.races) == 1, (
        "the lockset is EXPECTED to false-positive here — if it stopped, "
        "the two detectors no longer bracket each other"
    )


def test_thread_start_join_edges_order_accesses(detector):
    """Parent-before-start and child-before-join accesses are ordered by
    the fork/join edges alone — no lock, no channel."""
    holder = RacyCounter()
    racecheck.note_access(holder, "counts")
    holder.counts["parent"] = 1

    def child():
        racecheck.note_access(holder, "counts")
        holder.counts["child"] = 1

    t = threading.Thread(target=child, name="child")
    t.start()
    t.join()
    racecheck.note_access(holder, "counts")
    holder.counts["parent"] = 2
    assert detector.hb_races == [], "\n".join(detector.report_lines())


def test_missing_join_edge_is_hb_race(detector):
    """The same parent/child shape WITHOUT the join edge: the parent's
    second write races the child's."""
    holder = RacyCounter()
    done = threading.Event()

    def child():
        racecheck.note_access(holder, "counts")
        holder.counts["child"] = 1
        done.set()

    t = threading.Thread(target=child, name="child")
    t.start()
    done.wait()  # real-time ordering only — no HB edge
    racecheck.note_access(holder, "counts")
    holder.counts["parent"] = 2
    t.join()
    assert len(detector.hb_races) == 1
    report = detector.hb_races[0]
    assert report.first_site is not None and report.second_site is not None
    assert "test_torch_racecheck" in str(report.first_site[0])


def test_hb_report_carries_both_access_sites(detector):
    racy = RacyCounter()
    _hammer(racy, threads=2, iters=100)
    assert detector.hb_races
    text = str(detector.hb_races[0])
    # both sites name this file and the mutating function
    assert text.count("test_torch_racecheck.py") == 2
    assert "bump" in text


def test_clean_includes_hb_races(detector):
    detector.hb_races.append(
        racecheck.HbRaceReport(
            owner="X#0", field="f",
            first_thread="a", first_site=None, first_write=True,
            second_thread="b", second_site=None, second_write=True,
        )
    )
    assert not detector.clean()
    assert any("happens-before race" in line for line in detector.report_lines())


def test_unjoined_threads_do_not_leak_fork_clocks(detector):
    """Thread.start stashes the parent's clock for the child; a child
    that never touches the detector and is never joined must not pin
    that copy forever (one such thread per HTTP connection)."""
    import gc

    threads = [threading.Thread(target=lambda: None, name=f"idle-{i}") for i in range(20)]
    for t in threads:
        t.start()
    deadline = 50
    while any(t.is_alive() for t in threads) and deadline:
        threading.Event().wait(0.02)
        deadline -= 1
    del threads, t  # never joined: the weak keying alone must reclaim the clocks
    gc.collect()
    assert len(detector._fork_vcs) == 0, f"{len(detector._fork_vcs)} fork clocks pinned for dead threads"


def test_failed_queue_handoff_plants_no_edge(detector):
    """hb_snapshot edges are carried inside the handed-off item: a
    snapshot that is dropped (a full shard) must not order the producer
    before any later consumer."""
    _handoff_snapshot(racecheck, RacyCounter(), delivered=False)
    assert len(detector.hb_races) == 1, "a dropped handoff snapshot must leave the accesses unordered"


def test_successful_handoff_snapshot_orders_consumer(detector):
    _handoff_snapshot(racecheck, RacyCounter(), delivered=True)
    assert detector.hb_races == [], "\n".join(detector.report_lines())


def test_lock_release_acquire_is_an_hb_edge(detector):
    """Two threads writing under DIFFERENT critical sections of the SAME
    lock are ordered — the HB detector must not fire even though the
    accesses interleave arbitrarily."""
    _hammer(SafeCounter(), threads=4, iters=200)
    assert detector.hb_races == [], "\n".join(detector.report_lines())


# -- both packages' detectors on the same scenarios ----------------------------


def _lock_cycle(rc, holders):
    a, b = holders
    with a._lock:
        with b._lock:
            pass
    with b._lock:
        with a._lock:
            pass


def _scenario_run(pkg_guarded_by, rc, seed):
    """Seeded scenarios through one package's detector: report counts
    per scenario as (lockset races, HB races, lock-order cycles)."""
    racy_cls, safe_cls, holder_cls = _fixtures(pkg_guarded_by, rc)
    rng = np.random.default_rng(seed)
    threads = int(rng.integers(2, 5))
    iters = int(rng.integers(50, 200))
    scenarios = {
        "hammer": lambda: _hammer(racy_cls(), safe_cls(), threads=threads, iters=iters),
        "safe": lambda: _hammer(safe_cls(), threads=threads, iters=iters),
        "write-read": lambda: _write_then_read(rc, racy_cls()),
        "channel": lambda: _channel_handoff(rc, racy_cls()),
        "handoff-dropped": lambda: _handoff_snapshot(rc, racy_cls(), delivered=False),
        "handoff": lambda: _handoff_snapshot(rc, racy_cls(), delivered=True),
        "cycle": lambda: _lock_cycle(rc, (holder_cls(), holder_cls())),
    }
    out = {}
    for name in sorted(scenarios, key=lambda _: rng.random()):
        det = rc.enable(rc.RaceDetector())
        try:
            scenarios[name]()
        finally:
            rc.disable()
        out[name] = (len(det.races), len(det.hb_races), len(det.lock_order_violations))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_detectors_of_both_packages_report_alike(seed):
    assert not racecheck.active() and not jax_racecheck.active()
    theirs = _scenario_run(jax_guarded.guarded_by, jax_racecheck, seed)
    ours = _scenario_run(guarded_by, racecheck, seed)
    assert ours == theirs
    assert ours["safe"] == (0, 0, 0) and ours["hammer"] == (1, 1, 0)
    # handoffs: lockset noise, HB-clean exactly when the edge was planted
    assert ours["channel"] == ours["handoff"] == (1, 0, 0)
    assert ours["handoff-dropped"] == (1, 1, 0) and ours["write-read"] == (0, 1, 0)
    assert ours["cycle"] == (0, 0, 1)


# -- the declarations ----------------------------------------------------------

# fields the port's class declares differently from the reference's class
# of the same name, with the reason
DECLARATION_DIFFERENCES = {
    # the reference's note_access sites name _slots, but its declaration
    # is @guarded_by("_lock") alone; the port declares what it notes
    "ClassIndex": ("_lock", ("_slots",)),
}


def _guarded_modules(pkg_dir):
    """Relative module paths of ``pkg_dir`` whose source declares a
    ``@guarded_by`` class."""
    out = set()
    for root, _, names in os.walk(pkg_dir):
        for n in names:
            if n.endswith(".py"):
                path = os.path.join(root, n)
                with open(path) as f:
                    if "\n@guarded_by(" in f.read():
                        out.add(os.path.relpath(path, pkg_dir)[:-3].replace(os.sep, "."))
    return out


def _declared(package, modules, registry):
    mods = {importlib.import_module(f"{package}.{m}") for m in modules}
    return {
        cls.__name__: decl
        for cls, decl in registry().items()
        if importlib.import_module(cls.__module__) in mods
    }


def test_port_declares_the_reference_guards():
    """Every @guarded_by class of a module the port has is declared in
    the port's module of the same path with the same lock attribute and
    fields, the listed differences aside."""
    ref_modules = _guarded_modules(REF_PKG)
    port_modules = _guarded_modules(PORT_PKG)
    shared = {m for m in ref_modules if os.path.exists(os.path.join(PORT_PKG, *m.split(".")) + ".py")}
    # the port declares in every module it shares with the reference
    assert shared <= port_modules, sorted(shared - port_modules)
    theirs = _declared("k8s_spark_scheduler_tpu", shared, jax_guarded.registry)
    ours = _declared("k8s_spark_scheduler_tpu_torch", port_modules, port_guarded.registry)
    assert set(ours) == set(theirs), (sorted(set(ours) - set(theirs)), sorted(set(theirs) - set(ours)))
    assert len(ours) >= 37
    for name, decl in sorted(ours.items()):
        assert decl == DECLARATION_DIFFERENCES.get(name, theirs[name]), name
    for name, decl in DECLARATION_DIFFERENCES.items():
        assert theirs[name] != decl, f"{name} no longer differs: drop it from the list"


def _note_access_sites():
    """(module, class name, field) of every ``racecheck.note_access(self,
    "<field>")`` in the port, by the class it sits in."""
    sites = []
    for root, _, names in os.walk(PORT_PKG):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(root, n)
            with open(path) as f:
                tree = ast.parse(f.read())
            module = "k8s_spark_scheduler_tpu_torch." + os.path.relpath(path, PORT_PKG)[:-3].replace(os.sep, ".")
            for cls in (node for node in ast.walk(tree) if isinstance(node, ast.ClassDef)):
                for call in (node for node in ast.walk(cls) if isinstance(node, ast.Call)):
                    fn = call.func
                    if (
                        isinstance(fn, ast.Attribute)
                        and fn.attr == "note_access"
                        and isinstance(fn.value, ast.Name)
                        and fn.value.id == "racecheck"
                    ):
                        assert isinstance(call.args[1], ast.Constant), (module, cls.name)
                        sites.append((module, cls.name, call.args[1].value))
    return sites


def test_every_noted_field_is_declared():
    sites = _note_access_sites()
    assert len(sites) >= 80
    for module, cls_name, field in sites:
        cls = getattr(importlib.import_module(module), cls_name)
        lock_attr, fields = guarded_fields(cls)
        assert lock_attr, (module, cls_name)
        assert field in fields, (module, cls_name, field)


def test_hb_channels_are_restored():
    """The change feed and the event log publish their wakeup edges on
    a per-instance channel, as in the reference."""
    from k8s_spark_scheduler_tpu_torch.events.events import EventLog
    from k8s_spark_scheduler_tpu_torch.state.store import ChangeFeed

    for make in (ChangeFeed, EventLog):
        a, b = make(), make()
        assert a.hb_channel() != b.hb_channel()
        assert a.hb_channel()[0] == make().hb_channel()[0]


# -- the server under the detector --------------------------------------------


def test_harness_sequence_runs_clean_under_the_detector(monkeypatch):
    """A Filter / bind / terminate sequence with the capacity sampler,
    the lifecycle ledger and the five write-back workers live, a
    write-back outage journaled and recovered, and a sample and a drain
    on demand: 0 lockset races, 0 happens-before races, 0 lock-order
    cycles (the counterpart of the reference's chaos-sim run)."""
    from k8s_spark_scheduler_tpu_torch.kube.errors import APIError
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    assert not jax_racecheck.active()
    monkeypatch.setenv(racecheck.ENV_FLAG, "1")
    racecheck.disable()
    h = None
    try:
        h = Harness(binpack_algo="tpu-batch", device="cpu")
        assert racecheck.active()
        names = [f"n{i}" for i in range(4)]
        for i, name in enumerate(names):
            h.new_node(name, cpu="16", memory="32Gi", zone=f"z{i % 2}")
        t0 = time.time()
        apps = [h.static_allocation_spark_pods(f"app{k}", 2, creation_timestamp=t0 - 100 + k) for k in range(5)]
        for pods in apps:
            for pod in pods:
                assert h.schedule(pod, names).node_names
        h.create_pod(h.static_allocation_spark_pods("queued", 500, creation_timestamp=t0 - 50)[0])
        big = h.static_allocation_spark_pods("big", 300, creation_timestamp=t0)[0]
        h.create_pod(big)
        for _ in range(3):
            assert not h.schedule(big, names).node_names
        h.api.set_write_fault(lambda op, kind, ns, name: APIError("down") if kind == "ResourceReservation" else None)
        late = h.static_allocation_spark_pods("late", 1, creation_timestamp=t0 - 60)
        assert h.schedule(late[0], names).node_names
        h.api.set_write_fault(None)
        h.server.resource_reservation_cache.nudge_recovery(force=True)
        kit = h.server.resilience
        assert h.wait_for_api(lambda: kit.journal.depth() == 0)
        for pods in apps[:2]:
            h.terminate_pod(pods[0])
        h.wait_quiesced()
        h.server.capacity.sample_now(trigger="test")
        h.server.lifecycle.drain(trigger="test")
        h.server.reporters.report_once()
        # the reporters' tick drained the predicate lock's holds (one a
        # Filter, none under a span: called directly) into the registry
        hist = h.server.metrics.get_histogram(M.LOCK_HOLD_TIME, {M.TAG_LOCK: "extender.predicate", M.TAG_PHASE: "-"})
        assert hist["count"] >= 19 and not h.server.extender._predicate_lock._pending_hold
    finally:
        if h is not None:
            h.close()
        detector = racecheck.disable()
    assert detector is not None
    assert detector.races == [] and detector.hb_races == [], "\n".join(detector.report_lines())
    assert detector.lock_order_violations == [], "\n".join(detector.report_lines())
    assert len(detector._instances) > 30  # the server's guarded singletons were tracked
