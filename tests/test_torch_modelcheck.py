"""The port's model checker against the reference's.

The seeded bugs of tests/test_modelcheck.py (a lost wakeup, a TOCTOU on a
feed-sequence warm check, an unlock-before-publish reordering) are built
from one factory, once with each package's primitives (its model
checker, race detector and ``@guarded_by``).  For the same seed and
budget the port's ``explore`` must return the same schedule count and the
same counterexample decision sequence as the reference's, ``replay``
must reproduce it, and the fixed twins must be clean in both.  The port's
scenario corpus (``corpus(device="cpu")``) holds the reference's ten
scenarios, each clean at the reference's tier-1 budget with the same
schedules and decisions.  The rest mirrors the reference's own cases.
"""

import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import pytest
import torch

from k8s_spark_scheduler_tpu.analysis import guarded as ref_guarded
from k8s_spark_scheduler_tpu.analysis import modelcheck as ref_mc
from k8s_spark_scheduler_tpu.analysis import racecheck as ref_racecheck
from k8s_spark_scheduler_tpu.analysis.mcscenarios import corpus as ref_corpus
from k8s_spark_scheduler_tpu_torch.analysis import guarded
from k8s_spark_scheduler_tpu_torch.analysis import modelcheck as mc
from k8s_spark_scheduler_tpu_torch.analysis import racecheck
from k8s_spark_scheduler_tpu_torch.analysis.guarded import guarded_by
from k8s_spark_scheduler_tpu_torch.analysis.mcscenarios import corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUDGET = 300  # schedules; each seeded bug must fall well inside this

PORT = SimpleNamespace(mc=mc, racecheck=racecheck, guarded_by=guarded.guarded_by)
REFERENCE = SimpleNamespace(mc=ref_mc, racecheck=ref_racecheck, guarded_by=ref_guarded.guarded_by)


# ---------------------------------------------------------------------------
# the seeded bugs of tests/test_modelcheck.py, over either package
# ---------------------------------------------------------------------------


def _lost_wakeup_scenario(pkg, buggy: bool):
    class State:
        def __init__(self):
            self.pulse = pkg.mc.CoopPulse()
            self.event = pkg.mc.CoopEvent()
            self.ready = False

    def setup():
        return State()

    def threads(st):
        def producer():
            st.ready = True
            pkg.mc.checkpoint("produced")
            st.pulse.notify()
            st.event.set()

        def consumer():
            ready = st.ready
            pkg.mc.checkpoint("checked")  # the check→wait window
            if not ready:
                if buggy:
                    # a pulse carries no memory: a notify that fired in
                    # the window is lost and this waits forever
                    st.pulse.wait()
                else:
                    # sticky event: set-before-wait still wakes
                    st.event.wait()

        return [("producer", producer), ("consumer", consumer)]

    return pkg.mc.Scenario(
        name="lost-wakeup" + ("-buggy" if buggy else "-fixed"),
        setup=setup, threads=threads,
    )


def _toctou_scenario(pkg, buggy: bool):
    """A versioned mirror: (data, seq) move in lockstep under one lock.
    The buggy reader checks the sequence in one lock hold and reads the
    data in another — the delta-solve warm check done wrong."""

    @pkg.guarded_by("_lock", "data", "seq")
    class Mirror:
        def __init__(self):
            self._lock = threading.Lock()
            self.data = 0
            self.seq = 0

        def mutate(self):
            with self._lock:
                pkg.racecheck.note_access(self, "data")
                self.data += 1
                self.seq += 1

        def read_pair(self):
            with self._lock:
                return self.data, self.seq

        def read_seq(self):
            with self._lock:
                return self.seq

    class State:
        def __init__(self):
            self.mirror = Mirror()

    def setup():
        return State()

    def threads(st):
        def writer():
            st.mirror.mutate()

        def warm_reader():
            data1, seq1 = st.mirror.read_pair()
            pkg.mc.checkpoint("warm-window")
            if buggy:
                # TOCTOU: seq checked in one critical section …
                seq2 = st.mirror.read_seq()
                pkg.mc.checkpoint("between-check-and-use")
                if seq2 == seq1:
                    # … data used from another: the writer can slip in
                    data2, _ = st.mirror.read_pair()
                    assert data2 == data1, (
                        f"warm check unsound: seq {seq1} unchanged but "
                        f"data {data1}→{data2}"
                    )
            else:
                data2, seq2 = st.mirror.read_pair()
                if seq2 == seq1:
                    assert data2 == data1

        return [("writer", writer), ("reader", warm_reader)]

    return pkg.mc.Scenario(
        name="feed-toctou" + ("-buggy" if buggy else "-fixed"),
        setup=setup, threads=threads,
    )


def _publish_reorder_scenario(pkg, buggy: bool):
    @pkg.guarded_by("_lock", "items", "seq")
    class Ring:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = []
            self.seq = 0

        def publish_buggy(self, x):
            # BUG: the sequence is published in one critical section,
            # the item lands in a second — a reader between them sees
            # seq=N with N-1 items
            with self._lock:
                pkg.racecheck.note_access(self, "seq")
                self.seq += 1
            with self._lock:
                pkg.racecheck.note_access(self, "items")
                self.items.append(x)

        def publish_ok(self, x):
            with self._lock:
                pkg.racecheck.note_access(self, "items")
                self.items.append(x)
                self.seq += 1

        def read(self):
            with self._lock:
                return self.seq, len(self.items)

    class State:
        def __init__(self):
            self.ring = Ring()

    def setup():
        return State()

    def threads(st):
        def writer():
            if buggy:
                st.ring.publish_buggy("a")
            else:
                st.ring.publish_ok("a")

        def reader():
            seq, n = st.ring.read()
            assert n >= seq, f"seq {seq} published but only {n} items"

        return [("writer", writer), ("reader", reader)]

    return pkg.mc.Scenario(
        name="publish-reorder" + ("-buggy" if buggy else "-fixed"),
        setup=setup, threads=threads,
    )



SEEDED = {
    "lost-wakeup": (_lost_wakeup_scenario, 3, ("deadlock", "pulse-wait")),
    "feed-toctou": (_toctou_scenario, 5, ("warm check unsound",)),
    "publish-reorder": (_publish_reorder_scenario, 11, ("published but only",)),
}


@pytest.fixture(autouse=True)
def _no_detector_left_on():
    """Never both packages' detectors at once, and none left behind."""
    assert not racecheck.active() and not ref_racecheck.active()
    yield
    assert not racecheck.active() and not ref_racecheck.active()


@pytest.mark.parametrize("bug", sorted(SEEDED))
def test_seeded_bug_counterexample_equals_the_reference(bug):
    factory, seed, words = SEEDED[bug]
    ours = mc.explore(factory(PORT, True), max_schedules=_BUDGET, seed=seed)
    theirs = ref_mc.explore(factory(REFERENCE, True), max_schedules=_BUDGET, seed=seed)
    assert ours.violation is not None, f"{bug} survived the port's exploration"
    assert theirs.violation is not None
    for word in words:
        assert word in ours.violation.reason
    assert ours.schedules == theirs.schedules <= _BUDGET
    assert ours.decisions == theirs.decisions
    assert ours.violation.schedule == theirs.violation.schedule
    assert ours.violation.schedule_index == theirs.violation.schedule_index
    assert ours.violation.reason == theirs.violation.reason
    assert ours.violation.trace == theirs.violation.trace
    # the recorded schedule replays to the same failure, in both packages
    replayed = mc.replay(factory(PORT, True), ours.violation.schedule)
    assert replayed is not None and replayed.schedule == ours.violation.schedule
    assert replayed.reason == ours.violation.reason
    ref_replayed = ref_mc.replay(factory(REFERENCE, True), ours.violation.schedule)
    assert ref_replayed is not None and ref_replayed.schedule == replayed.schedule


@pytest.mark.parametrize("bug", sorted(SEEDED))
def test_seeded_bug_fixed_twin_is_clean_in_both(bug):
    factory, seed, _ = SEEDED[bug]
    ours = mc.explore(factory(PORT, False), max_schedules=_BUDGET, seed=seed)
    theirs = ref_mc.explore(factory(REFERENCE, False), max_schedules=_BUDGET, seed=seed)
    assert ours.ok, str(ours.violation)
    assert theirs.ok, str(theirs.violation)
    assert (ours.schedules, ours.decisions) == (theirs.schedules, theirs.decisions)


def test_counterexamples_are_deterministic_and_replayable():
    for factory, seed, _ in SEEDED.values():
        a = mc.explore(factory(PORT, True), max_schedules=_BUDGET, seed=seed)
        b = mc.explore(factory(PORT, True), max_schedules=_BUDGET, seed=seed)
        assert a.violation is not None and b.violation is not None
        assert a.violation.schedule == b.violation.schedule
        assert a.violation.schedule_index == b.violation.schedule_index


def test_counterexample_carries_a_trace():
    res = mc.explore(_publish_reorder_scenario(PORT, True), max_schedules=_BUDGET, seed=11)
    assert res.violation is not None
    text = str(res.violation)
    assert "schedule:" in text
    assert any("run writer" in line for line in res.violation.trace)
    assert any("run reader" in line for line in res.violation.trace)


def test_schedule_level_race_detection_fires():
    @guarded_by("_lock", "count")
    class Racy:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0

        def bump(self):
            racecheck.note_access(self, "count")
            self.count += 1
            mc.checkpoint("unlocked-bump")

    def setup():
        return Racy()

    def threads(racy):
        return [("a", racy.bump), ("b", racy.bump)]

    res = mc.explore(mc.Scenario(name="racy", setup=setup, threads=threads), max_schedules=50, seed=1)
    assert res.violation is not None
    assert "race detected" in res.violation.reason


def test_lock_taking_invariant_does_not_mask_races():
    """The orchestrator runs invariants under a quarantine: its lock
    traffic must not thread the scenario threads' vector clocks through
    component locks (the port's racecheck has the reference's
    quarantine and extra-lock tracking)."""

    @guarded_by("_lock", "value")
    class Holder:
        def __init__(self):
            self._lock = threading.Lock()
            self.other = threading.Lock()
            self.value = 0

    def setup():
        h = Holder()
        racecheck.track_extra_lock(h, "other")
        return h

    def threads(h):
        def writer():
            racecheck.note_access(h, "value")  # unguarded write
            h.value = 1
            with h._lock:
                pass

        def reader():
            with h.other:
                pass
            racecheck.note_access(h, "value", write=False)  # unguarded read

        return [("writer", writer), ("reader", reader)]

    def lock_taking_invariant(h):
        with h._lock:
            pass
        with h.other:
            pass

    sc = mc.Scenario(name="invariant-quarantine", setup=setup, threads=threads, invariant=lock_taking_invariant)
    res = mc.explore(sc, max_schedules=100, seed=2)
    assert res.violation is not None, "the race was masked by the invariant's lock traffic"
    assert "race detected" in res.violation.reason


def test_detector_restored_after_runs():
    prior = racecheck.enable(racecheck.RaceDetector())
    try:
        mc.explore(_lost_wakeup_scenario(PORT, False), max_schedules=10, seed=1)
        assert racecheck.get() is prior
    finally:
        racecheck.disable()


def test_sched_hook_is_cleared_after_runs():
    mc.explore(_toctou_scenario(PORT, False), max_schedules=5, seed=1)
    assert racecheck._sched_hook is None


# ---------------------------------------------------------------------------
# the component corpus, at the reference's tier-1 budget
# ---------------------------------------------------------------------------


# built in the tests, not at collection: each build defines the scenarios'
# guarded fixture classes anew
SCENARIOS = (
    "changefeed-publish-wakeup", "mirror-seq-warm-check", "journal-divert-replay", "admission-gate",
    "deltasolve-eviction", "capacity-sampler-freshen", "preemption-commit-vs-recover",
    "fencing-steal-vs-writeback", "concurrent-commit-fifo", "class-rebuild-warm-check",
)


def _scenario(name, package_corpus=None):
    scenarios = package_corpus() if package_corpus else corpus(device="cpu")
    return next(s for s in scenarios if s.name == name)


def test_corpus_names_are_the_references():
    assert tuple(s.name for s in corpus(device="cpu")) == tuple(s.name for s in ref_corpus()) == SCENARIOS


@pytest.mark.parametrize("name", SCENARIOS)
def test_component_corpus_clean_at_tier1_budget(name):
    res = mc.explore(_scenario(name), max_schedules=120, seed=7)
    assert res.ok, str(res.violation)
    assert res.schedules == 120
    assert res.decisions > 0


@pytest.mark.parametrize("name", ["changefeed-publish-wakeup", "journal-divert-replay", "admission-gate",
                                  "deltasolve-eviction", "capacity-sampler-freshen"])
def test_component_scenarios_interleave_like_the_reference(name):
    """Same components, same preemption points: the same number of
    scheduling decisions over the same schedules."""
    a = mc.explore(_scenario(name), max_schedules=40, seed=7)
    b = ref_mc.explore(_scenario(name, ref_corpus), max_schedules=40, seed=7)
    assert a.ok and b.ok
    assert (a.schedules, a.decisions) == (b.schedules, b.decisions)


def test_corpus_places_the_sampler_on_the_device():
    sampler = _scenario("capacity-sampler-freshen").setup().sampler
    assert sampler.device.type == "cpu"
    if torch.cuda.is_available():
        assert corpus()[5].setup().sampler.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            corpus()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_via_python_dash_m_subprocess():
    """``python -m …analysis.modelcheck`` loads modelcheck twice (as
    __main__ and canonically); the run registry lives on racecheck, so
    the real CLI passes quickly."""
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_spark_scheduler_tpu_torch.analysis.modelcheck",
         "--schedules", "30", "--seed", "7", "--device", "cpu",
         "--scenario", "changefeed-publish-wakeup"],
        capture_output=True, text=True, timeout=240, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ok" in proc.stdout


def test_cli_runs_one_scenario(capsys, tmp_path):
    import json

    out = tmp_path / "mc.json"
    rc = mc.main(["--schedules", "40", "--seed", "7", "--device", "cpu",
                  "--scenario", "admission-gate", "--json", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "admission-gate" in text and "ok" in text
    doc = json.loads(out.read_text())
    assert doc["results"][0]["scenario"] == "admission-gate" and doc["results"][0]["ok"]
    assert mc.main(["--device", "cpu", "--scenario", "no-such-scenario"]) == 2


def test_cli_defaults_to_cuda():
    argv = ["--schedules", "1", "--scenario", "admission-gate"]
    if torch.cuda.is_available():
        assert mc.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mc.main(argv)
