"""The port's crash-point injection and recovery matrix (ha/crashpoint,
ha/crashmatrix) against the reference's tests/test_ha_crashpoints.py,
and each matrix cell against the JAX package's.

The registry cases, the reference's representative subset and its three
speculation→commit window cases run on the port's server stack on
``device="cpu"``: kill -9 at the armed point, cold-restart a successor on
the same API server and journal files, audit invariants and exactly-once
intent delivery.  Then every one of the thirteen points runs through both
packages' matrices, each with its concurrent admission engine on, and
the two reports must be equal (a cell's report holds no timing)."""

import pytest

from k8s_spark_scheduler_tpu.ha import crashpoint as jax_crashpoint
from k8s_spark_scheduler_tpu.ha.crashmatrix import CrashMatrix as JaxCrashMatrix
from k8s_spark_scheduler_tpu_torch.ha import crashpoint
from k8s_spark_scheduler_tpu_torch.ha.crashmatrix import PORTED_POINTS, CrashMatrix
from k8s_spark_scheduler_tpu_torch.ha.crashpoint import SimulatedCrash

# a SimulatedCrash killing an async worker thread is the scenario under
# test, not a leak
pytestmark = pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")


@pytest.fixture(autouse=True)
def _disarmed():
    crashpoint.disarm()
    jax_crashpoint.disarm()
    yield
    crashpoint.disarm()
    jax_crashpoint.disarm()


class BinpackJaxCrashMatrix(JaxCrashMatrix):
    """The reference's matrix (its concurrent admission engine on, as in
    the port's cells) under ``binpack_algo``."""

    def __init__(self, binpack_algo: str = "tightly-pack", **kw):
        super().__init__(**kw)
        self.binpack_algo = binpack_algo

    def _install(self, identity: str, journal_path: str):
        install = super()._install(identity, journal_path)
        install.binpack_algo = self.binpack_algo
        return install


# -- registry semantics --------------------------------------------------------


def test_registry_covers_every_pipeline():
    points = crashpoint.registered_points()
    assert len(points) == 13
    assert points == jax_crashpoint.registered_points()
    for prefix in ("writeback.", "journal.", "preempt.", "lease.", "concurrent."):
        assert any(p.startswith(prefix) for p in points), prefix
    assert PORTED_POINTS == tuple(points)


def test_arm_unknown_point_rejected():
    with pytest.raises(ValueError):
        crashpoint.arm("no.such.point")


def test_disabled_traversal_is_a_no_op():
    crashpoint.maybe_crash(crashpoint.WRITEBACK_PRE_COMMIT)  # nothing armed


def test_armed_point_fires_once_then_disarms():
    crashpoint.arm(crashpoint.JOURNAL_POST_APPEND)
    # other points pass through untouched
    crashpoint.maybe_crash(crashpoint.WRITEBACK_PRE_COMMIT)
    assert crashpoint.armed() == crashpoint.JOURNAL_POST_APPEND
    with pytest.raises(SimulatedCrash) as e:
        crashpoint.maybe_crash(crashpoint.JOURNAL_POST_APPEND)
    assert e.value.point == crashpoint.JOURNAL_POST_APPEND
    # one-shot: recovery re-traversing the same point must not re-die
    assert crashpoint.armed() is None
    crashpoint.maybe_crash(crashpoint.JOURNAL_POST_APPEND)


def test_simulated_crash_skips_except_exception():
    """The whole point of BaseException: the async worker's
    ``except Exception`` drain-keeper must not survive a kill."""
    assert not issubclass(SimulatedCrash, Exception)
    crashpoint.arm(crashpoint.WRITEBACK_POST_COMMIT)
    with pytest.raises(SimulatedCrash):
        try:
            crashpoint.maybe_crash(crashpoint.WRITEBACK_POST_COMMIT)
        except Exception:  # noqa: BLE001 - the handler under test
            pytest.fail("SimulatedCrash was caught by `except Exception`")


# -- matrix cells through the port's server stack ------------------------------

# one representative point per pipeline (the reference's subset)
SUBSET = [
    crashpoint.WRITEBACK_PRE_COMMIT,
    crashpoint.JOURNAL_POST_APPEND,
    crashpoint.JOURNAL_POST_ACK,
    crashpoint.PREEMPT_MID_EXECUTE,
    crashpoint.LEASE_PRE_RENEW,
]

# the speculation→commit window (concurrent/engine.py): every cell
CONCURRENT_WINDOW = [
    crashpoint.CONCURRENT_SPECULATION_SOLVED,
    crashpoint.CONCURRENT_COMMIT_REVALIDATED,
    crashpoint.CONCURRENT_COMMIT_WRITTEN,
]


@pytest.mark.parametrize("point", SUBSET)
def test_crash_point_recovery(point):
    report = CrashMatrix(nodes=2, device="cpu").run_point(point)
    assert report["crashed"], f"{point}: crash never fired"
    assert report["ok"], f"{point}: {report['violations']}"
    # the successor took over at the next epoch and drained both
    # journals: every intent landed exactly once across the restart
    assert report["recoveredEpoch"] == 2
    assert report["journalDepth"] == 0
    assert report["evictJournalDepth"] == 0
    assert report["staleCommits"] == 0


@pytest.mark.parametrize("point", CONCURRENT_WINDOW)
def test_concurrent_window_crash_is_exactly_once(point):
    """Death inside the speculation→commit window: a crash before the
    commit leaves no reservation (the gang was never admitted; the retry
    re-admits); a crash after the reservation write leaves all or
    nothing, never a half-committed gang.  The port's report equals the
    reference's."""
    report = CrashMatrix(nodes=2, device="cpu").run_point(point)
    assert report["crashed"], f"{point}: crash never fired"
    assert report["ok"], f"{point}: {report['violations']}"
    assert report["recoveredEpoch"] == 2
    assert report["journalDepth"] == 0
    assert report["staleCommits"] == 0
    if point != crashpoint.CONCURRENT_COMMIT_WRITTEN:
        assert report["reservationPresent"] is False
    assert report == JaxCrashMatrix(nodes=2).run_point(point)


def test_mid_preemption_crash_finishes_the_eviction():
    """The sharpest cell: death between the first and second victim pod
    delete.  The successor must finish the half-evicted gang — pods
    gone AND reservation gone — never leave it straddled."""
    report = CrashMatrix(nodes=2, device="cpu").run_point(crashpoint.PREEMPT_MID_EXECUTE)
    assert report["ok"], report["violations"]
    assert report["victimPods"], "cell never scheduled its victim gang"


@pytest.mark.parametrize("binpack", ["tightly-pack", "tpu-batch"])
@pytest.mark.parametrize("point", PORTED_POINTS)
def test_cell_report_equals_the_reference(point, binpack):
    """Each of the thirteen cells, under the reference's ``tightly-pack``
    and under ``tpu-batch`` (each driver Filter through the delta-solve
    session), both matrices with their concurrent admission engine on:
    the port's report on ``device="cpu"`` equals the JAX package's key
    for key."""
    theirs = BinpackJaxCrashMatrix(binpack, nodes=2).run_point(point)
    ours = CrashMatrix(nodes=2, device="cpu", binpack_algo=binpack).run_point(point)
    assert theirs["ok"], theirs["violations"]
    assert ours == theirs


@pytest.mark.parametrize("point", [p for p in crashpoint.registered_points() if p.startswith("concurrent.")])
def test_concurrent_points_wait_for_the_concurrent_engine(point):
    """Each ``concurrent.*`` point fires inside the engine every cell
    wires: on the Filter caller's thread, inside ``engine.predicate``."""
    matrix = CrashMatrix(nodes=2, device="cpu")
    assert matrix._install("replica-a", "intents.jsonl").concurrent.enabled
    report = matrix.run_point(point)
    assert report["crashed"] and report["ok"], report


class NoPolicyJaxCrashMatrix(BinpackJaxCrashMatrix):
    """The reference's matrix with its policy engine off, so its
    speculations solve and its commits consume them."""

    def _install(self, identity: str, journal_path: str):
        install = super()._install(identity, journal_path)
        install.policy.enabled = False
        install.policy.preemption_enabled = False
        return install


@pytest.mark.parametrize("binpack", ["tpu-batch", "tpu-batch-minimal-fragmentation", "tpu-batch-distribute-evenly"])
@pytest.mark.parametrize("point", CONCURRENT_WINDOW)
def test_concurrent_window_with_a_live_verdict(point, binpack):
    """The window's cells with the policy engine off, under each tensor
    lane: the crashed Filter's speculation solved (its verdict in flight
    at the first two points, consumed as a hit before
    ``concurrent.commit-written``), recovery is exactly-once, and the
    report equals the reference's cell with its policy engine off."""
    ours = CrashMatrix(nodes=2, device="cpu", binpack_algo=binpack, policy=False).run_point(point)
    assert ours["crashed"] and ours["ok"], ours
    hit = point == crashpoint.CONCURRENT_COMMIT_WRITTEN
    assert ours.pop("speculation") == {"solved": 1, "hits": int(hit)}
    assert ours["reservationPresent"] is hit
    assert ours == NoPolicyJaxCrashMatrix(binpack, nodes=2).run_point(point)


def test_policy_off_refuses_the_preemption_points():
    with pytest.raises(ValueError, match="policy engine"):
        CrashMatrix(nodes=2, device="cpu", policy=False).run_point(crashpoint.PREEMPT_MID_EXECUTE)


def test_policy_off_under_a_host_lane_flags_the_missing_verdict():
    """``tightly-pack`` has no tensor solver: the speculator declines, so
    a policy-off cell cannot show a live verdict and its audit says so."""
    report = CrashMatrix(nodes=2, device="cpu", policy=False).run_point(crashpoint.CONCURRENT_COMMIT_WRITTEN)
    assert report["crashed"] and not report["ok"]
    assert "no speculative verdict was in flight at the crash" in report["violations"]
