"""The port's crash-point injection and recovery matrix (ha/crashpoint,
ha/crashmatrix) against the reference's tests/test_ha_crashpoints.py,
and each matrix cell against the JAX package's.

The registry cases and the reference's representative subset run on the
port's server stack on ``device="cpu"``: kill -9 at the armed point,
cold-restart a successor on the same API server and journal files,
audit invariants and exactly-once intent delivery.  Then every one of
the ten points outside the concurrent admission engine runs through
both packages' matrices, and the two reports must be equal (a cell's
report holds no timing).  The reference's cells run its concurrent
admission engine; the port has none yet (ROADMAP A.4), so the JAX side
here runs a test-local matrix with that engine off, and the port refuses
the three ``concurrent.*`` points."""

import pytest

from k8s_spark_scheduler_tpu.config import ConcurrentConfig as JaxConcurrentConfig
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


class SerialJaxCrashMatrix(JaxCrashMatrix):
    """The reference's matrix with its concurrent admission engine off
    (the serial extender, as the port's cells run it), under
    ``binpack_algo``."""

    def __init__(self, binpack_algo: str = "tightly-pack", **kw):
        super().__init__(**kw)
        self.binpack_algo = binpack_algo

    def _install(self, identity: str, journal_path: str):
        install = super()._install(identity, journal_path)
        install.concurrent = JaxConcurrentConfig(enabled=False)
        install.binpack_algo = self.binpack_algo
        return install


# -- registry semantics --------------------------------------------------------


def test_registry_covers_every_pipeline():
    points = crashpoint.registered_points()
    assert len(points) == 13
    assert points == jax_crashpoint.registered_points()
    for prefix in ("writeback.", "journal.", "preempt.", "lease.", "concurrent."):
        assert any(p.startswith(prefix) for p in points), prefix
    assert PORTED_POINTS == tuple(p for p in points if not p.startswith("concurrent."))


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
    """Each of the ten cells, under the reference's ``tightly-pack`` and
    under ``tpu-batch`` (each driver Filter through the delta-solve
    session): the port's report on ``device="cpu"`` equals the JAX
    package's (serial extender) key for key."""
    theirs = SerialJaxCrashMatrix(binpack, nodes=2).run_point(point)
    ours = CrashMatrix(nodes=2, device="cpu", binpack_algo=binpack).run_point(point)
    assert theirs["ok"], theirs["violations"]
    assert ours == theirs


@pytest.mark.parametrize("point", [p for p in crashpoint.registered_points() if p.startswith("concurrent.")])
def test_concurrent_points_wait_for_the_concurrent_engine(point):
    with pytest.raises(ValueError, match=r"ROADMAP A\.4"):
        CrashMatrix(nodes=2, device="cpu").run_point(point)
