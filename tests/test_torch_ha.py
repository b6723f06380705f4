"""The port's HA fabric (ha/: lease CAS election, fencing epochs,
split-brain refusal) against the reference's tests/test_ha.py, and
against the JAX package itself.

The first half is the reference's 15 tests on the port's elector, fence
and embedded ``APIServer`` under a fake clock (the end-to-end handoff
through the port's crash-matrix harness on ``device="cpu"``).  The
second half runs both packages side by side: one scripted sequence of
``step`` / ``step_down`` / clock advances on a JAX elector over the JAX
``APIServer`` and a port elector over the port's gives equal
``(is_leader, epoch, lease history, fence.state())`` after every step;
the Lease's coordination.k8s.io/v1 wire form is equal and each package
reads the other's (the whole-second TTL included); and a journal written
under a fencing epoch by either package loads in the other with the
same pending intents."""

import json

import pytest

from k8s_spark_scheduler_tpu import timesource as jax_timesource
from k8s_spark_scheduler_tpu.ha import fencing as jax_fencing
from k8s_spark_scheduler_tpu.ha import lease as jax_lease
from k8s_spark_scheduler_tpu.kube.apiserver import APIServer as JaxAPIServer
from k8s_spark_scheduler_tpu.kube.errors import APIError as JaxAPIError
from k8s_spark_scheduler_tpu.resilience.journal import IntentJournal as JaxJournal
from k8s_spark_scheduler_tpu.types.objects import ObjectMeta as JaxObjectMeta
from k8s_spark_scheduler_tpu_torch import timesource
from k8s_spark_scheduler_tpu_torch.ha.crashmatrix import CrashMatrix
from k8s_spark_scheduler_tpu_torch.ha.fencing import FencedWriter, FenceState, StaleEpochError
from k8s_spark_scheduler_tpu_torch.ha.lease import (
    HISTORY_LIMIT,
    LeaderElector,
    Lease,
    lease_from_wire,
    lease_to_wire,
)
from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
from k8s_spark_scheduler_tpu_torch.kube.errors import APIError
from k8s_spark_scheduler_tpu_torch.resilience.journal import IntentJournal
from k8s_spark_scheduler_tpu_torch.types.objects import ObjectMeta


class FakeClock:
    def __init__(self, t: float = 1_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def clock():
    """One fake clock behind both packages' time sources."""
    c = FakeClock()
    timesource.set_source(c)
    jax_timesource.set_source(c)
    yield c
    timesource.reset()
    jax_timesource.reset()


def _elector(api, identity, duration=30.0, **kwargs):
    return LeaderElector(api, identity, FenceState(), duration_seconds=duration, **kwargs)


# -- elector (the reference's tests/test_ha.py) --------------------------------


def test_first_step_creates_lease_at_epoch_one(clock):
    api = APIServer()
    a = _elector(api, "replica-a")
    assert a.step() is True
    assert a.is_leader()
    assert a.fence.epoch() == 1
    lease = a.peek()
    assert lease.holder == "replica-a"
    assert lease.epoch == 1
    assert lease.history == [[1, "replica-a", clock.t]]


def test_second_replica_stays_follower_under_live_lease(clock):
    api = APIServer()
    a = _elector(api, "replica-a")
    b = _elector(api, "replica-b")
    assert a.step()
    assert b.step() is False
    assert not b.is_leader()
    # the follower observed the leader's epoch but was never granted one
    assert b.fence.highest_observed() == 1
    assert b.fence.epoch() == 0


def test_expired_lease_acquired_at_next_epoch_and_deposes(clock):
    api = APIServer()
    deposed_at = []
    a = _elector(api, "replica-a", on_deposed=deposed_at.append)
    b = _elector(api, "replica-b")
    assert a.step()
    clock.advance(31.0)  # past the 30s TTL: a's lease is stealable
    assert b.step() is True
    assert b.fence.epoch() == 2
    assert b.peek().history == [
        [1, "replica-a", clock.t - 31.0],
        [2, "replica-b", clock.t],
    ]
    # a's next round observes the steal: deposed, callback fired
    assert a.step() is False
    assert not a.is_leader()
    assert a.fence.deposed()
    assert deposed_at == [2]


def test_step_down_hands_off_without_ttl_wait(clock):
    api = APIServer()
    a = _elector(api, "replica-a")
    b = _elector(api, "replica-b")
    assert a.step()
    assert b.step() is False
    a.step_down()
    assert not a.is_leader()
    # no clock advance: the standby takes over immediately
    assert b.step() is True
    assert b.fence.epoch() == 2


def test_partitioned_leader_self_demotes_on_ttl(clock):
    """Renewals fail (coordination-API partition) → the leader keeps
    serving until its own TTL lapses, then stops claiming leadership
    even though it never observed a rival."""
    api = APIServer()
    a = _elector(api, "replica-a")
    assert a.step()

    def fail_lease(op, kind, ns, name):
        if kind == Lease.KIND:
            return APIError(f"partition ({op} {ns}/{name})")
        return None

    api.set_write_fault(fail_lease)
    clock.advance(10.0)
    assert a.step() is True  # renew failed but the TTL has not lapsed
    assert a.is_leader()
    clock.advance(21.0)  # now - last_renewal > duration
    assert not a.is_leader()


def test_reelection_after_deposition_clears_the_fence(clock):
    api = APIServer()
    a = _elector(api, "replica-a")
    b = _elector(api, "replica-b")
    assert a.step()
    clock.advance(31.0)
    assert b.step()
    assert a.step() is False and a.fence.deposed()
    clock.advance(31.0)  # b's lease lapses too
    assert a.step() is True
    assert a.fence.epoch() == 3
    assert not a.fence.deposed()
    assert a.is_leader()


def test_lease_history_is_bounded(clock):
    api = APIServer()
    a = _elector(api, "replica-a")
    b = _elector(api, "replica-b")
    assert a.step()
    for _ in range(HISTORY_LIMIT + 8):
        clock.advance(31.0)
        winner = b if a.peek().holder == "replica-a" else a
        assert winner.step()
    lease = a.peek()
    assert len(lease.history) == HISTORY_LIMIT
    epochs = [h[0] for h in lease.history]
    assert epochs == sorted(epochs) and len(set(epochs)) == len(epochs)
    assert lease.history[-1][0] == lease.epoch


def test_lease_wire_round_trip(clock):
    lease = Lease(
        meta=ObjectMeta(name="sched", namespace="kube-system", resource_version=7),
        holder="replica-a",
        epoch=3,
        acquired_at=5.0,
        renewed_at=9.0,
        duration_seconds=15.0,
        history=[[1, "x", 1.0], [2, "y", 3.0], [3, "replica-a", 5.0]],
    )
    back = lease_from_wire(lease_to_wire(lease))
    assert back.holder == lease.holder
    assert back.epoch == lease.epoch
    assert back.duration_seconds == lease.duration_seconds
    assert back.history == lease.history
    assert back.meta.resource_version == 7


# -- fencing -------------------------------------------------------------------


def test_never_elected_writer_refuses():
    writer = FencedWriter(FenceState())
    with pytest.raises(StaleEpochError) as e:
        writer.check("writeback.create")
    assert e.value.held_epoch == 0


def test_granted_writer_passes_and_accounts_commits():
    fence = FenceState()
    fence.grant(1)
    writer = FencedWriter(fence)
    assert writer.check("writeback.create") == 1
    writer.commit()
    st = fence.state()
    assert st["commits"] == 1 and st["staleCommits"] == 0 and st["refusals"] == {}


def test_deposed_writer_refuses_and_counts_per_op():
    fence = FenceState()
    fence.grant(1)
    assert fence.observe(2) is True
    writer = FencedWriter(fence)
    for _ in range(3):
        with pytest.raises(StaleEpochError):
            writer.check("writeback.update")
    with pytest.raises(StaleEpochError):
        writer.check("preempt.commit")
    assert fence.state()["refusals"] == {"writeback.update": 3, "preempt.commit": 1}


def test_read_through_observes_lease_movement_on_the_write_path():
    """The lease moved but no renewal tick has run: the very first
    fenced write must still refuse (read-through, not poll-based)."""
    fence = FenceState()
    fence.grant(1)
    moved = Lease(epoch=2)
    writer = FencedWriter(fence, lease_reader=lambda: moved)
    with pytest.raises(StaleEpochError) as e:
        writer.check("writeback.create")
    assert e.value.observed_epoch == 2
    assert fence.highest_observed() == 2
    assert fence.deposed()


def test_stale_commit_witness_counts_check_commit_straddles():
    """A write that passed check() before deposition but commits after
    is the one hole fencing cannot close at the gate — the I-H3 witness
    must count it."""
    fence = FenceState()
    fence.grant(1)
    writer = FencedWriter(fence)
    assert writer.check("writeback.create") == 1
    fence.observe(2)  # deposed between check and commit
    writer.commit()
    assert fence.stale_commits() == 1


# -- split-brain ---------------------------------------------------------------


def test_split_brain_deposed_writer_fenced_100_percent(clock):
    """After a rival steals the lease, EVERY write through the old
    leader's gate refuses — zero stale writes can land."""
    api = APIServer()
    a = _elector(api, "replica-a")
    b = _elector(api, "replica-b")
    assert a.step()
    writer_a = FencedWriter(a.fence, lease_reader=a.peek)
    assert writer_a.check("writeback.create") == 1
    writer_a.commit()

    clock.advance(31.0)
    assert b.step()  # rival steals at epoch 2; a has NOT stepped since

    refused = 0
    for op in ("writeback.create", "writeback.update", "writeback.delete",
               "demand.create", "demand.delete", "preempt.commit",
               "journal.ack") * 3:
        with pytest.raises(StaleEpochError):
            writer_a.check(op)
        refused += 1
    assert refused == 21
    assert a.fence.refusals() == refused
    assert a.fence.stale_commits() == 0


def test_two_replica_graceful_handoff_end_to_end():
    """Two full server replicas on one API server: leader steps down,
    standby takes over at epoch 2, the deposed replica's write paths
    refuse 100%, the new leader schedules and drains cleanly."""
    report = CrashMatrix(nodes=2, device="cpu").run_handoff()
    assert report["ok"], report["violations"]
    assert report["handoffEpoch"] == 2
    assert report["deposedRefusals"] == 5
    assert report["staleCommits"] == {"replica-a": 0, "replica-b": 0}


# -- against the JAX package ---------------------------------------------------


def _lease_view(lease):
    if lease is None:
        return None
    return (lease.holder, lease.epoch, lease.acquired_at, lease.renewed_at, lease.duration_seconds,
            [list(h) for h in lease.history])


class _Pair:
    """The same replica in each package: an elector, its fence and a
    read-through writer, over that package's API server."""

    def __init__(self, jax_api, port_api, identity, duration):
        self.deposed = ([], [])
        self.jax = jax_lease.LeaderElector(jax_api, identity, jax_fencing.FenceState(),
                                           duration_seconds=duration, on_deposed=self.deposed[0].append)
        self.port = LeaderElector(port_api, identity, FenceState(), duration_seconds=duration,
                                  on_deposed=self.deposed[1].append)
        self.writers = (jax_fencing.FencedWriter(self.jax.fence, lease_reader=self.jax.peek),
                        FencedWriter(self.port.fence, lease_reader=self.port.peek))

    def view(self, side: int):
        elector = (self.jax, self.port)[side]
        return (elector.is_leader(), elector.fence.epoch(), elector.fence.highest_observed(),
                _lease_view(elector.peek()), elector.fence.state(), list(self.deposed[side]))


@pytest.mark.parametrize("duration", [30.0, 0.3])
def test_scripted_election_sequence_equals_the_reference(clock, duration):
    """Three replicas through creation, followers, a planned handoff,
    TTL steals, a partition, re-election and fenced writes: after every
    step both packages agree on each replica's leadership, epoch, lease
    history and fence counters."""
    japi, papi = JaxAPIServer(), APIServer()
    replicas = {name: _Pair(japi, papi, name, duration) for name in ("replica-a", "replica-b", "replica-c")}
    past_ttl = duration + 1.0

    def partition(on: bool):
        """Lease writes fail in both API servers (a coordination-API
        partition), or stop failing."""
        for api, error, kind in ((japi, JaxAPIError, jax_lease.Lease.KIND), (papi, APIError, Lease.KIND)):
            api.set_write_fault(
                (lambda op, k, ns, name, error=error, kind=kind: error("partition") if k == kind else None)
                if on else None
            )

    script = [
        ("step", "replica-a"), ("step", "replica-b"), ("step", "replica-c"),
        ("write", "replica-a"), ("write", "replica-b"),
        ("advance", duration / 2), ("step", "replica-a"),
        ("step_down", "replica-a"), ("step", "replica-b"), ("step", "replica-a"),
        ("write", "replica-a"), ("write", "replica-b"),
        ("advance", past_ttl), ("step", "replica-c"), ("write", "replica-b"),
        ("step", "replica-b"), ("step", "replica-a"),
        ("partition", True), ("advance", duration / 2), ("step", "replica-c"),
        ("advance", past_ttl), ("partition", False), ("step", "replica-a"),
        ("step", "replica-c"), ("write", "replica-c"), ("write", "replica-a"),
        ("step_down", "replica-b"), ("advance", past_ttl), ("step", "replica-b"),
        ("step", "replica-a"), ("step", "replica-c"), ("write", "replica-b"),
    ]
    for i, (op, arg) in enumerate(script):
        if op == "advance":
            clock.advance(arg)
        elif op == "partition":
            partition(arg)
        else:
            pair = replicas[arg]
            outs = []
            for side in (0, 1):
                elector = (pair.jax, pair.port)[side]
                if op == "step":
                    outs.append(elector.step())
                elif op == "step_down":
                    outs.append(elector.step_down())
                else:
                    try:
                        outs.append(pair.writers[side].check("writeback.create"))
                        pair.writers[side].commit()
                    except (jax_fencing.StaleEpochError, StaleEpochError) as err:
                        outs.append(("refused", err.held_epoch, err.observed_epoch))
            assert outs[0] == outs[1], (i, op, arg, outs)
        for name, pair in replicas.items():
            assert pair.view(1) == pair.view(0), (i, op, arg, name)
    # the script reached epoch 5 with every kind of transition
    assert replicas["replica-b"].port.fence.epoch() == 5
    assert len(replicas["replica-a"].port.peek().history) == 5
    assert replicas["replica-a"].port.fence.state()["refusals"]


@pytest.mark.parametrize("duration", [15.0, 2.0, 0.3, 7.9])
def test_lease_wire_form_equals_the_reference_and_reads_across(duration):
    """``lease_to_wire`` writes the same coordination.k8s.io/v1 object
    in both packages, and each package's ``lease_from_wire`` reads the
    other's.  The TTL travels as whole seconds, so a sub-second TTL reads
    back as the 15 s default in both (the reference's semantics)."""
    history = [[1, "replica-a", 5.5], [2, "replica-b", 9.25]]
    kw = dict(holder="replica-b", epoch=2, acquired_at=9.25, renewed_at=11.5, duration_seconds=duration,
              history=history)
    ours = Lease(meta=ObjectMeta(name="sched", namespace="kube-system", resource_version=7), **kw)
    theirs = jax_lease.Lease(meta=JaxObjectMeta(name="sched", namespace="kube-system", resource_version=7), **kw)
    wire = lease_to_wire(ours)
    assert wire == jax_lease.lease_to_wire(theirs)
    assert json.loads(json.dumps(wire)) == wire
    want_ttl = float(int(duration)) or 15.0
    for back in (lease_from_wire(jax_lease.lease_to_wire(theirs)), jax_lease.lease_from_wire(wire)):
        assert (back.holder, back.epoch, back.acquired_at, back.renewed_at, back.history) == (
            "replica-b", 2, 9.25, 11.5, history)
        assert back.duration_seconds == want_ttl
        assert back.meta.resource_version == 7 and back.meta.namespace == "kube-system"


def _journal_under_epochs(journal, epochs):
    """Puts and acks under a moving fencing epoch: the intents left
    pending are a create, an update folded over a create, and a delete."""
    epoch = {"now": epochs[0]}
    journal.epoch_source = lambda: epoch["now"]
    wire = {"metadata": {"name": "app-1", "namespace": "ns"}, "spec": {"reservations": {}}}
    journal.record("create", "ResourceReservation", "ns", "app-1", wire)
    journal.record("create", "ResourceReservation", "ns", "app-2", dict(wire, metadata={"name": "app-2"}))
    epoch["now"] = epochs[1]
    journal.record("update", "ResourceReservation", "ns", "app-2", dict(wire, spec={"x": 1}))
    journal.record("create", "ResourceReservation", "ns", "app-3", None)
    assert journal.ack("create", "ns", "app-3")
    journal.record("delete", "ResourceReservation", "ns", "app-4", None)
    journal.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_with_epochs_loads_in_either_package(tmp_path, writer):
    """Put and ack records carry ``"epoch"`` in both packages; a journal
    either package wrote loads in the other with the same pending
    intents, epochs included."""
    path = str(tmp_path / "intents.jsonl")
    make = JaxJournal if writer == "jax" else IntentJournal
    _journal_under_epochs(make(path), (1, 2))
    records = [json.loads(line.split(" ", 3)[3]) for line in open(path).read().splitlines()]
    assert [r.get("epoch") for r in records] == [1, 1, 2, 2, 2, 2]
    loaded = [JaxJournal(path), IntentJournal(path)]
    pending = [sorted(j.pending(), key=lambda r: r["seq"]) for j in loaded]
    assert pending[0] == pending[1]
    assert [(r["op"], r["name"], r["epoch"]) for r in pending[1]] == [
        ("create", "app-1", 1), ("update", "app-2", 2), ("delete", "app-4", 2)]
    for j in loaded:
        j.close()
