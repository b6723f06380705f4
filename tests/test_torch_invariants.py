"""The port's debug invariant checker (scheduler/invariants.py, I1-I5):
the reference package's cases (tests/test_invariants.py) on the port's
harness, an I5 case that corrupts the tensor mirror, the wiring's
``SCHED_DEBUG_INVARIANTS=1`` hook, and every Twin sequence of
tests/test_torch_extender.py and tests/test_torch_tensor_snapshot.py run
once more with both packages' checkers on after every Filter, raising on
a violation."""

import logging
import random

import pytest

import test_torch_extender as extender_cases
import test_torch_tensor_snapshot as snapshot_cases
from k8s_spark_scheduler_tpu_torch.scheduler import invariants
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from torch_parity import Twin


def test_invariants_hold_through_churn():
    h = Harness(binpack_algo="tpu-batch", is_fifo=True, device="cpu")
    try:
        rng = random.Random(123)
        for i in range(4):
            h.new_node(f"n{i}")
        nodes = [f"n{i}" for i in range(4)]
        live = []
        for step in range(30):
            if rng.random() < 0.6 or not live:
                pods = h.static_allocation_spark_pods(f"a{step}", rng.randint(1, 3))
                if h.schedule(pods[0], nodes).node_names:
                    placed = [pods[0]]
                    for p in pods[1:]:
                        if h.schedule(p, nodes).node_names:
                            placed.append(p)
                    live.append(placed)
            else:
                for p in live.pop(rng.randrange(len(live))):
                    try:
                        h.delete_pod(p)
                    except Exception:
                        pass
                h.wait_quiesced()
            assert invariants.check(h.server) == []
    finally:
        h.close()


def test_invariants_catch_corruption():
    h = Harness(device="cpu")
    try:
        h.new_node("n1")
        pods = h.static_allocation_spark_pods("app-c", 1)
        h.assert_success(h.schedule(pods[0], ["n1"]))
        # corrupt: bind a pod to a nonexistent reservation name
        rr = h.server.resource_reservation_cache.get("default", "app-c").deepcopy()
        rr.status.pods["executor-99"] = "ghost"
        h.server.resource_reservation_cache.update(rr)
        violations = invariants.check(h.server, raise_on_violation=False)
        assert any(v.startswith("I1") for v in violations)
        with pytest.raises(invariants.InvariantViolation):
            invariants.check(h.server)
    finally:
        h.close()


def test_i5_catches_a_drifted_tensor_mirror():
    """I5 compares the mirror's rows with the Quantity path: a mirror
    row off by one milli-CPU is a violation naming the node."""
    h = Harness(binpack_algo="tpu-batch", device="cpu")
    try:
        h.new_node("n1")
        h.new_node("n2")
        pods = h.static_allocation_spark_pods("app-i5", 1)
        h.assert_success(h.schedule(pods[0], ["n1", "n2"]))
        assert invariants.check(h.server) == []
        cache = h.server.tensor_snapshot
        real = cache.snapshot

        def drifted():
            snap = real()
            snap.usage = snap.usage.copy()
            snap.usage[snap.name_index["n2"], 0] += 1
            return snap

        cache.snapshot = drifted
        violations = invariants.check(h.server, raise_on_violation=False)
        assert len(violations) == 1 and violations[0].startswith("I5: tensor mirror drift on n2")
        cache.snapshot = real
        assert invariants.check(h.server) == []
    finally:
        h.close()


def test_debug_env_wraps_the_predicate(monkeypatch, caplog):
    """SCHED_DEBUG_INVARIANTS=1: the wiring checks after every Filter,
    inside the predicate lock, and logs a violation at CRITICAL."""
    monkeypatch.setenv("SCHED_DEBUG_INVARIANTS", "1")
    h = Harness(binpack_algo="tpu-batch", device="cpu")
    calls = []
    real = invariants.check
    monkeypatch.setattr(invariants, "check", lambda server, **kw: calls.append(kw) or real(server, **kw))
    try:
        h.new_node("n1")
        pods = h.static_allocation_spark_pods("app-env", 1)
        h.assert_success(h.schedule(pods[0], ["n1"]))
        assert calls == [{"raise_on_violation": False}]
        rr = h.server.resource_reservation_cache.get("default", "app-env").deepcopy()
        rr.status.pods["executor-99"] = "ghost"
        h.server.resource_reservation_cache.update(rr)
        with caplog.at_level(logging.CRITICAL, logger=invariants.__name__):
            h.schedule(pods[1], ["n1"])
        assert any("I1" in r.getMessage() for r in caplog.records if r.levelno == logging.CRITICAL)
    finally:
        h.close()


# -- every Twin sequence with both checkers on ----------------------------------


@pytest.fixture
def checked_twins(monkeypatch):
    """Every Twin built in the test checks invariants after each Filter."""
    made = []
    init = Twin.__init__

    def checked_init(self, *args, **kw):
        kw["check_invariants"] = True
        init(self, *args, **kw)
        made.append(self)

    monkeypatch.setattr(Twin, "__init__", checked_init)
    yield made
    assert made and all(t.invariant_checks > 0 for t in made), [t.invariant_checks for t in made]


def _twin_factory(made_by_case):
    def make(*args, **kw):
        twin = Twin(*args, **kw)
        made_by_case.append(twin)
        return twin

    return make


EXTENDER_CASES = [
    (name, policy, seed)
    for name in sorted(n for n in dir(extender_cases) if n.startswith("test_"))
    for policy in extender_cases.POLICIES
    for seed in ((0, 1, 2) if name == "test_random_filter_sequence" else (None,))
]


@pytest.mark.parametrize(
    "name, policy, seed", EXTENDER_CASES, ids=[f"{n[5:]}-{p}-{s}" for n, p, s in EXTENDER_CASES]
)
def test_extender_sequences_keep_invariants(checked_twins, name, policy, seed):
    made = []
    try:
        args = (_twin_factory(made), policy) + (() if seed is None else (seed,))
        getattr(extender_cases, name)(*args)
    finally:
        for twin in made:
            twin.close()


@pytest.mark.parametrize("seed", range(4))
def test_snapshot_sequences_keep_invariants(checked_twins, seed):
    snapshot_cases.test_mirror_and_tensor_build_track_random_mutations(seed)
