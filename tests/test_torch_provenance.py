"""The port's decision provenance (k8s_spark_scheduler_tpu_torch/
provenance/), case for case the reference's tests/test_provenance.py on
the port, and the port against the reference:

- the explainer (``ops/explain.py``: one queue-kernel launch with the
  target probed between the queue's apps, its plain version here) equal
  to the reference's native ``explain_queue_native`` — all 12 info
  fields and the blocker set — on 60 random seeds under each of the
  policy codes 0, 1 and 2, targets that stay feasible included;
- a bundle the JAX package persists replays in the port and the port's
  in the JAX package; a journal the JAX package writes is recovered by
  the port's server at boot;
- the Twin (tests/torch_parity.py), both sides on their default
  resilience and provenance, holds refused drivers' enriched failure
  messages byte-equal and their decision records equal, every field but
  the ones that name the serving server (``lane``: cuda / torch against
  native / xla / pallas, the trace id, and the mirror instance in the
  content key).

The reference's ``test_engine_parity_guard_runs_clean`` is in
tests/test_torch_deltasolve.py with the rest of the delta-solve engine;
``test_sim_replay_bundle_cli`` (the ``sim`` command line) is in
tests/test_torch_sim_smoke.py.
"""

import json
import os

import numpy as np
import pytest

from k8s_spark_scheduler_tpu.native.fifo import (
    explain_queue_native,
    native_explain_available,
    native_fifo_available,
    solve_queue_min_frag_native,
    solve_queue_native,
)
from k8s_spark_scheduler_tpu_torch.ops.explain import explain_queue
from k8s_spark_scheduler_tpu_torch.ops.minfrag_kernel import fifo_queue_min_frag
from k8s_spark_scheduler_tpu_torch.ops.queue_kernel import fifo_queue
from k8s_spark_scheduler_tpu_torch.provenance.recorder import (
    FlightRecorder,
    replay_bundle,
    replay_bundle_file,
)
from k8s_spark_scheduler_tpu_torch.provenance.records import (
    DecisionRecord,
    ProvenanceRing,
)
from k8s_spark_scheduler_tpu_torch.provenance.tracker import (
    ProvenanceTracker,
    SolveArtifacts,
)
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

needs_native = pytest.mark.skipif(
    not (native_fifo_available() and native_explain_available()),
    reason="the reference's native explainer is unavailable",
)

FIELDS = ("flip", "feasible", "cap_total", "dim_totals", "max_cap", "max_node",
          "driver_fit", "tightest_dim", "shortfall_execs")


def _explain(avail, rank, eok, apps, policy, target):
    return explain_queue(avail, rank, eok, apps, policy, target, device="cpu")


# ---------------------------------------------------------------------------
# explainer units
# ---------------------------------------------------------------------------


def _uniform_cluster(nb=4, cpu=8, mem=16, gpu=0):
    avail = np.tile(np.array([cpu, mem, gpu], np.int32), (nb, 1))
    rank = np.arange(nb, dtype=np.int32)
    eok = np.ones(nb, dtype=bool)
    return avail, rank, eok


def _app(d, e, k, valid=1):
    return list(d) + list(e) + [k, valid]


def test_explain_capacity_shortfall_tightest_dimension():
    # 2 nodes × (cpu 4, mem 100): a gang of 5 × (cpu 2, mem 1) is cpu-
    # bound — per-dim totals: cpu 2+2=4, mem 100→clamped 5+5=10
    avail, rank, eok = _uniform_cluster(nb=2, cpu=4, mem=100)
    apps = np.array([_app((1, 1, 0), (2, 1, 0), 5)], np.int32)
    res = _explain(avail, rank, eok, apps, 0, 0)
    assert not res.feasible
    assert res.flip == -2  # infeasible even at the basis
    assert res.tightest_dim == 0  # cpu
    assert res.dim_totals[0] == 4
    assert res.dim_totals[1] == 10
    assert res.cap_total == 4
    assert res.shortfall_execs == 5 - 4 == 1
    assert res.max_cap == 2 and res.max_node in (0, 1)
    assert res.blocker_count == 0


def test_explain_feasible_target_flags():
    avail, rank, eok = _uniform_cluster(nb=2, cpu=8, mem=16)
    apps = np.array([_app((1, 1, 0), (2, 2, 0), 3)], np.int32)
    res = _explain(avail, rank, eok, apps, 0, 0)
    assert res.feasible
    assert res.flip == -1
    assert res.shortfall_execs == 0
    assert res.blocker_count == 0


def test_explain_blocker_set_walkback():
    # 2 nodes × cpu 10.  Three earlier 1×(cpu 4) gangs drain the cpu;
    # the target 2×(cpu 4) gang fits the basis but not position 3.
    avail, rank, eok = _uniform_cluster(nb=2, cpu=10, mem=1000)
    earlier = [_app((1, 0, 0), (4, 0, 0), 1) for _ in range(3)]
    target = _app((1, 0, 0), (4, 0, 0), 2)
    apps = np.array(earlier + [target], np.int32)
    res = _explain(avail, rank, eok, apps, 0, 3)
    assert not res.feasible
    assert res.flip >= 0  # became infeasible because of the queue
    assert res.tightest_dim == 0
    assert res.blocker_count >= 1
    # the flip-position driver is always in the blocker set
    assert bool(res.blockers[res.flip])
    # blockers are earlier feasible drivers only
    assert not res.blockers[3:].any()


@pytest.mark.parametrize("policy", [0, 1, 2])
def test_explain_runs_under_every_policy(policy):
    import torch

    avail, rank, eok = _uniform_cluster(nb=3, cpu=9, mem=30)
    earlier = [_app((1, 1, 0), (2, 2, 0), 3) for _ in range(3)]
    target = _app((1, 1, 0), (2, 2, 0), 3)
    apps = np.array(earlier + [target], np.int32)
    res = _explain(avail, rank, eok, apps, policy, len(earlier))
    assert res is not None
    # policy-correct replay must agree with the policy's own solver on
    # the earlier verdicts' effect: the probe's verdict for the target
    # equals solving the whole queue and reading the target's verdict
    args = tuple(torch.as_tensor(x) for x in (
        avail, rank, eok, apps[:, 0:3], apps[:, 3:6], apps[:, 6], apps[:, 7].astype(bool)))
    if policy == 2:
        feas, _, _ = fifo_queue_min_frag(*args)
    else:
        feas, _, _ = fifo_queue(*args, evenly=(policy == 1))
    assert bool(res.feasible) == bool(feas[len(earlier)])


def _random_problem(rng):
    """A raw explain problem: availability that may be negative, ranks
    with non-candidates, exec_ok holes, zero requests (a zero gpu
    request on most apps), k = 0, invalid apps."""
    nb = int(rng.integers(2, 24))
    avail = rng.integers(0, 40, size=(nb, 3)).astype(np.int32)
    avail[:, 2] = rng.integers(0, 3, size=nb) * rng.integers(0, 2)
    if rng.random() < 0.3:
        avail[rng.integers(0, nb)] = -rng.integers(1, 5, size=3)
    rank = rng.permutation(nb).astype(np.int32)
    rank[rng.random(nb) < 0.2] = 2**31 - 1
    eok = rng.random(nb) < 0.85
    na = int(rng.integers(1, 14))
    apps = np.zeros((na, 8), np.int32)
    apps[:, 0:3] = rng.integers(0, 6, size=(na, 3))
    apps[:, 3:6] = rng.integers(0, 9, size=(na, 3))
    apps[:, 2] = 0
    apps[:, 5] = rng.integers(0, 2, size=na) * (rng.random() < 0.3)
    apps[:, 6] = rng.integers(0, 9, size=na)
    apps[:, 7] = rng.random(na) < 0.9
    return avail, rank, eok, apps


@needs_native
@pytest.mark.parametrize("policy", [0, 1, 2])
def test_explainer_equals_native(policy):
    """Every target of 60 random queues under the policy: the 12 fields
    and the blocker set equal the reference's native explainer."""
    seen = {"feasible": 0, "basis-short": 0, "blocked": 0, "blockers>1": 0, "driver-blocked": 0}
    for seed in range(60):
        rng = np.random.default_rng(1000 * policy + seed)
        avail, rank, eok, apps = _random_problem(rng)
        for target in range(apps.shape[0]):
            want = explain_queue_native(avail, rank, eok, apps, policy, target)
            got = _explain(avail, rank, eok, apps, policy, target)
            assert tuple(getattr(got, f) for f in FIELDS) == tuple(getattr(want, f) for f in FIELDS), (
                seed, target)
            assert got.blockers.tolist() == want.blockers.astype(bool).tolist(), (seed, target)
            assert got.blocker_count == want.blocker_count
            seen["feasible"] += got.feasible
            seen["basis-short"] += got.flip == -2
            seen["blocked"] += got.flip >= 0 and not got.feasible
            seen["blockers>1"] += got.blocker_count > 1
            seen["driver-blocked"] += not got.feasible and got.tightest_dim < 0
    # the seeds reach every branch of the walk
    assert all(seen.values()), seen


def _queue_tensors(rng, n, a):
    import torch

    avail = rng.integers(-4, 64, size=(n, 3)).astype(np.int32)
    rank = rng.permutation(n).astype(np.int32)
    rank[rng.random(n) < 0.3] = 2**31 - 1
    eok = rng.random(n) < 0.85
    drivers = rng.integers(0, 4, size=(a, 3)).astype(np.int32)
    executors = rng.integers(0, 9, size=(a, 3)).astype(np.int32)
    counts = rng.integers(0, 12, size=a).astype(np.int32)
    valid = rng.random(a) < 0.9
    return tuple(torch.as_tensor(x) for x in (avail, rank, eok, drivers, executors, counts, valid))


@pytest.mark.parametrize("kernel", ["tightly", "evenly", "min-frag"])
def test_probe_flags_and_usage_output_of_the_plain_versions(kernel):
    """The explainer's launch arguments on the kernels' plain versions: a
    probed app gets its verdict against the carry and subtracts nothing
    (so probes leave the queue's own verdicts and carry as they were),
    and an applied app's usage word is what it takes: 2 x its executor
    nodes + 1 when its driver's node got none, equal to the carry's
    decrease in each dimension."""
    import torch

    from k8s_spark_scheduler_tpu_torch.ops.minfrag_kernel import queue_min_frag_plain
    from k8s_spark_scheduler_tpu_torch.ops.queue_kernel import queue_plain

    def run(*args, probe=None):
        if kernel == "min-frag":
            return queue_min_frag_plain(*args, probe=probe)
        return queue_plain(*args, evenly=kernel == "evenly", probe=probe)

    for seed in range(6):
        rng = np.random.default_rng(seed)
        args = _queue_tensors(rng, int(rng.integers(3, 40)), int(rng.integers(1, 12)))
        feas, didx, usage, after = run(*args)
        # with every app probed after it, the queue's verdicts do not move
        a = args[3].shape[0]
        idx = torch.arange(2 * a) // 2
        probe = torch.arange(2 * a) % 2 == 1
        inter = args[:3] + tuple(x[idx] for x in args[3:6]) + (args[6][idx] | probe,)
        i_feas, i_didx, i_usage, i_after = run(*inter, probe=probe)
        assert torch.equal(i_feas[0::2], feas) and torch.equal(i_didx[0::2], didx)
        assert torch.equal(i_usage[0::2], usage) and torch.equal(i_after, after)
        assert not i_usage[1::2].any()
        # the usage word, step by step, against the carry's decrease
        carry = args[0].to(torch.int64)
        for j in range(a):
            step = tuple(x[: j + 1] for x in args[3:])
            _, _, _, carry_j = run(*args[:3], *step)
            took = carry.sum(0) - carry_j.to(torch.int64).sum(0)
            word = int(usage[j])
            want = (word >> 1) * args[4][j].to(torch.int64) + (word & 1) * args[3][j].to(torch.int64)
            assert torch.equal(took, want), (seed, j)
            assert bool(feas[j]) or word == 0
            carry = carry_j.to(torch.int64)


@pytest.mark.cuda
@pytest.mark.skipif(not __import__("torch").cuda.is_available(), reason="needs a CUDA GPU")
@pytest.mark.parametrize("kernel", ["tightly", "evenly", "min-frag"])
def test_cuda_explain_launch_matches_plain(kernel):
    """The kernels' probe flags and usage output against the plain
    versions on the card (chip_smoke.py phase 3 holds the same at the
    main path's shapes)."""
    import torch

    from k8s_spark_scheduler_tpu_torch.ops.minfrag_kernel import (
        fifo_queue_min_frag_explain,
        queue_min_frag_plain,
    )
    from k8s_spark_scheduler_tpu_torch.ops.queue_kernel import fifo_queue_explain, queue_plain

    for seed, (n, a) in enumerate([(7, 20), (1000, 100), (12345, 40)]):
        rng = np.random.default_rng(seed)
        args = tuple(x.cuda() for x in _queue_tensors(rng, n, a))
        probe = torch.as_tensor(rng.random(a) < 0.5, device="cuda")
        if kernel == "min-frag":
            got = fifo_queue_min_frag_explain(*args, probe)
            want = queue_min_frag_plain(*args, probe=probe)
        else:
            got = fifo_queue_explain(*args, probe, evenly=kernel == "evenly")
            want = queue_plain(*args, evenly=kernel == "evenly", probe=probe)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.skipif(not __import__("torch").cuda.is_available(), reason="needs a CUDA GPU")
@pytest.mark.parametrize("policy", [0, 1, 2])
def test_cuda_explainer_equals_native(policy):
    for seed in range(20):
        rng = np.random.default_rng(1000 * policy + seed)
        avail, rank, eok, apps = _random_problem(rng)
        for target in range(apps.shape[0]):
            want = explain_queue_native(avail, rank, eok, apps, policy, target)
            got = explain_queue(avail, rank, eok, apps, policy, target, device="cuda")
            assert tuple(getattr(got, f) for f in FIELDS) == tuple(getattr(want, f) for f in FIELDS)
            assert got.blockers.tolist() == want.blockers.astype(bool).tolist()


# ---------------------------------------------------------------------------
# record ring
# ---------------------------------------------------------------------------


def test_ring_bounded_and_latest_indexed():
    ring = ProvenanceRing(capacity=4)
    for i in range(10):
        ring.record(DecisionRecord(pod=f"pod-{i % 3}", outcome="success"))
    assert len(ring) == 4
    stats = ring.stats()
    assert stats["size"] == 4 and stats["recorded"] == 10
    # latest wins per pod; the index never outgrows the ring
    assert ring.latest_for_pod("pod-0") is not None
    assert stats["indexed_pods"] <= 4
    # an evicted pod with no newer record is pruned from the index
    ring2 = ProvenanceRing(capacity=2)
    ring2.record(DecisionRecord(pod="a"))
    ring2.record(DecisionRecord(pod="b"))
    ring2.record(DecisionRecord(pod="c"))
    assert ring2.latest_for_pod("a") is None
    assert ring2.latest_for_pod("b") is not None


# ---------------------------------------------------------------------------
# flight recorder + replay parity
# ---------------------------------------------------------------------------


def _queue_problem(policy_code, seed=0):
    rng = np.random.default_rng(42 + seed + policy_code)
    nb = 16
    avail = rng.integers(4, 40, size=(nb, 3)).astype(np.int32)
    avail[:, 2] = 0  # keep min-frag sentinel-safe and gangs schedulable
    rank = np.arange(nb, dtype=np.int32)
    eok = np.ones(nb, dtype=bool)
    na = 7
    apps = np.zeros((na, 8), np.int32)
    apps[:, 0:3] = rng.integers(1, 4, size=(na, 3))
    apps[:, 3:6] = rng.integers(1, 6, size=(na, 3))
    apps[:, 2] = 0
    apps[:, 5] = 0
    apps[:, 6] = rng.integers(1, 5, size=na)
    apps[:, 7] = 1
    return avail, rank, eok, apps


def _artifacts_for(policy_code, seed=0):
    """A captured solve of the port's queue pass (its plain version)."""
    import torch

    avail, rank, eok, apps = _queue_problem(policy_code, seed)
    n_earlier = apps.shape[0] - 1
    earlier = apps[:n_earlier]
    args = tuple(torch.as_tensor(x) for x in (
        avail, rank, eok, earlier[:, 0:3], earlier[:, 3:6], earlier[:, 6], earlier[:, 7].astype(bool)))
    if policy_code == 2:
        feas, didx, after = fifo_queue_min_frag(*args)
    else:
        feas, didx, after = fifo_queue(*args, evenly=(policy_code == 1))
    return SolveArtifacts(
        policy_code=policy_code,
        lane="torch",
        basis=avail,
        driver_rank=rank,
        exec_ok=eok,
        packed=apps,
        n_earlier=n_earlier,
        feasible=feas.numpy(),
        didx=didx,
        resume=0,
        avail_after=after,
        queue_names=tuple(f"drv-{i}" for i in range(n_earlier)),
    )


@pytest.mark.parametrize("policy_code", [0, 1, 2])
def test_bundle_replays_byte_identical_across_lanes(policy_code, tmp_path):
    """A persisted bundle replays to byte-identical verdicts (here the
    plain lane; tests marked cuda and chip_smoke.py hold the kernel
    lane) for every policy."""
    rec = FlightRecorder(capacity=4, out_dir=str(tmp_path))
    art = _artifacts_for(policy_code)
    seq = rec.note(art, f"pod-p{policy_code}", "failure-fit")
    assert seq is not None
    path = rec.persist("test-trigger", "unit")
    assert path is not None and os.path.exists(path)
    results = replay_bundle_file(path, device="cpu")
    assert len(results) == 1
    r = results[0]
    assert r["ok"], r["mismatches"]
    assert r["lanes"] == {"torch": "ok"}


def test_replay_detects_tampered_verdicts(tmp_path):
    rec = FlightRecorder(capacity=2, out_dir=str(tmp_path))
    rec.note(_artifacts_for(0), "pod-t", "success")
    path = rec.persist("tamper-test")
    lines = open(path).read().splitlines()
    bundle = json.loads(lines[1])
    # flip one recorded verdict: the replay must notice
    bundle["verdicts"]["feasible"][0] ^= 1
    res = replay_bundle(bundle, device="cpu")
    assert not res["ok"]
    assert any("feasible" in m for m in res["mismatches"])


def test_recorder_ring_and_bundles_bounded(tmp_path):
    rec = FlightRecorder(capacity=3, out_dir=str(tmp_path), max_nodes=64)
    for i in range(10):
        rec.note(_artifacts_for(0, seed=i), f"pod-{i}", "success")
    stats = rec.stats()
    assert stats["size"] == 3 and stats["noted"] == 10
    path = rec.persist("bound-test")
    with open(path) as f:
        payload_lines = [ln for ln in f if ln.strip()]
    assert len(payload_lines) == 1 + 3  # header + bounded ring
    # oversize bases are skipped, not stored
    big = _artifacts_for(0)
    big.basis = np.zeros((128, 3), np.int32)
    assert rec.note(big, "pod-big", "success") is None
    assert rec.stats()["skipped_oversize"] == 1


def _native_artifacts(policy_code, seed=0):
    """The reference's test fixture: a native solve captured in the JAX
    package's SolveArtifacts."""
    from k8s_spark_scheduler_tpu.provenance.tracker import SolveArtifacts as JaxArtifacts

    avail, rank, eok, apps = _queue_problem(policy_code, seed)
    n_earlier = apps.shape[0] - 1
    earlier = apps[:n_earlier]
    solve = solve_queue_min_frag_native if policy_code == 2 else solve_queue_native
    kw = {} if policy_code == 2 else {"evenly": policy_code == 1}
    feas, didx, after = solve(avail, rank, eok, earlier[:, 0:3], earlier[:, 3:6], earlier[:, 6],
                              earlier[:, 7].astype(bool), **kw)
    return JaxArtifacts(
        policy_code=policy_code, lane="native", basis=avail, driver_rank=rank, exec_ok=eok,
        packed=apps, n_earlier=n_earlier, feasible=feas, didx=didx, resume=0, avail_after=after,
        queue_names=tuple(f"drv-{i}" for i in range(n_earlier)),
    )


@needs_native
@pytest.mark.parametrize("policy_code", [0, 1, 2])
def test_bundles_cross_between_the_packages(policy_code, tmp_path):
    """A bundle file the JAX package persists replays in the port, and
    the port's replays in the JAX package: one file format."""
    from k8s_spark_scheduler_tpu.provenance.recorder import FlightRecorder as JaxRecorder
    from k8s_spark_scheduler_tpu.provenance.recorder import replay_bundle_file as jax_replay

    jax_rec = JaxRecorder(capacity=4, out_dir=str(tmp_path / "jax"))
    port_rec = FlightRecorder(capacity=4, out_dir=str(tmp_path / "port"))
    for seed in range(3):
        jax_rec.note(_native_artifacts(policy_code, seed), f"pod-{seed}", "failure-fit")
        port_rec.note(_artifacts_for(policy_code, seed), f"pod-{seed}", "failure-fit")
    jax_path = jax_rec.persist("breaker-open", "unit")
    port_path = port_rec.persist("breaker-open", "unit")
    ours = replay_bundle_file(jax_path, device="cpu")
    assert len(ours) == 3 and all(r["ok"] for r in ours), ours
    theirs = jax_replay(port_path)
    assert len(theirs) == 3 and all(r["ok"] for r in theirs), theirs
    # the same solves, captured by each package, persist the same bundle
    # rows, verdicts included (only the lane names differ)
    with open(jax_path) as f:
        jax_bundles = [json.loads(line) for line in f][1:]
    with open(port_path) as f:
        port_bundles = [json.loads(line) for line in f][1:]
    for j, p in zip(jax_bundles, port_bundles):
        assert {k: v for k, v in j.items() if k not in ("lane", "t")} == {
            k: v for k, v in p.items() if k not in ("lane", "t")
        }


def test_journal_written_by_the_reference_recovers_in_the_port(tmp_path):
    """A durable journal the JAX package wrote (a reservation diverted
    during an outage, another acked) is replayed by the port's server at
    boot: the unlanded reservation lands in the API server, the acked
    one does not come back, and the journal drains."""
    from k8s_spark_scheduler_tpu.resilience.journal import IntentJournal as JaxJournal
    from k8s_spark_scheduler_tpu.types import serde as jax_serde
    from k8s_spark_scheduler_tpu.types.objects import ObjectMeta, Reservation, ResourceReservation
    from k8s_spark_scheduler_tpu.types.resources import Resources
    from k8s_spark_scheduler_tpu_torch.config import Install, ResilienceConfig
    from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
    from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients

    def rr(name):
        out = ResourceReservation(meta=ObjectMeta(name=name, namespace="default"))
        out.spec.reservations["driver"] = Reservation.for_resources("n1", Resources.of("1", "1Gi"))
        out.status.pods["driver"] = f"{name}-driver"
        return out

    path = str(tmp_path / "intents.jsonl")
    journal = JaxJournal(path=path)
    for name in ("app-lost", "app-landed"):
        journal.record("create", "ResourceReservation", "default", name,
                       jax_serde.rr_to_dict_v1beta2(rr(name)))
    journal.ack("create", "default", "app-landed")
    journal.close()

    install = Install(binpack_algo="tpu-batch", resilience=ResilienceConfig(journal_path=path))
    server = init_server_with_clients(APIServer(), install, device="cpu")
    try:
        kit = server.resilience
        deadline = __import__("time").monotonic() + 10
        while kit.journal.depth() or not server.api.list("ResourceReservation"):
            assert __import__("time").monotonic() < deadline, kit.journal.pending()
            __import__("time").sleep(0.01)
        landed = server.api.list("ResourceReservation")
        assert [x.name for x in landed] == ["app-lost"]
        assert landed[0].spec.reservations["driver"].node == "n1"
        assert landed[0].status.pods == {"driver": "app-lost-driver"}
    finally:
        server.stop()
    # the port's journal file reloads in the JAX package, drained
    assert JaxJournal(path=path).depth() == 0


# ---------------------------------------------------------------------------
# extender integration (harness)
# ---------------------------------------------------------------------------


@pytest.fixture
def fifo_harness(tmp_path):
    h = Harness(binpack_algo="tpu-batch", is_fifo=True, device="cpu")
    tracker = h.server.provenance
    if tracker is not None:
        tracker.recorder.out_dir = str(tmp_path / "bundles")
    yield h
    h.close()


def test_refused_driver_explain_has_shortfall_and_message(fifo_harness):
    h = fifo_harness
    for i in range(2):
        h.new_node(f"node-{i}", cpu="8", memory="32Gi", zone="az-a")
    names = [f"node-{i}" for i in range(2)]
    pods = h.static_allocation_spark_pods(
        "app-too-big", 5, driver_cpu="2", executor_cpu="4",
        driver_mem="2Gi", executor_mem="4Gi",
    )
    result = h.schedule(pods[0], names)
    assert not result.node_names
    message = next(iter(result.failed_nodes.values()))
    assert "short" in message and "cpu" in message

    tracker = h.server.provenance
    record = tracker.explain(pods[0].name)
    assert record is not None
    assert record["outcome"] == "failure-fit"
    sf = record["shortfall"]
    assert sf["kind"] == "capacity"
    assert sf["tightestDimension"] == "cpu"
    assert sf["shortfallExecutors"] >= 1
    assert sf["nearestFitNode"] in names
    assert record["feedSeq"] is not None
    # the delta-solve session served it (on by default, as in the reference)
    assert record["lane"] == "torch-session"


def test_refusal_blocked_by_earlier_driver_names_blockers(fifo_harness):
    h = fifo_harness
    for i in range(2):
        h.new_node(f"node-{i}", cpu="8", memory="32Gi", zone="az-a")
    names = [f"node-{i}" for i in range(2)]
    # a pending earlier driver that hogs the cluster when replayed
    first = h.static_allocation_spark_pods(
        "app-hog", 2, driver_cpu="2", executor_cpu="5",
        driver_mem="2Gi", executor_mem="4Gi",
    )
    h.create_pod(first[0])
    import time

    time.sleep(0.02)
    second = h.static_allocation_spark_pods(
        "app-victim", 2, driver_cpu="1", executor_cpu="3",
        driver_mem="1Gi", executor_mem="2Gi",
    )
    h.create_pod(second[0])
    result = h.schedule(second[0], names)
    assert not result.node_names
    message = next(iter(result.failed_nodes.values()))
    assert "blocked by 1 earlier drivers" in message
    assert "app-hog-driver" in message

    record = h.server.provenance.explain(second[0].name)
    assert record["shortfall"]["blockedBy"] == ["app-hog-driver"]
    assert record["queueSlice"] == ["app-hog-driver"]
    # the decision carried a replayable bundle
    assert record["bundleSeq"] is not None


def test_earlier_driver_refusal_explained_without_delta_engine():
    """With the delta engine off (the Install kill switch) the stateless
    solve_tensor lane captures artifacts BEFORE the blocked-earlier
    early return, so FAILURE_EARLIER_DRIVER refusals carry shortfall
    detail too."""
    h = Harness(binpack_algo="tpu-batch", is_fifo=True, device="cpu", delta_solve=False)
    try:
        assert h.server.extender.delta_engine is None
        for i in range(2):
            h.new_node(f"node-{i}", cpu="8", memory="32Gi", zone="az-a")
        names = [f"node-{i}" for i in range(2)]
        # an enforced earlier driver that cannot fit at all: 3 × 6cpu
        # executors against 2 × 8cpu nodes (per-node cap 1, total 2 < 3)
        hog = h.static_allocation_spark_pods(
            "app-stuck", 3, driver_cpu="1", executor_cpu="6",
            driver_mem="1Gi", executor_mem="1Gi",
        )[0]
        h.create_pod(hog)
        import time

        time.sleep(0.02)
        victim = h.static_allocation_spark_pods(
            "app-after", 1, driver_cpu="1", executor_cpu="1",
            driver_mem="1Gi", executor_mem="1Gi",
        )[0]
        h.create_pod(victim)
        result = h.schedule(victim, names)
        assert not result.node_names
        message = next(iter(result.failed_nodes.values()))
        assert message.startswith("earlier drivers do not fit")
        assert "short" in message

        record = h.server.provenance.explain(victim.name)
        assert record is not None
        assert record["outcome"] == "failure-earlier-driver"
        sf = record["shortfall"]
        assert sf is not None and sf["tightestDimension"] == "cpu"
        assert record["lane"] == "torch"
    finally:
        h.close()


def test_uniform_failure_buffer_reuse_with_enriched_message(fifo_harness):
    """The shortfall-enriched message must not break the encode-once
    buffer — identical refusals reuse the same encoded response bytes."""
    from k8s_spark_scheduler_tpu_torch.types import serde
    from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs

    h = fifo_harness
    h.new_node("node-0", cpu="2", memory="4Gi", zone="az-a")
    names = serde.intern_node_names(["node-0"])
    pods = h.static_allocation_spark_pods(
        "app-reuse", 4, driver_cpu="2", executor_cpu="2",
        driver_mem="2Gi", executor_mem="2Gi",
    )
    h.create_pod(pods[0])
    r1 = h.extender.predicate(ExtenderArgs(pod=pods[0], node_names=names))
    r2 = h.extender.predicate(ExtenderArgs(pod=pods[0], node_names=names))
    assert r1.uniform_failure is not None and r2.uniform_failure is not None
    b1 = serde.encode_extender_filter_result(r1)
    b2 = serde.encode_extender_filter_result(r2)
    assert b1 is b2  # same (interned candidates, message) → same buffer
    body = json.loads(b1)
    msg = next(iter(body["FailedNodes"].values()))
    assert "short" in msg  # the dimension detail reached the wire


def test_success_decisions_recorded_too(fifo_harness):
    h = fifo_harness
    h.new_node("node-0", cpu="8", memory="32Gi", zone="az-a")
    pods = h.static_allocation_spark_pods("app-ok", 1)
    result = h.schedule(pods[0], ["node-0"])
    assert result.node_names
    record = h.server.provenance.explain(pods[0].name)
    assert record is not None
    assert record["outcome"] == "success"
    assert record["node"] == "node-0"
    assert record["shortfall"] is None


def test_provenance_soak_stays_bounded(fifo_harness):
    """Ring and bundle sizes stay bounded while decisions stream
    through."""
    h = fifo_harness
    tracker = h.server.provenance
    for i in range(3):
        h.new_node(f"node-{i}", cpu="16", memory="64Gi", zone="az-a")
    names = [f"node-{i}" for i in range(3)]
    for i in range(40):
        pods = h.static_allocation_spark_pods(
            f"app-soak-{i}", 1, driver_cpu="1", executor_cpu="1",
            driver_mem="1Gi", executor_mem="1Gi",
        )
        h.schedule(pods[0], names)
    stats = tracker.stats()
    assert stats["ring"]["size"] <= stats["ring"]["capacity"]
    assert stats["recorder"]["size"] <= stats["recorder"]["capacity"]
    # bundle ring holds bounded host bytes (16-node basis × 8 bundles)
    assert stats["recorder"]["ring_bytes"] < 4 << 20
    assert stats["ring"]["recorded"] >= 40


# ---------------------------------------------------------------------------
# triggers
# ---------------------------------------------------------------------------


def test_trigger_persists_bundles(tmp_path):
    tracker = ProvenanceTracker(bundle_dir=str(tmp_path))
    tracker.recorder.note(_artifacts_for(0), "pod-x", "failure-fit")
    path = tracker.on_trigger("deadline-exceeded", "unit test")
    assert path is not None and os.path.exists(path)
    header = json.loads(open(path).readline())
    assert header["trigger"] == "deadline-exceeded"
    results = replay_bundle_file(path, device="cpu")
    assert results and all(r["ok"] for r in results)


def test_parity_mismatch_fires_recorder(tmp_path):
    tracker = ProvenanceTracker(bundle_dir=str(tmp_path))
    tracker.recorder.note(_artifacts_for(1), "pod-y", "success")
    tracker.on_parity_mismatch({"policy": 1})
    assert tracker.parity_mismatches == 1
    assert tracker.recorder.persisted_paths


def test_parity_mismatch_bundle_contains_the_diverging_solve(tmp_path):
    """The persisted mismatch bundle must hold the anomalous solve
    itself, so replaying it reproduces the divergence by construction."""
    tracker = ProvenanceTracker(bundle_dir=str(tmp_path))
    bad = _artifacts_for(0)
    # fabricate a divergence: flip one recorded verdict
    bad.feasible = bad.feasible.copy()
    bad.feasible[0] = not bad.feasible[0]
    tracker.on_parity_mismatch({"policy": 0, "artifacts": bad})
    assert tracker.recorder.persisted_paths
    results = replay_bundle_file(tracker.recorder.persisted_paths[-1], device="cpu")
    parity = [r for r in results if r["pod"] == "parity-check"]
    assert parity, "the diverging solve was not in the bundle"
    assert not parity[0]["ok"]  # the replay diverges from the recorded verdicts


def test_refusal_explain_memoized_per_content_key(fifo_harness):
    """A requeue of the same refused pod against unchanged cluster
    state must serve the explanation from the memo, not re-replay the
    queue (the refusal-path cost bound)."""
    from k8s_spark_scheduler_tpu_torch.metrics import names as mnames
    from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs

    h = fifo_harness
    h.new_node("node-0", cpu="4", memory="8Gi", zone="az-a")
    pod = h.static_allocation_spark_pods(
        "app-memo", 4, driver_cpu="2", executor_cpu="2",
        driver_mem="2Gi", executor_mem="2Gi",
    )[0]
    h.create_pod(pod)
    metrics = h.server.metrics
    args = ExtenderArgs(pod=pod, node_names=["node-0"])
    r1 = h.extender.predicate(args)
    fresh = metrics.get_counter(
        mnames.PROVENANCE_EXPLAIN_COUNT, {"source": "refusal"}
    )
    r2 = h.extender.predicate(args)
    assert not r1.node_names and not r2.node_names
    assert metrics.get_counter(
        mnames.PROVENANCE_EXPLAIN_COUNT, {"source": "refusal"}
    ) == fresh  # no second explain
    assert metrics.get_counter(
        mnames.PROVENANCE_EXPLAIN_COUNT, {"source": "refusal-cached"}
    ) >= 1
    # both responses carry the same enriched message
    assert next(iter(r1.failed_nodes.values())) == next(
        iter(r2.failed_nodes.values())
    )


def test_refusal_explain_memo_distinguishes_candidate_subsets(fifo_harness):
    """kube-scheduler node sampling rotates NodeNames between attempts
    with no state delta; the memo must treat a different candidate
    subset as a different explain (the subset lives in the exec_ok /
    driver_rank masks, not node_names)."""
    from k8s_spark_scheduler_tpu_torch.metrics import names as mnames
    from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs

    h = fifo_harness
    h.new_node("node-0", cpu="8", memory="32Gi", zone="az-a")
    h.new_node("node-1", cpu="4", memory="32Gi", zone="az-a")
    pod = h.static_allocation_spark_pods(
        "app-subset", 9, driver_cpu="2", executor_cpu="4",
        driver_mem="1Gi", executor_mem="1Gi",
    )[0]
    h.create_pod(pod)
    m = h.server.metrics
    h.extender.predicate(ExtenderArgs(pod=pod, node_names=["node-0", "node-1"]))
    h.extender.predicate(ExtenderArgs(pod=pod, node_names=["node-0", "node-1"]))
    h.extender.predicate(ExtenderArgs(pod=pod, node_names=["node-0"]))
    assert m.get_counter(
        mnames.PROVENANCE_EXPLAIN_COUNT, {"source": "refusal"}
    ) == 2  # full set once, subset once
    assert m.get_counter(
        mnames.PROVENANCE_EXPLAIN_COUNT, {"source": "refusal-cached"}
    ) == 1  # the unchanged repeat


def test_shortfall_gauges_cleared_on_next_admission(fifo_harness):
    from k8s_spark_scheduler_tpu_torch.metrics import names as mnames

    h = fifo_harness
    h.new_node("node-0", cpu="8", memory="32Gi", zone="az-a")
    metrics = h.server.metrics
    too_big = h.static_allocation_spark_pods(
        "app-gauge-big", 6, driver_cpu="2", executor_cpu="4",
        driver_mem="1Gi", executor_mem="1Gi",
    )[0]
    result = h.schedule(too_big, ["node-0"])
    assert not result.node_names
    assert metrics.get_gauge(
        mnames.PROVENANCE_SHORTFALL, {"dim": "cpu"}
    ) > 0
    # the refused driver leaves the queue, a fitting gang admits:
    # the deficit is resolved and the gauge must clear
    h.delete_pod(too_big)
    fits = h.static_allocation_spark_pods(
        "app-gauge-fit", 1, driver_cpu="1", executor_cpu="1",
        driver_mem="1Gi", executor_mem="1Gi",
    )[0]
    assert h.schedule(fits, ["node-0"]).node_names
    assert metrics.get_gauge(
        mnames.PROVENANCE_SHORTFALL, {"dim": "cpu"}
    ) == 0.0


def test_trigger_persist_debounced_per_trigger(tmp_path):
    """An overload-driven trigger storm writes one file per trigger
    type per interval, never one per failed request."""
    tracker = ProvenanceTracker(
        bundle_dir=str(tmp_path), trigger_min_interval=3600.0
    )
    tracker.recorder.note(_artifacts_for(0), "pod-d", "failure-deadline")
    first = tracker.on_trigger("deadline-exceeded", "storm 1")
    assert first is not None
    for i in range(5):
        assert tracker.on_trigger("deadline-exceeded", f"storm {i+2}") is None
    assert tracker.triggers_suppressed == 5
    # a DIFFERENT trigger type is not suppressed by the deadline storm
    assert tracker.on_trigger("breaker-open", "other") is not None
    assert len(os.listdir(tmp_path)) == 2


def test_ring_namespace_disambiguation():
    ring = ProvenanceRing(capacity=8)
    ring.record(DecisionRecord(pod="driver-0", namespace="ns-a", outcome="failure-fit"))
    ring.record(DecisionRecord(pod="driver-0", namespace="ns-b", outcome="success"))
    assert ring.latest_for_pod("ns-a/driver-0").outcome == "failure-fit"
    assert ring.latest_for_pod("ns-b/driver-0").outcome == "success"
    # bare name: newest match across namespaces
    assert ring.latest_for_pod("driver-0").outcome == "success"
    assert ring.latest_for_pod("ns-c/driver-0") is None


def test_breaker_open_invokes_observer():
    from k8s_spark_scheduler_tpu_torch.resilience.breaker import CircuitBreaker

    opened = []
    breaker = CircuitBreaker(failure_threshold=2)
    breaker.on_open = opened.append
    breaker.record_failure()
    assert not opened
    breaker.record_failure()
    assert opened == ["writeback"]
    breaker.record_failure()  # already open: no second fire
    assert opened == ["writeback"]


def test_breaker_open_trigger_persists_replayable_bundles(tmp_path):
    """The wiring makes the write-back breaker's opening a flight-recorder
    trigger: an outage persists the recent decisions, which replay."""
    from k8s_spark_scheduler_tpu_torch.kube.errors import APIError

    h = Harness(binpack_algo="tpu-batch", is_fifo=True, device="cpu")
    try:
        tracker = h.server.provenance
        tracker.recorder.out_dir = str(tmp_path)
        h.server.resilience.breaker.failure_threshold = 1
        h.new_node("node-0", cpu="16", memory="64Gi", zone="az-a")
        queued = h.static_allocation_spark_pods("app-queued", 2, executor_cpu="4")[0]
        h.create_pod(queued)
        h.api.set_write_fault(lambda op, kind, ns, name: APIError("down") if kind == "ResourceReservation" else None)
        try:
            pod = h.static_allocation_spark_pods("app-first", 1)[0]
            assert h.schedule(pod, ["node-0"]).node_names
            assert h.wait_for_api(lambda: tracker.recorder.persisted_paths)
        finally:
            h.api.set_write_fault(None)
        path = tracker.recorder.persisted_paths[0]
        assert "breaker-open" in os.path.basename(path)
        results = replay_bundle_file(path, device="cpu")
        assert results and all(r["ok"] for r in results), results
    finally:
        h.close()


# ---------------------------------------------------------------------------
# the Twin: both packages on their default provenance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "policy", ["tpu-batch", "tpu-batch-distribute-evenly", "tpu-batch-minimal-fragmentation"]
)
def test_twin_refusals_explained_equal(policy):
    """Refusals behind the queue, refusals of a blocked earlier driver and
    an undersized cluster, on the JAX server and the port's: failure
    messages byte-equal (Twin.schedule) and the decision records equal
    but for the fields that name the serving server."""
    from tests.torch_parity import Twin

    twin = Twin(policy)
    try:
        names = []
        for i in range(4):
            twin.add_node(f"n{i}", cpu="16", memory="64Gi")
            names.append(f"n{i}")
        twin.advance(1)
        queue = []
        for j, (k, cpu) in enumerate([(6, "4"), (3, "8"), (5, "2")]):
            wire = twin.static_pods(f"queued-{j}", k, age=100 - j, executor_cpu=cpu)[0]
            twin.create_pod(wire)
            queue.append(wire)
        probes = [
            twin.static_pods("behind", 10, executor_cpu="4")[0],  # fits the cluster, not behind the queue
            twin.static_pods("huge", 40, executor_cpu="8")[0],  # fits nowhere
        ]
        messages = []
        for wire in probes:
            twin.create_pod(wire)
            assert twin.schedule(wire, names) is None
            messages.append(twin.results[-1]["FailedNodes"][names[0]])
            records = []
            for tracker in (twin.jax.server.provenance, twin.port.server.provenance):
                record = dict(tracker.explain(wire["metadata"]["name"]))
                for key in ("lane", "traceId"):
                    record.pop(key)
                record["contentKey"] = record["contentKey"][1:]
                records.append(record)
            assert records[0] == records[1]
        assert "blocked by" in messages[0] and "short" in messages[1]
        # an enforced earlier driver that cannot fit blocks the queue
        stuck = twin.static_pods("stuck", 30, age=200, executor_cpu="16")[0]
        twin.create_pod(stuck)
        late = twin.static_pods("late", 1)[0]
        twin.create_pod(late)
        assert twin.schedule(late, names) is None
        assert twin.results[-1]["FailedNodes"][names[0]].startswith("earlier drivers do not fit")
        twin.assert_state_equal()
    finally:
        twin.close()


# ---------------------------------------------------------------------------
# OpenMetrics exemplars
# ---------------------------------------------------------------------------


def test_openmetrics_exemplars_negotiated():
    from k8s_spark_scheduler_tpu_torch.metrics import prometheus as prom
    from k8s_spark_scheduler_tpu_torch.metrics.registry import MetricsRegistry
    from k8s_spark_scheduler_tpu_torch.tracing import Tracer

    registry = MetricsRegistry()
    tracer = Tracer(capacity=8, metrics=registry)
    with tracer.span("predicate", {"pod": "p"}, trace_id="trace-abc-123"):
        registry.histogram("foundry.spark.scheduler.schedule.time", 0.0125)
    registry.histogram("foundry.spark.scheduler.wait.time", 1.0)  # no trace

    plain = prom.render(registry)
    assert "trace_id" not in plain
    assert "# EOF" not in plain

    om = prom.render(registry, openmetrics=True)
    assert om.rstrip().endswith("# EOF")
    line = next(
        ln for ln in om.splitlines()
        if ln.startswith("foundry_spark_scheduler_schedule_time_count")
    )
    assert '# {trace_id="trace-abc-123"} 0.0125' in line
    # a histogram never observed in-trace carries no exemplar
    no_ex = next(
        ln for ln in om.splitlines()
        if ln.startswith("foundry_spark_scheduler_wait_time_count")
    )
    assert "trace_id" not in no_ex
