"""The port's node equivalence-class index (``state/classindex.py``) and
the snapshot stamps the delta-solve engine's class-digest warm tier keys
on, case for case the digest and revision tests of the reference's
tests/test_class_compression.py, and the port against the reference:

- ``ClassIndex`` digest / revision semantics, and the tensor mirror's
  ``class_digest`` / ``class_rev`` stamps;
- the port's and the JAX package's ``ClassIndex`` give equal ``digest``
  and ``class_rev`` for the same node sequence in one process;
- the digest tier's warm hit (a reservation created then released: the
  change feed moved, the XOR digest cancelled back) on both packages'
  servers through the Twin, decisions byte-equal, and equal to a port
  server without the tier and one without the engine.

- the exact grouping on the device (``ops/classes.group_rows``) against
  the JAX package's ``group_rows``, class ids element for element, and
  the capacity observatory's multiplicity-weighted class probes and
  frag reports against the row-level programs and the JAX package's
  (the reference's analytics-parity cases).

The reference's class-compressed stepping tests (the stateless and
session class solves) are tests/test_torch_class_compression.py's.
"""

import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu.capacity.probe import INT32_SAFE
from k8s_spark_scheduler_tpu.capacity.probe import frag_report as jax_frag_report
from k8s_spark_scheduler_tpu.capacity.probe import frag_report_classes as jax_frag_report_classes
from k8s_spark_scheduler_tpu.capacity.probe import probe_headroom_classes as jax_probe_headroom_classes
from k8s_spark_scheduler_tpu.capacity.probe import probe_headroom_numpy as jax_probe_headroom
from k8s_spark_scheduler_tpu.native import group_rows as jax_group_rows
from k8s_spark_scheduler_tpu.state.classindex import ClassIndex as JaxClassIndex
from k8s_spark_scheduler_tpu_torch.capacity.probe import frag_segments, probe_segments
from k8s_spark_scheduler_tpu_torch.ops.classes import group_rows
from k8s_spark_scheduler_tpu_torch.state.classindex import ClassIndex
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

from torch_parity import Twin


def test_classindex_digest_and_revision_semantics():
    ci = ClassIndex()
    alloc = np.array([8000, 16 << 30, 0], dtype=np.int64)
    zero = np.zeros(3, dtype=np.int64)
    ci.note_node(0, "a", alloc, zero, zero, 0, True, False, labels={})
    ci.note_node(1, "b", alloc, zero, zero, 0, True, False, labels={})
    assert ci.stats()[:2] == (1, 2)
    rev0, d0 = ci.class_rev, ci.digest

    # usage-only churn: content digest flips, the class multiset (and
    # therefore class_rev) does not
    used = zero.copy()
    used[0] = 100
    ci.note_node(1, "b", alloc, used, zero, 0, True, False)
    assert ci.digest != d0 and ci.class_rev == rev0
    ci.note_node(1, "b", alloc, zero, zero, 0, True, False)
    assert ci.digest == d0 and ci.class_rev == rev0

    # cordon flips schedulability: a class-key move, so the rev bumps
    ci.note_node(1, "b", alloc, zero, zero, 0, True, True)
    assert ci.class_rev > rev0 and ci.stats()[0] == 2

    # drop + byte-identical re-add: the XOR digest cancels exactly while
    # the rev records that the multiset was disturbed in between
    rev1, d1 = ci.class_rev, ci.digest
    ci.drop_node(1)
    assert ci.digest != d1
    ci.note_node(1, "b", alloc, zero, zero, 0, True, True, labels={})
    assert ci.digest == d1 and ci.class_rev > rev1

    # capacity bucketing: one alloc milli-unit apart lands in the SAME
    # identity class (identity is bucketed; solve decisions are not)
    ci2 = ClassIndex()
    ci2.note_node(0, "x", np.array([8000, 1 << 30, 0], np.int64), zero, zero, 0, True, False, labels={})
    ci2.note_node(1, "y", np.array([8001, 1 << 30, 0], np.int64), zero, zero, 0, True, False, labels={})
    assert ci2.stats()[0] == 1
    assert sum(ci2.class_sizes().values()) == 2


class _FakeInformer:
    def add_event_handler(self, **kw):
        pass


class _FakeObservable:
    def add_change_observer(self, fn):
        pass


def test_snapshot_stamps_class_digest_and_revision():
    from k8s_spark_scheduler_tpu_torch.state.tensor_snapshot import TensorSnapshotCache
    from k8s_spark_scheduler_tpu_torch.types.objects import Node, ObjectMeta
    from k8s_spark_scheduler_tpu_torch.types.resources import Resources

    cache = TensorSnapshotCache(_FakeInformer(), _FakeInformer(), _FakeObservable(), _FakeObservable())

    def node(name, cpu="8", unschedulable=False):
        return Node(
            meta=ObjectMeta(name=name, labels={}),
            allocatable=Resources.of(cpu, "16Gi", "0"),
            ready=True,
            unschedulable=unschedulable,
        )

    cache._on_node(node("n1"))
    cache._on_node(node("n2"))
    cache._on_node(node("n3", cpu="4"))
    s0 = cache.snapshot()
    assert s0.class_digest[0] == cache._instance_id
    assert cache.classes.stats()[:2] == (2, 3)

    # delete + byte-identical re-add: digest cancels, revision advances
    cache._on_node_delete(node("n2"))
    cache._on_node(node("n2"))
    s1 = cache.snapshot()
    assert s1.class_digest == s0.class_digest
    assert s1.class_rev > s0.class_rev

    # cordon moves n3 to a new (unschedulable) class: both change
    cache._on_node(node("n3", cpu="4", unschedulable=True))
    s2 = cache.snapshot()
    assert s2.class_digest != s1.class_digest
    assert s2.class_rev > s1.class_rev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_and_reference_index_agree_on_one_node_sequence(seed):
    """Both packages' indexes fed one random sequence of notes and drops
    (usage churn, cordons, relabels, removals) in one process: equal
    digest, revision, stats and class multiset after every step."""
    rng = np.random.RandomState(seed)
    ours, theirs = ClassIndex(), JaxClassIndex()
    shapes = [np.array([c * 1000, m << 30, g * 1000], np.int64) for c, m, g in ((8, 32, 0), (16, 64, 1), (4, 8, 0))]
    zero = np.zeros(3, np.int64)
    for step in range(120):
        slot = int(rng.randint(0, 12))
        if rng.rand() < 0.15:
            ours.drop_node(slot)
            theirs.drop_node(slot)
        else:
            alloc = shapes[rng.randint(0, len(shapes))]
            usage = np.array([rng.randint(0, 4) * 500, rng.randint(0, 3) << 30, 0], np.int64)
            labels = {"pool": f"p{rng.randint(0, 3)}"} if rng.rand() < 0.5 else None
            args = (slot, f"n{slot}", alloc, usage, zero, int(rng.randint(0, 2)), bool(rng.rand() < 0.9),
                    bool(rng.rand() < 0.1))
            res_count = int(rng.randint(0, 2))
            ours.note_node(*args, res_count=res_count, labels=labels)
            theirs.note_node(*args, res_count=res_count, labels=labels)
        assert (ours.digest, ours.class_rev) == (theirs.digest, theirs.class_rev), f"step {step}"
        assert ours.stats() == theirs.stats() and ours.class_sizes() == theirs.class_sizes()


def _digest_tier_sequence(twin):
    """Nodes and a FIFO queue; a probe app scheduled then deleted
    between Filters of an unschedulable queued gang: the change feed
    moves, the node rows cancel back."""
    names = [f"n{i}" for i in range(6)]
    for name in names:
        twin.add_node(name, cpu="16", memory="32Gi")
    twin.advance(1)
    for j in range(5):
        twin.create_pod(twin.static_pods(f"queued-{j}", 2, age=100 - j)[0])
    big = twin.static_pods("big", 400)[0]
    twin.create_pod(big)
    assert twin.schedule(big, names) is None
    for i in range(3):
        probe = twin.static_pods(f"probe-{i}", 1, age=200)
        twin.create_pod(probe[0])
        assert twin.schedule(probe[0], names) is not None
        twin.delete_pod(probe[0])
        twin.settle()
        assert twin.replay(big, names) is None
    return names


def test_digest_tier_warm_hit_equals_cold_on_both_packages():
    twin = Twin("tpu-batch")
    try:
        _digest_tier_sequence(twin)
        jax_stats, port_stats = twin.delta_stats()
        assert port_stats == jax_stats
        assert port_stats["digest_hits"] >= 3 and port_stats["warm_hits"] >= 3
        twin.assert_state_equal()
        results = list(twin.results)
    finally:
        twin.close()
    # the same decisions with the tier off (the row compare serves) and
    # with the engine off (every Filter cold)
    for switch in ("classes-off", "engine-off"):
        twin = Twin("tpu-batch")
        try:
            engine = twin.port.extender.delta_engine
            if switch == "classes-off":
                engine.classes_enabled = False
                twin.jax.extender.delta_engine.classes_enabled = False
            else:
                twin.port.extender.delta_engine = None
            _digest_tier_sequence(twin)
            assert twin.results == results, switch
            if switch == "classes-off":
                jax_stats, port_stats = twin.delta_stats()
                assert port_stats == jax_stats and port_stats["digest_hits"] == 0
                assert port_stats["warm_hits"] >= 3
        finally:
            twin.close()


def test_classes_enabled_or_not_gives_identical_verdicts():
    """The reference's end-to-end case on the engine's lane: a harness
    with classes on (min-nodes 0) and one with them off give the same
    Filter verdicts and FailedNodes messages."""
    from k8s_spark_scheduler_tpu_torch.config import ClassesConfig, FifoConfig, Install

    outs = []
    for enabled in (True, False):
        h = Harness(extra_install=Install(
            fifo=True, fifo_config=FifoConfig(), binpack_algo="tpu-batch",
            instance_group_label="resource_channel", classes=ClassesConfig(enabled=enabled, min_nodes=0),
        ), device="cpu")
        try:
            names = []
            for i in range(6):
                h.new_node(f"node-{i}", cpu="8", memory="8Gi", gpu="0")
                names.append(f"node-{i}")
            h.new_node("node-odd", cpu="9", memory="8Gi", gpu="0")
            names.append("node-odd")
            out = {}
            pods = h.static_allocation_spark_pods(
                "app-fit", 4, driver_cpu="1", driver_mem="1Gi", executor_cpu="2", executor_mem="2Gi",
            )
            out["fit_driver"] = list(h.schedule(pods[0], names).node_names or [])
            out["fit_execs"] = [list(h.schedule(p, names).node_names or []) for p in pods[1:]]
            pods = h.static_allocation_spark_pods(
                "app-toobig", 64, driver_cpu="1", driver_mem="1Gi", executor_cpu="4", executor_mem="4Gi",
            )
            r = h.schedule(pods[0], names)
            out["big_nodes"] = list(r.node_names or [])
            out["big_failed"] = dict(r.failed_nodes or {})
            r = h.schedule(pods[0], names)  # the retry is served warm
            out["big_retry"] = dict(r.failed_nodes or {})
            assert h.extender.delta_engine.stats()["warm_hits"] >= 1
            outs.append(out)
        finally:
            h.close()
    assert outs[0] == outs[1]
    assert outs[0]["fit_driver"] and not outs[0]["big_nodes"]


# -- the exact grouping and the class analytics -------------------------------

SEEDS = [101, 102, 103, 104, 105]


def _fleet(rng, n, n_shapes=12):
    """Fleet-shaped availability (the reference's generator): ~n_shapes
    repeated machine shapes salted with near-duplicates (one resource
    off by exactly ONE unit, which must split the class) and unique
    single-node classes."""
    shapes = rng.randint(10, 120, size=(n_shapes, 3)).astype(np.int64)
    avail = shapes[rng.randint(0, n_shapes, size=n)].copy()
    near = rng.choice(n, size=max(1, n // 10), replace=False)
    avail[near, rng.randint(0, 3, size=len(near))] += 1
    singles = rng.choice(n, size=max(1, n // 20), replace=False)
    avail[singles] = rng.randint(1000, 2000, size=(len(singles), 3))
    return avail


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("seed", SEEDS)
def test_class_probe_and_frag_match_row_level(seed):
    """The reference's analytics parity case: class ids equal the JAX
    package's ``group_rows`` element for element, and the weighted class
    frag report and headroom search equal the row-level programs on the
    grouped rows and the JAX package's, probes per shape included."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(150, 500))
    avail = _fleet(rng, n)
    elig = rng.rand(n) > 0.15

    n_classes, cls, reps = group_rows(_t(avail), _t(elig))
    want_n, want_cls = jax_group_rows(avail, np.asarray(elig, dtype=np.uint8))
    assert n_classes == want_n < n  # fleet-shaped input must compress
    np.testing.assert_array_equal(cls.numpy(), want_cls)
    mult = np.bincount(want_cls, minlength=want_n).astype(np.int64)
    _, want_reps = np.unique(want_cls, return_index=True)
    np.testing.assert_array_equal(reps.numpy(), want_reps)
    class_avail, class_elig = avail[want_reps], elig[want_reps]

    def one_segment(out):
        return tuple(x[0] for x in out)

    ones = np.ones(n, dtype=np.int64)
    row_frag = one_segment(frag_segments(_t(avail), _t(ones), _t(elig), [0, n]))
    cls_frag = one_segment(frag_segments(_t(class_avail), _t(mult), _t(class_elig), [0, want_n]))
    want = jax_frag_report(avail, elig)
    for got in (row_frag, cls_frag):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(cls_frag[4].numpy(), jax_frag_report_classes(class_avail, class_elig, mult)[4])

    shapes = np.hstack([rng.randint(0, 3, size=(3, 3)), rng.randint(1, 6, size=(3, 3))]).astype(np.int64)
    rank = np.where(elig, 0, INT32_SAFE).astype(np.int64)
    want_h, want_u, want_p = jax_probe_headroom(avail, rank, elig, shapes)
    row_h, row_u, row_p = one_segment(
        probe_segments(_t(avail), _t(ones), _t(elig), _t(rank < INT32_SAFE), [0, n], _t(shapes))
    )
    cls_h, cls_u, cls_p = one_segment(
        probe_segments(_t(class_avail), _t(mult), _t(class_elig), _t(class_elig), [0, want_n], _t(shapes))
    )
    ref_cls = jax_probe_headroom_classes(class_avail, mult, class_elig, shapes)
    for got in ((row_h, row_u, row_p), (cls_h, cls_u, cls_p)):
        np.testing.assert_array_equal(got[0].numpy(), want_h)
        np.testing.assert_array_equal(got[1].numpy(), want_u)
        np.testing.assert_array_equal(got[2].numpy(), want_p)
    for a, b in zip((cls_h, cls_u, cls_p), ref_cls):
        np.testing.assert_array_equal(a.numpy(), b)


def test_group_rows_splits_near_duplicates_and_flags():
    rows = np.array([[10, 20, 30], [10, 20, 30], [10, 20, 31], [10, 20, 30]], dtype=np.int64)
    flags = np.array([1, 1, 1, 0], dtype=np.uint8)
    n_classes, cls, reps = group_rows(_t(rows), _t(flags))
    # one unit off in one dimension => different class; a different
    # eligibility flag on identical rows => different class too
    assert n_classes == 3
    assert cls[0] == cls[1] and cls[2] != cls[0] and cls[3] != cls[0]
    want_n, want_cls = jax_group_rows(rows, flags)
    assert n_classes == want_n
    np.testing.assert_array_equal(cls.numpy(), want_cls)
    np.testing.assert_array_equal(reps.numpy(), [0, 2, 3])
    # no rows, and no flag
    assert group_rows(torch.zeros((0, 3), dtype=torch.int64))[0] == 0
    n_classes, cls, _ = group_rows(_t(rows))
    assert n_classes == 2 and cls.tolist() == [0, 0, 1, 0]
