"""Class churn through the port's simulator (tests/test_sim_classchurn.py),
held to the reference: ``examples/sim/classchurn.json`` at 120 nodes
(its 100,000 cut as the reference's test cuts it) and the reference
test's inline dict give the reference's event logs and digests; the
capacity timeline carries the class lane; the class machinery on and off
decide alike."""

from torch_sim_parity import example, parity, run_port


def classchurn_dict(nodes=300):
    """tests/test_sim_classchurn.py's ``_classchurn_dict``."""
    return {
        "name": "classchurn-smoke", "seed": 20, "duration": 300, "retry_interval": 15, "fifo": True,
        "binpack_algo": "tightly-pack",
        "cluster": {"nodes": nodes, "cpu": "16", "memory": "32Gi", "zones": ["zone1", "zone2"]},
        "workload": {"process": "burst", "burst_interval": 60, "burst_size": 2, "executors": {"min": 2, "max": 6},
                     "lifetime": {"min": 60, "max": 150}},
        "classes": {"enabled": True, "min-nodes": 0},
        "faults": [
            {"at": 60, "kind": "node_cordon", "count": 4},
            {"at": 110, "kind": "node_uncordon", "count": 3},
            {"at": 160, "kind": "node_cordon", "count": 3},
            {"at": 210, "kind": "node_uncordon", "count": 3},
            {"at": 250, "kind": "node_kill", "count": 1},
        ],
    }


def test_classchurn_example_at_120_nodes_matches_the_reference():
    spec = example("classchurn")
    spec["cluster"] = dict(spec["cluster"], nodes=120)
    _, result, _ = parity(spec)
    assert result.summary["nodes"]["killed"] == 2
    assert sum(e["event"] == "fault:node_cordon" for e in result.event_log) == 4


def test_classchurn_dict_matches_the_reference_with_the_class_lane():
    _, result, _ = parity(classchurn_dict())
    assert result.summary["nodes"]["killed"] == 1 and result.summary["decisions"] > 0
    classed = [s["classes"] for s in result.capacity_timeline if s.get("classes")]
    assert classed, "no capacity sample carried the class lane"
    assert all(c["count"] >= 1 for c in classed)
    assert any(c["ratio"] > 1.0 for c in classed)
    counts = {c["indexCount"] for c in classed if "indexCount" in c}
    assert len(counts) >= 2, f"class membership never flipped: {counts}"
    _, again = run_port(classchurn_dict())
    assert again.digest == result.digest and again.violations == []


def test_classchurn_decides_alike_with_classes_off():
    on_spec, off_spec = classchurn_dict(nodes=120), classchurn_dict(nodes=120)
    off_spec["classes"] = {"enabled": False}
    _, on = run_port(on_spec)
    _, off, _ = parity(off_spec)
    assert on.violations == [] and on.digest == off.digest
