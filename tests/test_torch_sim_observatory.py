"""The observatories through the port's simulator, the reference cases
that waited for it:

- tests/test_capacity.py:572: the sim summary's capacity and waste
  columns, equal to the reference's for the same scenario (where the
  probes ran aside), and the capacity timeline against the reference's;
- tests/test_lifecycle.py:344: the sim's SLO scorecard has the live
  server's schema (and the reference's sim scorecard's);
- the chaos scorecard's ``scorecard_digest`` equals the reference's.

One count in the scorecard races in both packages: ``lifecycle.
transitions`` counts a gang's ``reserved`` phase only when the
reservation's informer event (from the asynchronous write-back thread)
arrives before the driver's bind (from the round), so runs of either
package count differently on a loaded host (chaos.json: 104 on an idle
one, 105 in one of eight fresh reference runs, 105 against the port's
107 under the six-worker tier-1 run).  The digests are compared with
that count taken from the port's card; every other field is compared as
is."""

import json

from k8s_spark_scheduler_tpu.lifecycle import scorecard_digest as jax_scorecard_digest
from k8s_spark_scheduler_tpu_torch.lifecycle import build_scorecard, scorecard_digest
from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
from torch_sim_parity import example, parity, run_port, run_reference

CAPACITY_SMOKE = {
    "name": "capacity-smoke", "seed": 11, "duration": 120, "retry_interval": 15, "fifo": True,
    "binpack_algo": "tpu-batch",
    "cluster": {"nodes": 3, "cpu": "8", "memory": "16Gi", "zones": ["z1"]},
    "workload": {"process": "poisson", "rate_per_min": 3, "executors": {"min": 1, "max": 3},
                 "lifetime": {"min": 30, "max": 60}},
}
# where the probes ran and what a sample cost on the host clock
SAMPLE_HOST_FIELDS = ("probeLane", "sampleMs")


def _sample_fields(sample: dict) -> dict:
    """A timeline sample less its host fields and the tensor mirror's
    instance number (the first element of its keys: a count of the
    mirrors built in the process)."""
    out = {k: v for k, v in sample.items() if k not in SAMPLE_HOST_FIELDS}
    for key in ("contentKey", "structureKey"):
        if key in out:
            out[key] = out[key][1:]
    if isinstance(out.get("classes"), dict):
        out["classes"] = {k: v for k, v in out["classes"].items() if k != "expandMs"}
    return out


def test_sim_summary_carries_the_reference_capacity_and_waste_columns():
    sim, result, theirs = parity(CAPACITY_SMOKE)
    capsum = result.summary["capacity"]
    assert capsum is not None and capsum["samples"] > 0
    assert capsum["lock_violations"] == 0
    assert capsum["probe_lane"] == "torch"
    assert 0.0 <= capsum["fragmentation_max_dim"]["max"] <= 1.0
    assert capsum["headroom_executors"]["p50"] >= 0 and capsum["queue_pressure"]["max"] >= 0
    ref = dict(theirs.summary["capacity"])
    assert {k: v for k, v in capsum.items() if k != "probe_lane"} == {
        k: v for k, v in ref.items() if k != "probe_lane"}
    assert result.summary["waste_phases"] == theirs.summary["waste_phases"]
    assert result.capacity_timeline
    assert len(result.capacity_timeline) == capsum["timeline_ring"]
    seqs = [s["seq"] for s in result.capacity_timeline]
    assert seqs == sorted(seqs)
    assert [_sample_fields(s) for s in result.capacity_timeline] == [
        _sample_fields(s) for s in theirs.capacity_timeline]


def test_chaos_capacity_columns_match_the_reference():
    _, result, theirs = parity(example("chaos"))
    ours, ref = result.summary["capacity"], theirs.summary["capacity"]
    assert {k: v for k, v in ours.items() if k != "probe_lane"} == {
        k: v for k, v in ref.items() if k != "probe_lane"}
    assert result.summary["waste_phases"] == theirs.summary["waste_phases"]
    assert result.summary["waste_phases"], "the chaos run recorded no scheduling waste"


def _schema_tree(value, path=""):
    """tests/test_lifecycle.py's ``_schema_tree``: the key structure,
    content-keyed maps as opaque leaves whose values still count."""
    content_keyed = {"lifecycle.phases", "lifecycle.evictionsByCause", "objectives"}
    if isinstance(value, dict):
        if path == "":
            value = {k: (v if k != "meta" else {}) for k, v in value.items()}
        if path in content_keyed:
            sub = sorted({json.dumps(_schema_tree(v, path + ".*")) for v in value.values()})
            return {"*": sub}
        return {k: _schema_tree(v, f"{path}.{k}" if path else k) for k, v in sorted(value.items())}
    return type(value).__name__ if not isinstance(value, (int, float, str, type(None))) else "leaf"


def test_sim_and_live_scorecards_share_a_schema():
    spec = {"name": "schema-probe", "seed": 3, "duration": 120, "cluster": {"nodes": 4},
            "workload": {"rate_per_min": 2.0}}
    _, result = run_port(spec)
    sim_card = result.summary["slo"]
    assert sim_card is not None and sim_card["meta"]["source"] == "sim"
    _, theirs = run_reference(spec)
    assert _schema_tree(sim_card) == _schema_tree(theirs.summary["slo"])

    h = Harness(device="cpu")
    try:
        h.new_node("n1")
        h.new_node("n2")
        pods = h.static_allocation_spark_pods("app-schema", 1)
        h.assert_success(h.schedule(pods[0], ["n1", "n2"]))
        h.wait_quiesced()
        h.server.lifecycle.drain(trigger="test")
        live_card = build_scorecard(h.server.lifecycle, h.server.slo, meta={"source": "server"})
    finally:
        h.close()
    assert _schema_tree(sim_card) == _schema_tree(live_card)
    assert sim_card["digest"] == scorecard_digest(sim_card)
    assert live_card["digest"] == scorecard_digest(live_card)


def test_chaos_scorecard_digest_matches_the_reference():
    _, result, theirs = parity(example("chaos"))
    ours, ref = result.summary["slo"], json.loads(json.dumps(theirs.summary["slo"]))
    assert ours["meta"] == ref["meta"] == {"source": "sim", "scenario": "chaos", "seed": 42}
    assert ours["lifecycle"]["transitions"] >= ours["lifecycle"]["gangs"]
    ref["lifecycle"]["transitions"] = ours["lifecycle"]["transitions"]
    assert {k: v for k, v in ours.items() if k != "digest"} == {k: v for k, v in ref.items() if k != "digest"}
    assert ours["digest"] == scorecard_digest(ours) == jax_scorecard_digest(ref)
