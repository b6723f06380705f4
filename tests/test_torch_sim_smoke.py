"""The port's simulator end to end on the CPU (``device="cpu"``: the
kernels' plain versions), held to the reference's ``Simulation``: the
bundled ``examples/sim/smoke.json`` and the inline mini-chaos scenario of
tests/test_sim_smoke.py give equal event logs, digests, summaries and no
violation on either side; sim traces are virtual end to end; the CLI
writes the reference's artifacts, prints the reference CLI's ``digest=``
line, exits nonzero on a violation and replays flight-recorder bundles
through the port's ``provenance.replay_bundle_file``."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from k8s_spark_scheduler_tpu.sim.__main__ import main as jax_sim_main
from k8s_spark_scheduler_tpu_torch.ops.queue_kernel import fifo_queue
from k8s_spark_scheduler_tpu_torch.provenance.recorder import FlightRecorder
from k8s_spark_scheduler_tpu_torch.provenance.tracker import SolveArtifacts
from k8s_spark_scheduler_tpu_torch.sim import auditor as port_auditor
from k8s_spark_scheduler_tpu_torch.sim.__main__ import main as sim_main
from k8s_spark_scheduler_tpu_torch.sim.manifest import MANIFEST_NAME, MANIFEST_SCHEMA
from torch_sim_parity import EXAMPLES, example, parity

MINI_CHAOS = {
    "name": "mini-chaos", "seed": 11, "duration": 240, "retry_interval": 15, "fifo": True,
    "cluster": {"nodes": 3, "cpu": "8", "memory": "16Gi", "zones": ["zone1", "zone2"]},
    "workload": {"process": "burst", "burst_interval": 60, "burst_size": 2, "executors": {"min": 1, "max": 4},
                 "dynamic_fraction": 0.5, "lifetime": {"min": 50, "max": 120}},
    "autoscaler": {"enabled": True, "delay": 20, "max_nodes": 6},
    "faults": [
        {"at": 70, "kind": "node_kill", "count": 1},
        {"at": 100, "kind": "executor_storm", "apps": 1, "fraction": 0.5},
        {"at": 130, "kind": "failover"},
    ],
}


def test_smoke_scenario_matches_the_reference():
    _, result, _ = parity(example("smoke"))
    s = result.summary
    assert s["invariant_violations"] == 0 and s["decisions"] > 0
    assert s["apps"]["arrived"] > 0 and s["apps"]["completed"] > 0
    assert s["events_audited"] >= s["events_logged"] > 0
    assert s["digest"] == result.digest and len(result.digest) == 64
    for entry in result.event_log:
        assert "state" in entry and "t" in entry and entry["t"] >= 0.0
    lat = s["decision_latency_ms"]
    assert set(lat) == {"p50", "p95", "p99", "max"} and lat["max"] >= lat["p99"] >= lat["p50"] >= 0.0


def test_mini_chaos_scenario_matches_the_reference():
    _, result, _ = parity(MINI_CHAOS)
    s = result.summary
    assert s["nodes"]["killed"] == 1 and s["apps"]["arrived"] >= 4
    kinds = [e["event"] for e in result.event_log if e["event"].startswith("fault:")]
    assert kinds == ["fault:node_kill", "fault:executor_storm", "fault:failover"]


def test_sim_traces_are_virtual_end_to_end_with_contention_summary():
    """Span durations read ``timesource.perf``, which the sim points at
    its clock: a request runs while virtual time stands still, so every
    span of every sim trace lasts exactly 0.0 ms.  The contention
    scorecard is wall-clock telemetry by design."""
    from torch_sim_parity import run_port

    sim, result = run_port(example("smoke"))
    assert result.violations == []
    traces = sim.harness.server.tracer.traces()
    assert traces, "sim requests must produce traces"

    def walk(span):
        yield span
        for child in span.get("children", ()):
            yield from walk(child)

    for trace in traces:
        assert trace["durationMs"] == 0.0, trace["traceId"]
        for span in walk(trace["root"]):
            assert span["durationMs"] == 0.0, (trace["traceId"], span["name"])
    con = result.summary["contention"]
    assert con is not None and con["predicate_lock"]["acquisitions"] > 0
    assert con["criticalpath"]["requests"] >= 0


# -- the CLI ------------------------------------------------------------------


def _digest_line(out: str) -> str:
    lines = [line for line in out.splitlines() if line.startswith("digest=")]
    assert len(lines) == 1, out[-2000:]
    return lines[0]


def test_cli_writes_the_artifacts_and_the_reference_digest(tmp_path, capsys):
    scenario = os.path.join(EXAMPLES, "smoke.json")
    out = tmp_path / "port"
    assert sim_main(["--scenario", scenario, "--device", "cpu", "--out", str(out), "--quiet"]) == 0
    ours = _digest_line(capsys.readouterr().out)
    assert jax_sim_main(["--scenario", scenario, "--out", str(tmp_path / "ref"), "--quiet"]) == 0
    theirs = _digest_line(capsys.readouterr().out)
    assert ours == theirs

    summary = json.loads((out / "summary.json").read_text())
    assert ours == f"digest={summary['digest']}"
    events = [json.loads(line) for line in (out / "events.jsonl").read_text().splitlines()]
    assert events == [json.loads(line) for line in (tmp_path / "ref" / "events.jsonl").read_text().splitlines()]
    assert (out / "events.jsonl").read_bytes() == (tmp_path / "ref" / "events.jsonl").read_bytes()
    manifest = json.loads((out / MANIFEST_NAME).read_text())
    assert manifest["schema"] == MANIFEST_SCHEMA and manifest["kind"] == "sim-run"
    assert manifest["seed"] == 7 and manifest["scenario"] == "smoke"
    assert manifest["digests"]["events"] == summary["digest"]
    ref_manifest = json.loads((tmp_path / "ref" / MANIFEST_NAME).read_text())
    assert manifest["digests"] == ref_manifest["digests"]
    listed = {a["name"]: a for a in manifest["artifacts"]}
    assert {"events.jsonl", "summary.json", "capacity.jsonl", "contention.json", "scorecard.json"} <= set(listed)
    assert set(listed) == {a["name"] for a in ref_manifest["artifacts"]}
    for name, entry in listed.items():
        body = (out / name).read_bytes()
        assert hashlib.sha256(body).hexdigest() == entry["sha256"] and entry["bytes"] == len(body), name


def test_cli_seed_override_and_trace_dump(tmp_path, capsys):
    scenario = os.path.join(EXAMPLES, "smoke.json")
    trace = tmp_path / "trace.jsonl"
    assert sim_main(["--scenario", scenario, "--seed", "3", "--dump-trace", str(trace)]) == 0
    ref_trace = tmp_path / "ref.jsonl"
    assert jax_sim_main(["--scenario", scenario, "--seed", "3", "--dump-trace", str(ref_trace)]) == 0
    assert trace.read_bytes() == ref_trace.read_bytes() and trace.read_bytes()
    capsys.readouterr()
    assert sim_main(["--scenario", scenario, "--seed", "3", "--device", "cpu", "--quiet"]) == 0
    ours = _digest_line(capsys.readouterr().out)
    assert jax_sim_main(["--scenario", scenario, "--seed", "3", "--quiet"]) == 0
    assert ours == _digest_line(capsys.readouterr().out)


def test_cli_exits_nonzero_on_a_violation(monkeypatch, capsys):
    real = port_auditor.invariants.check
    calls = []

    def check(server, raise_on_violation=True):
        calls.append(1)
        found = real(server, raise_on_violation=raise_on_violation)
        return found + (["I9: planted violation"] if len(calls) == 3 else [])

    monkeypatch.setattr(port_auditor.invariants, "check", check)
    scenario = os.path.join(EXAMPLES, "smoke.json")
    assert sim_main(["--scenario", scenario, "--device", "cpu", "--quiet"]) == 1
    captured = capsys.readouterr()
    assert "VIOLATION: I9: planted violation" in captured.err
    assert _digest_line(captured.out)


def _artifacts(policy_code: int, seed: int) -> SolveArtifacts:
    """A captured solve of the port's queue pass (its plain version)."""
    from k8s_spark_scheduler_tpu_torch.ops.minfrag_kernel import fifo_queue_min_frag

    rng = np.random.default_rng(42 + seed + policy_code)
    nb, na = 16, 7
    avail = rng.integers(4, 40, size=(nb, 3)).astype(np.int32)
    avail[:, 2] = 0
    rank, eok = np.arange(nb, dtype=np.int32), np.ones(nb, dtype=bool)
    apps = np.zeros((na, 8), np.int32)
    apps[:, 0:2] = rng.integers(1, 4, size=(na, 2))
    apps[:, 3:5] = rng.integers(1, 6, size=(na, 2))
    apps[:, 6] = rng.integers(1, 5, size=na)
    apps[:, 7] = 1
    earlier = apps[: na - 1]
    args = tuple(torch.as_tensor(x) for x in (avail, rank, eok, earlier[:, 0:3], earlier[:, 3:6], earlier[:, 6],
                                                 earlier[:, 7].astype(bool)))
    if policy_code == 2:
        feas, didx, after = fifo_queue_min_frag(*args)
    else:
        feas, didx, after = fifo_queue(*args, evenly=policy_code == 1)
    return SolveArtifacts(policy_code=policy_code, lane="torch", basis=avail, driver_rank=rank, exec_ok=eok,
                          packed=apps, n_earlier=na - 1, feasible=feas.numpy(), didx=didx, resume=0,
                          avail_after=after, queue_names=tuple(f"drv-{i}" for i in range(na - 1)))


def test_cli_replays_bundles_and_fails_a_tampered_file(tmp_path, capsys):
    """tests/test_provenance.py:661 on the port's CLI: three bundles, one
    per policy, replay byte-identical; a tampered verdict exits 1."""
    rec = FlightRecorder(capacity=4, out_dir=str(tmp_path))
    for policy in (0, 1, 2):
        rec.note(_artifacts(policy, 0), f"pod-{policy}", "failure-fit")
    path = rec.persist("cli-test")
    assert sim_main(["--replay-bundle", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "3 byte-identical, 0 diverged" in out
    assert out.count("[torch=ok] ok") == 3

    lines = open(path).read().splitlines()
    bundle = json.loads(lines[1])
    bundle["verdicts"]["didx"][0] += 1
    tampered = tmp_path / "tampered.jsonl"
    tampered.write_text(lines[0] + "\n" + json.dumps(bundle) + "\n")
    assert sim_main(["--replay-bundle", str(tampered), "--device", "cpu"]) == 1
    assert "1 diverged" in capsys.readouterr().out


def test_cli_needs_a_scenario_or_a_bundle(capsys):
    with pytest.raises(SystemExit) as exc:
        sim_main(["--device", "cpu"])
    assert exc.value.code == 2
    assert "--scenario is required" in capsys.readouterr().err
