"""The port's policy-regression gate
(``python -m k8s_spark_scheduler_tpu_torch.tools.policy_regression``):
the reference's gate cases of tests/test_lifecycle.py (the scorecard
mode's exit codes, the matrix mode's exit codes, the committed chaos
baseline's self-consistency), each run through the port's gate and
through the reference's ``tools/policy_regression.py``, which must
answer the same exit codes; and the lab's seeded regression and forged
baseline through both gates, their reports equal.
"""

import importlib.util
import json
import pathlib

import pytest

from k8s_spark_scheduler_tpu_torch.lab import MatrixSpec, SynthSpec, run_matrix, synthesize
from k8s_spark_scheduler_tpu_torch.lifecycle import (
    SCHEMA_NAME,
    SloEngine,
    build_scorecard,
    scorecard_digest,
)
from k8s_spark_scheduler_tpu_torch.tools import policy_regression

REPO = pathlib.Path(__file__).resolve().parents[1]


def _reference_gate_main():
    spec = importlib.util.spec_from_file_location(
        "policy_regression_reference", REPO / "tools" / "policy_regression.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


GATES = {"port": lambda: policy_regression.main, "reference": _reference_gate_main}


@pytest.fixture(params=sorted(GATES))
def gate(request):
    return GATES[request.param]()


def test_policy_regression_gate_exit_codes(gate, tmp_path, capsys):
    main = gate
    card = build_scorecard(None, SloEngine(), meta={"source": "sim"}, now=5.0)
    current = tmp_path / "current.json"
    baseline = tmp_path / "baseline.json"
    current.write_text(json.dumps(card))

    # 2: no baseline yet
    assert main(["--current", str(current), "--baseline", str(baseline)]) == 2

    # --update seeds it → 0 on re-check
    assert main(["--current", str(current), "--baseline", str(baseline), "--update"]) == 0
    report = tmp_path / "report.json"
    assert main(
        ["--current", str(current), "--baseline", str(baseline), "--json", str(report)]
    ) == 0
    assert json.loads(report.read_text())["pass"] is True

    # 1: seeded digest mismatch, with the drifted leaf named
    seeded = json.loads(json.dumps(card))
    seeded["lifecycle"] = {"gangs": 7}
    drifted = tmp_path / "drifted.json"
    drifted.write_text(json.dumps(seeded))
    assert main(
        ["--current", str(drifted), "--baseline", str(baseline), "--json", str(report)]
    ) == 1
    out = json.loads(report.read_text())
    assert out["pass"] is False
    assert any(d["path"] == "lifecycle.gangs" for d in out["diffs"])

    # a hand-edited baseline digest cannot mask drift: digests are
    # recomputed from the documents
    forged = json.loads(baseline.read_text())
    forged["digest"] = out["currentDigest"]
    baseline.write_text(json.dumps(forged))
    assert main(["--current", str(drifted), "--baseline", str(baseline)]) == 1

    # 2: invalid JSON input
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert main(["--current", str(bad), "--baseline", str(baseline)]) == 2




def test_policy_regression_matrix_gate_exit_codes(gate, tmp_path, capsys):
    """Matrix-mode gate (lab PR): 2 on malformed/forged inputs, 0 after
    --update, 1 on drifted or missing cells — mirroring the scorecard
    mode's contract."""
    main = gate
    card = build_scorecard(None, SloEngine(), meta={"source": "lab"}, now=5.0)
    cell = {
        "cell": "fifo",
        "axes": {"ordering": "fifo"},
        "scorecard": card,
        "eventsDigest": "e" * 64,
        "kpis": {"packing_efficiency": {"max": 0.5}},
    }
    matrix = {"schema": "tpu-gang-scheduler-matrix", "version": 1, "cells": [cell]}
    current = tmp_path / "matrix.json"
    baseline = tmp_path / "baseline.json"
    current.write_text(json.dumps(matrix))

    # exactly one mode may be selected
    with pytest.raises(SystemExit):
        main([])
    with pytest.raises(SystemExit):
        main(["--current", "x.json", "--matrix-current", "y.json"])

    # 2: no baseline yet; --update seeds it -> 0 on re-check
    args = ["--matrix-current", str(current), "--matrix-baseline", str(baseline)]
    assert main(args) == 2
    assert main(args + ["--update"]) == 0
    report = tmp_path / "report.json"
    assert main(args + ["--json", str(report)]) == 0
    assert json.loads(report.read_text())["pass"] is True

    # 2: malformed current (invalid JSON / no schema / no cells list)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert main(["--matrix-current", str(bad), "--matrix-baseline", str(baseline)]) == 2
    bad.write_text(json.dumps({"cells": []}))
    assert main(["--matrix-current", str(bad), "--matrix-baseline", str(baseline)]) == 2
    bad.write_text(json.dumps({"schema": "tpu-gang-scheduler-matrix", "cells": "nope"}))
    assert main(["--matrix-current", str(bad), "--matrix-baseline", str(baseline)]) == 2

    # 1: a cell's scorecard drifted — the leaf is named in the report
    drifted_doc = json.loads(json.dumps(matrix))
    drifted_doc["cells"][0]["scorecard"]["lifecycle"] = {"gangs": 9}
    drifted = tmp_path / "drifted.json"
    drifted.write_text(json.dumps(drifted_doc))
    assert main(
        ["--matrix-current", str(drifted), "--matrix-baseline", str(baseline),
         "--json", str(report)]
    ) == 1
    out = json.loads(report.read_text())
    assert out["pass"] is False
    assert out["driftedCells"][0]["cell"] == "fifo"
    assert any(
        d["path"] == "lifecycle.gangs" for d in out["driftedCells"][0]["diffs"]
    )

    # 1: KPI drift alone (same scorecard) still trips the composite digest
    kpi_drift = json.loads(json.dumps(matrix))
    kpi_drift["cells"][0]["kpis"]["packing_efficiency"]["max"] = 0.9
    drifted.write_text(json.dumps(kpi_drift))
    assert main(
        ["--matrix-current", str(drifted), "--matrix-baseline", str(baseline),
         "--json", str(report)]
    ) == 1
    assert json.loads(report.read_text())["driftedCells"][0]["diffs"] == []

    # 1: a baseline cell missing from the current run
    empty = json.loads(json.dumps(matrix))
    empty["cells"] = []
    drifted.write_text(json.dumps(empty))
    assert main(
        ["--matrix-current", str(drifted), "--matrix-baseline", str(baseline),
         "--json", str(report)]
    ) == 1
    assert json.loads(report.read_text())["missingCells"] == ["fifo"]

    # forged baseline digests are ignored: the gate recomputes from the
    # documents, so editing the stored strings cannot mask a stale body
    forged = json.loads(baseline.read_text())
    forged["cells"][0]["scorecard"]["lifecycle"] = {"gangs": 1}
    baseline.write_text(json.dumps(forged))
    drifted.write_text(json.dumps(matrix))
    assert main(["--matrix-current", str(drifted), "--matrix-baseline", str(baseline)]) == 1



def test_committed_chaos_baseline_is_internally_consistent():
    """The committed baseline's stored digest must match its own body —
    a hand-edited baseline is caught here, not first in CI."""
    path = REPO / "tests" / "baselines" / "scorecard_chaos.json"
    card = json.loads(path.read_text())
    assert card["schema"]["name"] == SCHEMA_NAME
    assert card["digest"] == scorecard_digest(card)
    assert len(card["objectives"]) >= 4
    assert card["lifecycle"]["gangs"] > 0


def test_port_gate_passes_the_committed_chaos_baseline_against_itself(tmp_path):
    """Scorecard mode with the default baseline, found from the repo
    root: the committed chaos scorecard checked against itself passes."""
    current = tmp_path / "scorecard.json"
    current.write_text((REPO / "tests" / "baselines" / "scorecard_chaos.json").read_text())
    assert policy_regression.DEFAULT_BASELINE == str(
        REPO / "tests" / "baselines" / "scorecard_chaos.json"
    )
    assert policy_regression.DEFAULT_MATRIX_BASELINE == str(
        REPO / "tests" / "baselines" / "matrix_smoke.json"
    )
    assert policy_regression.main(["--current", str(current)]) == 0


@pytest.fixture(scope="module")
def drifted_smoke(tmp_path_factory):
    """The lab's seeded regression (preemption reaches one band further
    down) on the smoke matrix, as a matrix document."""
    raw = json.loads((REPO / "examples" / "lab" / "smoke_synth.json").read_text())
    apps = synthesize(SynthSpec.from_dict(raw))
    spec = json.loads((REPO / "examples" / "lab" / "smoke_matrix.json").read_text())
    base = run_matrix(MatrixSpec.from_dict(spec), apps=apps)
    drifted = run_matrix(MatrixSpec.from_dict(dict(spec, min_band_gap=2)), apps=apps)
    out = tmp_path_factory.mktemp("drift")
    return base, drifted, out


@pytest.mark.parametrize("forged", [False, True], ids=["seeded", "forged-baseline"])
def test_seeded_and_forged_matrix_drift_same_report_from_both_gates(drifted_smoke, forged):
    base, drifted, out = drifted_smoke
    baseline = json.loads(json.dumps(base))
    if forged:
        for base_cell, cur_cell in zip(baseline["cells"], drifted["cells"]):
            base_cell["digest"] = cur_cell["digest"]
            base_cell["eventsDigest"] = cur_cell["eventsDigest"]
            base_cell["scorecard"]["digest"] = cur_cell["scorecard"]["digest"]
    base_path, cur_path = out / f"baseline-{forged}.json", out / f"current-{forged}.json"
    base_path.write_text(json.dumps(baseline))
    cur_path.write_text(json.dumps(drifted))
    reports = {}
    for name, make in sorted(GATES.items()):
        report = out / f"{name}-{forged}.json"
        code = make()(
            ["--matrix-current", str(cur_path), "--matrix-baseline", str(base_path),
             "--json", str(report)]
        )
        assert code == 1, name
        reports[name] = json.loads(report.read_text())
    assert reports["port"] == reports["reference"]
    assert reports["port"]["driftedCells"]
    # the stored baseline checked against itself passes through both,
    # forged digests and all: only the bodies count
    for make in GATES.values():
        assert make()(["--matrix-current", str(base_path), "--matrix-baseline", str(base_path)]) == 0
