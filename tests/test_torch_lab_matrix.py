"""The port's policy lab (``k8s_spark_scheduler_tpu_torch/lab/``: spec,
engine, runner, report, the CLI) and its policy-regression gate
(``k8s_spark_scheduler_tpu_torch/tools/policy_regression.py``), case for
case the reference's tests/test_lab_matrix.py, and the port against the
reference:

- the smoke matrix through both packages' ``run_matrix``: every cell
  document equal (less ``wallSeconds``), every digest the committed
  ``tests/baselines/matrix_smoke.json``'s;
- all 24 cells of ``full_matrix.json`` over the week trace, loaded from
  a trace file with ``arrival_limit`` 2,000 (the runner's truncation
  path), each cell equal between the packages;
- two full-scale corner cells of the week trace (100,000 arrivals on 96
  nodes), each equal to the reference's ``run_cell`` and to the digest
  the reference computes here (``WEEK_CORNERS``).

The reference's docstring, which every mirrored case below keeps:

The acceptance spine of the lab PR: declarative specs expand into a
deterministic cell set; every cell replays byte-identically in-process
and across spawned worker processes; the report ranks policies; and the
extended policy-regression gate catches a seeded policy change with
exit 1 against the committed 3-cell smoke baseline.
"""

import json
import hashlib
import pathlib
import resource

import pytest

from k8s_spark_scheduler_tpu.lab import MatrixSpec as JaxMatrixSpec
from k8s_spark_scheduler_tpu.lab import run_cell as jax_run_cell
from k8s_spark_scheduler_tpu.lab import run_matrix as jax_run_matrix
from k8s_spark_scheduler_tpu.sim.workload import load_trace as jax_load_trace
from k8s_spark_scheduler_tpu_torch.lab import (
    MatrixSpec,
    SpecError,
    SynthSpec,
    build_matrix_report,
    diff_cells,
    run_cell,
    run_matrix,
    synthesize,
)
from k8s_spark_scheduler_tpu_torch.lab.__main__ import main as lab_main
from k8s_spark_scheduler_tpu_torch.lab.report import render_report_text
from k8s_spark_scheduler_tpu_torch.sim.manifest import MANIFEST_NAME
from k8s_spark_scheduler_tpu_torch.sim.workload import dump_trace, load_trace
from k8s_spark_scheduler_tpu_torch.tools.policy_regression import main as gate_main

REPO = pathlib.Path(__file__).resolve().parents[1]


def _smoke_apps():
    raw = json.loads((REPO / "examples" / "lab" / "smoke_synth.json").read_text())
    return synthesize(SynthSpec.from_dict(raw))


def _smoke_spec(**over):
    raw = json.loads((REPO / "examples" / "lab" / "smoke_matrix.json").read_text())
    raw.update(over)
    return MatrixSpec.from_dict(raw)


@pytest.fixture(scope="module")
def smoke_apps():
    return _smoke_apps()


@pytest.fixture(scope="module")
def smoke_matrix(smoke_apps):
    """One in-process run of the committed 3-cell smoke matrix, shared
    across this module's assertions."""
    return run_matrix(_smoke_spec(), apps=smoke_apps)


# -- spec validation + expansion ----------------------------------------------


@pytest.mark.parametrize(
    "doc, fragment",
    [
        ({"trace": "", "cellz": 3}, "matrix spec: unknown keys ['cellz']"),
        ({"cluster": {"cores": 4}}, "matrix.cluster: unknown keys ['cores']"),
        ({"cluster": {"nodes": 0}}, "matrix.cluster.nodes: expected a positive int"),
        ({"axes": {"tiebreak": ["lifo"]}}, "matrix.axes: unknown axes ['tiebreak']"),
        ({"axes": {"ordering": ["sjf"]}}, "matrix.axes.ordering: unknown ordering 'sjf'"),
        ({"axes": {"ordering": []}}, "matrix.axes.ordering: expected a non-empty list"),
        ({"axes": {"preemption": [1]}}, "matrix.axes.preemption: expected booleans"),
        ({"axes": {"drf_weights": ["ads"]}}, "matrix.axes.drf_weights: expected null or"),
        (
            {"axes": {"autoscaler_lag": [-3]}},
            "matrix.axes.autoscaler_lag: expected null or",
        ),
        ({"axes": {"chaos": [7]}}, "matrix.axes.chaos: expected null or"),
    ],
)
def test_spec_validation_is_actionable(doc, fragment):
    with pytest.raises(SpecError) as exc:
        MatrixSpec.from_dict(doc)
    assert fragment in str(exc.value), str(exc.value)


def test_duplicate_axis_values_yield_duplicate_cells():
    with pytest.raises(SpecError, match="duplicate cell ids"):
        MatrixSpec.from_dict({"axes": {"ordering": ["fifo", "fifo"]}}).expand()


def test_full_matrix_example_expands_to_24_unique_cells():
    raw = json.loads((REPO / "examples" / "lab" / "full_matrix.json").read_text())
    cells = MatrixSpec.from_dict(raw).expand()
    assert len(cells) == 24  # 3 orderings x 2 preemption x 2 backfill x 2 lag
    ids = [c.cell_id for c in cells]
    assert len(set(ids)) == 24
    # cell ids name exactly the spec-varied axes, in canonical order
    assert any(i.startswith("fifo-nopre-nobf-") for i in ids)
    assert any("-as120" in i for i in ids)
    for cell in cells:
        assert cell.cfg["nodes"] == 96
        assert cell.cfg["cell_id"] == cell.cell_id


def test_unvaried_axes_take_defaults_and_stay_out_of_cell_ids():
    cells = MatrixSpec.from_dict({"axes": {"ordering": ["fifo", "drf"]}}).expand()
    assert [c.cell_id for c in cells] == ["fifo", "drf"]
    for c in cells:
        assert c.axes["preemption"] is False
        assert c.axes["chaos"] is None


def test_spec_digest_is_canonical():
    a = _smoke_spec()
    b = _smoke_spec()
    assert a.digest() == b.digest()
    assert a.digest() != _smoke_spec(min_band_gap=2).digest()


# -- determinism + the committed baseline -------------------------------------


def test_smoke_matrix_is_deterministic_and_policies_diverge(smoke_apps, smoke_matrix):
    rerun = run_matrix(_smoke_spec(), apps=smoke_apps)
    assert [c["digest"] for c in rerun["cells"]] == [
        c["digest"] for c in smoke_matrix["cells"]
    ]
    # the 3 orderings must produce genuinely different outcomes on a
    # contended cluster — identical digests would mean the matrix can't
    # distinguish policies at all
    assert len({c["digest"] for c in smoke_matrix["cells"]}) == 3
    assert len({c["eventsDigest"] for c in smoke_matrix["cells"]}) == 3


def test_committed_matrix_baseline_matches_fresh_run(smoke_matrix, tmp_path):
    """CI's matrix gate contract end to end: a fresh smoke run must be
    byte-identical (per recomputed digests) to the committed baseline."""
    current = tmp_path / "matrix.json"
    current.write_text(json.dumps(smoke_matrix))
    report = tmp_path / "gate.json"
    code = gate_main(
        ["--matrix-current", str(current), "--json", str(report)]
    )
    out = json.loads(report.read_text())
    assert code == 0, out
    assert out["pass"] is True and out["cells"] == 3


def test_seeded_policy_regression_caught_by_matrix_gate(smoke_apps, tmp_path):
    """Acceptance: an intentional policy change (preemption reaches one
    band further down) must trip the gate with exit 1 and name the
    drifted cells."""
    drifted = run_matrix(_smoke_spec(min_band_gap=2), apps=smoke_apps)
    current = tmp_path / "matrix.json"
    current.write_text(json.dumps(drifted))
    report = tmp_path / "gate.json"
    code = gate_main(
        ["--matrix-current", str(current), "--json", str(report)]
    )
    out = json.loads(report.read_text())
    assert code == 1, out
    assert out["pass"] is False
    assert out["driftedCells"], "gate passed a changed preemption policy"
    for cell in out["driftedCells"]:
        assert cell["baselineDigest"] != cell["currentDigest"]


def test_forged_baseline_digests_cannot_mask_drift(smoke_apps, smoke_matrix, tmp_path):
    """The gate recomputes every digest from the documents — copying
    the current run's digest strings into a stale baseline changes
    nothing."""
    drifted = run_matrix(_smoke_spec(min_band_gap=2), apps=smoke_apps)
    baseline = json.loads(json.dumps(smoke_matrix))
    for base_cell, cur_cell in zip(baseline["cells"], drifted["cells"]):
        base_cell["digest"] = cur_cell["digest"]
        base_cell["eventsDigest"] = cur_cell["eventsDigest"]
        base_cell["scorecard"]["digest"] = cur_cell["scorecard"]["digest"]
    base_path = tmp_path / "baseline.json"
    cur_path = tmp_path / "current.json"
    base_path.write_text(json.dumps(baseline))
    cur_path.write_text(json.dumps(drifted))
    code = gate_main(
        ["--matrix-current", str(cur_path), "--matrix-baseline", str(base_path)]
    )
    assert code == 1


def test_cell_digest_excludes_wall_time_and_meta(smoke_apps):
    """Two runs of one cell must share a digest even though wallSeconds
    differ — and the digest must cover the scorecard body, events, and
    KPIs (so any of those drifting changes it)."""
    cfg = _smoke_spec().expand()[0].cfg
    a = run_cell(smoke_apps, cfg)
    b = run_cell(smoke_apps, dict(cfg, trace_digest="different-path"))
    assert a.digest == b.digest  # meta (trace path, seed) is excluded
    limited = run_cell(smoke_apps[:-50], cfg)
    assert limited.digest != a.digest


def test_chaos_and_autoscaler_axes_change_outcomes(smoke_apps):
    """The remaining matrix axes must be live levers, not dead config:
    a leader-crash outage window stalls admission (and is visible in
    the epoch-continuity counters), and autoscaler lag adds capacity."""
    base_cfg = _smoke_spec().expand()[0].cfg
    calm = run_cell(smoke_apps, base_cfg)
    stormy = run_cell(
        smoke_apps,
        dict(base_cfg, chaos={"at": 3600.0, "duration": 1800.0, "every": 43_200.0}),
    )
    assert stormy.digest != calm.digest
    assert stormy.counters["chaos_windows"] >= 4  # every 12h over 2 days
    assert stormy.counters["gangs_spanning_chaos"] > 0
    summary = stormy.scorecard["lifecycle"]["epochContinuity"]
    assert summary["gangsSpanningEpochs"] == stormy.counters["gangs_spanning_chaos"]

    scaled = run_cell(smoke_apps, dict(base_cfg, autoscaler_lag=120.0))
    assert scaled.digest != calm.digest
    assert scaled.counters["nodes_added"] > 0
    # extra capacity must not make waits worse at p50
    assert scaled.kpis["wait_seconds"]["p50"] <= calm.kpis["wait_seconds"]["p50"]


# -- parallel workers ---------------------------------------------------------


def test_parallel_workers_match_in_process_digests(smoke_apps, tmp_path):
    """Cross-process determinism: the same cells run in spawned worker
    processes must produce byte-identical digests to in-process runs —
    verified both by runner's own verify pass and by an independent
    serial run here."""
    trace = tmp_path / "trace.jsonl"
    dump_trace(smoke_apps, str(trace))
    spec = _smoke_spec(trace=str(trace))
    parallel = run_matrix(
        spec, workers=2, out_dir=str(tmp_path / "out"), verify=3
    )
    assert parallel["verification"]["ok"] is True
    assert len(parallel["verification"]["cells"]) == 3
    serial = run_matrix(spec, apps=smoke_apps)
    assert [c["digest"] for c in parallel["cells"]] == [
        c["digest"] for c in serial["cells"]
    ]


def test_run_artifacts_and_manifests(smoke_apps, tmp_path):
    out = tmp_path / "out"
    trace = tmp_path / "trace.jsonl"
    dump_trace(smoke_apps, str(trace))
    matrix = run_matrix(_smoke_spec(trace=str(trace)), out_dir=str(out), apps=smoke_apps)

    top = json.loads((out / MANIFEST_NAME).read_text())
    assert top["kind"] == "lab-matrix"
    assert set(top["digests"]) == {"spec", "trace"}
    assert len(top["cells"]) == 3
    # every sibling artifact is hashed, and the hashes are real
    listed = {a["name"]: a["sha256"] for a in top["artifacts"]}
    assert "matrix.json" in listed
    body = (out / "matrix.json").read_bytes()
    assert hashlib.sha256(body).hexdigest() == listed["matrix.json"]

    for doc in matrix["cells"]:
        cell_dir = out / "cells" / doc["cell"]
        cell_manifest = json.loads((cell_dir / MANIFEST_NAME).read_text())
        assert cell_manifest["kind"] == "lab-cell"
        assert cell_manifest["digests"]["cell"] == doc["digest"]
        assert cell_manifest["digests"]["events"] == doc["eventsDigest"]
        scorecard = json.loads((cell_dir / "scorecard.json").read_text())
        assert scorecard["digest"] == doc["scorecard"]["digest"]
        cell_doc = json.loads((cell_dir / "cell.json").read_text())
        assert cell_doc["digest"] == doc["digest"]


# -- report + diff ------------------------------------------------------------


def test_report_ranks_policies(smoke_matrix):
    report = build_matrix_report(smoke_matrix)
    ids = sorted(c["cell"] for c in smoke_matrix["cells"])
    assert report["cellCount"] == 3
    for dim in ("packing", "wait_p50", "wait_p99", "eviction_waste", "fairness_gap"):
        assert sorted(report["rankings"][dim]) == ids  # a permutation
        assert report["leaders"][dim] == report["rankings"][dim][0]
    # rankings follow the KPIs: best packing really is max packing
    by_id = {c["cell"]: c for c in report["cells"]}
    best_pack = report["leaders"]["packing"]
    assert by_id[best_pack]["packing"] == max(r["packing"] for r in report["cells"])
    best_wait = report["leaders"]["wait_p50"]
    assert by_id[best_wait]["wait_p50"] == min(r["wait_p50"] for r in report["cells"])
    for row in report["cells"]:
        assert row["sloWorst"] in {"ok", "ticket", "page"}
        assert set(row["slo"]) >= {"time_to_admit", "eviction_waste"}
    # the report digest covers its own body
    assert report["digest"] == build_matrix_report(smoke_matrix)["digest"]
    text = render_report_text(report)
    for cell_id in ids:
        assert cell_id in text


def test_diff_cells_localizes_policy_differences(smoke_matrix):
    ids = [c["cell"] for c in smoke_matrix["cells"]]
    assert diff_cells(smoke_matrix, ids[0], ids[0]) == []
    diffs = diff_cells(smoke_matrix, ids[0], ids[-1])
    assert diffs, "fifo and drf cells cannot have identical scorecards here"
    paths = {p for p, _, _ in diffs}
    assert any(p.startswith("objectives.") or p.startswith("lifecycle.") for p in paths)
    with pytest.raises(KeyError, match="not in matrix"):
        diff_cells(smoke_matrix, ids[0], "no-such-cell")


# -- CLI ----------------------------------------------------------------------


def test_cli_end_to_end(tmp_path, capsys):
    trace = tmp_path / "t.jsonl"
    out = tmp_path / "run"
    synth_spec = str(REPO / "examples" / "lab" / "smoke_synth.json")
    matrix_spec = str(REPO / "examples" / "lab" / "smoke_matrix.json")

    # full smoke arrival count: a 300-app trace leaves the 12-node
    # cluster uncontended and every policy produces the same scorecard
    assert lab_main(["synth", "--spec", synth_spec, "--out", str(trace)]) == 0
    assert trace.exists()

    assert lab_main(["run", "--spec", matrix_spec, "--trace", str(trace), "--out", str(out)]) == 0
    assert (out / "matrix.json").exists()
    assert (out / "report.json").exists()
    table = capsys.readouterr().out
    assert "best packing:" in table

    # the CLI refreshes the manifest after writing report.json, so the
    # report is hashed alongside matrix.json and its digest is recorded
    top = json.loads((out / MANIFEST_NAME).read_text())
    listed = {a["name"]: a["sha256"] for a in top["artifacts"]}
    assert {"matrix.json", "report.json"} <= set(listed)
    assert set(top["digests"]) == {"report", "spec", "trace"}
    report_body = (out / "report.json").read_bytes()
    assert hashlib.sha256(report_body).hexdigest() == listed["report.json"]

    assert lab_main(["report", "--matrix", str(out / "matrix.json"), "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    ids = report["rankings"]["packing"]

    # different policies -> nonzero exit and leaf output; same cell -> 0
    assert lab_main(["diff", "--matrix", str(out / "matrix.json"), "--cells", ids[0], ids[-1]]) == 1
    assert "scorecard leaves differ" in capsys.readouterr().out
    assert lab_main(["diff", "--matrix", str(out / "matrix.json"), "--cells", ids[0], ids[0]]) == 0


# -- tier-2 nightly acceptance ------------------------------------------------


@pytest.mark.slow
def test_full_matrix_acceptance_production_scale(tmp_path):
    """Production-scale acceptance: a >=24-cell matrix over >=1e5 synthesized
    arrivals completes across parallel workers with same-seed ⇒
    byte-identical per-cell digests verified cross-process, the report
    ranks policies, and RSS stays bounded over days of simulated time."""
    synth_raw = json.loads((REPO / "examples" / "lab" / "week_synth.json").read_text())
    apps = synthesize(SynthSpec.from_dict(synth_raw))
    assert len(apps) >= 100_000
    trace = tmp_path / "week.jsonl"
    dump_trace(apps, str(trace))

    matrix_raw = json.loads((REPO / "examples" / "lab" / "full_matrix.json").read_text())
    matrix_raw["trace"] = str(trace)
    spec = MatrixSpec.from_dict(matrix_raw)
    assert len(spec.expand()) >= 24

    matrix = run_matrix(spec, workers=2, out_dir=str(tmp_path / "out"), verify=2)
    assert len(matrix["cells"]) == 24
    assert matrix["verification"]["ok"] is True
    digests = [c["digest"] for c in matrix["cells"]]
    assert len(set(digests)) > 1  # axes genuinely change outcomes

    report = build_matrix_report(matrix)
    assert report["cellCount"] == 24
    for dim, order in report["rankings"].items():
        assert len(order) == 24, dim

    # bounded RSS: the engine streams events into an incremental digest,
    # so a week-long 1e5-arrival replay must not balloon the parent
    # (workers are separate processes; the parent holds the trace +
    # 24 scorecards).  3 GiB is ~6x the steady-state observed locally.
    rss_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert rss_kib < 3 * 1024 * 1024, f"parent RSS {rss_kib} KiB"


# -- the port against the reference ------------------------------------------

# full_matrix.json's two corner cells over the whole week trace: every
# axis off, and every axis on; digests from the reference's run_cell
WEEK_CORNERS = {
    "fifo-nopre-nobf-w-d5c449-as-off": (
        "c3c1f6d228c29f26b8167890f4ac13c9d2e37706b31f55db8102b9123fc15f5b",
        268_099,
    ),
    "drf-pre-bf-w-d5c449-as120": (
        "611d2acedb46d0b60cec6e259b8814983e76ab5573789c7873f183aa5dc1e20e",
        285_273,
    ),
}
CUT_ARRIVALS = 2000


def _without_wall(doc):
    """A cell document less its host-clock field."""
    return {k: v for k, v in doc.items() if k != "wallSeconds"}


def _matrix_without_wall(matrix):
    return dict(matrix, cells=[_without_wall(c) for c in matrix["cells"]])


def _full_raw(trace, **over):
    raw = json.loads((REPO / "examples" / "lab" / "full_matrix.json").read_text())
    raw.update(trace=str(trace), **over)
    return raw


@pytest.fixture(scope="module")
def week_trace(tmp_path_factory):
    """The committed week spec's 100,000 arrivals, synthesized by the
    port and written as a trace file (its bytes equal the reference's:
    tests/test_torch_lab_synth.py)."""
    raw = json.loads((REPO / "examples" / "lab" / "week_synth.json").read_text())
    path = tmp_path_factory.mktemp("week") / "week.jsonl"
    dump_trace(synthesize(SynthSpec.from_dict(raw)), str(path))
    return path


@pytest.fixture(scope="module")
def cut_matrices(week_trace):
    """full_matrix.json over the week trace file, cut by the spec's
    ``arrival_limit``, through both packages' runners."""
    raw = _full_raw(week_trace, arrival_limit=CUT_ARRIVALS)
    port = run_matrix(MatrixSpec.from_dict(raw))
    ref = jax_run_matrix(JaxMatrixSpec.from_dict(raw))
    return port, ref


def test_smoke_matrix_equals_the_reference_and_the_baseline(smoke_apps, smoke_matrix):
    raw = json.loads((REPO / "examples" / "lab" / "smoke_matrix.json").read_text())
    ref = jax_run_matrix(JaxMatrixSpec.from_dict(raw), apps=smoke_apps)
    assert _matrix_without_wall(smoke_matrix) == _matrix_without_wall(ref)
    baseline = json.loads((REPO / "tests" / "baselines" / "matrix_smoke.json").read_text())
    assert [(c["cell"], c["digest"], c["eventsDigest"]) for c in smoke_matrix["cells"]] == [
        (c["cell"], c["digest"], c["eventsDigest"]) for c in baseline["cells"]
    ]


def test_cut_week_matrix_documents_equal(cut_matrices, week_trace):
    """The matrix document around the cells (each cell is its own case
    below): the cut arrival count, the trace file's digest, the spec
    digest and the cell order."""
    port, ref = cut_matrices
    assert port["arrivals"] == ref["arrivals"] == CUT_ARRIVALS
    assert port["traceDigest"] == hashlib.sha256(week_trace.read_bytes()).hexdigest()
    assert {k: v for k, v in port.items() if k != "cells"} == {
        k: v for k, v in ref.items() if k != "cells"
    }
    assert [c["cell"] for c in port["cells"]] == [c["cell"] for c in ref["cells"]]
    assert len({c["digest"] for c in port["cells"]}) > 1


_FULL_CELL_IDS = [
    c.cell_id
    for c in MatrixSpec.from_dict(
        json.loads((REPO / "examples" / "lab" / "full_matrix.json").read_text())
    ).expand()
]


@pytest.mark.parametrize("cell_id", _FULL_CELL_IDS)
def test_cut_week_cell_equals_the_reference(cut_matrices, cell_id):
    port, ref = cut_matrices
    mine = next(c for c in port["cells"] if c["cell"] == cell_id)
    theirs = next(c for c in ref["cells"] if c["cell"] == cell_id)
    assert _without_wall(mine) == _without_wall(theirs)
    assert mine["counters"]["arrived"] == CUT_ARRIVALS


@pytest.mark.parametrize("cell_id", sorted(WEEK_CORNERS))
def test_week_corner_cell_equals_the_reference(week_trace, cell_id):
    raw = _full_raw(week_trace)
    cfg = next(c.cfg for c in MatrixSpec.from_dict(raw).expand() if c.cell_id == cell_id)
    jax_cfg = next(c.cfg for c in JaxMatrixSpec.from_dict(raw).expand() if c.cell_id == cell_id)
    assert cfg == jax_cfg
    mine = run_cell(load_trace(str(week_trace)), cfg).to_dict()
    theirs = jax_run_cell(jax_load_trace(str(week_trace)), jax_cfg).to_dict()
    assert _without_wall(mine) == _without_wall(theirs)
    assert (mine["digest"], mine["events"]) == WEEK_CORNERS[cell_id]
