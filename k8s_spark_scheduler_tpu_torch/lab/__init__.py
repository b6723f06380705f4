"""Trace lab: production-scale workload synthesis + policy-matrix
evaluation; a copy of the reference package's ``lab/``, on this
package's ``sim/`` and ``lifecycle/`` (the same trace bytes, cell
digests and matrix documents as the reference's).

The lab is the judging apparatus for every other roadmap item: scale
refactors and policy changes land with trace-level before/after
evidence, not microbenchmarks.

- :mod:`.synth` — seeded synthesizer for production-shaped workloads
  (heavy-tailed gang sizes, diurnal arrival intensity, multi-tenant
  band/weight mixes) at 10^5–10^6 app arrivals, dumped as the same
  JSONL trace format ``sim/workload.py`` replays;
- :mod:`.spec` — declarative matrix experiment spec (ordering ×
  preemption × backfill × DRF weights × autoscaler lag × chaos)
  validated up front and expanded into named cells;
- :mod:`.engine` — the gang-level discrete-event replay engine: one
  isolated VirtualClock per cell, deterministic admission/backfill/
  preemption/fair-share dynamics over integer resource math, emitting
  the scorecard schema per cell;
- :mod:`.runner` — parallel worker *processes* executing cells with a
  self-describing artifact directory per cell (scorecard.json +
  run_manifest.json), digest-verified cross-process;
- :mod:`.report` — folds per-cell scorecards into one matrix report
  (packing / wait / waste / fairness rankings, canonical digests,
  leaf-level cell diffs via ``lifecycle/scorecard.py``).

CLI: ``python -m k8s_spark_scheduler_tpu_torch.lab {synth,run,report,diff}``;
the gate over its matrix documents is
``python -m k8s_spark_scheduler_tpu_torch.tools.policy_regression``.

The lab runs on the host only and has no ``device`` argument: the
replay is integer math in Python over per-node free vectors, and nothing
of it reaches a tensor, so there is no CUDA path to default to.  Its
worker processes import this package but open no CUDA context.
"""

from .engine import CellResult, GangLabSim, run_cell
from .report import build_matrix_report, diff_cells
from .runner import run_matrix
from .spec import MatrixCell, MatrixSpec, SpecError
from .synth import SynthSpec, synthesize

__all__ = [
    "CellResult",
    "GangLabSim",
    "run_cell",
    "build_matrix_report",
    "diff_cells",
    "run_matrix",
    "MatrixCell",
    "MatrixSpec",
    "SpecError",
    "SynthSpec",
    "synthesize",
]
