"""Parallel matrix execution across worker processes; a copy of the
reference package's ``lab/runner.py``.

Each cell is a fully isolated replay — its own :class:`GangLabSim`,
its own VirtualClock, no process-global timesource — so cells are safe
to fan out across a ``multiprocessing`` pool.  The pool uses the
*spawn* start method (fork under a thread-carrying parent is how you
mint deadlocks) and a per-worker initializer that parses the trace
ONCE per worker instead of once per cell.

Determinism is the contract: a cell's digest is a pure function of
(trace bytes, cell config), so the same spec + trace must produce
byte-identical digests whether a cell runs in a worker process or
in-process.  ``run_matrix(verify=k)`` re-runs the first ``k`` cells
in-process and refuses to hand back a matrix whose parallel and serial
digests disagree.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
from typing import Dict, List, Optional

from ..sim.manifest import write_run_manifest
from ..sim.workload import AppSpec, load_trace
from .engine import run_cell
from .spec import MatrixSpec

MATRIX_SCHEMA = "tpu-gang-scheduler-matrix"
MATRIX_VERSION = 1

_WORKER: Dict = {}


def _trace_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _load_apps(trace_path: str, arrival_limit: int) -> List[AppSpec]:
    apps = load_trace(trace_path)
    if arrival_limit:
        apps = apps[:arrival_limit]
    return apps


def _worker_init(trace_path: str, arrival_limit: int) -> None:
    _WORKER["apps"] = _load_apps(trace_path, arrival_limit)


def _worker_run(task: Dict) -> Dict:
    cfg = task["cfg"]
    result = run_cell(_WORKER["apps"], cfg)
    doc = result.to_dict()
    cell_dir = task.get("cell_dir")
    if cell_dir:
        _write_cell_artifacts(cell_dir, doc, cfg)
    return doc


def _write_cell_artifacts(cell_dir: str, doc: Dict, cfg: Dict) -> None:
    os.makedirs(cell_dir, exist_ok=True)
    with open(os.path.join(cell_dir, "scorecard.json"), "w") as f:
        json.dump(doc["scorecard"], f, indent=2, sort_keys=True)
        f.write("\n")
    with open(os.path.join(cell_dir, "cell.json"), "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    write_run_manifest(
        cell_dir,
        kind="lab-cell",
        seed=cfg.get("seed"),
        digests={
            "cell": doc["digest"],
            "events": doc["eventsDigest"],
            "scorecard": doc["scorecard"]["digest"],
            "spec": cfg.get("spec_digest", ""),
            "trace": cfg.get("trace_digest", ""),
        },
        extra={"cell": doc["cell"]},
    )


def run_matrix(
    spec: MatrixSpec,
    *,
    workers: int = 0,
    out_dir: Optional[str] = None,
    verify: int = 0,
    apps: Optional[List[AppSpec]] = None,
    metrics=None,
) -> Dict:
    """Expand ``spec`` and execute every cell, returning the matrix
    results document.

    ``workers=0`` runs cells serially in-process (no pool); ``workers>0``
    fans cells out over that many spawned worker processes.  ``verify``
    re-runs the first N cells in-process after a parallel run and raises
    ``RuntimeError`` on any digest divergence — the cross-process
    determinism gate.  ``apps`` short-circuits trace loading (tests).
    """
    cells = spec.expand()
    spec_digest = spec.digest()
    trace_digest = ""
    if spec.trace and os.path.exists(spec.trace):
        trace_digest = _trace_digest(spec.trace)
    if apps is None:
        if not spec.trace:
            raise ValueError("matrix spec has no trace and no apps were supplied")
        apps = _load_apps(spec.trace, spec.arrival_limit)

    tasks = []
    for cell in cells:
        cfg = dict(cell.cfg)
        cfg["spec_digest"] = spec_digest
        cfg["trace_digest"] = trace_digest
        cell_dir = (
            os.path.join(out_dir, "cells", cell.cell_id) if out_dir else None
        )
        tasks.append({"cfg": cfg, "cell_dir": cell_dir})

    if workers > 0:
        ctx = multiprocessing.get_context("spawn")
        if not spec.trace:
            raise ValueError("parallel workers need a trace path to load")
        with ctx.Pool(
            processes=workers,
            initializer=_worker_init,
            initargs=(spec.trace, spec.arrival_limit),
        ) as pool:
            docs = pool.map(_worker_run, tasks, chunksize=1)
    else:
        docs = [
            _run_local(task, apps)
            for task in tasks
        ]

    verification = None
    if verify > 0:
        checked = []
        ok = True
        for task, doc in list(zip(tasks, docs))[:verify]:
            local = run_cell(apps, task["cfg"]).to_dict()
            match = local["digest"] == doc["digest"]
            ok = ok and match
            checked.append(
                {"cell": doc["cell"], "match": match, "digest": doc["digest"]}
            )
        verification = {"cells": checked, "ok": ok}
        if not ok:
            raise RuntimeError(
                "cross-process digest divergence: "
                + json.dumps([c for c in checked if not c["match"]])
            )

    if metrics is not None:
        _publish(metrics, docs)

    matrix: Dict = {
        "schema": MATRIX_SCHEMA,
        "version": MATRIX_VERSION,
        "name": spec.name,
        "specDigest": spec_digest,
        "traceDigest": trace_digest,
        "arrivals": len(apps),
        "workers": workers,
        "cells": docs,
    }
    if verification is not None:
        matrix["verification"] = verification
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "matrix.json"), "w") as f:
            json.dump(matrix, f, indent=2, sort_keys=True)
            f.write("\n")
        write_run_manifest(
            out_dir,
            kind="lab-matrix",
            digests={"spec": spec_digest, "trace": trace_digest},
            extra={"name": spec.name, "cells": [c.cell_id for c in cells]},
        )
    return matrix


def _publish(metrics, docs: List[Dict]) -> None:
    from ..metrics import names as mnames

    metrics.counter(mnames.LAB_MATRIX_CELLS, inc=float(len(docs)))
    for doc in docs:
        tags = {mnames.TAG_CELL: doc["cell"]}
        metrics.histogram(mnames.LAB_CELL_WALL_TIME, doc["wallSeconds"], tags)
        metrics.gauge(mnames.LAB_CELL_EVENTS, float(doc["events"]), tags)
        metrics.gauge(
            mnames.LAB_CELL_EVICTIONS,
            float(doc["counters"]["evictions"]),
            tags,
        )


def _run_local(task: Dict, apps: List[AppSpec]) -> Dict:
    doc = run_cell(apps, task["cfg"]).to_dict()
    if task.get("cell_dir"):
        _write_cell_artifacts(task["cell_dir"], doc, task["cfg"])
    return doc
