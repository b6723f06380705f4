"""CLI: run a scenario, write the replayable event log + summary; the
reference package's ``sim`` CLI with a ``--device``.

    python -m k8s_spark_scheduler_tpu_torch.sim \\
        --scenario examples/sim/chaos.json --seed 42 --out out/sim-chaos

``--device`` is where the queue solvers and capacity probes run: CUDA by
default (raising on a host without it), ``cpu`` for the kernels' plain
versions.  Same scenario + same seed ⇒ byte-identical event-log digest
(printed as ``digest=...`` and embedded in summary.json), on either
device and equal to the reference CLI's, so a sim run is a reviewable,
diffable artifact: re-run a reported digest to reproduce, diff two event
logs to bisect a behavior change.

``--dump-trace`` writes the generated workload as JSONL; a scenario
whose ``workload`` is ``{"trace": "path.jsonl"}`` replays it verbatim.

``--replay-bundle <path.jsonl>`` replays a flight-recorder bundle file
(provenance/recorder.py): every recorded decision re-runs through the
queue kernel on ``--device`` and, off the CPU, through its plain
version too, asserting byte-identical verdicts.  Exit 0 = every bundle
reproduced exactly; a mismatch prints the diverging lane and exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

from .manifest import write_run_manifest
from .runner import Simulation
from .scenario import Scenario
from .workload import WorkloadGenerator, dump_trace


def _replay_bundles(path: str, device=None, quiet: bool = False) -> int:
    from ..provenance.recorder import replay_bundle_file

    results = replay_bundle_file(path, device=device)
    failed = [r for r in results if not r["ok"]]
    if not quiet:
        for r in results:
            status = "ok" if r["ok"] else "MISMATCH"
            lanes = ",".join(f"{k}={v}" for k, v in sorted(r["lanes"].items()))
            print(
                f"bundle seq={r['seq']} pod={r['pod']} policy={r['policy']} "
                f"nEarlier={r['nEarlier']} [{lanes}] {status}"
            )
            for m in r["mismatches"]:
                print(f"  MISMATCH: {m}", file=sys.stderr)
    print(
        f"replayed {len(results)} bundles: "
        f"{len(results) - len(failed)} byte-identical, {len(failed)} diverged"
    )
    return 1 if failed or not results else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m k8s_spark_scheduler_tpu_torch.sim",
        description="deterministic discrete-event cluster simulator",
    )
    parser.add_argument("--scenario", default=None, help="scenario JSON path")
    parser.add_argument("--seed", type=int, default=None, help="override the scenario seed")
    parser.add_argument("--out", default=None, help="output directory (events.jsonl, summary.json)")
    parser.add_argument(
        "--dump-trace", default=None, metavar="PATH",
        help="write the generated workload trace as JSONL and exit",
    )
    parser.add_argument(
        "--replay-bundle", default=None, metavar="PATH",
        help="replay a flight-recorder bundle file and assert "
        "byte-identical verdicts (no scenario needed)",
    )
    parser.add_argument(
        "--override-nodes", type=int, default=None, metavar="N",
        help="override scenario.cluster.nodes — CI runs the 100k-node "
        "class-churn scenario scaled down; digests are only comparable "
        "at the same node count",
    )
    parser.add_argument("--quiet", action="store_true", help="suppress the summary dump")
    parser.add_argument(
        "--device", default=None,
        help="where the queue solvers and capacity probes run: cuda "
        "(the default; raises without CUDA) or cpu (the plain versions)",
    )
    args = parser.parse_args(argv)

    if args.replay_bundle:
        return _replay_bundles(args.replay_bundle, device=args.device, quiet=args.quiet)
    if not args.scenario:
        parser.error("--scenario is required (unless --replay-bundle)")

    scenario = Scenario.from_file(args.scenario)
    if args.seed is not None:
        scenario.seed = args.seed
    if args.override_nodes is not None:
        scenario.cluster.nodes = args.override_nodes

    if args.dump_trace:
        apps = WorkloadGenerator(scenario.workload, scenario.seed).generate(scenario.duration)
        dump_trace(apps, args.dump_trace)
        print(f"wrote {len(apps)} apps to {args.dump_trace}")
        return 0

    bundle_dir = os.path.join(args.out, "bundles") if args.out else None
    result = Simulation(scenario, bundle_dir=bundle_dir, device=args.device).run()

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "events.jsonl"), "w") as f:
            for entry in result.event_log:
                f.write(json.dumps(entry, sort_keys=True, separators=(",", ":")) + "\n")
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(result.summary, f, indent=2, sort_keys=True)
        # capacity-observatory timeline (one sample per state-changing
        # event): the chaos-CI artifact alongside flight-recorder bundles
        with open(os.path.join(args.out, "capacity.jsonl"), "w") as f:
            for sample in result.capacity_timeline:
                f.write(
                    json.dumps(sample, sort_keys=True, separators=(",", ":"))
                    + "\n"
                )
        # contention report (predicate-lock wait/hold + critical-path
        # decomposition): the "is the lock or the solver the bottleneck"
        # artifact for the chaos-CI job
        with open(os.path.join(args.out, "contention.json"), "w") as f:
            json.dump(
                result.summary.get("contention"), f, indent=2, sort_keys=True
            )
        # SLO scorecard (same schema as a live GET /slo): the input to
        # the policy-regression gate (python -m
        # k8s_spark_scheduler_tpu_torch.tools.policy_regression --current)
        if result.summary.get("slo") is not None:
            with open(os.path.join(args.out, "scorecard.json"), "w") as f:
                json.dump(result.summary["slo"], f, indent=2, sort_keys=True)
        # self-describing manifest: seed, scenario digest, and a
        # sha256-addressed list of every artifact written above
        scenario_blob = json.dumps(
            scenario.to_dict(), sort_keys=True, separators=(",", ":")
        )
        write_run_manifest(
            args.out,
            kind="sim-run",
            seed=scenario.seed,
            digests={
                "events": result.digest,
                "scenario": hashlib.sha256(scenario_blob.encode()).hexdigest(),
            },
            extra={"scenario": scenario.name},
        )

    if not args.quiet:
        json.dump(result.summary, sys.stdout, indent=2, sort_keys=True)
        print()
    for v in result.violations:
        print(f"VIOLATION: {v}", file=sys.stderr)
    print(f"digest={result.digest}")
    return 1 if result.violations else 0


if __name__ == "__main__":
    sys.exit(main())
