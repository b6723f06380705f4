"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero and prints no result line:

1. device: the card's name, CUDA version, name and power limit;
2. build: the four kernels from ``ops/csrc/`` (queue_kernel.cu,
   minfrag_kernel.cu, single_az_kernel.cu, class_kernel.cu; one nvcc
   each, all started together, sm_90a);
3. kernel vs plain: each CUDA kernel on the card against its plain
   PyTorch version on the same inputs, computed on the CPU in the plain
   twins (below) and compared before phase 5, on randomized queues
   (ragged N, k = 0, zero-resource
   executors, negative availability, invalid apps, zone id -1, a problem
   too large for shared memory, more than 127 zones) and at 10,240 nodes ×
   1,024 apps (3 zones for the single-AZ kernel), every variant; also 10,240
   nodes in one zone, 12,345 in one zone, 4,000 zones, 3 zones with
   one empty, 9 and 17 zones, an az-aware queue where many apps take the
   cross-zone solve, min-frag queues where the pass's largest capacity is
   above k and below it; the queue kernel also on 7 nodes (fewer than its
   cluster's blocks), on 100,000 (its node planes in global scratch) and
   on values near the int32 range (availabilities near 2^31 - 1, large,
   odd and power-of-two requests, gangs whose capacity sums wrap), with
   its cluster size, threads and shared bytes a block; the queue and
   min-frag kernels also with the refusal explainer's probe flags and
   usage output, and with the delta-solve session's checkpoint buffer
   (the carry before every stride-th queue position, from a nonzero
   queue position, slots past the buffer skipped); outputs are integers
   and must be exactly equal;
4. main path: Filter decisions on a 10,000-node cluster in 3 zones with a
   1,000-deep pending queue, on the card and equal to the same calls on
   the CPU (made in the twin process, below): ``TpuFifoSolver`` tightly-pack, distribute-evenly and
   minimal-fragmentation, ``TpuSingleAzFifoSolver`` single-AZ tightly-pack,
   az-aware and single-AZ minimal-fragmentation; one ``binpack_func`` call
   of every ``tpu-batch*`` binpacker; small snapshots checked against the
   host oracles' sequential FIFO loop for each policy; each policy's
   kernel launch counts, zeroed just before its decisions and read just
   after; each kernel's time, bound and serial floor at the main path's
   inputs (its plain version's in the plain twins), the apps that take
   the az-aware cross-zone solve, each variant's cluster size and threads,
   and ptxas's registers and spills for each kernel instantiation; the
   explainer's launch at the main path's inputs (1,000 probes interleaved
   with the 1,000 earlier apps) against its plain version, with its time;
   decision breakdowns and the device's busy time in profiler traces of
   single decisions;
5. server: the port's Filter server on the card — ``init_server_with_clients``
   (binpack ``tpu-batch``, then ``tpu-batch-distribute-evenly``, then
   ``tpu-batch-minimal-fragmentation``, fifo, the reference's defaults:
   resilience, provenance and the delta-solve engine) with
   ``ExtenderHTTPServer`` on port 0, bench.py's headline HTTP snapshot
   (10,000 nodes in 3 zones, allocatable 4–96 CPU / 8–256 Gi, 1,000 queued
   drivers of 1–32 executors of 1–8 CPU / 2–16 Gi) rebuilt from ``--seed``;
   2 warmup and 24 timed ``POST /predicates`` probes with all 10,000 node
   names, each retired and settled before the next, each cuda server
   timed alone (the other cuda server's sampler and ledger paused around
   each timed request); every response body, the checked executors' and
   the refused probe's equal to those of a ``device="cpu"`` server fed
   the same objects and probes in a server twin (submitted after the
   phase, compared before phase classes), every probe on the tensor lane (``lane=fast``) through the
   delta-solve session on the card (its first, cold pass a launch of the
   checkpointed queue kernel; the retired probes leave the cluster as it
   was, so the timed probes are served warm); for 3
   granted probes the driver is bound and every executor POSTed, each
   granted its reserved node; request latency p50 / p99, the provenance
   work a request does, span medians, the slowest timed Filter's span
   tree and ``/debug/criticalpath`` record, and the device's idle share
   in a profiler trace of one request; then one probe refused behind the
   queue, explained on the card, its message held to the cpu server's;
5b. az-server: the single-AZ family through the port's server on phase
   5's snapshot — a cuda server for each of ``tpu-batch-single-az``,
   ``tpu-batch-az-aware`` and ``tpu-batch-single-az-minimal-fragmentation``
   (fifo, the reference's defaults; the tensor lane declines these
   names, so every driver Filter takes the metadata lane,
   ``scheduler/extender._try_device_fifo`` → ``TpuSingleAzFifoSolver``
   → ``single_az_kernel.fifo_queue_single_az``); phase 5's protocol: 2
   warmup and 24 timed probes, each retired, the server alone; each
   Filter's launches of its name's kernel variant read around it (a
   fused Filter one launch), ``…tpu.singleaz.lane`` (fused / host)
   equal to the solver's lanes, no Filter on the tensor lane; 3 granted
   probes' executors each granted its reserved node; p50 / p99, span
   medians, the slowest Filter's span tree, the decision by piece
   (tensorize, zone inputs, kernel, the current app's zone solves,
   efficiencies); one probe refused behind the queue (its gang sized
   from the last Filter's queue pass: more executors than the best
   zone, or the cluster under az-aware, holds after the queue, fewer
   than before it).  The warmups' bodies, every 4th timed probe's and
   the refused probe's equal those of a ``device="cpu"`` server fed the
   same objects and probes in a server twin, compared before phase
   classes;
6. cluster: the same server against a Kubernetes API over REST — a cuda
   and a cpu server, each on its own ``FakeKubeAPI`` (a local HTTP
   Kubernetes API) holding phase 5's objects, reached through a
   kubeconfig as the CLI's ``--kubeconfig`` reaches it; the first full
   LIST's time and decode and the time until the informers watch; phase
   5's probe protocol under ``tpu-batch`` (2 warmup and 24 timed probes,
   bodies equal, served by the delta-solve session, 3 granted
   probes' executors), with every pod created, bound and deleted in the
   fake and seen through the watches, and the reservations and demands
   each server wrote back read over REST and equal; the invariant checker
   (I1-I5, I5 at 10,000 nodes) after every 4th driver Filter of the cuda
   server (the other Filters skip it: ~1.5 s a check) and on both servers
   at the end, no violation, and the request latency given without and with its time;
   ``/metrics`` with ``Accept: text/plain`` parsed as Prometheus text,
   its fast-lane counter equal to the probes; ``/convert`` round-tripping
   a v1beta1 reservation; one unschedulable-marker scan of the 1,000
   queued drivers on each server, verdicts equal, with its time;
7. resilience: a cuda and a cpu server under ``tpu-batch`` on phase 5's
   snapshot with the flight recorder keeping 10,240-node bundles; 8
   probes whose gangs fit the cluster but not behind the queue, their
   explanations walking all 1,000 earlier apps, failure messages and
   ``/explain`` bodies equal on cuda and cpu, the refused requests' and
   the explanations' times; a write-back outage (``set_write_fault``):
   the breaker opens, readiness reads ``degraded``, every admitted gang's
   reservation is journaled and none lands, then the journal replays
   and the reservations equal the cpu server's; the bundles the
   ``breaker-open`` trigger persisted replayed through the kernel and
   the plain version, equal to the recorded verdicts, with their times;
   a burst of 32 concurrent ``/predicates`` on the cuda server: each
   answer a grant, a refusal or the shed message, at least one shed,
   the shed requests' wait, and I1-I5 after it;
8. delta: the delta-solve engine (ops/deltasolve.py, its device-resident
   session ops/fifo_session.py) on phase 5's snapshot.  (1) The
   checkpointed launches of ``fifo_queue`` (tightly, evenly) and
   ``fifo_queue_min_frag`` at phase 4's inputs (10,240 x 1,024, 1,000
   valid apps), stride 64: outputs and every checkpoint equal to the plain
   version, a suffix pass from a checkpoint too, a pass resumed from
   every checkpoint equal to the whole-queue pass, with times.  (2) Under
   ``tpu-batch`` and ``tpu-batch-minimal-fragmentation``, a cuda server
   with the engine on, one with it off and a cpu server with it on, the
   1,000 queued drivers behind an enforced driver that fits nowhere;
   three segments of 40 Filters, each posted to the two cuda servers in
   turns: (a) retries of queued drivers in random order, nothing changing
   between them; (b) the same with an unrelated reservation created and
   deleted before each (the change feed moves, the class digest cancels
   back); (c) every 10th Filter an app that is granted and starts (the
   basis changes); segment (a) under ``tpu-batch-distribute-evenly`` too.
   Bodies equal on and off, and on the cpu server for a
   sample; per segment p50 / p99 on and off, the warm-hit share, miss
   reasons, resume depths and span medians; the device's busy share in a
   profiler trace of one warm and one cold request.  (3) The engine's
   warm-captured decisions persisted and replayed cold through the
   kernel and the plain version, and a session stream at the library
   layer (a FifoSession on the card against one on the CPU and the
   stateless pass).  Step (1) also launches the tightly-pack and
   min-frag kernels checkpointed at 20,480 nodes (the main path's
   cluster twice over, the same apps), a whole queue and a 640-app
   suffix, each equal to its plain version and timed;
9. observatory: the capacity observatory and the lifecycle ledger
   (capacity/, lifecycle/) on phase 5's snapshot under ``tpu-batch``: a
   cuda server on the reference's defaults, a cuda server with both
   off and a cpu server on the defaults; after the same 4 Filters on
   each, a sample on the cuda and the cpu server, equal but for the
   fields that name the host (``SAMPLE_HOST_FIELDS``,
   ``QUEUE_HOST_FIELDS``); the sampler's two probe programs (row-level
   over the cluster and its (group, zone) combos, and the class lane)
   by CUDA events at 10,000 nodes × 16 shapes, and a whole sample's
   ``sampleMs`` with each of its parts by the host clock; 100 granted
   probes, each retired, on the on and off cuda servers in blocks in
   turns, each block posted to its own server alone, p50 / p99 of each,
   the samples and drains taken and one ledger drain's time; no probe
   or drain under the predicate lock and no class-lane
   failure; ``/slo`` counting the Filters served, ``/lifecycle`` listing
   the probe apps.  Phases 5 to delta run with both subsystems on too
   (the reference's defaults);
10. contention: the contention observatory (contention/: every
   ``@guarded_by`` lock and the predicate lock a ``TimedLock``, each
   request's span tree decomposed into gate-queue / lock-wait / serde /
   solve / write-back / other) and the race detector (analysis/) on
   phase 5's snapshot under ``tpu-batch``: a cuda server on the
   reference's defaults, a cuda server with ``{"contention": {"enabled":
   false}}`` and a cpu server; 4 probes on all three, bodies equal; 100
   granted probes, each retired, on the on and off cuda servers in blocks
   of 25 in turns, the process-wide timekeeper enabled for the on blocks
   and disabled for the off blocks, p50 / p99 of each;
   ``/debug/criticalpath`` counting the on server's Filters, every record's
   segments within 10 % of its total, the segments' p50 / p99 and shares
   and the slowest Filter's decomposition; ``/debug/contention``: the
   predicate lock's acquires, waits, holds and holding phases, the five
   locks with the most wait and their top blockers (the on server's
   samples and drains labelled by phase), the Prometheus series; a fourth
   cuda server built under the race detector, 40 granted probes with the
   sampler, ledger and write-back live, 0 races and 0 lock-order cycles;
   the disabled path's ns per acquire and per ``note_access``; the
   checkpointed queue kernel launched on the phase's path.  Every phase's
   servers run the contention observatory (the reference's default);
11. policy: the scheduling-policy engine (policy/) on phase 5's snapshot
   under ``tpu-batch``, each queued driver labelled with a band (low /
   normal / high, 20 / 60 / 20 %) and one of 4 tenants from ``--seed``,
   the newest 100 younger than the starvation age (so the backfill
   probe runs for them): a cuda server with ``priority-then-fifo``,
   backfill and preemption, a cuda server with the policy off and a cpu
   server with the policy on; 4 probes on all three (on and cpu bodies
   equal), then 16 granted probes a side in blocks of 8 in turns, each
   block posted to its own server alone after ``quiet()``, every probe
   of each on block then posted to the cpu server, bodies equal; p50 /
   p99, the warm-hit share and miss reasons, the backfill probes a
   Filter with their host time, span medians; one block of 3 under
   ``drf`` and under ``fifo`` (each its own cuda server, after one
   probe), the ``drf`` block's bodies equal to a cpu server's with
   ``drf`` and the ``fifo`` engine's byte-equal to the policy-off
   server's; then, on a fresh cuda and cpu server with the first
   policy, in a pool of 8 nodes of its own instance group, two
   low-band apps bound and a high-band gang that fits only after an
   eviction: its Filter refused
   with ``preempting victims: low-b``, the victim's pods and reservation
   gone, the retry granted, the messages, ``/policy/state`` (less the
   evictions' clock stamps) and ``/lifecycle/low-b`` (``evicted``) equal
   on cuda and cpu; the checkpointed queue kernel launched on the
   phase's path;
12. ha: the HA failover fabric (ha/) on phase 5's snapshot under
   ``tpu-batch``: one ``FakeKubeAPI`` holding it, two cuda replicas a and
   b each through its own kubeconfig and journal with ``ha: {enabled,
   background: false, lease-duration-seconds: 2}`` (the lease travels
   over REST as coordination.k8s.io/v1, whose TTL is whole seconds), and
   a cpu server fed the same objects for body equality.  (a) a steps to
   epoch 1, b follows; readiness a 200, b 503; both ``/status/ha``
   bodies.  (b) 2 warmup and 24 timed probes on a, each retired and
   timed alone (phase 5's protocol, a renewing before each), bodies equal
   to the cpu server's, p50 / p99 beside phase 5's ``tpu-batch`` in the
   same call; the fence counts commits, no refusal, no stale commit.
   (c) a steps down, b steps to epoch 2, a steps and is deposed: the
   takeover time from the step-down to b's first ``/predicates`` answer,
   split into b's election step, its ``Reconciler`` report and its first
   Filter, which is one cold checkpointed ``fifo_queue_tightly`` launch
   from row 0; 12 timed probes on b, warm, bodies equal; a's writer
   refuses all 5 fenced operations; readiness a 503, b 200.  (d) b stops
   renewing; after the TTL a steps to epoch 3 (its takeover report and
   cold first Filter; the time to recover from b's last renewal to a's
   first answer); b, not stepped since, grants one probe whose
   write-back the read-through fence refuses and diverts to b's journal,
   no reservation of b's reaching the API; generation-2 collections
   inside timed Filters are counted (``GcWatch``);
13. concurrent: the concurrent admission engine (concurrent/) on phase
   5's snapshot.  (a) under ``tpu-batch`` and
   ``tpu-batch-minimal-fragmentation``, a cuda server with ``concurrent:
   {enabled: true}`` and one without: 48 new drivers through
   ``engine.predicate`` from 8 threads (tickets assigned in advance, each
   grant bound inside its commit turn) and the same drivers through the
   other server's serial extender in ticket order, every encoded body
   byte-equal; speculation outcomes (``error`` must be 0), commit
   results and the queue-kernel launches on the speculating threads'
   own CUDA streams.  (b) under ``tpu-batch``, 1 and 8 HTTP client
   threads against each server, 64 Filters a point: granted drivers
   behind the queue, each retired, then queued drivers refused behind
   an enforced driver that fits nowhere; decisions/s, p50 / p99,
   speculation outcomes, commit results, the ticket wait's mean from
   the engine's own histogram, the ``speculation.solve`` span p50 and
   the launches on the speculators' streams.  (c) ``fifo_queue`` at the main path's inputs launched k =
   1, 2, 4, 8 times at once on k streams, each batch timed by CUDA
   events with each launch's own time, every result equal to the plain
   version.  (d) the crash matrix (``CrashMatrix(nodes=2)`` under
   ``tpu-batch``, its concurrent admission engine on in every cell) on
   cuda, each of the thirteen points, the three ``concurrent.*`` points
   again with the policy engine off (the crashed Filter's verdict solved,
   and consumed before ``concurrent.commit-written``) and the
   two-replica handoff cell, each report ok and equal to the same cell
   on cpu, with seconds and queue-kernel launches;
14. sim: the discrete-event simulator (sim/) on the card.  (a) a scenario
   built here: 10,000 nodes of 16 CPU / 32 Gi in three zones
   (``bench.py:60``) under ``tpu-batch``, bursts of 6 gangs of 6–10
   executors that outlive the run, every node but 5 cordoned at t = 1
   (drivers queue behind the FIFO head), the cordon lifted at two-thirds
   of the run (the queue drains), one node killed; run on cuda and on a
   ``device="cpu"`` twin (in the twin process): digests equal, 0 violations on both, the
   summary's queue depth max at least 5, at least one checkpointed
   ``fifo_queue_tightly`` launch on the card; events, decisions, wall
   seconds, host ms an event, decision-latency p50 / p99 (host clock) and
   launches by kernel for each run.  (b) ``examples/sim/concurrent.json``
   on cuda, on cpu (in the twin process) and on cuda without its
   ``concurrent`` block: the three digests equal, the speculations'
   launches on their own streams;
15. lab: the policy lab (lab/) and its gate (tools/policy_regression.py)
   on the card's host; the lab is host-only and launches no kernel.  (a)
   ``examples/lab/smoke_synth.json`` (5,000 arrivals) synthesized and
   written; ``smoke_matrix.json`` (12 nodes, 3 cells) in-process and
   again over 2 spawned workers with 2 cells re-run in-process, every
   digest equal to ``tests/baselines/matrix_smoke.json``'s; a spawned
   worker's start-up time with the runner's initializer (started beside
   those runs), and no CUDA context in it after a cell; the port's gate on the in-process
   document exits 0, and 1 with one cell's KPI altered.  (b)
   ``week_synth.json`` (100,000 arrivals over 604,800 virtual s) and the
   two corner cells of ``full_matrix.json`` (96 nodes of 16 CPU / 64 Gi),
   every axis off and every axis on, in-process, their digests equal to
   the reference's (``LAB_CORNERS``).  Wall time and events/s a cell, the
   parent's RSS, 0 launches in the phase;
16. analysis: the model checker of ``analysis/`` on the card's host: its
   10-scenario corpus (``analysis/mcscenarios.py``) at 120 schedules and
   seed 7 with ``device="cuda"`` (the capacity sampler's probe programs
   on its own CUDA stream under controlled interleavings), every scenario
   clean, each one's schedules, decisions and seconds; no hand kernel
   launched in the phase.  It is host work and starts beside phase lab
   in a spawned process of its own (so phase lab's times are taken
   beside it and the twin's phase classes (b) passes), and is read right
   after phase lab, before phase classes.  The linter's check of the
   shipped tree is tier-1's (``tests/test_torch_analysis.py``): its
   findings do not depend on the host;
17. classes: class-compressed stepping (ops/class_kernel.py, the
   reference's native class solver on the card).  (a) bench.py's class
   lane inputs (``class_fleet``: seed 20, 24 machine shapes, 2 %
   near-duplicates, 5 % not exec_ok) at 100,000 nodes x 10,000 apps:
   under tightly, evenly and min-frag the class kernel against the row
   kernel, byte-equal, both timed by CUDA events, the four evidence
   values and the compression.  (b) The same fleet at 20,480 x 1,000:
   each class kernel against its plain version (computed in the twin),
   outputs, every checkpoint (stride 64) and the evidence, a suffix pass
   from the checkpoint at position 384 too, and against the row kernel;
   timed beside the row kernel.  (e) An odd-input queue whose partition
   outgrows shared memory at a rebuild and fits it again at a later one
   inside one launch (``tests/torch_class_cases.budget_crossing`` at the
   card's whole budget, an invalid app and a k = 0 app among its apps), and
   (f) bench.py's fleet at 20,480 nodes with every node unique (as (c)'s
   churned basis): each class kernel against its plain version (the twin)
   and the row kernel, (e)'s placements as the rule says, both timed.
   (g) The crossover: class against row kernel at 40,960 x 1,000; (h) the
   class kernels' serial floor at 1,024 x 1,000; (i) (b)'s queue with
   every app invalid, with k past any total, with k = 0, whole: a step's
   time by piece.  (c) A class-mode ``FifoSession`` and a
   row-mode one on the card replay one random delta stream at 20,480
   nodes (pops, appends, executor edits, availability churn with a
   reload), equal at every step, per policy, with ``class_stats``.  (d)
   Phase 5's HTTP snapshot on a ``tpu-batch`` server with ``classes:
   {min-nodes: 0}`` against one with class stepping off: 4 queued
   drivers' Filters byte-equal, the class kernel launched on the first.
   (j) bench.py's HTTP snapshot at 20,480 nodes in 3 zones with 1,000
   queued drivers, past ``classes.min-nodes``: for ``tpu-batch``,
   ``tpu-batch-distribute-evenly`` and ``tpu-batch-minimal-fragmentation``
   a cuda server on the default ``classes`` config and one with
   ``classes: {enabled: false}``; 2 warmups, 8 new drivers (each
   retired) and 8 retries of queued drivers, posted to both in turns,
   bodies byte-equal; every session of the default server in class mode
   and none of the other's; the class kernel launched on the first, the
   checkpointed row kernel on the second; p50 / p99 of each, class
   rebuilds and ``class_stats``; the warmups' bodies and every 4th
   Filter's after them equal a ``device="cpu"`` server's on the default
   config in a server twin.  (c), (d) and (j) are the class kernels' main
   path (launches counted there);
18. mesh: ``GangPacker`` and the whole-queue programs with the node axis
   sharded over a ``torch.distributed`` process group (parallel/), each
   world in spawned processes.  (a) one NCCL rank on the card at phase
   4's inputs (10,240 x 1,024, 1,000 valid apps): ``GangPacker(use_mesh=
   True)`` under tightly-pack and distribute-evenly, its decisions and
   ``avail_after`` equal to the unsharded ``GangPacker`` (one
   ``fifo_queue`` launch) and its placements to ``solve_queue(...,
   with_placements=True)``; the sharded ``solve_queue_min_frag`` and the
   az-aware and min-frag strict ``solve_queue_single_az`` at 10,240 x 16
   equal to the unsharded programs; ms a solve (host clock to a
   synchronize, median of 3 after a warm one) and collectives a solve
   beside the unsharded time.  (b) ``entry.dryrun_multichip`` in gloo
   worlds of 2 and 4 ranks whose shards share the card: every check of
   the dry run (the mesh solve, both single-AZ scans and the min-frag
   scan equal to the unsharded programs, the 10,240-node bucket's
   decisions equal to the unsharded program), its scaling curve and each
   rank's shard bytes;
19. the kernels line (times, bounds, launches) and the device result line.

The cpu halves run in spawned processes (``CpuTwin``) while this process
drives the card: the same functions on the same inputs (shipped, or made
from the same seeds).  One twin computes phase 4's tensor-lane decisions,
phase concurrent (d)'s cells, phase sim's simulations and phase classes
(b)'s passes (beside phase lab), and stops before phase classes.  The
plain twins (``PLAIN_WORKERS`` processes of one torch thread) compute
phase 4's single-AZ decisions and the plain versions of phases 3, 4 and
delta step 1 (shipped each launch's inputs), and stop after phase 4.
The server twins (``SERVER_WORKERS`` of them) hold the cpu servers of
phases 5, az-server and classes (j), one a name, submitted after phase 5,
and stop after phase classes.  All start before the build, and run at a
lower priority than this process.  Nothing runs beside phases 3-4 but
their own cpu halves, and nothing beside phase 5.  The comparisons are
the same; only the host's idle cores do the cpu work.

Needs CUDA: without it the script exits with an error before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import gc
import importlib
import json
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BIG = 2**31 - 1
N_NODES, N_APPS, N_ZONES = 10_000, 1_000, 3  # the main path's cluster and queue depth
DECISIONS = 3  # Filter decisions per tightly-pack / distribute-evenly policy on the main path
NEW_DECISIONS = 2  # Filter decisions per min-frag / single-AZ policy on the main path
# plain twins: one-thread processes computing the plain versions the kernels
# are held to beside phases 3-4 (a plain version is a loop of small ops: more
# threads do not speed it); server twins: the cpu servers of phases 5,
# az-server and classes (j) beside the phases after 5, two at a time (more
# slowed the timed phases beside them)
PLAIN_WORKERS, SERVER_WORKERS = 4, 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
# int32 ALU rate: 132 SMs x 64 int32 lanes a clock x 1.98 GHz boost
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per node for each valid app, a lower bound: the capacity
# (3 divisions by the app's request, each at least a multiply-high, a shift,
# a sign fix and a select with a per-app magic number; 2 mins, 2 clamps and
# the exec_ok select), the driver fit (4 compares) and the key minimum; the
# capacity beside the driver is counted for no node, as only driver
# candidates need it.  For feasible apps, the fill (a scan add, 2 compares)
# and the carry update (3 subtracts).
OPS_PER_NODE_VALID_APP = 3 * 4 + 5 + 4 + 1
OPS_PER_NODE_FEASIBLE_APP = 3 + 3
# the min-frag drain per node for each feasible app, instead of the fill,
# counting only the work its result needs: the unclamped capacity from the
# gang core's quotients (2 selects) and its maximum (1), the two passes'
# totals (2 compares, 2 mins, 2 adds), v* of the placing pass by a radix
# selection (4 rounds of 8 bits, each a digit extract, a prefix compare and
# a histogram add), the drained sum and class count (4), the final
# placement's key (6), the counts (4), the carry update (3)
MF_OPS_PER_NODE_FEASIBLE_APP = 2 + 1 + 6 + 4 * 3 + 4 + 6 + 4 + 3
FLOOR_NODES = 1024  # one node a thread: the kernel's serial per-app floor

CSRC = "k8s_spark_scheduler_tpu_torch/ops/csrc/"
PALLAS = "k8s_spark_scheduler_tpu/ops/pallas_queue.py:"
SOURCES = {"queue": CSRC + "queue_kernel.cu", "min_frag": CSRC + "minfrag_kernel.cu",
           "single_az": CSRC + "single_az_kernel.cu", "classes": CSRC + "class_kernel.cu",
           "classes_min_frag": CSRC + "class_kernel.cu"}
# the class kernels replace no Pallas kernel: they stand for the reference's
# native class steps (native/fifo_solver.cpp step_app_plain_classes,
# step_app_minfrag_classes), which the port does not carry
REPLACES = {"queue": PALLAS + "681", "min_frag": PALLAS + "614", "single_az": PALLAS + "525",
            "classes": "native/fifo_solver.cpp:946", "classes_min_frag": "native/fifo_solver.cpp:1150"}
# (az_aware, minfrag) of each single-AZ kernel variant
SINGLE_AZ = {"fifo_queue_single_az_tightly": (False, False),
             "fifo_queue_single_az_az_aware": (True, False),
             "fifo_queue_single_az_min_frag": (False, True)}
# the kernel (variant) each main-path policy's queue pass launches
POLICY_KERNEL = {"tightly-pack": "fifo_queue_tightly", "distribute-evenly": "fifo_queue_evenly",
                 "minimal-fragmentation": "fifo_queue_min_frag",
                 "single-az-tightly-pack": "fifo_queue_single_az_tightly",
                 "az-aware-tightly-pack": "fifo_queue_single_az_az_aware",
                 "single-az-minimal-fragmentation": "fifo_queue_single_az_min_frag"}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, stamped with the seconds since the
    script started (where the time goes, phase by phase)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(xs) -> str:
    return f"{statistics.median(xs):.1f} ms (runs {', '.join(f'{x:.1f}' for x in xs)})"


# -- phase 3 inputs -----------------------------------------------------------


def random_queue(rng: np.random.RandomState, n: int, a: int):
    """A raw queue problem: avail may be negative, ranks are a permutation
    with non-candidates at BIG, executors may need 0 of a dimension,
    k may be 0, some apps invalid."""
    avail = rng.randint(-4, 64, size=(n, 3)).astype(np.int32)
    avail[rng.rand(n) < 0.3, 2] = 0
    rank = rng.permutation(n).astype(np.int32)
    rank[rng.rand(n) < 0.3] = BIG
    exec_ok = rng.rand(n) < 0.85
    drivers = rng.randint(0, 4, size=(a, 3)).astype(np.int32)
    executors = rng.randint(0, 9, size=(a, 3)).astype(np.int32)
    executors[rng.rand(a) < 0.1] = 0
    counts = rng.randint(0, 40, size=a).astype(np.int32)
    valid = rng.rand(a) < 0.9
    return avail, rank, exec_ok, drivers, executors, counts, valid


def random_queue_large(rng: np.random.RandomState, n: int, a: int):
    """random_queue with values near the int32 range, as GCD-scaled
    quantities reach it: availabilities near 2^31 - 1 (some anywhere in
    int32), large, odd and power-of-two requests, large drivers, and some
    gangs of up to 2^31 - 1 executors, so capacity sums and prefixes wrap."""
    _, rank, exec_ok, _, _, _, valid = random_queue(rng, n, a)
    avail = BIG - rng.randint(0, 2**16, size=(n, 3)).astype(np.int64)
    spread = rng.rand(n, 3) < 0.3
    avail[spread] = rng.randint(-(2**31), BIG, size=int(spread.sum()))
    choices = np.array([1, 2, 3, 7, 2**16, 2**20, 2**30, BIG, BIG - 1, 12345677, 1000003])
    executors = np.where(rng.rand(a, 3) < 0.5, rng.choice(choices, size=(a, 3)),
                         rng.randint(1, BIG, size=(a, 3)))
    executors[rng.rand(a, 3) < 0.1] = 0
    drivers = rng.randint(0, 2**30, size=(a, 3))
    counts = np.where(rng.rand(a) < 0.3, rng.randint(0, BIG, size=a), rng.randint(0, 40, size=a))
    return (avail.astype(np.int32), rank, exec_ok, drivers.astype(np.int32),
            executors.astype(np.int32), counts.astype(np.int32), valid)


def queue_layout(qk, n: int, device) -> str:
    """The queue kernel's launch for n nodes, for the log."""
    lay = qk.layout(n, device)
    where = "in shared memory" if lay.segment_bytes else "in global scratch"
    return (f"cluster of {lay.blocks} blocks of {lay.threads} threads, "
            f"{lay.segment_bytes + lay.static_bytes} shared bytes a block, node planes {where}")


def random_single_az_queue(rng: np.random.RandomState, n: int, a: int, n_zones: int):
    """A raw single-AZ queue: random_queue's problem plus zone ids from -1
    (no zone) to n_zones - 1 and schedulable columns (cpu and gpu in units
    of 1000 milli, memory in scaled units), some nodes gpu-less.  Returns
    (twelve arrays, (scale_cpu, scale_gpu, n_zones))."""
    avail, rank, exec_ok, drivers, executors, counts, valid = random_queue(rng, n, a)
    zone_id = rng.randint(-1, max(n_zones, 1), size=n).astype(np.int32)
    sched = np.maximum(avail, 0) + rng.randint(0, 16, size=(n, 3))
    sched[:, :2] = np.maximum(sched[:, :2], 1)
    s_cpu = (sched[:, 0] * 1000).astype(np.int32)
    s_gpu = np.where(rng.rand(n) < 0.5, sched[:, 2] * 1000, 0).astype(np.int32)
    inv_mem = (1.0 / sched[:, 1].astype(np.float64)).astype(np.float32)
    th_mem = sched[:, 1].astype(np.int32)
    arrays = (avail, rank, exec_ok, zone_id, drivers, executors, counts, valid,
              s_cpu, s_gpu, inv_mem, th_mem)
    return arrays, (1000, 1000, n_zones)


def on(device, arrays):
    return tuple(torch.as_tensor(x, device=device) for x in arrays)


def compare(kernel_out, plain_out) -> int:
    """Max absolute difference over the outputs (booleans as 0/1)."""
    err = 0
    for k, p in zip(kernel_out, plain_out):
        d = (k.to(torch.int64) - p.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 5: the Filter server -------------------------------------------------

SERVER_POLICIES = ("tpu-batch", "tpu-batch-distribute-evenly", "tpu-batch-minimal-fragmentation")
SERVER_WARMUP_PROBES, SERVER_TIMED_PROBES, SERVER_EXECUTOR_CHECKS = 2, 24, 3
# the policy whose probes also go to a cuda server with provenance off,
# in alternating order: provenance's cost within one run
SERVER_PROVENANCE_OFF = "tpu-batch"
# the kernel (variant) each server policy's Filter launches
SERVER_KERNEL = {"tpu-batch": "fifo_queue_tightly", "tpu-batch-distribute-evenly": "fifo_queue_evenly",
                 "tpu-batch-minimal-fragmentation": "fifo_queue_min_frag"}
# the spans of a Filter the delta-solve session serves warm (a cold one
# adds deltasolve.cold_build with fast_path.build_tensor, tensorize.scale
# and deltasolve.load, and skips deltasolve.scale)
SERVER_SPANS = ("http.read", "serde.decode", "predicate", "fast_path.snapshot", "fast_path.earlier_drivers",
                "deltasolve.lookup", "deltasolve.scale", "fifo_gate", "kernel:fifo_queue", "binpack",
                "serde.encode", "http.request")
# the lane that serves a Filter with the delta-solve engine on (the
# default): the session, on the card
SESSION_LANE = "cuda-session"
# each policy's timed /predicates latencies (ms) in phase 5 of this run,
# for later phases to print beside their own
SERVER_LATENCY = {}


def server_objects(seed: int, n_nodes: int = None, base: float = None):
    """bench.py's headline HTTP snapshot (bench.py:1533-1562) in the
    port's types, from `seed`: node names, `n_nodes` (10,000) nodes in 3
    zones with allocatable 4–96 CPU / 8–256 Gi, 1,000 queued drivers of
    1–32 executors of 1–8 CPU / 2–16 Gi created a second apart from
    `base` (10,000 s ago by default), the probe generator's random state
    and the queue's base creation time."""
    from k8s_spark_scheduler_tpu_torch.types.objects import Node, ObjectMeta
    from k8s_spark_scheduler_tpu_torch.types.resources import ZONE_LABEL, Resources

    rng = np.random.RandomState(seed + 5)
    names, nodes = [], []
    for i in range(N_NODES if n_nodes is None else n_nodes):
        name = f"n{i:05d}"
        names.append(name)
        nodes.append(Node(
            meta=ObjectMeta(name=name, labels={ZONE_LABEL: f"z{i % N_ZONES}",
                                               "resource_channel": "batch-medium-priority"}),
            allocatable=Resources.of(str(int(rng.randint(4, 96))), f"{int(rng.randint(8, 256))}Gi"),
        ))
    base = time.time() - 10_000.0 if base is None else base
    queue = [probe_pods(rng, f"queue-{i:04d}", base + i)[0] for i in range(N_APPS)]
    return names, nodes, queue, rng, base


def probe_pods(rng: np.random.RandomState, app_id: str, created: float):
    """A driver and its executors as the snapshot's queue holds them:
    1–32 executors of 1–8 CPU / 2–16 Gi drawn from `rng`."""
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    return Harness.static_allocation_spark_pods(
        app_id, int(rng.randint(1, 32)), executor_cpu=str(int(rng.randint(1, 8))),
        executor_mem=f"{int(rng.randint(2, 16))}Gi", creation_timestamp=created,
    )


def server_resilience(device: str):
    """The reference's default resilience, but on a cpu server no request
    deadline short of an hour: the cpu servers are the plain versions'
    oracle for the card's answers, and a host that runs them slowly must
    not turn a decision into a deadline failure."""
    from k8s_spark_scheduler_tpu_torch.config import ResilienceConfig

    return ResilienceConfig(request_deadline_seconds=3600.0) if device == "cpu" else ResilienceConfig()


class PortServer:
    """The port's server on its own embedded API server, serving HTTP on
    an ephemeral port."""

    live = set()  # the servers built and not yet stopped

    def __init__(self, policy: str, device: str, nodes, queue, provenance=None, delta_solve: bool = True,
                 observatories: bool = True, contention: bool = True, scheduling_policy=None,
                 concurrent: bool = False, classes=None):
        from k8s_spark_scheduler_tpu_torch.config import (CapacityConfig, ClassesConfig, ConcurrentConfig,
                                                          ContentionConfig, Install, LifecycleConfig,
                                                          PolicyConfig, ProvenanceConfig)
        from k8s_spark_scheduler_tpu_torch.kube.apiserver import APIServer
        from k8s_spark_scheduler_tpu_torch.kube.crd import DEMAND_CRD_NAME, demand_crd_spec
        from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer
        from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients

        self.api = APIServer()
        self.api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
        # the reference's defaults, resilience, provenance, the capacity
        # observatory, the lifecycle ledger and the contention observatory
        # included (`observatories` False turns the capacity observatory
        # and the ledger off, `contention` False the last;
        # `scheduling_policy` is a PolicyConfig, off by default as in the
        # reference; `concurrent` turns the concurrent admission engine on,
        # off by default as in the reference); the marker's scan is phase
        # 6's, not a load on the timed probes
        install = Install(binpack_algo=policy, fifo=True, provenance=provenance or ProvenanceConfig(),
                          resilience=server_resilience(device), delta_solve=delta_solve,
                          capacity=CapacityConfig(enabled=observatories),
                          lifecycle=LifecycleConfig(enabled=observatories),
                          contention=ContentionConfig(enabled=contention),
                          policy=scheduling_policy or PolicyConfig(),
                          concurrent=ConcurrentConfig(enabled=concurrent),
                          classes=classes or ClassesConfig())
        self.scheduler = init_server_with_clients(
            self.api, install, demand_poll_interval=0.5, unschedulable_polling_interval=3600.0,
            device=device,
        )
        self.http = None
        self.background_paused = False
        PortServer.live.add(self)
        try:
            for obj in nodes + queue:
                self.api.create(obj.deepcopy())
            self.http = ExtenderHTTPServer(self.scheduler, port=0, host="127.0.0.1")
            self.http.start()
            if not self.scheduler.wait_ready(timeout=600.0):
                raise SystemExit(f"the {device} server did not become ready")
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        PortServer.live.discard(self)
        if self.http is not None:
            self.http.stop()
        self.scheduler.stop()

    def pause_background(self) -> None:
        """Stop the capacity sampler's and the lifecycle ledger's threads,
        joining a sample or drain in flight (Filters never depend on
        them)."""
        for part in (self.scheduler.capacity, self.scheduler.lifecycle):
            if part is not None:
                part.stop()
        self.background_paused = True

    def resume_background(self) -> None:
        for part in (self.scheduler.capacity, self.scheduler.lifecycle):
            if part is not None:
                part.start()
        self.background_paused = False

    def post_alone(self, others, pod, names):
        """``post`` with every server in ``others`` paused for the
        request: no other in-process server's background work runs
        while this one is timed."""
        for other in others:
            other.pause_background()
        try:
            return self.post(pod, names)
        finally:
            for other in others:
                other.resume_background()

    def post(self, pod, names):
        """(ms on the host clock, status, body bytes) of one Filter of the
        pod as this server's API stores it."""
        return self.post_body(self.request_body(pod, names))

    def request_body(self, pod, names) -> bytes:
        """The ExtenderArgs of a Filter of the pod as this server's API
        stores it."""
        from k8s_spark_scheduler_tpu_torch.types import serde

        stored = self.api.get("Pod", pod.namespace, pod.name)
        return json.dumps({"Pod": serde.pod_to_dict(stored), "NodeNames": names}).encode()

    def post_body(self, data: bytes):
        """(ms on the host clock, status, body bytes) of one POST of
        `data` to /predicates."""
        import urllib.error
        import urllib.request

        req = urllib.request.Request(f"http://127.0.0.1:{self.http.port}/predicates", data=data,
                                     headers={"Content-Type": "application/json"}, method="POST")
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                status, body = resp.status, resp.read()
        except urllib.error.HTTPError as err:
            status, body = err.code, err.read()
        return (time.perf_counter() - t) * 1e3, status, body

    def reserved_node(self, pod) -> str:
        rr = self.scheduler.resource_reservation_cache.get(pod.namespace, pod.labels["spark-app-id"])
        for key, pod_name in rr.status.pods.items():
            if pod_name == pod.name:
                return rr.spec.reservations[key].node
        raise SystemExit(f"no reservation holds {pod.name}")

    def bind(self, pod, node: str) -> None:
        stored = self.api.get("Pod", pod.namespace, pod.name)
        stored.node_name, stored.phase = node, "Running"
        self.api.update(stored)

    def retire(self, pods) -> None:
        """The app-finished flow: delete its pods (owner GC collects the
        reservation) and wait until the reservation cache dropped it."""
        for pod in pods:
            self.api.delete("Pod", pod.namespace, pod.name)
        app_id = pods[0].labels["spark-app-id"]
        deadline = time.monotonic() + 30.0
        while self.scheduler.resource_reservation_cache.get(pods[0].namespace, app_id) is not None:
            if time.monotonic() > deadline:
                raise SystemExit(f"the reservation of {app_id} was not collected")
            time.sleep(0.002)

    def fast_lane_count(self) -> float:
        from k8s_spark_scheduler_tpu_torch.metrics import names as mnames

        return self.scheduler.metrics.get_counter(mnames.TPU_FASTPATH, {"path": "driver", "lane": "fast"})

    def get(self, path: str, accept: str = None):
        import urllib.request

        req = urllib.request.Request(f"http://127.0.0.1:{self.http.port}{path}",
                                     headers={"Accept": accept} if accept else {})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.headers.get("Content-Type"), resp.read()

    def settle_embedded(self) -> None:
        """Wait until the write-back queues have drained and the caches
        equal the embedded API server's objects."""
        sched = self.scheduler
        wait_for(lambda: not any(sched.resource_reservation_cache.inflight_queue_lengths())
                 and not any(sched.demand_cache.inflight_queue_lengths())
                 and reservations_of(sched.resource_reservation_cache.list())
                 == reservations_of(self.api.list("ResourceReservation")),
                 "the write-back to land in the API server")

    def watch_provenance(self):
        """Wrap this server's provenance hot path to time it and keep the
        last captured solve: returns a dict the wrappers fill
        ({"art": last SolveArtifacts, "ms": [per-decision capture ms],
        "explain_ms": [per-refusal explanation ms]})."""
        tracker = self.scheduler.provenance
        solver = self.scheduler.extender.binpacker.queue_solver
        acc = {"art": None, "ms": [], "explain_ms": [], "open": 0.0}

        def timed(fn, key=None):
            def wrapper(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    dt = (time.perf_counter() - t) * 1e3
                    if key is None:
                        acc["open"] += dt
                    else:
                        acc[key].append(dt)
            return wrapper

        def keeping(sink):
            def keep(art):
                acc["art"] = art
                sink(art)
            return keep

        # the solve is captured by the delta-solve engine when it serves,
        # else by the solver's cold lane
        solver.capture_sink = keeping(solver.capture_sink)
        solver._capture_solve = timed(solver._capture_solve)
        engine = self.scheduler.extender.delta_engine
        if engine is not None:
            engine.capture_sink = keeping(engine.capture_sink)
            engine._capture = timed(engine._capture)
        tracker.begin_decision = timed(tracker.begin_decision)
        tracker.note_context = timed(tracker.note_context)
        finish = tracker.finish_decision

        def finish_and_close(*a, **kw):
            t = time.perf_counter()
            try:
                return finish(*a, **kw)
            finally:
                acc["ms"].append(acc["open"] + (time.perf_counter() - t) * 1e3)
                acc["open"] = 0.0

        tracker.finish_decision = finish_and_close
        tracker.refusal_detail = timed(tracker.refusal_detail, "explain_ms")
        return acc


def reservations_of(rrs) -> dict:
    return {(rr.namespace, rr.name): (sorted((k, v.node) for k, v in rr.spec.reservations.items()),
                                      sorted(rr.status.pods.items())) for rr in rrs}


# executors of the refused probes: 8 CPU / 16 Gi each
REFUSED_EXECUTOR = (8, 16)


def refused_gang_sizes(art, n: int):
    """n executor counts of 8 CPU / 16 Gi gangs that fit the cluster as it
    stands but not behind the queue (the captured solve `art` of a granted
    probe holds both availabilities): each such refusal's explanation
    walks the whole queue and names the drivers that took the room."""
    scale = np.asarray(art.scale, dtype=np.int64)
    exec_base = np.array([REFUSED_EXECUTOR[0] * 1000, REFUSED_EXECUTOR[1] * 2**30], np.int64)

    def capacity(avail) -> int:
        a = np.asarray(avail, dtype=np.int64)[:, :2] * scale[None, :2]
        cap = np.minimum(a[:, 0] // exec_base[0], a[:, 1] // exec_base[1])
        return int(np.where(art.exec_ok & (a >= 0).all(axis=1), np.maximum(cap, 0), 0).sum())

    before = capacity(art.basis)
    after = capacity(art.avail_after.cpu().numpy() if hasattr(art.avail_after, "cpu") else art.avail_after)
    if before - after < n + 2:
        raise SystemExit(f"the queue takes too little room to refuse behind it ({before} -> {after})")
    return [after + 1 + (before - after) * (j + 1) // (n + 2) for j in range(n)], before, after


def refused_driver(app_id: str, k: int, created: float):
    """A driver whose gang is k executors of REFUSED_EXECUTOR."""
    from k8s_spark_scheduler_tpu_torch.scheduler import labels as L
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    driver = Harness.static_allocation_spark_pods(
        app_id, 0, executor_cpu=str(REFUSED_EXECUTOR[0]), executor_mem=f"{REFUSED_EXECUTOR[1]}Gi",
        creation_timestamp=created,
    )[0]
    driver.meta.annotations[L.EXECUTOR_COUNT] = str(k)
    return driver


# the fields of an /explain body that name the serving server rather than
# the decision: the queue pass's lane, the trace id, the server's clock,
# and the mirror instance in the snapshot's content key
EXPLAIN_SERVER_FIELDS = ("lane", "traceId", "t")


def decision_fields(body: bytes) -> dict:
    record = json.loads(body)
    out = {k: v for k, v in record.items() if k not in EXPLAIN_SERVER_FIELDS}
    if out.get("contentKey"):
        out["contentKey"] = out["contentKey"][1:]
    return out


def span_durations(span: dict, out: dict) -> dict:
    out.setdefault(span["name"], []).append(span["durationMs"])
    for child in span.get("children", ()):
        span_durations(child, out)
    return out


def span_tree_lines(span: dict, depth: int = 0) -> list:
    """A span tree as indented ``name ms`` lines."""
    lines = [f"{'  ' * depth}{span['name']} {span['durationMs']:.3f}"]
    for child in span.get("children", ()):
        lines += span_tree_lines(child, depth + 1)
    return lines


class GcWatch:
    """The interpreter's garbage collections while in ``gc.callbacks``:
    (generation, start on the wall clock, ms, objects collected) each."""

    def __init__(self):
        self.events = []
        self._start = (0.0, 0.0)

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = (time.time(), time.perf_counter())
        else:
            self.events.append((info["generation"], self._start[0],
                                (time.perf_counter() - self._start[1]) * 1e3, info["collected"]))

    def between(self, start: float, end: float) -> list:
        return [e for e in self.events if start <= e[1] <= end]


def slow_filter_capture(server, policy: str, slowest, gcs: GcWatch, smi: str, phase: str = "server") -> None:
    """Log the slowest timed Filter's span tree, its
    ``/debug/criticalpath`` record and the garbage collections that ran
    inside it."""
    ms, trace_id = slowest
    trace = server.scheduler.tracer.find_by_trace_id(trace_id)
    _, body = server.get("/debug/criticalpath?limit=256")
    record = next((r for r in json.loads(body).get("recent", ()) if r["traceId"] == trace_id), None)
    inside = gcs.between(trace["startTime"], trace["startTime"] + ms / 1e3)
    full = [e for e in gcs.events if e[0] == 2]
    log(f"phase {phase}: {policy}: the slowest timed Filter ({ms:.3f} ms, trace {trace_id}): "
        f"criticalpath {json.dumps(record, sort_keys=True)}; spans by exclusive time "
        + ", ".join(f"{name} {t:.3f}" for name, t in
                    sorted(self_times(trace["root"], {}).items(), key=lambda kv: -kv[1])[:8])
        + f"; tree: {' | '.join(span_tree_lines(trace['root']))}; garbage collections inside it "
        + (", ".join(f"generation {g} {t:.1f} ms ({n} collected)" for g, _, t, n in inside) or "none")
        + f" (generation-2 collections so far in the phase: {len(full)}, "
        + (f"max {max(e[2] for e in full):.1f} ms" if full else "none") + f") | {smi}")


def server_phase(seed: int, smi: str, base: float) -> tuple:
    """Phase 5 (see the module docstring), the card's half: its snapshot's
    queue created from `base`.  Returns ({checkpointed kernel: launches on
    its policy's cuda servers' run}, {policy: answers}: the bodies
    server_check holds to twin_server_phase's cpu server).  Raises
    SystemExit on any failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.config import ProvenanceConfig
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    path_launches, recorded = {}, {}
    gcs = GcWatch()
    gc.callbacks.append(gcs)
    try:
        t0 = time.perf_counter()
        names, nodes, queue, rng, _ = server_objects(seed, base=base)
        log(f"phase server: snapshot {len(nodes)} nodes in {N_ZONES} zones, {len(queue)} queued drivers "
            f"built in {time.perf_counter() - t0:.2f} s")
        for pi, policy in enumerate(SERVER_POLICIES):
            t0 = time.perf_counter()
            servers = {}
            answers = recorded[policy] = {}
            try:
                servers["cuda"] = PortServer(policy, "cuda", nodes, queue)
                off = None
                if policy == SERVER_PROVENANCE_OFF:
                    off = servers["cuda-provenance-off"] = PortServer(
                        policy, "cuda", nodes, queue, provenance=ProvenanceConfig(enabled=False))
                log(f"phase server: {policy}: {', '.join(servers)} servers ready in "
                    f"{time.perf_counter() - t0:.2f} s")
                card = servers["cuda"]
                # each cuda server is timed alone: the other cuda server's
                # sampler and ledger are paused around each timed request
                solver = card.scheduler.extender.binpacker.queue_solver
                prov = card.watch_provenance()
                kname = SERVER_KERNEL[policy]
                engine = card.scheduler.extender.delta_engine
                lat_ms, off_ms, traces, granted, exec_checked = [], [], [], 0, 0
                slowest = None  # (ms, trace id) of the slowest timed Filter
                n_probes = SERVER_WARMUP_PROBES + SERVER_TIMED_PROBES
                # the path is driven with every count at 0: the first probe's
                # cold session pass launches the checkpointed kernel, and
                # the warm probes after it launch none
                qk.reset_launch_counts()
                mk.reset_launch_counts()
                for i in range(n_probes):
                    timed = i >= SERVER_WARMUP_PROBES
                    if i == SERVER_WARMUP_PROBES:
                        prov["ms"].clear()  # the timed probes' run starts here
                        warm_before = engine.stats()["warm_hits"]
                    pods = probe_pods(rng, f"probe-{pi}-{i:03d}", base + N_APPS + i)
                    created = pods[:1]
                    for server in servers.values():
                        server.api.create(pods[0].deepcopy())
                    fast_before = card.fast_lane_count()
                    others = [off] if off is not None else []
                    if off is not None and i % 2:  # the two cuda servers in turns
                        o_ms, o_status, o_body = off.post_alone([card], pods[0], names)
                    ms, status, body = card.post_alone(others, pods[0], names)
                    if timed:
                        lat_ms.append(ms)
                        traces.append(card.scheduler.tracer.traces(limit=1)[0])
                        if slowest is None or ms > slowest[0]:
                            slowest = (ms, traces[-1]["traceId"])
                    if off is not None:
                        if not i % 2:
                            o_ms, o_status, o_body = off.post_alone([card], pods[0], names)
                        if (o_status, o_body) != (status, body):
                            raise SystemExit(f"{policy} probe {i}: provenance off answered {o_status} "
                                             f"{o_body[:300]!r}, on {status} {body[:300]!r}")
                        if timed:
                            off_ms.append(o_ms)
                    if status != 200:
                        raise SystemExit(f"{policy} probe {i}: cuda answered {status} {body[:300]!r}")
                    answers[i] = (status, body)
                    if card.fast_lane_count() != fast_before + 1 or solver.last_queue_lane != SESSION_LANE:
                        raise SystemExit(f"{policy} probe {i} did not take the tensor lane with the CUDA "
                                         f"session (queue lane {solver.last_queue_lane!r})")
                    result = json.loads(body)
                    if result["NodeNames"]:
                        granted += 1
                        if timed and exec_checked < SERVER_EXECUTOR_CHECKS:
                            exec_checked += 1
                            for server in servers.values():
                                server.bind(pods[0], result["NodeNames"][0])
                            for pod in pods[1:]:
                                created.append(pod)
                                for server in servers.values():
                                    server.api.create(pod.deepcopy())
                                _, e_status, e_body = card.post(pod, names)
                                answers[pod.name] = (e_status, e_body)
                                e_nodes = json.loads(e_body).get("NodeNames") if e_status == 200 else None
                                if not e_nodes:
                                    raise SystemExit(f"{policy} executor {pod.name}: cuda {e_status} {e_body[:300]!r}")
                                if e_nodes[0] != card.reserved_node(pod):
                                    raise SystemExit(f"{policy} executor {pod.name} placed on {e_nodes[0]}, "
                                                     f"reserved {card.reserved_node(pod)}")
                            log(f"phase server: {policy}: probe {i} bound on {result['NodeNames'][0]}; "
                                f"its {len(pods) - 1} executors each granted their reserved node")
                    for server in servers.values():
                        server.retire(created)
                launches = {**qk.launch_counts, **mk.launch_counts}[kname + "_checkpointed"]
                path_launches[kname + "_checkpointed"] = launches
                warm = engine.stats()["warm_hits"] - warm_before
                cuda_servers = 1 + (off is not None)
                if launches != cuda_servers:  # one cold session pass a server, the rest served warm
                    raise SystemExit(f"{policy}: {kname}_checkpointed launched {launches} times on the "
                                     f"server's path, expected {cuda_servers} (one cold pass a cuda server)")
                if warm != SERVER_TIMED_PROBES:
                    raise SystemExit(f"{policy}: {warm} of the {SERVER_TIMED_PROBES} timed probes served warm")
                if exec_checked < SERVER_EXECUTOR_CHECKS:
                    raise SystemExit(f"{policy}: only {exec_checked} granted probes to check executors on")
                log(f"phase server: {policy}: {n_probes} probes (their bodies and the executors' held to a cpu "
                    f"server's in a server twin), {granted} granted, all on lane=fast with the cuda delta-solve session; "
                    f"{kname}_checkpointed launches {launches} over the probes on {cuda_servers} cuda "
                    f"servers, {warm} of the {SERVER_TIMED_PROBES} timed probes served warm; engine "
                    f"{engine.stats()}")
                log(f"phase server: {policy}: provenance on the request path (begin, context, capture, "
                    f"record) median {statistics.median(prov['ms']):.3f} ms, max {max(prov['ms']):.3f} ms "
                    f"a Filter over the timed run's {len(prov['ms'])} driver and executor Filters")
                log(f"phase server: {policy}: /predicates at {N_NODES} nodes x {N_APPS} queued drivers, the "
                    f"cuda server timed alone (the other server's sampler and ledger paused): "
                    f"p50 {statistics.median(lat_ms):.3f} ms, p99 {float(np.percentile(lat_ms, 99)):.3f} ms "
                    f"over {len(lat_ms)} probes (runs {', '.join(f'{x:.1f}' for x in lat_ms)}) | {smi}")
                SERVER_LATENCY[policy] = list(lat_ms)
                slow_filter_capture(card, policy, slowest, gcs, smi)
                if off is not None:
                    log(f"phase server: {policy}: the same probes on a cuda server with provenance off, in "
                        f"turns with it on: p50 {statistics.median(off_ms):.3f} ms, p99 "
                        f"{float(np.percentile(off_ms, 99)):.3f} ms (runs {', '.join(f'{x:.1f}' for x in off_ms)}) "
                        f"against p50 {statistics.median(lat_ms):.3f}, p99 {float(np.percentile(lat_ms, 99)):.3f} "
                        f"ms on, bodies equal | {smi}")
                spans = {}
                for trace in traces:
                    span_durations(trace["root"], spans)
                # the kernel's span is named after the queue solve it profiles
                kernel_span = "kernel:fifo_queue_min_frag" if kname == "fifo_queue_min_frag" else "kernel:fifo_queue"
                wanted = [kernel_span if name == "kernel:fifo_queue" else name for name in SERVER_SPANS]
                log(f"phase server: {policy}: span medians (ms) " + ", ".join(
                    f"{name} {statistics.median(spans[name]):.3f}" for name in wanted if name in spans
                ) + f" | {smi}")
                missing = [name for name in wanted if name not in spans]
                if missing:
                    raise SystemExit(f"{policy}: the request traces lack spans {missing}")
                pods = Harness.static_allocation_spark_pods(
                    f"probe-{pi}-traced", 4, creation_timestamp=base + N_APPS + n_probes)
                card.api.create(pods[0].deepcopy())
                share = busy_share(lambda: card.post(pods[0], names))
                card.retire(pods[:1])
                log(f"phase server: {policy}: profiler trace of one /predicates request: {share} | {smi}")
                # one refused probe behind the queue: its explanation
                # (this policy's queue kernel with probes) on the card,
                # its failure message held to the cpu server's
                ks, before, after = refused_gang_sizes(prov["art"], 1)
                pod = refused_driver(f"probe-{pi}-refused", ks[0], base + N_APPS + n_probes + 1)
                card.api.create(pod.deepcopy())
                qk.reset_launch_counts()
                mk.reset_launch_counts()
                ms, status, body = card.post(pod, names)
                answers["refused"] = (ks[0], status, body)
                explain_launches = {**qk.launch_counts, **mk.launch_counts}
                message = next(iter(json.loads(body).get("FailedNodes", {}).values()), "")
                if status != 200 or "blocked by" not in message:
                    raise SystemExit(f"{policy} refused probe: cuda {status} {body[:300]!r}")
                if explain_launches[kname] != 1:
                    raise SystemExit(f"{policy} refused probe: {explain_launches[kname]} {kname} launches, "
                                     f"want the explanation's")
                log(f"phase server: {policy}: refused probe of {ks[0]} executors (room {before} before the "
                    f"queue, {after} behind it): {ms:.3f} ms, explanation {prov['explain_ms'][-1]:.3f} ms "
                    f"({kname} launches {explain_launches[kname]}: the explanation's; the warm Filter's "
                    f"{kname}_checkpointed {explain_launches[kname + '_checkpointed']}): {message[:160]!r} | {smi}")
                card.api.delete("Pod", pod.namespace, pod.name)  # refused: nothing reserved
            finally:
                for server in servers.values():
                    server.stop()
    finally:
        gc.callbacks.remove(gcs)
        logging.disable(logging.NOTSET)
    return path_launches, recorded


def twin_server_phase(seed: int, base: float, policy: str) -> tuple:
    """Phase 5's cpu half for one policy, in a server twin: a device="cpu"
    server on the same objects, through the same draws of the same random
    state (the earlier policies' probes drawn and dropped), answers every
    probe, the executors of its first SERVER_EXECUTOR_CHECKS granted timed
    probes and the refused probe, sized from its own captured solve, as
    server_phase drives the card: ({probe or executor or "refused":
    answer}, seconds)."""
    t = time.perf_counter()
    names, nodes, queue, rng, _ = server_objects(seed, base=base)
    n_probes = SERVER_WARMUP_PROBES + SERVER_TIMED_PROBES
    pi = SERVER_POLICIES.index(policy)
    for _ in range(pi * n_probes):
        probe_pods(rng, "", 0.0)
    server = PortServer(policy, "cpu", nodes, queue)
    try:
        server.pause_background()
        prov = server.watch_provenance()
        answers, exec_checked = {}, 0
        for i in range(n_probes):
            pods = probe_pods(rng, f"probe-{pi}-{i:03d}", base + N_APPS + i)
            created = pods[:1]
            server.api.create(pods[0].deepcopy())
            _, status, body = server.post(pods[0], names)
            answers[i] = (status, body)
            result = json.loads(body) if status == 200 else {}
            if result.get("NodeNames") and i >= SERVER_WARMUP_PROBES and exec_checked < SERVER_EXECUTOR_CHECKS:
                exec_checked += 1
                server.bind(pods[0], result["NodeNames"][0])
                for pod in pods[1:]:
                    created.append(pod)
                    server.api.create(pod.deepcopy())
                    answers[pod.name] = server.post(pod, names)[1:]
            server.retire(created)
        ks, _, _ = refused_gang_sizes(prov["art"], 1)
        pod = refused_driver(f"probe-{pi}-refused", ks[0], base + N_APPS + n_probes + 1)
        server.api.create(pod.deepcopy())
        answers["refused"] = (ks[0],) + server.post(pod, names)[1:]
        return answers, time.perf_counter() - t
    finally:
        server.stop()


def server_check(recorded: dict, cpu: dict) -> None:
    """Phase 5's answers against the server twins' cpu servers (`cpu`:
    twin_server_phase's result by policy): every probe's body, the
    checked executors' and the refused probe's, with its size."""
    for policy, answers in recorded.items():
        want, twin_s = cpu[policy]
        if sorted(map(str, answers)) != sorted(map(str, want)):
            raise SystemExit(f"phase server: {policy}: the card answered {sorted(map(str, answers))}, the cpu "
                             f"server {sorted(map(str, want))}")
        for key, answer in answers.items():
            if answer != want[key]:
                raise SystemExit(f"phase server: {policy} {key}: cuda {str(answer)[:300]}, cpu {str(want[key])[:300]}")
        log(f"phase server: {policy}: all {len(answers)} answers (probes, executors, the refused probe's) equal "
            f"to a cpu server's (its Filters and start {twin_s:.1f} s in a server twin)")


# -- phase az-server: the single-AZ family through the port's server -------------

# each single-AZ name and the kernel variant its Filters launch: the
# tensor lane declines these names, so every driver Filter takes the
# metadata lane (scheduler/extender._try_device_fifo)
AZ_SERVER_KERNEL = {"tpu-batch-single-az": "fifo_queue_single_az_tightly",
                    "tpu-batch-az-aware": "fifo_queue_single_az_az_aware",
                    "tpu-batch-single-az-minimal-fragmentation": "fifo_queue_single_az_min_frag"}
# the warmups' bodies and every AZ_CPU_EVERY-th timed probe's are held to a
# cpu server's, which answers them in a server twin (seconds a Filter there)
AZ_CPU_EVERY = 4
# the pieces of a single-AZ decision (ROADMAP D.2): the functions each
# times, looked up in ops/fifo_solver's namespace ("packers." in ops/packers')
AZ_PIECES = {"tensorize": ("tensorize_cluster", "tensorize_apps", "scale_problem"),
             "zone inputs": ("candidate_zone_masks", "single_az_queue_inputs"),
             "kernel": ("fifo_queue_single_az",),
             "current app's zone solves": ("solve_zones", "min_frag_zone_decode", "solve_single"),
             "efficiencies": ("efficiencies_from_rows", "packers._choose_best_result")}


def az_compared(i: int) -> bool:
    """Whether phase az-server's probe i is held to the cpu server's."""
    return i < SERVER_WARMUP_PROBES or (i - SERVER_WARMUP_PROBES) % AZ_CPU_EVERY == 0


def keep_solve_args(solver) -> dict:
    """Wrap the solver's ``solve`` to keep its last call's arguments
    ("args") and each call's host ms ("ms")."""
    kept = {"ms": []}
    solve = solver.solve

    def keeping(*args):
        kept["args"] = args
        t = time.perf_counter()
        try:
            return solve(*args)
        finally:
            kept["ms"].append((time.perf_counter() - t) * 1e3)

    solver.solve = keeping
    return kept


@contextlib.contextmanager
def az_pieces():
    """Time AZ_PIECES' functions while inside: yields a dict of ms by
    piece, which the caller clears between Filters.  The kernel's piece
    ends in a synchronize."""
    from k8s_spark_scheduler_tpu_torch.ops import fifo_solver, packers

    ms, saved = {}, []

    def timed(piece, fn, sync):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                out = fn(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                ms[piece] = ms.get(piece, 0.0) + (time.perf_counter() - t) * 1e3
        return wrapper

    for piece, fns in AZ_PIECES.items():
        for name in fns:
            module, attr = (packers, name[len("packers."):]) if name.startswith("packers.") else (fifo_solver, name)
            saved.append((module, attr, getattr(module, attr)))
            setattr(module, attr, timed(piece, saved[-1][2], piece == "kernel"))
    try:
        yield ms
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def az_refused_size(solver, args) -> tuple:
    """(k, room before, room after): an executor count for a gang of
    REFUSED_EXECUTOR executors that fits the cluster as it stands but not
    behind the queue, from the arguments of `solver`'s last solve and the
    queue pass on its device (the kernel on the card, the plain version on
    the CPU).  The room is the most such executors one zone holds, or the
    cluster under az-aware, whose fallback packs across zones."""
    from k8s_spark_scheduler_tpu_torch.ops import single_az_kernel as sk
    from k8s_spark_scheduler_tpu_torch.ops.batch_adapter import candidate_zone_masks
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import single_az_queue_inputs
    from k8s_spark_scheduler_tpu_torch.ops.tensorize import scale_problem, tensorize_apps, tensorize_cluster

    metadata, driver_order, executor_order, earlier, _, current = args
    cluster = tensorize_cluster(metadata, driver_order, executor_order)
    problem = scale_problem(cluster, tensorize_apps(list(earlier) + [current]))
    zones, masks = candidate_zone_masks(driver_order, executor_order, metadata, cluster.node_names,
                                        problem.avail.shape[0])
    arrays, scalars = single_az_queue_inputs(cluster, problem, masks, len(zones), len(earlier))
    after = sk.fifo_queue_single_az(*on(solver.device, arrays), *scalars, az_aware=solver.az_aware,
                                    minfrag=solver.inner_policy == "minimal-fragmentation",
                                    strict=solver.strict_reference_parity)[4].cpu().numpy()
    scale = problem.scale.astype(np.int64)
    exec_base = np.array([REFUSED_EXECUTOR[0] * 1000, REFUSED_EXECUTOR[1] * 2**30], np.int64)

    def room(avail) -> int:
        a = np.asarray(avail, dtype=np.int64)
        cap = np.minimum(a[:, 0] * scale[0] // exec_base[0], a[:, 1] * scale[1] // exec_base[1])
        cap = np.where(problem.exec_ok & (a >= 0).all(axis=1), np.maximum(cap, 0), 0)
        if solver.az_aware:
            return int(cap.sum())
        return max(int(cap[arrays[3] == z].sum()) for z in range(len(zones)))

    before, behind = room(problem.avail), room(after)
    if before - behind < 4:
        raise SystemExit(f"the queue takes too little room to refuse behind it ({before} -> {behind})")
    return behind + 1 + (before - behind) // 2, before, behind


def az_server_phase(seed: int, smi: str, base: float) -> tuple:
    """Phase az-server (see the module docstring), the card's half: a cuda
    server for each single-AZ name on phase 5's snapshot (its queue created
    from `base`).  Returns ({variant: launches over its name's Filters},
    {policy: {"bodies": {probe: (status, body)}, "refused": (k, status,
    body)}}), the answers az_server_check holds to the twin's cpu servers.
    Raises SystemExit on any failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.metrics import names as mnames
    from k8s_spark_scheduler_tpu_torch.ops import single_az_kernel as sk

    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    launches, recorded = {}, {}
    gcs = GcWatch()
    gc.callbacks.append(gcs)
    n_probes = SERVER_WARMUP_PROBES + SERVER_TIMED_PROBES
    try:
        t0 = time.perf_counter()
        names, nodes, queue, rng, _ = server_objects(seed, base=base)
        log(f"phase az-server: snapshot {len(nodes)} nodes in {N_ZONES} zones, {len(queue)} queued drivers "
            f"built in {time.perf_counter() - t0:.2f} s")
        for pi, (policy, kname) in enumerate(AZ_SERVER_KERNEL.items()):
            t0 = time.perf_counter()
            card = PortServer(policy, "cuda", nodes, queue)
            try:
                log(f"phase az-server: {policy}: cuda server ready in {time.perf_counter() - t0:.2f} s")
                solver = card.scheduler.extender.binpacker.queue_solver
                kept = keep_solve_args(solver)
                metrics = card.scheduler.metrics
                lane_before = {lane: metrics.get_counter(mnames.SINGLEAZ_LANE, {"lane": lane})
                               for lane in ("fused", "host")}
                # the path is driven with every count at 0; each Filter's
                # launches are read around it
                sk.reset_launch_counts()
                lat_ms, traces, pieces, decision_ms, lanes, bodies = [], [], [], [], [], {}
                granted, exec_checked, path_launches = 0, 0, 0
                slowest = None  # (ms, trace id) of the slowest timed Filter
                with az_pieces() as piece_ms:
                    for i in range(n_probes):
                        timed = i >= SERVER_WARMUP_PROBES
                        pods = probe_pods(rng, f"az-{pi}-{i:03d}", base + N_APPS + i)
                        created = pods[:1]
                        card.api.create(pods[0].deepcopy())
                        piece_ms.clear()
                        before = sk.launch_counts[kname]
                        ms, status, body = card.post(pods[0], names)
                        filter_launches = sk.launch_counts[kname] - before
                        path_launches += filter_launches
                        if status != 200:
                            raise SystemExit(f"{policy} probe {i}: cuda answered {status} {body[:300]!r}")
                        lanes.append(solver.last_path)
                        # the snapshot is inside the fused lane's bounds: a
                        # fused Filter is one launch; one whose valve solved
                        # uncertain apps on the host, one launch more for
                        # each side of each of them
                        if solver.last_path not in ("fused", "host") or filter_launches < 1 or (
                                solver.last_path == "fused" and filter_launches != 1):
                            raise SystemExit(f"{policy} probe {i}: lane {solver.last_path!r} with {filter_launches} "
                                             f"{kname} launches")
                        if az_compared(i):
                            bodies[i] = (status, body)
                        if timed:
                            lat_ms.append(ms)
                            decision_ms.append(kept["ms"][-1])
                            pieces.append(dict(piece_ms))
                            traces.append(card.scheduler.tracer.traces(limit=1)[0])
                            if slowest is None or ms > slowest[0]:
                                slowest = (ms, traces[-1]["traceId"])
                        result = json.loads(body)
                        if result["NodeNames"]:
                            granted += 1
                            if timed and exec_checked < SERVER_EXECUTOR_CHECKS:
                                exec_checked += 1
                                card.bind(pods[0], result["NodeNames"][0])
                                for pod in pods[1:]:
                                    created.append(pod)
                                    card.api.create(pod.deepcopy())
                                    _, e_status, e_body = card.post(pod, names)
                                    e_nodes = json.loads(e_body).get("NodeNames") if e_status == 200 else None
                                    if not e_nodes or e_nodes[0] != card.reserved_node(pod):
                                        raise SystemExit(f"{policy} executor {pod.name}: {e_status} {e_body[:300]!r}, "
                                                         f"reserved {card.reserved_node(pod)}")
                                log(f"phase az-server: {policy}: probe {i} bound on {result['NodeNames'][0]}; its "
                                    f"{len(pods) - 1} executors each granted their reserved node")
                        card.retire(created)
                lane_counts = {lane: metrics.get_counter(mnames.SINGLEAZ_LANE, {"lane": lane}) - n
                               for lane, n in lane_before.items()}
                if lane_counts != {lane: lanes.count(lane) for lane in lane_counts}:
                    raise SystemExit(f"{policy}: {mnames.SINGLEAZ_LANE} counted {lane_counts}, the solver's lanes "
                                     f"{lanes}")
                if card.fast_lane_count():
                    raise SystemExit(f"{policy}: {card.fast_lane_count()} Filters on the tensor lane")
                if path_launches < 1:
                    raise SystemExit(f"{policy}: {kname} was not launched on the server's path")
                if exec_checked < SERVER_EXECUTOR_CHECKS:
                    raise SystemExit(f"{policy}: only {exec_checked} granted probes to check executors on")
                log(f"phase az-server: {policy}: {n_probes} probes through _try_device_fifo, {granted} granted; "
                    f"{kname} launches {path_launches}; {mnames.SINGLEAZ_LANE} fused {lane_counts['fused']:.0f}, "
                    f"host {lane_counts['host']:.0f} (the valve: uncertain apps on the host lane); tensor-lane "
                    f"Filters 0 | {smi}")
                log(f"phase az-server: {policy}: /predicates at {N_NODES} nodes x {N_APPS} queued drivers, the "
                    f"cuda server alone: p50 {statistics.median(lat_ms):.3f} ms, p99 "
                    f"{float(np.percentile(lat_ms, 99)):.3f} ms over {len(lat_ms)} probes (runs "
                    f"{', '.join(f'{x:.1f}' for x in lat_ms)}) | {smi}")
                log(f"phase az-server: {policy}: the decision (solve) median {statistics.median(decision_ms):.3f} "
                    f"ms, of which (medians) " + ", ".join(
                        f"{piece} {statistics.median(p.get(piece, 0.0) for p in pieces):.3f}" for piece in AZ_PIECES)
                    + f" | {smi}")
                spans = {}
                for trace in traces:
                    span_durations(trace["root"], spans)
                log(f"phase az-server: {policy}: span medians (ms) " + ", ".join(
                    f"{name} {statistics.median(v):.3f}" for name, v in spans.items()) + f" | {smi}")
                slow_filter_capture(card, policy, slowest, gcs, smi, phase="az-server")
                # one probe refused behind the queue, its size from the
                # last Filter's queue pass
                k, room_before, room_after = az_refused_size(solver, kept["args"])
                pod = refused_driver(f"az-{pi}-refused", k, base + N_APPS + n_probes)
                card.api.create(pod.deepcopy())
                before = sk.launch_counts[kname]
                ms, status, body = card.post(pod, names)
                path_launches += sk.launch_counts[kname] - before
                message = next(iter(json.loads(body).get("FailedNodes", {}).values()), "")
                if status != 200 or json.loads(body).get("NodeNames") or "does not fit" not in message:
                    raise SystemExit(f"{policy} refused probe of {k} executors: {status} {body[:300]!r}")
                card.api.delete("Pod", pod.namespace, pod.name)  # refused: nothing reserved
                log(f"phase az-server: {policy}: refused probe of {k} executors (room {room_before} before the "
                    f"queue, {room_after} behind it): {ms:.3f} ms, lane {solver.last_path}: {message[:160]!r} | {smi}")
                launches[kname] = path_launches
                recorded[policy] = {"bodies": bodies, "refused": (k, status, body)}
            finally:
                card.stop()
    finally:
        gc.callbacks.remove(gcs)
        logging.disable(logging.NOTSET)
    return launches, recorded


def twin_az_server(seed: int, base: float, policy: str) -> tuple:
    """Phase az-server's cpu half for one name, in a server twin: a
    device="cpu" server on the same objects, through the same draws of the
    same random state (the earlier names' probes drawn and dropped),
    answers the probes az_compared names (each probe is retired before the
    next, so the others leave nothing behind) and the refused probe, sized
    from its own queue pass: ({"bodies": {probe: (status, body)},
    "refused": (k, status, body)}, seconds)."""
    t = time.perf_counter()
    names, nodes, queue, rng, _ = server_objects(seed, base=base)
    n_probes = SERVER_WARMUP_PROBES + SERVER_TIMED_PROBES
    pi = list(AZ_SERVER_KERNEL).index(policy)
    for i in range(pi * n_probes):
        probe_pods(rng, "", 0.0)
    server = PortServer(policy, "cpu", nodes, queue)
    try:
        server.pause_background()
        solver = server.scheduler.extender.binpacker.queue_solver
        kept = keep_solve_args(solver)
        bodies = {}
        for i in range(n_probes):
            pods = probe_pods(rng, f"az-{pi}-{i:03d}", base + N_APPS + i)
            if az_compared(i):
                server.api.create(pods[0].deepcopy())
                _, status, body = server.post(pods[0], names)
                bodies[i] = (status, body)
                server.retire(pods[:1])
        k, _, _ = az_refused_size(solver, kept["args"])
        pod = refused_driver(f"az-{pi}-refused", k, base + N_APPS + n_probes)
        server.api.create(pod.deepcopy())
        _, status, body = server.post(pod, names)
        return {"bodies": bodies, "refused": (k, status, body)}, time.perf_counter() - t
    finally:
        server.stop()


def az_server_check(recorded: dict, cpu: dict) -> None:
    """Phase az-server's answers against the server twins' cpu servers
    (`cpu`: twin_az_server's result by name)."""
    for policy, got in recorded.items():
        want, twin_s = cpu[policy]
        if sorted(got["bodies"]) != sorted(want["bodies"]):
            raise SystemExit(f"phase az-server: {policy}: compared probes {sorted(got['bodies'])} vs "
                             f"{sorted(want['bodies'])}")
        for i, answer in got["bodies"].items():
            if answer != want["bodies"][i]:
                raise SystemExit(f"phase az-server: {policy} probe {i}: cuda {answer[0]} {answer[1][:300]!r}, "
                                 f"cpu {want['bodies'][i][0]} {want['bodies'][i][1][:300]!r}")
        if got["refused"] != want["refused"]:
            raise SystemExit(f"phase az-server: {policy} refused probe: cuda {got['refused'][0]} executors "
                             f"{got['refused'][2][:300]!r}, cpu {want['refused'][0]} {want['refused'][2][:300]!r}")
        log(f"phase az-server: {policy}: probes {sorted(got['bodies'])} ({len(got['bodies'])} bodies) and the "
            f"refused probe's ({got['refused'][0]} executors) equal to a cpu server's (its {len(want['bodies']) + 1} "
            f"Filters and start {twin_s:.1f} s in a server twin)")


# -- phase 6: the server against a cluster over REST ----------------------------

CLUSTER_POLICY = "tpu-batch"
# the invariant checker runs after every CLUSTER_CHECK_EVERY-th driver
# Filter of the cuda server (I5 at 10,000 nodes is ~1.5 s a check), and
# on both servers at the end
CLUSTER_CHECK_EVERY = 4
WAIT_S = 60.0
_PROM_TYPE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|summary)$")
_PROM_SERIES = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*",?)*\})? (\S+)$'
)


def wait_for(cond, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise SystemExit(f"timed out waiting for {what}")
        time.sleep(0.002)


def parse_prometheus(text: str) -> dict:
    """{series line's name and labels: value} of a Prometheus 0.0.4
    exposition; raises SystemExit on a line that is neither a TYPE line
    nor a sample."""
    samples = {}
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("#"):
            if not _PROM_TYPE.match(line):
                raise SystemExit(f"/metrics: bad comment line {line!r}")
            continue
        m = _PROM_SERIES.match(line)
        if m is None:
            raise SystemExit(f"/metrics: bad sample line {line!r}")
        samples[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return samples


def identity_free(wire: dict) -> dict:
    """A wire object without what each API server assigns itself (uids,
    resource versions, creation times)."""
    meta = {k: v for k, v in (wire.get("metadata") or {}).items()
            if k not in ("uid", "resourceVersion", "creationTimestamp")}
    meta["ownerReferences"] = [{k: v for k, v in ref.items() if k != "uid"}
                               for ref in meta.get("ownerReferences") or []]
    return dict(wire, metadata=meta)


class ClusterServer(PortServer):
    """The port's server against its own FakeKubeAPI over REST: the fake
    holds the cluster's objects, a kubeconfig names it, and the backend
    is the one the CLI's ``--kubeconfig`` flag builds.  Filters, binds
    and deletes act on the fake's store; the server sees them through its
    watches."""

    def __init__(self, device: str, nodes, queue, workdir: str):
        from k8s_spark_scheduler_tpu_torch.config import Install
        from k8s_spark_scheduler_tpu_torch.kube.crd import DEMAND_CRD_NAME, demand_crd_spec
        from k8s_spark_scheduler_tpu_torch.server.__main__ import api_backend
        from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer
        from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients
        from k8s_spark_scheduler_tpu_torch.testing.fake_kube_api import FakeKubeAPI

        self.fake = FakeKubeAPI().start()
        self.scheduler = self.http = self.backend = None
        try:
            self.api = self.fake.api  # the cluster's own store
            self.api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
            for obj in nodes + queue:
                self.api.create(obj.deepcopy())
            path = os.path.join(workdir, f"kubeconfig-{device}.json")
            with open(path, "w") as f:
                json.dump({
                    "current-context": "fake",
                    "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "fake"}}],
                    "clusters": [{"name": "fake", "cluster": {"server": self.fake.host}}],
                    "users": [{"name": "fake", "user": {}}],
                }, f)
            self.backend, _ = api_backend(path, None, False)
            # the first full LIST of the nodes and pods over REST, and
            # their decode into objects, alone
            from k8s_spark_scheduler_tpu_torch.kube.restbackend import _RESOURCES

            self.list_ms, self.decode_ms, self.list_bytes = {}, {}, {}
            for kind in ("Node", "Pod"):
                res = _RESOURCES[kind]
                t = time.perf_counter()
                data = self.backend.client.request("GET", res.path())
                self.list_ms[kind] = (time.perf_counter() - t) * 1e3
                t = time.perf_counter()
                objs = [res.from_wire(item) for item in data["items"]]
                self.decode_ms[kind] = (time.perf_counter() - t) * 1e3
                self.list_bytes[kind] = len(json.dumps(data))
                if len(objs) != len(self.api.list(kind)):
                    raise SystemExit(f"the {kind} LIST over REST returned {len(objs)} objects")
            t = time.perf_counter()
            self.scheduler = init_server_with_clients(
                self.backend, Install(binpack_algo=CLUSTER_POLICY, fifo=True, resilience=server_resilience(device)),
                demand_poll_interval=0.5,
                unschedulable_polling_interval=3600.0, device=device,
            )
            # every informer has listed its kind over REST, replayed it,
            # and its watch stream has started
            self.watch_start_ms = (time.perf_counter() - t) * 1e3
            self.http = ExtenderHTTPServer(self.scheduler, port=0, host="127.0.0.1")
            self.http.start()
            if not self.scheduler.wait_ready(timeout=600.0):
                raise SystemExit(f"the {device} cluster server did not become ready")
            if len(self.scheduler.node_informer.list()) != len(nodes):
                raise SystemExit(f"the {device} server's informer holds "
                                 f"{len(self.scheduler.node_informer.list())} nodes")
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        if self.http is not None:
            self.http.stop()
        if self.scheduler is not None:
            self.scheduler.stop()
        if self.backend is not None:
            self.backend.stop()
        self.fake.stop()

    def retire(self, pods) -> None:
        """PortServer.retire, then wait until the watch has taken the
        pods out of the server's informer too."""
        super().retire(pods)
        wait_for(lambda: all(self.scheduler.pod_informer.get(p.namespace, p.name) is None for p in pods),
                 "the watch to deliver the deletes")

    def post_json(self, path: str, payload: dict) -> dict:
        import urllib.request

        req = urllib.request.Request(f"http://127.0.0.1:{self.http.port}{path}",
                                     data=json.dumps(payload).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def sees(self, pod, node: str = "") -> None:
        """Wait until the server's pod informer holds the pod (bound to
        `node` when given), delivered by its watch."""
        def seen():
            got = self.scheduler.pod_informer.get(pod.namespace, pod.name)
            return got is not None and got.node_name == node
        wait_for(seen, f"the watch to deliver {pod.name}")

    def settle(self) -> None:
        """Wait until the write-backs have landed in the fake over REST:
        queues drained, caches equal to the cluster's objects."""
        sched = self.scheduler

        def rr_content(rrs):
            return {(rr.namespace, rr.name): (sorted((k, v.node) for k, v in rr.spec.reservations.items()),
                                              sorted(rr.status.pods.items())) for rr in rrs}

        wait_for(lambda: not any(sched.resource_reservation_cache.inflight_queue_lengths())
                 and not any(sched.demand_cache.inflight_queue_lengths())
                 and rr_content(sched.resource_reservation_cache.list())
                 == rr_content(self.api.list("ResourceReservation"))
                 and {(d.namespace, d.name) for d in sched.demand_cache.list()}
                 == {(d.namespace, d.name) for d in self.api.list("Demand")},
                 "the write-back to land in the fake")

    def written(self):
        """The reservations and demands in the cluster, read over REST."""
        from k8s_spark_scheduler_tpu_torch.types import serde

        return (sorted(json.dumps(identity_free(serde.rr_to_dict_v1beta2(rr)), sort_keys=True)
                       for rr in self.backend.list("ResourceReservation")),
                sorted(json.dumps(identity_free(serde.demand_to_dict_v1alpha2(d)), sort_keys=True)
                       for d in self.backend.list("Demand")))


def cluster_phase(seed: int, smi: str) -> None:
    """Phase 6 (see the module docstring); raises SystemExit on any failure."""
    import logging
    import tempfile

    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.scheduler import invariants
    from k8s_spark_scheduler_tpu_torch.scheduler.unschedulable import POD_EXCEEDS_CLUSTER_CAPACITY
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
    from k8s_spark_scheduler_tpu_torch.types import serde

    # the invariant checker after every CLUSTER_CHECK_EVERY-th driver
    # Filter of the cuda server (the wiring reads SCHED_DEBUG_INVARIANTS
    # when it builds a server), counting its checks, their time and their
    # violations; "on" is set for those Filters only
    checked = {"checks": 0, "violations": [], "ms": [], "on": False}
    real_check = invariants.check

    def counting_check(server, raise_on_violation=True):
        if not checked["on"]:
            return []
        t = time.perf_counter()
        found = real_check(server, raise_on_violation=False)
        checked["ms"].append((time.perf_counter() - t) * 1e3)
        checked["checks"] += 1
        checked["violations"] += found
        return found

    invariants.check = counting_check
    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    servers = {}
    try:
        t0 = time.perf_counter()
        names, nodes, queue, rng, base = server_objects(seed)
        with tempfile.TemporaryDirectory() as workdir:
            for device in ("cuda", "cpu"):
                if device == "cuda":
                    os.environ["SCHED_DEBUG_INVARIANTS"] = "1"
                try:
                    servers[device] = ClusterServer(device, nodes, queue, workdir)
                finally:
                    os.environ.pop("SCHED_DEBUG_INVARIANTS", None)
        card, host = servers["cuda"], servers["cpu"]
        log(f"phase cluster: {CLUSTER_POLICY}: cuda and cpu servers, each on its own FakeKubeAPI holding "
            f"{len(nodes)} nodes in {N_ZONES} zones and {len(queue)} queued drivers, ready in "
            f"{time.perf_counter() - t0:.2f} s")
        for device, server in servers.items():
            log(f"phase cluster: {device} server: first full LIST over REST: nodes {server.list_ms['Node']:.1f} ms "
                f"({server.list_bytes['Node']} bytes) + decode {server.decode_ms['Node']:.1f} ms, pods "
                f"{server.list_ms['Pod']:.1f} ms ({server.list_bytes['Pod']} bytes) + decode "
                f"{server.decode_ms['Pod']:.1f} ms; informers listed, replayed and watching after "
                f"{server.watch_start_ms:.1f} ms | {smi}")
        solver = card.scheduler.extender.binpacker.queue_solver
        lat_ms, net_ms, check_ms, traces, granted, exec_checked, n_written = [], [], [], [], 0, 0, 0
        n_probes = SERVER_WARMUP_PROBES + SERVER_TIMED_PROBES
        checks_before = checked["checks"]
        engine = card.scheduler.extender.delta_engine
        qk.reset_launch_counts()  # the path's run starts here
        for i in range(n_probes):
            timed = i >= SERVER_WARMUP_PROBES
            if i == SERVER_WARMUP_PROBES:
                warm_before = engine.stats()["warm_hits"]
            pods = Harness.static_allocation_spark_pods(
                f"probe-c-{i:03d}", int(rng.randint(1, 32)), executor_cpu=str(int(rng.randint(1, 8))),
                executor_mem=f"{int(rng.randint(2, 16))}Gi", creation_timestamp=base + N_APPS + i,
            )
            created = pods[:1]
            for server in servers.values():
                server.api.create(pods[0].deepcopy())
                server.sees(pods[0])
                server.settle()
            fast_before, checks_seen = card.fast_lane_count(), checked["checks"]
            checked["on"] = i % CLUSTER_CHECK_EVERY == 0
            try:
                ms, status, body = card.post(pods[0], names)
            finally:
                checked["on"] = False
            if checked["checks"] != checks_seen + (i % CLUSTER_CHECK_EVERY == 0):
                raise SystemExit(f"cluster probe {i}: the invariant checker did not run as planned in the Filter")
            if timed:
                lat_ms.append(ms)
                # the request without the checker, which runs inside it
                check_ms.append(checked["ms"][-1] if i % CLUSTER_CHECK_EVERY == 0 else 0.0)
                net_ms.append(ms - check_ms[-1])
                traces.append(card.scheduler.tracer.traces(limit=1)[0])
            _, cpu_status, cpu_body = host.post(pods[0], names)
            if (status, body) != (cpu_status, cpu_body) or status != 200:
                raise SystemExit(f"cluster probe {i}: cuda answered {status} {body[:300]!r}, "
                                 f"cpu {cpu_status} {cpu_body[:300]!r}")
            if card.fast_lane_count() != fast_before + 1 or solver.last_queue_lane != SESSION_LANE:
                raise SystemExit(f"cluster probe {i} did not take the tensor lane with the CUDA session "
                                 f"(queue lane {solver.last_queue_lane!r})")
            result = json.loads(body)
            if result["NodeNames"]:
                granted += 1
                if timed and exec_checked < SERVER_EXECUTOR_CHECKS:
                    exec_checked += 1
                    for server in servers.values():
                        server.bind(pods[0], result["NodeNames"][0])
                        server.sees(pods[0], result["NodeNames"][0])
                    for pod in pods[1:]:
                        created.append(pod)
                        for server in servers.values():
                            server.api.create(pod.deepcopy())
                            server.sees(pod)
                            server.settle()
                        _, e_status, e_body = card.post(pod, names)
                        _, c_status, c_body = host.post(pod, names)
                        e_nodes = json.loads(e_body).get("NodeNames") if e_status == 200 else None
                        if (e_status, e_body) != (c_status, c_body) or not e_nodes:
                            raise SystemExit(f"cluster executor {pod.name}: cuda {e_status} {e_body[:300]!r}, "
                                             f"cpu {c_status} {c_body[:300]!r}")
                        if e_nodes[0] != card.reserved_node(pod):
                            raise SystemExit(f"cluster executor {pod.name} placed on {e_nodes[0]}, "
                                             f"reserved {card.reserved_node(pod)}")
                    log(f"phase cluster: probe {i} bound on {result['NodeNames'][0]}; its {len(pods) - 1} "
                        f"executors each granted their reserved node, equal on cuda and cpu")
            # what each server wrote back, read from its fake over REST
            for server in servers.values():
                server.settle()
            rrs, demands = card.written()
            if (rrs, demands) != host.written():
                raise SystemExit(f"cluster probe {i}: the reservations / demands written over REST differ")
            n_written += len(rrs) + len(demands)
            for server in servers.values():
                server.retire(created)
        launches = qk.launch_counts["fifo_queue_tightly_checkpointed"]
        warm = engine.stats()["warm_hits"] - warm_before
        if launches != 1:  # the first probe's cold session pass, the rest served warm
            raise SystemExit(f"cluster: fifo_queue_tightly_checkpointed launched {launches} times on the path, "
                             f"expected 1")
        if warm != SERVER_TIMED_PROBES:
            raise SystemExit(f"cluster: {warm} of the {SERVER_TIMED_PROBES} timed probes served warm")
        if exec_checked < SERVER_EXECUTOR_CHECKS or not n_written:
            raise SystemExit(f"cluster: only {exec_checked} granted probes checked, {n_written} objects written")
        log(f"phase cluster: {n_probes} probes equal on cuda and cpu, {granted} granted, all on lane=fast with "
            f"the cuda delta-solve session; fifo_queue_tightly_checkpointed launches {launches}, {warm} of the "
            f"{SERVER_TIMED_PROBES} timed probes served warm; engine {engine.stats()}; "
            f"{n_written} reservations and demands read back over REST equal on both fakes")
        log(f"phase cluster: /predicates over REST at {N_NODES} nodes x {N_APPS} queued drivers, without "
            f"the invariant checker's time: p50 {statistics.median(net_ms):.3f} ms, "
            f"p99 {float(np.percentile(net_ms, 99)):.3f} ms over {len(net_ms)} probes "
            f"(runs {', '.join(f'{x:.1f}' for x in net_ms)}) | {smi}")
        log(f"phase cluster: the same requests with the checker (I1-I5 after every {CLUSTER_CHECK_EVERY}th "
            f"Filter, median {statistics.median(checked['ms']):.1f} ms a check): p50 "
            f"{statistics.median(lat_ms):.3f} ms, p99 {float(np.percentile(lat_ms, 99)):.3f} ms | {smi}")
        spans = {}
        for trace in traces:
            span_durations(trace["root"], spans)
        missing = [name for name in SERVER_SPANS if name not in spans]
        if missing:
            raise SystemExit(f"cluster: the request traces lack spans {missing}")
        # the checker runs inside `predicate` (so inside `http.request`)
        for name in ("predicate", "http.request"):
            spans[name] = [d - c for d, c in zip(spans[name], check_ms)]
        log("phase cluster: span medians (ms; predicate and http.request without the checker) " + ", ".join(
            f"{name} {statistics.median(spans[name]):.3f}" for name in SERVER_SPANS) + f" | {smi}")

        # the invariant checker ran after every CLUSTER_CHECK_EVERY-th
        # driver Filter of the cuda server
        filters = checked["checks"] - checks_before
        if filters < -(-n_probes // CLUSTER_CHECK_EVERY) or checked["violations"]:
            raise SystemExit(f"cluster: {filters} invariant checks, violations {checked['violations'][:5]}")
        for device, server in servers.items():
            if not server.scheduler.tensor_snapshot.snapshot().exact:
                raise SystemExit(f"cluster: the {device} tensor mirror is inexact, so I5 checks nothing")
            found = real_check(server.scheduler, raise_on_violation=False)
            if found:
                raise SystemExit(f"cluster: {device} invariant violations {found[:5]}")
        log(f"phase cluster: invariants I1-I5 (I5 over {N_NODES} mirror rows) checked after {filters} of the "
            f"cuda server's {n_probes} driver Filters, 0 violations, median {statistics.median(checked['ms']):.1f} "
            f"ms a check; both servers hold them at the end | {smi}")

        # Prometheus text, with the fast-lane counter equal to the probes
        ctype, raw = card.get("/metrics", accept="text/plain")
        if not ctype.startswith("text/plain"):
            raise SystemExit(f"cluster: /metrics answered {ctype} to Accept: text/plain")
        samples = parse_prometheus(raw.decode())
        fast = samples.get('foundry_spark_scheduler_tpu_fastpath{lane="fast",path="driver"}')
        if fast != n_probes:
            raise SystemExit(f"cluster: the fast-lane counter reads {fast}, not {n_probes}")
        log(f"phase cluster: /metrics (Accept: text/plain) parses as Prometheus text: {len(samples)} samples, "
            f"lane=fast driver counter {fast:.0f} = {n_probes} probes")

        # /convert round-trips a v1beta1 reservation
        pods = Harness.static_allocation_spark_pods("convert-probe", 2,
                                                    creation_timestamp=base + N_APPS + n_probes)
        card.api.create(pods[0].deepcopy())
        card.sees(pods[0])
        card.settle()
        _, status, body = card.post(pods[0], names)
        if status != 200 or not json.loads(body)["NodeNames"]:
            raise SystemExit(f"cluster: the convert probe was not granted: {status} {body[:300]!r}")
        card.settle()
        v2 = serde.rr_to_dict_v1beta2(card.backend.get("ResourceReservation", "default", "convert-probe"))
        review = {"apiVersion": "apiextensions.k8s.io/v1", "kind": "ConversionReview",
                  "request": {"uid": "c1", "desiredAPIVersion": "sparkscheduler.palantir.com/v1beta1",
                              "objects": [v2]}}
        v1 = card.post_json("/convert", review)["response"]["convertedObjects"][0]
        review["request"].update(uid="c2", desiredAPIVersion="sparkscheduler.palantir.com/v1beta2", objects=[v1])
        back = card.post_json("/convert", review)["response"]["convertedObjects"][0]
        if not v1["apiVersion"].endswith("v1beta1") or back["spec"] != v2["spec"]:
            raise SystemExit("cluster: /convert did not round-trip a v1beta1 reservation")
        card.retire(pods[:1])
        log(f"phase cluster: /convert round-trips reservation convert-probe v1beta2 -> v1beta1 -> v1beta2 "
            f"({len(v2['spec']['reservations'])} reservations)")

        # one scan of the unschedulable marker over the 1,000-driver backlog
        verdicts, scan_ms = {}, {}
        for device, server in servers.items():
            server.settle()
            t = time.perf_counter()
            server.scheduler.unschedulable_marker.scan_for_unschedulable_pods()
            scan_ms[device] = (time.perf_counter() - t) * 1e3
            conds = {}
            for pod in server.api.list("Pod"):
                cond = pod.conditions.get(POD_EXCEEDS_CLUSTER_CAPACITY)
                if pod.name.startswith("queue-"):
                    conds[pod.name] = None if cond is None else cond.status
            verdicts[device] = conds
        if verdicts["cuda"] != verdicts["cpu"] or None in verdicts["cuda"].values() or len(verdicts["cuda"]) != N_APPS:
            raise SystemExit("cluster: the marker's verdicts differ on cuda and cpu, or a queued driver has none")
        n_exceed = sum(v == "True" for v in verdicts["cuda"].values())
        log(f"phase cluster: unschedulable marker, one scan of {N_APPS} queued drivers: {n_exceed} exceed "
            f"the empty cluster, verdicts equal on cuda and cpu; scan {scan_ms['cuda']:.1f} ms on cuda, "
            f"{scan_ms['cpu']:.1f} ms on cpu (conditions written over REST included) | {smi}")
    finally:
        for server in servers.values():
            server.stop()
        invariants.check = real_check
        logging.disable(logging.NOTSET)


# -- phase 4 snapshot ---------------------------------------------------------


# -- phase 7: resilience and provenance through the server -----------------------

RESILIENCE_POLICY = "tpu-batch"
RESILIENCE_REFUSED, RESILIENCE_OUTAGE, RESILIENCE_BURST = 8, 6, 32
BUNDLE_NODES = 10240  # the flight recorder keeps bundles of the 10,240-node bucket


def resilience_phase(seed: int, smi: str) -> None:
    """Phase 7 (see the module docstring); raises SystemExit on any failure."""
    import logging
    import tempfile
    import threading

    from k8s_spark_scheduler_tpu_torch.config import ProvenanceConfig
    from k8s_spark_scheduler_tpu_torch.kube.errors import APIError
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.provenance.recorder import _replay_solve, replay_bundle
    from k8s_spark_scheduler_tpu_torch.scheduler import invariants
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    def launches() -> dict:
        return {k: v for k, v in {**qk.launch_counts, **mk.launch_counts}.items() if v}

    logging.disable(logging.WARNING)  # the outage logs every failed write
    workdir = tempfile.mkdtemp(prefix="chip-smoke-resilience-")
    servers = {}
    try:
        t0 = time.perf_counter()
        names, nodes, queue, rng, base = server_objects(seed + 7)
        for device in ("cuda", "cpu"):
            servers[device] = PortServer(
                RESILIENCE_POLICY, device, nodes, queue,
                provenance=ProvenanceConfig(max_bundle_nodes=BUNDLE_NODES,
                                            bundle_dir=os.path.join(workdir, device)),
            )
        card, host = servers["cuda"], servers["cpu"]
        kit = card.scheduler.resilience
        prov = card.watch_provenance()
        log(f"phase resilience: cuda and cpu servers ({RESILIENCE_POLICY}, the reference's default "
            f"resilience and provenance, bundles up to {BUNDLE_NODES} nodes) ready in "
            f"{time.perf_counter() - t0:.2f} s")
        # the path is driven with every count at 0 and read after each step
        qk.reset_launch_counts()
        mk.reset_launch_counts()
        stamp = [base + N_APPS]

        def probe_pods(tag: str):
            stamp[0] += 1
            return Harness.static_allocation_spark_pods(
                f"res-{tag}", int(rng.randint(1, 32)), executor_cpu=str(int(rng.randint(1, 8))),
                executor_mem=f"{int(rng.randint(2, 16))}Gi", creation_timestamp=stamp[0])

        def both(pod, expect_granted=None):
            for server in servers.values():
                server.api.create(pod.deepcopy())
            ms, status, body = card.post(pod, names)
            _, c_status, c_body = host.post(pod, names)
            if (status, body) != (c_status, c_body) or status != 200:
                raise SystemExit(f"{pod.name}: cuda {status} {body[:300]!r}, cpu {c_status} {c_body[:300]!r}")
            result = json.loads(body)
            if expect_granted is not None and bool(result.get("NodeNames")) != expect_granted:
                raise SystemExit(f"{pod.name}: want granted={expect_granted}, got {body[:300]!r}")
            return ms, result

        # -- a granted probe: its captured solve sizes the refused gangs
        warm = probe_pods("warmup")
        both(warm[0], expect_granted=True)
        for server in servers.values():
            server.retire(warm[:1])
        sizes, before, after = refused_gang_sizes(prov["art"], RESILIENCE_REFUSED)
        log(f"phase resilience: 8 CPU / 16 Gi executors: room for {before} before the queue, "
            f"{after} behind it; refused gangs of {sizes[0]}-{sizes[-1]}")

        # -- refused probes: the explanation walks all 1,000 earlier apps
        refused_ms, explain_ms, blockers = [], [], []
        prov["explain_ms"].clear()
        for j, k in enumerate(sizes):
            stamp[0] += 1
            pod = refused_driver(f"res-refused-{j}", k, stamp[0])
            ms, result = both(pod, expect_granted=False)
            refused_ms.append(ms)
            message = next(iter(result["FailedNodes"].values()))
            bodies = [decision_fields(s.get(f"/explain/{pod.namespace}/{pod.name}")[1])
                      for s in (card, host)]
            if bodies[0] != bodies[1]:
                raise SystemExit(f"{pod.name}: /explain differs on cuda and cpu:\n{bodies[0]}\n{bodies[1]}")
            record = bodies[0]
            sf = record["shortfall"]
            if record["outcome"] != "failure-fit" or sf is None or record["queueLength"] != N_APPS \
                    or sf["flipPosition"] < 0 or not sf["blockedBy"] or "blocked by" not in message:
                raise SystemExit(f"{pod.name}: not explained behind the queue: {message!r} {record}")
            blockers.append(sf["blockedByCount"])
            for server in servers.values():
                server.api.delete("Pod", pod.namespace, pod.name)
        explain_ms = prov["explain_ms"][-RESILIENCE_REFUSED:]
        log(f"phase resilience: {RESILIENCE_REFUSED} refused probes explained over all {N_APPS} earlier "
            f"apps, messages and /explain bodies (less {', '.join(EXPLAIN_SERVER_FIELDS)}) equal on cuda "
            f"and cpu; blockers {blockers}; launches {launches()}")
        log(f"phase resilience: refused /predicates (explanation not memoised) p50 "
            f"{statistics.median(refused_ms):.3f} ms, p99 {float(np.percentile(refused_ms, 99)):.3f} ms "
            f"(runs {', '.join(f'{x:.1f}' for x in refused_ms)}); the explanation alone p50 "
            f"{statistics.median(explain_ms):.3f} ms, max {max(explain_ms):.3f} ms | {smi}")
        log(f"phase resilience: first refusal's message: {message[:200]!r}")

        # -- write-back outage: the breaker opens, intents are journaled
        def outage(op, kind, ns, name):
            return APIError(f"injected outage ({op} {kind})") if kind == "ResourceReservation" else None

        for server in servers.values():
            server.settle_embedded()
            server.api.set_write_fault(outage)
        held = []
        for j in range(RESILIENCE_OUTAGE):
            pods = probe_pods(f"outage-{j}")
            _, result = both(pods[0])
            if result.get("NodeNames"):
                held.append(pods[0])
        apps = {("default", p.labels["spark-app-id"]) for p in held}
        for device, server in servers.items():
            sk = server.scheduler.resilience
            wait_for(lambda: sk.journal.pending_keys() == apps
                     and not any(server.scheduler.resource_reservation_cache.inflight_queue_lengths()),
                     f"the {device} server to journal the reservations")
            landed = {(rr.namespace, rr.name) for rr in server.api.list("ResourceReservation")}
            if sk.breaker.state != "open" or landed & apps:
                raise SystemExit(f"{device}: breaker {sk.breaker.state}, landed {landed & apps}")
            cached = {(rr.namespace, rr.name) for rr in server.scheduler.resource_reservation_cache.list()}
            if not apps <= cached:
                raise SystemExit(f"{device}: the cache lost admitted reservations {apps - cached}")
        _, ready = card.get("/status/readiness")
        ready = json.loads(ready)
        if ready["state"] != "degraded" or ready["components"]["journalDepth"] != len(apps):
            raise SystemExit(f"readiness during the outage: {ready}")
        tracker = card.scheduler.provenance
        wait_for(lambda: tracker.recorder.persisted_paths, "the breaker-open bundle file")
        bundle_file = tracker.recorder.persisted_paths[0]
        log(f"phase resilience: outage: {len(apps)} admitted gangs' reservations journaled on both "
            f"servers, none landed, none dropped; breaker open; readiness {ready['state']} "
            f"(components {ready['components']}); breaker-open bundle file "
            f"{os.path.getsize(bundle_file)} bytes")

        # -- recovery: the journal replays, nothing lost
        t = time.perf_counter()
        for server in servers.values():
            server.api.set_write_fault(None)
            server.scheduler.resource_reservation_cache.nudge_recovery(force=True)
        for device, server in servers.items():
            sk = server.scheduler.resilience
            wait_for(lambda: sk.journal.depth() == 0 and sk.breaker.state == "closed",
                     f"the {device} server's journal to replay")
            server.settle_embedded()
        recover_ms = (time.perf_counter() - t) * 1e3
        written = [sorted(json.dumps(identity_free(serde_rr(rr)), sort_keys=True)
                          for rr in s.api.list("ResourceReservation")) for s in (card, host)]
        if written[0] != written[1] or not apps <= {(rr.namespace, rr.name)
                                                    for rr in card.api.list("ResourceReservation")}:
            raise SystemExit("after recovery the reservations differ from the cpu server's or are missing")
        _, ready = card.get("/status/readiness")
        if json.loads(ready)["state"] != "ready":
            raise SystemExit(f"readiness after recovery: {ready!r}")
        log(f"phase resilience: recovery: journals replayed in {recover_ms:.1f} ms, breakers closed, "
            f"{len(written[0])} reservations in the API equal on cuda and cpu; readiness ready")
        for server in servers.values():
            server.retire(held)

        # -- the breaker-open bundles replay through the kernel and the plain version
        with open(bundle_file) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        bundles = [b for b in lines if not b.get("header")]
        if lines[0].get("trigger") != "breaker-open" or not bundles:
            raise SystemExit(f"bad bundle file header {lines[0]}")
        replay_ms, card_ms = [], []
        before_counts = launches()
        for bundle in bundles:
            t = time.perf_counter()
            result = replay_bundle(bundle, device="cuda")
            replay_ms.append((time.perf_counter() - t) * 1e3)
            if not result["ok"] or result["lanes"] != {"cuda": "ok", "torch": "ok"}:
                raise SystemExit(f"bundle {bundle['seq']} replay: {result}")
            rows = np.asarray(bundle["apps8"], dtype=np.int32)[: bundle["nEarlier"]]
            t = time.perf_counter()
            _replay_solve(bundle["policyCode"], np.asarray(bundle["basis"], dtype=np.int32),
                          np.asarray(bundle["driverRank"], dtype=np.int32),
                          np.asarray(bundle["execOk"], dtype=bool), rows, torch.device("cuda"))
            card_ms.append((time.perf_counter() - t) * 1e3)
        replayed = {k: launches().get(k, 0) - before_counts.get(k, 0) for k in launches()}
        log(f"phase resilience: {len(bundles)} breaker-open bundles ({bundles[0]['nb']} nodes x "
            f"{bundles[0]['nEarlier']} earlier apps) replayed byte-identical through the cuda kernel and "
            f"the plain version; replay {statistics.median(replay_ms):.1f} ms a bundle with both lanes, "
            f"the card's lane alone {statistics.median(card_ms):.3f} ms (launches {replayed}) | {smi}")

        # -- a burst over the admission gate
        burst = [probe_pods(f"burst-{j}") for j in range(RESILIENCE_BURST)]
        for pods in burst:
            card.api.create(pods[0].deepcopy())
        answers = [None] * RESILIENCE_BURST
        barrier = threading.Barrier(RESILIENCE_BURST)
        bodies = [card.request_body(pods[0], names) for pods in burst]  # serialised before the burst

        def fire(j):
            barrier.wait()
            answers[j] = card.post_body(bodies[j])

        threads = [threading.Thread(target=fire, args=(j,)) for j in range(RESILIENCE_BURST)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        shed_ms, kinds = [], {"granted": 0, "refused": 0, "shed": 0}
        for ms, status, body in answers:
            result = json.loads(body) if status == 200 else {}
            failed = set((result.get("FailedNodes") or {}).values())
            if status == 200 and result.get("NodeNames"):
                kinds["granted"] += 1
            elif failed == {"scheduler overloaded; retry"}:
                kinds["shed"] += 1
                shed_ms.append(ms)
            elif status == 200 and len(failed) == 1:
                kinds["refused"] += 1
            else:
                raise SystemExit(f"burst answer {status} {body[:300]!r}")
        if not kinds["shed"] or kit.gate.shed_total < kinds["shed"]:
            raise SystemExit(f"the burst of {RESILIENCE_BURST} shed nothing: {kinds}")
        card.settle_embedded()
        t = time.perf_counter()
        violations = invariants.check(card.scheduler, raise_on_violation=False)
        check_ms = (time.perf_counter() - t) * 1e3
        if violations:
            raise SystemExit(f"invariants after the burst: {violations}")
        _, ready = card.get("/status/readiness")
        log(f"phase resilience: burst of {RESILIENCE_BURST} concurrent /predicates: {kinds}; a shed "
            f"request waited p50 {statistics.median(shed_ms):.3f} ms, max {max(shed_ms):.3f} ms; I1-I5 hold "
            f"after it ({check_ms:.0f} ms); readiness {json.loads(ready)['state']} | {smi}")
        counts = launches()
        if counts.get("fifo_queue_tightly", 0) < 1:
            raise SystemExit(f"fifo_queue was not launched on the resilience path: {counts}")
        log(f"phase resilience: launches on the path (Filters, explanations, replays) {counts}")
    finally:
        for server in servers.values():
            server.api.set_write_fault(None)
            server.stop()
        logging.disable(logging.NOTSET)


# -- phase delta: the delta-solve engine on against off ---------------------------

# the policies of phase delta and the segments each runs: segment (a)
# under distribute-evenly too, so the engine is held on against off and
# cuda against cpu under every tensor-lane name
DELTA_POLICIES = {"tpu-batch": "abc", "tpu-batch-minimal-fragmentation": "abc", "tpu-batch-distribute-evenly": "a"}
# Filters a segment: 40 (it was 200 before phase ha joined the script,
# 100 before phase concurrent did and 60 before phase mesh did; the script
# must end well inside its 1,200 s limit on a slow host)
DELTA_FILTERS = 40
DELTA_GRANT_EVERY = 10  # segment (c): every 10th Filter is an app that is granted and starts
# the queued drivers' Filters of segments (a) and (b) the cpu server
# answers too: its warm passes are the plain versions' suffixes, seconds a
# Filter on the host under min-frag
DELTA_CPU_EVERY = {"tpu-batch": 20, "tpu-batch-minimal-fragmentation": 40, "tpu-batch-distribute-evenly": 20}
DELTA_CPU_COLD = 2  # segment (c): queued drivers' Filters the cpu server answers, each a cold pass
DELTA_SEGMENTS = {
    "a": "retries of queued drivers in random order, nothing changes between them",
    "b": "the same, an unrelated reservation created and deleted before each",
    "c": "the same, every 10th Filter an app that is granted and starts",
}
DELTA_SPANS = ("predicate", "fast_path.snapshot", "fast_path.earlier_drivers", "deltasolve.lookup",
               "deltasolve.scale", "deltasolve.cold_build", "fast_path.build_tensor", "tensorize.scale",
               "deltasolve.load", "fifo_gate", "kernel:fifo_queue", "kernel:fifo_queue_min_frag", "binpack")
DELTA_STRIDE = 64  # the session's checkpoint stride (ops/deltasolve.py)


def delta_kernels(queue_args, n_valid: int, queue_bytes: int, check, defer, smi: str) -> dict:
    """Phase delta, step 1: the checkpointed launches of fifo_queue
    (tightly, evenly) and fifo_queue_min_frag at the main path's inputs
    (the 10,240 x 1,024 bucket, 1,000 valid apps), stride 64: a whole-queue
    pass and a suffix pass from the checkpoint at position 384 against
    their plain versions (outputs and every checkpoint), and a pass
    resumed from every checkpoint against the whole-queue pass.  Then the
    tightly-pack and min-frag launches at 20,480 nodes (the main path's
    cluster twice over, the same 1,000 apps), whole queue and a 640-app
    suffix, against their plain versions and timed: what a row-level
    launch costs at the reference's 20,000-node class threshold (phase
    classes sets the class kernels beside it).  `defer` holds a launch to
    its plain version in the plain twins (its ms under the kernel's name
    at the main path's inputs).  Returns {kernel name: (ms runs, bytes
    bound ms, operations bound ms)} at the main path's inputs."""
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk

    n_b, a_b = queue_args[0].shape[0], queue_args[3].shape[0]
    k = (a_b - 1) // DELTA_STRIDE
    out = {}

    def plain_later(name, policy, got, args, base, blank, where, key=None):
        kind, fn, flags = (("minfrag_kernel", "solve_queue_min_frag_plain", {}) if policy == 2 else
                           ("queue_kernel", "solve_queue_plain", {"evenly": policy == 1}))
        defer(name, got, kind, fn, args, where, chk=blank, key=key, chk_base=base, chk_stride=DELTA_STRIDE, **flags)

    for kname, policy in (("fifo_queue_tightly", 0), ("fifo_queue_evenly", 1), ("fifo_queue_min_frag", 2)):
        def kernel(args, base, chk):
            if policy == 2:
                return mk.fifo_queue_min_frag(*args, chk_base=base, chk_stride=DELTA_STRIDE, chk_out=chk)
            return qk.fifo_queue(*args, evenly=policy == 1, chk_base=base, chk_stride=DELTA_STRIDE, chk_out=chk)

        name = kname + "_checkpointed"
        blank = torch.full((k, n_b, 3), -7, dtype=torch.int32, device=queue_args[0].device)
        chk = blank.clone()
        got = kernel(queue_args, 0, chk)
        plain_later(name, policy, got + (chk,), queue_args, 0, blank, "the main-path inputs, every checkpoint", name)
        r = 6 * DELTA_STRIDE
        suffix = (chk[5].clone(),) + queue_args[1:3] + tuple(x[r:] for x in queue_args[3:])
        s_chk = blank.clone()
        s_got = kernel(suffix, r, s_chk)
        plain_later(name, policy, s_got + (s_chk,), suffix, r, blank, f"a suffix pass from position {r}")
        for j in range(k):
            r = (j + 1) * DELTA_STRIDE
            resumed = (chk[j].clone(),) + queue_args[1:3] + tuple(x[r:] for x in queue_args[3:])
            r_chk = blank.clone()
            f, d, after = kernel(resumed, r, r_chk)
            check(name, (f, d, after, r_chk[j:]), (got[0][r:], got[1][r:], got[2], chk[j:]),
                  f"resumed from the checkpoint at position {r}")
        n_feasible = int(got[0].sum())
        per_app = MF_OPS_PER_NODE_FEASIBLE_APP if policy == 2 else OPS_PER_NODE_FEASIBLE_APP
        ops = n_b * (n_valid * OPS_PER_NODE_VALID_APP + n_feasible * per_app)
        n_bytes = queue_bytes + k * n_b * 12  # and each checkpoint written once
        ms = [time_cuda(lambda: kernel(queue_args, 0, chk), 5) for _ in range(3)]
        r = 6 * DELTA_STRIDE
        resume_ms = time_cuda(lambda: kernel(suffix, r, s_chk), 5)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        log(f"phase delta: {name} N={n_b} A={a_b} ({n_valid} valid, {k} checkpoints a stride of "
            f"{DELTA_STRIDE}): outputs and every checkpoint held to the plain version, a suffix pass "
            f"from position {r} too, and a pass resumed from each of the {k} checkpoints equal to the "
            f"whole-queue pass; {statistics.median(ms):.3f} ms (runs {', '.join(f'{x:.3f}' for x in ms)}), "
            f"the suffix of {a_b - r} apps {resume_ms:.3f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, operations {t_ops:.4f}) | {smi}")
        out[name] = (ms, t_bytes, t_ops)
    big_args = doubled_cluster(queue_args)
    n_big = big_args[0].shape[0]
    for kname, policy in (("fifo_queue_tightly", 0), ("fifo_queue_min_frag", 2)):
        def kernel(args, base, chk):
            if policy == 2:
                return mk.fifo_queue_min_frag(*args, chk_base=base, chk_stride=DELTA_STRIDE, chk_out=chk)
            return qk.fifo_queue(*args, chk_base=base, chk_stride=DELTA_STRIDE, chk_out=chk)

        name = kname + "_checkpointed"
        blank = torch.full((k, n_big, 3), -7, dtype=torch.int32, device=big_args[0].device)
        chk = blank.clone()
        got = kernel(big_args, 0, chk)
        plain_later(name, policy, got + (chk,), big_args, 0, blank, f"N={n_big}, every checkpoint",
                    f"{name} N={n_big}")
        r = 6 * DELTA_STRIDE
        suffix = (chk[5].clone(),) + big_args[1:3] + tuple(x[r:] for x in big_args[3:])
        s_chk = blank.clone()
        plain_later(name, policy, kernel(suffix, r, s_chk) + (s_chk,), suffix, r, blank,
                    f"N={n_big}, a suffix from {r}", f"{name} N={n_big} suffix")
        ms = [time_cuda(lambda: kernel(big_args, 0, chk), 5) for _ in range(3)]
        suffix_ms = [time_cuda(lambda: kernel(suffix, r, s_chk), 5) for _ in range(3)]
        n_feasible = int(got[0].sum())
        per_app = MF_OPS_PER_NODE_FEASIBLE_APP if policy == 2 else OPS_PER_NODE_FEASIBLE_APP
        ops = n_big * (n_valid * OPS_PER_NODE_VALID_APP + n_feasible * per_app)
        t_ops = ops / INT32_OPS_PER_S * 1e3
        log(f"phase delta: {name} N={n_big} A={a_b} ({n_valid} valid, {n_feasible} feasible, {k} checkpoints): "
            f"outputs and every checkpoint held to the plain version, a suffix of {a_b - r} apps from "
            f"position {r} too; whole queue {statistics.median(ms):.3f} ms (runs "
            f"{', '.join(f'{x:.3f}' for x in ms)}), suffix {statistics.median(suffix_ms):.3f} ms (runs "
            f"{', '.join(f'{x:.3f}' for x in suffix_ms)}), operations bound {t_ops:.4f} ms | {smi}")
    return out


def doubled_cluster(queue_args):
    """The main path's queue with its cluster twice over: every node
    plane repeated, the copies' driver ranks after the originals'."""
    avail, rank, exec_ok = queue_args[:3]
    n = avail.shape[0]
    rank2 = torch.where(rank < BIG, rank + n, rank)
    return (torch.cat([avail, avail]), torch.cat([rank, rank2]), torch.cat([exec_ok, exec_ok])) + tuple(queue_args[3:])


def unrelated_reservation(server, tag: str, created: float, node: str) -> None:
    """A reservation the measured Filters do not ask about: a driver pod
    (younger than every queued one) and its reservation created, seen by
    the mirror, then the pod deleted and the reservation collected."""
    from k8s_spark_scheduler_tpu_torch.scheduler.reservations_manager import new_resource_reservation
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
    from k8s_spark_scheduler_tpu_torch.types.resources import Resources

    pod = Harness.static_allocation_spark_pods(tag, 1, creation_timestamp=created)[0]
    stored = server.api.create(pod.deepcopy())
    server.api.create(new_resource_reservation(node, [node], stored, Resources.of("1", "1Gi"),
                                               Resources.of("1", "1Gi")))
    cache = server.scheduler.resource_reservation_cache
    wait_for(lambda: cache.get(pod.namespace, tag) is not None, "the unrelated reservation to reach the cache")
    server.retire([pod])


def delta_phase(seed: int, smi: str) -> dict:
    """Phase delta, steps 2 and 3 (see the module docstring); returns the
    launches of each kernel variant on the engine-on servers' runs.
    Raises SystemExit on any failure."""
    import logging
    import tempfile

    from k8s_spark_scheduler_tpu_torch.config import ProvenanceConfig
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.provenance.recorder import replay_bundle
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    workdir = tempfile.mkdtemp(prefix="chip-smoke-delta-")
    launches = {}
    try:
        names, nodes, queue, rng, base = server_objects(seed)
        # an enforced driver at the head of the queue that fits nowhere (one
        # 97-CPU executor, above every node's allocatable): every queued
        # driver's Filter is refused behind it, so the retries change nothing
        blocker = Harness.static_allocation_spark_pods(
            "delta-blocker", 1, executor_cpu="97", creation_timestamp=base - 1.0)[0]
        stamp = [base + N_APPS + 100.0]
        for pi, policy in enumerate(DELTA_POLICIES):
            t0 = time.perf_counter()
            servers = {}
            try:
                servers["on"] = PortServer(policy, "cuda", nodes, queue + [blocker], provenance=ProvenanceConfig(
                    max_bundle_nodes=BUNDLE_NODES, bundle_dir=os.path.join(workdir, policy)))
                servers["off"] = PortServer(policy, "cuda", nodes, queue + [blocker], delta_solve=False)
                servers["cpu"] = PortServer(policy, "cpu", nodes, queue + [blocker])
                on, off, cpu = servers["on"], servers["off"], servers["cpu"]
                engine = on.scheduler.extender.delta_engine
                if off.scheduler.extender.delta_engine is not None or engine is None:
                    raise SystemExit("the delta-solve switch did not reach the servers")
                depths = []
                record_warm = engine._record_warm

                def note_depth(resume, record_warm=record_warm):
                    depths.append(int(resume))
                    record_warm(resume)

                engine._record_warm = note_depth
                log(f"phase delta: {policy}: servers with delta-solve on (cuda), off (cuda) and on (cpu) "
                    f"ready in {time.perf_counter() - t0:.2f} s; {N_APPS} queued drivers behind an "
                    f"enforced driver that fits nowhere")
                kname = SERVER_KERNEL[policy]
                qk.reset_launch_counts()
                mk.reset_launch_counts()
                n_compared = n_granted = 0
                for seg, what in DELTA_SEGMENTS.items():
                    if seg not in DELTA_POLICIES[policy]:
                        continue
                    lat = {"on": [], "off": []}
                    traces = []
                    stats0, depth0 = engine.stats(), len(depths)
                    cold_compares = 0
                    for f in range(DELTA_FILTERS):
                        grant = seg == "c" and f % DELTA_GRANT_EVERY == DELTA_GRANT_EVERY - 1
                        if grant:
                            # older than the blocker: no earlier drivers, granted
                            pod = Harness.static_allocation_spark_pods(
                                f"delta-{pi}-grant-{f}", int(rng.randint(1, 8)),
                                executor_cpu=str(int(rng.randint(1, 4))), creation_timestamp=base - 10.0 - f)[0]
                            for server in servers.values():
                                server.api.create(pod.deepcopy())
                        else:
                            pod = queue[int(rng.randint(0, N_APPS))]
                            if seg == "b":
                                stamp[0] += 1
                                for side in ("on", "off"):
                                    unrelated_reservation(servers[side], f"delta-{pi}-unrelated-{f}", stamp[0],
                                                          names[int(rng.randint(0, len(names)))])
                        order = ("on", "off") if f % 2 else ("off", "on")
                        answers = {}
                        for side in order:
                            ms, status, body = servers[side].post(pod, names)
                            answers[side] = (status, body)
                            lat[side].append(ms)
                            if side == "on":
                                traces.append(on.scheduler.tracer.traces(limit=1)[0])
                        if answers["on"] != answers["off"] or answers["on"][0] != 200:
                            raise SystemExit(f"{policy} segment {seg} Filter {f}: on {answers['on'][1][:300]!r}, "
                                             f"off {answers['off'][1][:300]!r}")
                        ask_cpu = grant or (seg != "c" and f % DELTA_CPU_EVERY[policy] == 0) or (
                            seg == "c" and not grant and f > DELTA_GRANT_EVERY and cold_compares < DELTA_CPU_COLD)
                        if ask_cpu:
                            cold_compares += seg == "c" and not grant
                            n_compared += 1
                            if cpu.post(pod, names)[1:] != answers["on"]:
                                raise SystemExit(f"{policy} segment {seg} Filter {f}: cuda and cpu differ")
                        granted = bool(json.loads(answers["on"][1]).get("NodeNames"))
                        if granted != grant:
                            raise SystemExit(f"{policy} segment {seg} Filter {f}: granted={granted}, want {grant}: "
                                             f"{answers['on'][1][:300]!r}")
                        if grant:
                            n_granted += 1
                            for server in servers.values():
                                server.bind(pod, json.loads(answers["on"][1])["NodeNames"][0])
                    stats1 = engine.stats()
                    n = DELTA_FILTERS
                    warm = stats1["warm_hits"] - stats0["warm_hits"]
                    digest = stats1["digest_hits"] - stats0["digest_hits"]
                    cold = stats1["cold_solves"] - stats0["cold_solves"]
                    misses = {r: c - stats0["misses"].get(r, 0) for r, c in stats1["misses"].items()
                              if c - stats0["misses"].get(r, 0)}
                    seg_depths = depths[depth0:]
                    spans = {}
                    for trace in traces:
                        span_durations(trace["root"], spans)
                    for side in ("on", "off"):
                        log(f"phase delta: {policy} segment {seg} ({what}): delta-solve {side}: /predicates "
                            f"p50 {statistics.median(lat[side]):.3f} ms, p99 "
                            f"{float(np.percentile(lat[side], 99)):.3f} ms over {n} Filters (the 3 slowest "
                            f"{', '.join(f'{x:.1f}' for x in sorted(lat[side])[-3:])}) | {smi}")
                    log(f"phase delta: {policy} segment {seg}: bodies equal on and off; warm hits {warm} of {n} "
                        f"({100.0 * warm / n:.1f} %; class-digest tier {digest}), cold builds {cold}, misses "
                        f"{misses or 'none'}; resume depth p50 "
                        f"{statistics.median(seg_depths) if seg_depths else 'none'}, min "
                        f"{min(seg_depths) if seg_depths else 'none'}, max {max(seg_depths) if seg_depths else 'none'}"
                        f" of up to {N_APPS + 1} earlier apps")
                    log(f"phase delta: {policy} segment {seg}: span medians on (ms, spans seen / Filters) "
                        + ", ".join(f"{name} {statistics.median(spans[name]):.3f} ({len(spans[name])})"
                                    for name in DELTA_SPANS if name in spans) + f" | {smi}")
                    if seg == "a":
                        if warm < n - 1:
                            raise SystemExit(f"{policy} segment a: only {warm} of {n} Filters served warm")
                        pod = queue[int(rng.randint(0, N_APPS))]
                        log(f"phase delta: {policy}: profiler trace of one warm request (delta-solve on): "
                            f"{busy_share(lambda: on.post(pod, names))} | {smi}")
                        log(f"phase delta: {policy}: profiler trace of one cold request (delta-solve off): "
                            f"{busy_share(lambda: off.post(pod, names))} | {smi}")
                    if seg == "b" and digest < n - 1:
                        raise SystemExit(f"{policy} segment b: only {digest} of {n} Filters warmed by the digest")
                counts = {**qk.launch_counts, **mk.launch_counts}
                launches[kname + "_checkpointed"] = counts[kname + "_checkpointed"]
                log(f"phase delta: {policy}: {len(DELTA_POLICIES[policy]) * DELTA_FILTERS} Filters on each cuda "
                    f"server ({n_granted} "
                    f"granted), {n_compared} of them equal on a cpu server too; launches {counts} (the "
                    f"engine-off server's whole-queue passes count under {kname}, the session's under "
                    f"{kname}_checkpointed; the refusals' explanations under {kname})")
                if counts[kname + "_checkpointed"] < 1 or counts[kname] < 1:
                    raise SystemExit(f"{policy}: a kernel of the path was not launched: {counts}")
                if pi == 0:
                    # step 3: the session's warm-captured decisions, persisted
                    # and replayed through the kernel and the plain version
                    path = on.scheduler.provenance.recorder.persist("delta-phase", "warm captures")
                    with open(path) as fh:
                        bundles = [b for b in (json.loads(line) for line in fh if line.strip())
                                   if not b.get("header")]
                    replay_ms, resumes = [], []
                    for bundle in bundles:
                        if bundle["lane"] != SESSION_LANE:
                            raise SystemExit(f"bundle {bundle['seq']} captured on lane {bundle['lane']!r}")
                        t = time.perf_counter()
                        result = replay_bundle(bundle, device="cuda")
                        replay_ms.append((time.perf_counter() - t) * 1e3)
                        resumes.append(bundle["verdicts"]["resume"])
                        if not result["ok"] or result["lanes"] != {"cuda": "ok", "torch": "ok"}:
                            raise SystemExit(f"warm-captured bundle {bundle['seq']} replay: {result}")
                    if not any(resumes):
                        raise SystemExit(f"no replayed bundle was captured warm: resumes {resumes}")
                    log(f"phase delta: {len(bundles)} decisions captured on lane {SESSION_LANE} (resumed at "
                        f"{resumes}) persisted and replayed cold through the cuda kernel and the plain version, "
                        f"equal to their recorded verdicts; {statistics.median(replay_ms):.1f} ms a bundle with "
                        f"both lanes | {smi}")
            finally:
                for server in servers.values():
                    server.stop()
    finally:
        logging.disable(logging.NOTSET)
    return launches


# -- phase observatory: the capacity observatory and the lifecycle ledger ------

OBSERVATORY_POLICY = "tpu-batch"
OBSERVATORY_WARM = 4  # probes on all three servers before the cuda and cpu samples
OBSERVATORY_PROBES = 100  # granted probes, each retired, on each of the on and off servers
# the probes go in blocks of this many, on and off in turns (on, off, off,
# on, ...), each block's probes posted to its own server alone: all
# servers share one process, so a probe of the off server taken while the
# on server samples would pay the on server's cost, and a probe of the off
# server between two on probes would give the on server's threads time
# outside the timed windows; each block starts once the on server's
# background work has stopped
OBSERVATORY_BLOCK = 25
OBSERVATORY_REPS = 5  # CUDA-event timings of each probe program, and samples timed
# the fields of a capacity sample that name the serving process or the
# host's clock rather than the cluster: the sample's time source read, its
# cost, where the probes ran, the mirror's process-local instance number,
# and the queue entries' ages and forecasts (the host clock's now)
SAMPLE_HOST_FIELDS = ("t", "sampleMs", "probeLane")
QUEUE_HOST_FIELDS = ("ageSeconds", "forecastSeconds")


def sample_fields(sample: dict) -> dict:
    out = {k: v for k, v in sample.items() if k not in SAMPLE_HOST_FIELDS}
    out["contentKey"], out["structureKey"] = sample["contentKey"][1:], sample["structureKey"][1:]
    out["classes"] = {k: v for k, v in sample["classes"].items() if k != "expandMs"}
    out["queue"] = [{k: v for k, v in e.items() if k not in QUEUE_HOST_FIELDS} for e in sample["queue"]]
    return out


def probe_programs_ms(server, sample: dict):
    """The sampler's two device programs as it runs them, on the server's
    current snapshot and the sample's shapes, each timed by CUDA events
    (median of OBSERVATORY_REPS after one warmup) and its headroom held
    to the sample's: the row-level frag report and headroom search over
    the cluster and its (instance-group, zone) combos, and the class lane
    (grouping, weighted frag report and search).  Returns (row ms, class
    ms, segments)."""
    from k8s_spark_scheduler_tpu_torch.capacity.observatory import CapacitySample

    sampler = server.scheduler.capacity
    snap = server.scheduler.tensor_snapshot.snapshot()
    avail, elig = snap.avail, snap.ready & ~snap.unschedulable
    layout = sampler._layout(snap)
    shape_list = []
    for key in sorted(sample["headroom"]):  # d<cpu>.<mem>.<gpu>-e<cpu>.<mem>.<gpu>
        d, e = key[1:].split("-e")
        shape_list.append((key, (tuple(int(x) for x in d.split(".")), tuple(int(x) for x in e.split(".")))))
    shape_rows = np.array([list(d) + list(e) for _, (d, e) in shape_list], dtype=np.int64)

    def row_level():
        out = CapacitySample(seq=0, content_key=(), structure_key=(), t=0.0, trigger="timed")
        sampler._row_level(avail, elig, shape_list, shape_rows, layout, True, out)
        return {key: entry["headroom"] for key, entry in out.headroom.items()}

    def class_lane():
        out = CapacitySample(seq=0, content_key=(), structure_key=(), t=0.0, trigger="timed")
        sampler._class_lane(snap, avail, elig, shape_list, shape_rows, out)
        return out.classes["headroom"]

    out = []
    for fn, want in ((row_level, {k: v["headroom"] for k, v in sample["headroom"].items()}),
                     (class_lane, sample["classes"]["headroom"])):
        if fn() != want:
            raise SystemExit(f"the timed {fn.__name__} program's headroom differs from the sample's")
        out.append(statistics.median(time_cuda(fn, 1) for _ in range(OBSERVATORY_REPS)))
    return out[0], out[1], len(layout.combos) + 1


# the parts of one sample, in the order the sampler runs them: the
# snapshot copy, the pending-driver listing and sort, the gangs' demand
# parse, the (group, zone) layout (cached per structure), the row-level
# programs, the class lane, the tenant sums, the forecast; and the gauges,
# published after sampleMs is taken
SAMPLE_PARTS = ("_pending_drivers", "_gang_rows", "_layout", "_row_level", "_class_lane", "_tenants",
                "_forecast", "_publish")


def sample_split(sampler, reps: int) -> tuple:
    """``reps`` whole samples, each part timed by the host clock around
    the sampler's own method: (sampleMs of each, {part: median ms})."""
    spent = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t) * 1000.0
        return wrapper

    class Cache:
        def __init__(self, cache):
            self._cache = cache
            self.snapshot = timed("snapshot", cache.snapshot)

        def __getattr__(self, name):
            return getattr(self._cache, name)

    cache = sampler._cache
    sampler._cache = Cache(cache)
    for name in SAMPLE_PARTS:
        setattr(sampler, name, timed(name, getattr(sampler, name)))
    runs, parts = [], {}
    try:
        for _ in range(reps):
            spent.clear()
            t = time.perf_counter()
            sample = sampler.sample_now()
            spent["whole call"] = (time.perf_counter() - t) * 1000.0
            runs.append(sample.sample_ms)
            for name, ms in spent.items():
                parts.setdefault(name, []).append(ms)
    finally:
        sampler._cache = cache
        for name in SAMPLE_PARTS:
            delattr(sampler, name)
    return runs, {name: statistics.median(ms) for name, ms in parts.items()}


def quiet(server, phase: str) -> None:
    """Until the server's sampler and ledger stop counting."""
    last, deadline = None, time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        now = (server.scheduler.capacity.stats()["samples"], server.scheduler.lifecycle.stats()["drains"])
        if now == last:
            return
        last = now
        time.sleep(0.6)
    raise SystemExit(f"phase {phase}: the on server's background work did not stop")


def observatory_phase(seed: int, smi: str) -> None:
    """Phase observatory (see the module docstring).  Raises SystemExit on
    any failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    try:
        t0 = time.perf_counter()
        names, nodes, queue, rng, base = server_objects(seed)
        servers = {}
        try:
            servers["on"] = PortServer(OBSERVATORY_POLICY, "cuda", nodes, queue)
            servers["off"] = PortServer(OBSERVATORY_POLICY, "cuda", nodes, queue, observatories=False)
            servers["cpu"] = PortServer(OBSERVATORY_POLICY, "cpu", nodes, queue)
            on, off, cpu = servers["on"], servers["off"], servers["cpu"]
            if off.scheduler.capacity is not None or on.scheduler.capacity is None:
                raise SystemExit("the observatories' switch did not reach the servers")
            log(f"phase observatory: {OBSERVATORY_POLICY}: servers with the observatories on (cuda), off (cuda) "
                f"and on (cpu) ready in {time.perf_counter() - t0:.2f} s")
            served = {side: 0 for side in servers}

            def probe(tag: str, sides) -> tuple:
                """A small gang that fits: its Filter on each side in order,
                bodies equal, then retired everywhere."""
                pods = Harness.static_allocation_spark_pods(
                    tag, int(rng.randint(1, 5)), executor_cpu=str(int(rng.randint(1, 5))),
                    executor_mem=f"{int(rng.randint(2, 9))}Gi", creation_timestamp=base + N_APPS + sum(served.values()))
                for side in sides:
                    servers[side].api.create(pods[0].deepcopy())
                answers, ms = {}, {}
                for side in sides:
                    ms[side], status, body = servers[side].post(pods[0], names)
                    answers[side] = (status, body)
                    served[side] += 1
                first = answers[sides[0]]
                if any(a != first for a in answers.values()) or first[0] != 200:
                    raise SystemExit(f"observatory probe {tag}: " + ", ".join(
                        f"{side} {a[0]} {a[1][:200]!r}" for side, a in answers.items()))
                if not json.loads(first[1]).get("NodeNames"):
                    raise SystemExit(f"observatory probe {tag} was not granted: {first[1][:300]!r}")
                for side in sides:
                    servers[side].retire(pods[:1])
                return ms

            # 1. the same Filters on all three, then a sample on cuda and cpu
            for i in range(OBSERVATORY_WARM):
                probe(f"obs-warm-{i}", ("on", "off", "cpu"))
            for side in ("on", "cpu"):
                servers[side].settle_embedded()
            samples = {side: servers[side].scheduler.capacity.sample_now().to_dict() for side in ("on", "cpu")}
            if sample_fields(samples["on"]) != sample_fields(samples["cpu"]):
                diff = [k for k in samples["on"] if sample_fields(samples["on"]).get(k)
                        != sample_fields(samples["cpu"]).get(k)]
                raise SystemExit(f"phase observatory: the cuda and cpu samples differ in {diff}")
            s = samples["on"]
            if s["probeLane"] != "cuda" or samples["cpu"]["probeLane"] != "torch" or s["nodes"] != N_NODES:
                raise SystemExit(f"phase observatory: lanes {s['probeLane']} / {samples['cpu']['probeLane']}, "
                                 f"{s['nodes']} nodes")
            log(f"phase observatory: after {OBSERVATORY_WARM} Filters on each server, the cuda and cpu samples "
                f"are equal (less {', '.join(SAMPLE_HOST_FIELDS)}, classes.expandMs, the mirror's instance "
                f"number and the queue's {', '.join(QUEUE_HOST_FIELDS)}): seq {s['seq']}, {s['nodes']} nodes, "
                f"{len(s['headroom'])} shapes ({s['shapesDropped']} dropped), {len(s['groups'])} groups, "
                f"{s['classes']['count']} classes, {s['queuedGangs']} queued gangs, pressure {s['pressure']}, "
                f"{s['probeSolves']} probe solves; sampleMs cuda {s['sampleMs']}, cpu "
                f"{samples['cpu']['sampleMs']} (expandMs {s['classes']['expandMs']} / "
                f"{samples['cpu']['classes']['expandMs']})")

            # 2. the probe programs by CUDA events, and whole samples
            row_ms, class_ms, n_segments = probe_programs_ms(on, s)
            sample_ms, parts = sample_split(on.scheduler.capacity, OBSERVATORY_REPS)
            log(f"phase observatory: the sampler's programs at {N_NODES} nodes x {len(s['headroom'])} shapes "
                f"(upload, program, one copy out), CUDA events, median of {OBSERVATORY_REPS}: row-level (frag "
                f"report and headroom search over {n_segments} segments: the cluster and its (group, zone) "
                f"combos) {row_ms:.3f} ms, class lane ({s['classes']['count']} classes: grouping, frag report "
                f"and search) {class_ms:.3f} ms; a whole sample (host clock) median "
                f"{statistics.median(sample_ms):.3f} ms (runs {', '.join(f'{x:.1f}' for x in sample_ms)}) | {smi}")
            inside = sum(parts.get(name, 0.0) for name in ("snapshot",) + SAMPLE_PARTS[:-1])
            log(f"phase observatory: one sample's parts, host clock, median of {OBSERVATORY_REPS} ms: "
                + ", ".join(f"{name.strip('_')} {parts.get(name, 0.0):.3f}" for name in ("snapshot",) + SAMPLE_PARTS)
                + f"; the rest of sampleMs {statistics.median(sample_ms) - inside:.3f}, the whole call "
                f"{parts['whole call']:.3f} | {smi}")

            # 3. granted probes on the on and off cuda servers, in blocks in turns
            cap0, led0 = on.scheduler.capacity.stats(), on.scheduler.lifecycle.stats()
            lat = {"on": [], "off": []}
            blocks = ["on", "off", "off", "on"] * (OBSERVATORY_PROBES // (2 * OBSERVATORY_BLOCK))
            for b, side in enumerate(blocks):
                quiet(on, "observatory")
                for j in range(OBSERVATORY_BLOCK):
                    lat[side].append(probe(f"obs-probe-{b}-{j:02d}", (side,))[side])
            cap1, led1 = on.scheduler.capacity.stats(), on.scheduler.lifecycle.stats()
            quiet(on, "observatory")
            ledger = on.scheduler.lifecycle
            drain_ms = []
            for _ in range(OBSERVATORY_REPS):
                t = time.perf_counter()
                ledger.drain(trigger="timed")
                drain_ms.append((time.perf_counter() - t) * 1000.0)
            for side in ("on", "off"):
                log(f"phase observatory: {OBSERVATORY_POLICY} observatories {side}: /predicates p50 "
                    f"{statistics.median(lat[side]):.3f} ms, p99 {float(np.percentile(lat[side], 99)):.3f} ms over "
                    f"{len(lat[side])} granted probes, each retired, in blocks of {OBSERVATORY_BLOCK} in turns "
                    f"({', '.join(blocks)}; the 3 slowest "
                    f"{', '.join(f'{x:.1f}' for x in sorted(lat[side])[-3:])}) | {smi}")
            log(f"phase observatory: over those probes the on server took {cap1['samples'] - cap0['samples']} "
                f"samples ({cap1['skipped_unchanged'] - cap0['skipped_unchanged']} skipped unchanged, "
                f"{cap1['probe_solves'] - cap0['probe_solves']} probe solves) and {led1['drains'] - led0['drains']} "
                f"ledger drains ({led1['skipped_unchanged'] - led0['skipped_unchanged']} skipped); a ledger drain "
                f"with nothing new (host clock, median of {OBSERVATORY_REPS}) "
                f"{statistics.median(drain_ms):.3f} ms | {smi}")

            # 4. no probe or drain under the predicate lock, no class-lane failure
            for side in ("on", "cpu"):
                sched = servers[side].scheduler
                bad = (sched.capacity.lock_violations, sched.lifecycle.lock_violations,
                       sched.capacity.stats()["class_lane_failures"])
                if any(bad):
                    raise SystemExit(f"phase observatory: {side} server lock violations (sampler, ledger) and "
                                     f"class-lane failures {bad}")

            # 5. what an operator reads
            _, body = on.get("/slo")
            card = json.loads(body)
            counted = card["objectives"]["filter_latency"]["total"]
            if counted < served["on"]:
                raise SystemExit(f"/slo counted {counted} Filters, the server served {served['on']}")
            _, body = on.get("/lifecycle")
            listed = {g["app"] for g in json.loads(body)["gangs"]}
            apps = {f"obs-warm-{i}" for i in range(OBSERVATORY_WARM)} | {
                f"obs-probe-{b}-{j:02d}" for b, side in enumerate(blocks) if side == "on"
                for j in range(OBSERVATORY_BLOCK)}
            if apps - listed:
                raise SystemExit(f"/lifecycle lacks {sorted(apps - listed)[:5]}")
            _, body = on.get("/state/capacity")
            latest = json.loads(body)
            if latest["nodes"] != N_NODES or latest["probeLane"] != "cuda":
                raise SystemExit(f"/state/capacity: {body[:300]!r}")
            log(f"phase observatory: /slo filter_latency counted {counted} of the {served['on']} Filters served "
                f"(state {card['objectives']['filter_latency']['state']}), /lifecycle lists all "
                f"{len(apps)} probe apps among {len(listed)} gangs, /state/capacity seq {latest['seq']}; lock "
                f"violations 0 and class-lane failures 0 on the cuda and cpu servers")
        finally:
            for server in servers.values():
                server.stop()
    finally:
        logging.disable(logging.NOTSET)


# -- phase contention: lock telemetry, the critical path, the race detector ---

CONTENTION_POLICY = "tpu-batch"
CONTENTION_WARM = 4  # probes on the on, off and cpu servers, bodies equal
CONTENTION_PROBES = 100  # granted probes, each retired, on each of the on and off servers
CONTENTION_BLOCK = 25  # in blocks in turns, each block to its own server alone (as phase observatory)
RACE_PROBES = 40  # granted probes through the server built under the race detector
TOP_LOCKS = 5
DISABLED_PATH_REPS = 200_000
# what the script labels the on server's background work with, so that a
# Filter's wait on a lock the sampler or the ledger holds is charged to
# them (their threads run outside any request span)
BACKGROUND_PHASES = {"capacity": ("sample_now", "capacity.sample"), "lifecycle": ("drain", "lifecycle.drain")}


def label_background(scheduler) -> None:
    """Run the sampler's samples and the ledger's drains under a span of
    their own name (a span of no tracer: the locks' holder attribution
    reads it, no trace records it)."""
    from k8s_spark_scheduler_tpu_torch.tracing.spans import _CURRENT, Span

    for attr, (method, phase) in BACKGROUND_PHASES.items():
        owner = getattr(scheduler, attr)
        fn = getattr(owner, method)

        def labelled(*a, fn=fn, phase=phase, **kw):
            token = _CURRENT.set(Span(phase, "background", None))
            try:
                return fn(*a, **kw)
            finally:
                _CURRENT.reset(token)

        setattr(owner, method, labelled)


def self_times(span: dict, out: dict) -> dict:
    """Each span name's exclusive time (its duration less its
    children's) in a trace's span tree, summed into ``out``."""
    children = span.get("children", ())
    own = span["durationMs"] - sum(c["durationMs"] for c in children)
    out[span["name"]] = out.get(span["name"], 0.0) + own
    for child in children:
        self_times(child, out)
    return out


def total_wait_ms(lock: dict) -> float:
    return sum(b["totalWaitMs"] for b in lock["topBlockers"])


def disabled_path_ns() -> dict:
    """ns per uncontended acquire + release of a raw lock and of a
    TimedLock with the keeper off and on (the stride of @guarded_by
    locks), and per note_access with the race detector off, each the
    median of 3 loops of DISABLED_PATH_REPS (host clock, loop included)."""
    import threading

    from k8s_spark_scheduler_tpu_torch.analysis import racecheck
    from k8s_spark_scheduler_tpu_torch.contention import locktime

    def per_op(body) -> float:
        runs = []
        for _ in range(3):
            t = time.perf_counter_ns()
            body()
            runs.append((time.perf_counter_ns() - t) / DISABLED_PATH_REPS)
        return statistics.median(runs)

    def lock_loop(lock):
        def body():
            for _ in range(DISABLED_PATH_REPS):
                lock.acquire()
                lock.release()
        return body

    owner = object()

    def note_loop():
        for _ in range(DISABLED_PATH_REPS):
            racecheck.note_access(owner, "f")

    if racecheck.active():
        raise SystemExit("phase contention: the race detector is still on")
    keeper = locktime.get()
    timed = locktime.TimedLock(threading.Lock(), "contention.disabled-path",
                               sample_every=locktime.DEFAULT_SAMPLE_EVERY)
    out = {"raw lock": per_op(lock_loop(threading.Lock()))}
    locktime.disable()
    try:
        out["TimedLock, keeper off"] = per_op(lock_loop(timed))
    finally:
        locktime.enable(keeper)
    out["TimedLock, keeper on"] = per_op(lock_loop(timed))
    out["note_access, detector off"] = per_op(note_loop)
    return out


def contention_phase(seed: int, smi: str) -> dict:
    """Phase contention (see the module docstring).  Returns the queue
    kernels' launches on the phase's path; raises SystemExit on any
    failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.analysis import racecheck
    from k8s_spark_scheduler_tpu_torch.contention import locktime
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    keeper = locktime.enable()  # on since phase 5's first server: every server here records by default
    try:
        t0 = time.perf_counter()
        names, nodes, queue, rng, base = server_objects(seed)
        servers = {}
        served = {}

        def probe(tag: str, sides) -> dict:
            """A small gang that fits: its Filter on each side in order,
            bodies equal, then retired everywhere."""
            pods = Harness.static_allocation_spark_pods(
                tag, int(rng.randint(1, 5)), executor_cpu=str(int(rng.randint(1, 5))),
                executor_mem=f"{int(rng.randint(2, 9))}Gi", creation_timestamp=base + N_APPS + sum(served.values()))
            for side in sides:
                servers[side].api.create(pods[0].deepcopy())
            answers, ms = {}, {}
            for side in sides:
                ms[side], status, body = servers[side].post(pods[0], names)
                answers[side] = (status, body)
                served[side] = served.get(side, 0) + 1
            first = answers[sides[0]]
            if any(a != first for a in answers.values()) or first[0] != 200:
                raise SystemExit(f"contention probe {tag}: " + ", ".join(
                    f"{side} {a[0]} {a[1][:200]!r}" for side, a in answers.items()))
            if not json.loads(first[1]).get("NodeNames"):
                raise SystemExit(f"contention probe {tag} was not granted: {first[1][:300]!r}")
            for side in sides:
                servers[side].retire(pods[:1])
            return ms

        try:
            servers["on"] = PortServer(CONTENTION_POLICY, "cuda", nodes, queue)
            servers["off"] = PortServer(CONTENTION_POLICY, "cuda", nodes, queue, contention=False)
            servers["cpu"] = PortServer(CONTENTION_POLICY, "cpu", nodes, queue)
            on, off = servers["on"], servers["off"]
            if off.scheduler.criticalpath is not None or on.scheduler.criticalpath is None:
                raise SystemExit("the contention switch did not reach the servers")
            label_background(on.scheduler)
            log(f"phase contention: {CONTENTION_POLICY}: servers with contention on (cuda), off (cuda) and on "
                f"(cpu) ready in {time.perf_counter() - t0:.2f} s")

            # 1. the same Filters on all three, then on against off in blocks
            qk.reset_launch_counts()  # the path's run starts here
            for i in range(CONTENTION_WARM):
                probe(f"cont-warm-{i}", ("on", "off", "cpu"))
            lat = {"on": [], "off": []}
            blocks = ["on", "off", "off", "on"] * (CONTENTION_PROBES // (2 * CONTENTION_BLOCK))
            for b, side in enumerate(blocks):
                quiet(on, "contention")
                if side == "on":
                    locktime.enable(keeper)
                else:
                    locktime.disable()
                for j in range(CONTENTION_BLOCK):
                    lat[side].append(probe(f"cont-probe-{b}-{j:02d}", (side,))[side])
            locktime.enable(keeper)
            for side in ("on", "off"):
                log(f"phase contention: {CONTENTION_POLICY} contention {side}: /predicates p50 "
                    f"{statistics.median(lat[side]):.3f} ms, p99 {float(np.percentile(lat[side], 99)):.3f} ms over "
                    f"{len(lat[side])} granted probes, each retired, in blocks of {CONTENTION_BLOCK} in turns "
                    f"({', '.join(blocks)}; the 3 slowest {', '.join(f'{x:.1f}' for x in sorted(lat[side])[-3:])}); "
                    f"bodies of the {CONTENTION_WARM} probes sent to all three servers equal on, off and cpu | {smi}")

            # 2. the decomposition of the on server's Filters
            limit = min(100, served["on"])
            _, body = on.get(f"/debug/criticalpath?limit={limit}")
            cp = json.loads(body)
            if not cp["enabled"] or cp["requests"] != served["on"] or len(cp["recent"]) != limit:
                raise SystemExit(f"/debug/criticalpath: requests {cp.get('requests')} of {served['on']} Filters, "
                                 f"{len(cp.get('recent', []))} records")
            _, body = on.get(f"/debug/criticalpath?limit={served['on']}")
            records = json.loads(body)["recent"]
            for record in records:
                total = record["totalMs"]
                if total <= 0 or abs(sum(record["segments"].values()) - total) / total >= 0.10:
                    raise SystemExit(f"a critical-path record does not sum to its request: {record}")
            all_ms = sum(r["totalMs"] for r in records)
            share = {seg: sum(r["segments"][seg] for r in records) / all_ms for seg in cp["segments"]}
            log(f"phase contention: /debug/criticalpath over the on server's {cp['requests']} Filters (every "
                f"record's segments within 10 % of its totalMs): totalMs p50 {cp['totalMs']['p50']} p99 "
                f"{cp['totalMs']['p99']}, coverage p50 {cp['coverage']['p50']} min {cp['coverage']['min']}; "
                + "; ".join(f"{seg} p50 {v['p50Ms']} p99 {v['p99Ms']} ({100 * share[seg]:.1f} %)"
                            for seg, v in cp["segments"].items())
                + f"; dominant {cp['dominant']} | {smi}")
            # under the solve segment: each span's exclusive time in the
            # on server's traces of its timed Filters (0 where a trace
            # lacks the span); records are newest first, the warm probes
            # the oldest
            timed = records[:-CONTENTION_WARM]
            wanted = {r["traceId"] for r in timed}
            traces = [t for t in on.scheduler.tracer.traces() if t["traceId"] in wanted]
            per_span = {}
            for trace in traces:
                for name, ms in self_times(trace["root"], {}).items():
                    per_span.setdefault(name, []).append(ms)
            per_span = {name: ms + [0.0] * (len(traces) - len(ms)) for name, ms in per_span.items()}
            top = sorted(per_span.items(), key=lambda kv: -statistics.median(kv[1]))[:10]
            log(f"phase contention: exclusive time by span over the on server's {len(traces)} timed Filters' "
                f"traces, median (p99) ms: " + ", ".join(
                    f"{name} {statistics.median(ms):.3f} ({float(np.percentile(ms, 99)):.3f})" for name, ms in top)
                + f" | {smi}")
            for what, record in (("the slowest timed Filter", max(timed, key=lambda r: r["totalMs"])),
                                 ("the on server's first (cold) Filter", records[-1])):
                trace = on.scheduler.tracer.find_by_trace_id(record["traceId"])
                spans = sorted(self_times(trace["root"], {}).items(), key=lambda kv: -kv[1])[:6]
                log(f"phase contention: {what} (trace {record['traceId']}): {record['totalMs']} ms = "
                    + ", ".join(f"{seg} {ms}" for seg, ms in record["segments"].items() if ms)
                    + f" (coverage {record['coverage']}); its spans by exclusive time: "
                    + ", ".join(f"{name} {ms:.3f}" for name, ms in spans) + f" | {smi}")

            # 3. the locks
            _, body = on.get("/debug/contention?lock=extender.predicate")
            (merged,) = json.loads(body)["locks"]
            # the on server's own predicate lock (the body merges every
            # server's of the process, keeping the worst percentiles)
            plock = on.scheduler.extender._predicate_lock.snapshot()
            if merged["acquisitions"] < plock["acquisitions"] or plock["acquisitions"] != served["on"]:
                raise SystemExit(f"extender.predicate: {plock['acquisitions']} acquires on the on server "
                                 f"({merged['acquisitions']} in the process), {served['on']} Filters")
            log(f"phase contention: the on server's extender.predicate (/debug/contention?lock= merges "
                f"{merged['instances']} instances, {merged['acquisitions']} acquires): "
                f"{plock['acquisitions']} acquires, {plock['contended']} contended, wait p50 "
                f"{plock['waitMs']['p50']} p99 {plock['waitMs']['p99']} ms, hold p50 {plock['holdMs']['p50']} "
                f"p99 {plock['holdMs']['p99']} max {plock['holdMs']['max']} ms; by phase "
                + ", ".join(f"{ph or '-'} {v['holds']} holds {v['totalMs']} ms" for ph, v in plock["byPhase"].items())
                + f" | {smi}")
            _, body = on.get("/debug/contention")
            locks = sorted(json.loads(body)["locks"], key=total_wait_ms, reverse=True)
            log(f"phase contention: the {TOP_LOCKS} locks with the most total wait of {len(locks)} (every server "
                f"of the process): " + "; ".join(
                    f"{lk['name']} ({lk['instances']}) {total_wait_ms(lk):.3f} ms over {lk['contended']} of "
                    f"{lk['acquisitions']} acquires, wait p99 {lk['waitMs']['p99']}, top blocker "
                    + (f"{lk['topBlockers'][0]['holderPhase']} {lk['topBlockers'][0]['totalWaitMs']} ms"
                       if lk["topBlockers"] else "none")
                    for lk in locks[:TOP_LOCKS]) + f" | {smi}")
            by_holder = {}
            for lk in locks:
                for blocker in lk["topBlockers"]:
                    by_holder[blocker["holderPhase"]] = by_holder.get(blocker["holderPhase"], 0.0) + blocker[
                        "totalWaitMs"]
            log("phase contention: wait charged to each holder's phase, every lock: " + ", ".join(
                f"{ph} {ms:.3f} ms" for ph, ms in sorted(by_holder.items(), key=lambda kv: -kv[1]))
                + f" (the on server's samples run as {BACKGROUND_PHASES['capacity'][1]}, its drains as "
                f"{BACKGROUND_PHASES['lifecycle'][1]}; other threads outside a request are 'unknown')")
            _, text = on.get("/metrics", accept="text/plain")
            text = text.decode()
            for series in ("foundry_spark_scheduler_tpu_lock_acquire_count", "foundry_spark_scheduler_tpu_lock_hold_time",
                           "foundry_spark_scheduler_tpu_criticalpath_segment_time",
                           "foundry_spark_scheduler_tpu_criticalpath_coverage"):
                if series not in text:
                    raise SystemExit(f"/metrics (Prometheus text) lacks {series}")
        finally:
            for server in servers.values():
                server.stop()
            servers.clear()

        # 4. the race detector on the card
        t = time.perf_counter()
        detector = racecheck.enable(racecheck.RaceDetector())
        try:
            servers["race"] = PortServer(CONTENTION_POLICY, "cuda", nodes, queue)
            boot_s = time.perf_counter() - t
            tracked = len(detector._instances)
            race_ms = [probe(f"race-probe-{i:02d}", ("race",))["race"] for i in range(RACE_PROBES)]
            servers["race"].settle_embedded()
            servers["race"].scheduler.capacity.sample_now(trigger="race")
            servers["race"].scheduler.lifecycle.drain(trigger="race")
        finally:
            for server in servers.values():
                server.stop()
            racecheck.disable()
        counts = (len(detector.races), len(detector.hb_races), len(detector.lock_order_violations))
        log(f"phase contention: race detector on a cuda server built under it ({tracked} guarded instances "
            f"tracked, boot {boot_s:.2f} s), {RACE_PROBES} granted probes (p50 "
            f"{statistics.median(race_ms):.3f} ms), the sampler, ledger and write-back live, a sample and a "
            f"drain: lockset races {counts[0]}, happens-before races {counts[1]}, lock-order cycles {counts[2]}")
        if any(counts):
            raise SystemExit("phase contention: the race detector found:\n" + "\n".join(detector.report_lines()))
        launches = {k: v for k, v in qk.launch_counts.items() if v}
        if launches.get("fifo_queue_tightly_checkpointed", 0) < 1:
            raise SystemExit(f"phase contention: the checkpointed fifo_queue was not launched ({launches})")

        # 5. the disabled path
        cost = disabled_path_ns()
        log("phase contention: ns per uncontended acquire + release (or call), host clock, loop included: "
            + ", ".join(f"{k} {v:.1f}" for k, v in cost.items()) + f" | {smi}")
        log(f"phase contention: queue-kernel launches on the phase's path {launches}")
        return launches
    finally:
        locktime.enable(keeper)
        logging.disable(logging.NOTSET)


# -- phase policy: the scheduling-policy engine ---------------------------------

POLICY_SERVER = "tpu-batch"
POLICY_WARM = 4  # probes on the on, off and cpu servers, on and cpu bodies equal
# granted probes, each retired, on each of the on and off servers (40
# before phase concurrent, 24 before its (b) timed 128 Filters a point)
POLICY_PROBES = 16
POLICY_BLOCK = 8  # in blocks in turns, each block to its own server alone, each on block then to the cpu server
ORDER_WARM = 1  # probes before the drf and fifo servers' block (the first a cold pass)
ORDER_BLOCK = 3  # the drf and fifo servers' block (5 before phase mesh joined the script)
POLICY_YOUNG = 100  # the newest queued drivers, younger than the starvation age: backfill probes them
POLICY_BANDS = (("low", 0.2), ("normal", 0.6), ("high", 0.2))
POLICY_TENANTS = 4
BAND_LABEL, TENANT_LABEL = "spark-priority-band", "spark-tenant"
# the preemption scenario's own instance group: nodes that fit one
# 12 CPU / 48 Gi executor each (and a driver beside it); no queued driver
# is in the group, so nothing queues ahead of its apps
POOL_GROUP, POOL_NODES, POOL_EXECUTOR = "preempt-pool", 8, ("12", "48Gi")
POLICY_SPANS = ("fast_path.snapshot", "fast_path.earlier_drivers", "deltasolve.lookup", "deltasolve.scale",
                "kernel:fifo_queue", "binpack", "predicate", "http.request")
# fields of a /lifecycle record the host's clock decides
LIFECYCLE_HOST_FIELDS = ("phaseTimes", "queueWaitSeconds", "solveTenureSeconds", "traceIds")


def policy_objects(seed: int):
    """Phase 5's snapshot with every queued driver labelled with a band
    (low / normal / high, 20 / 60 / 20 %) and a tenant (4), from
    `seed`, the newest POLICY_YOUNG of them created 300-201 s ago
    (younger than the starvation age of 600 s for the whole phase, so
    the backfill probe runs for them), plus the preemption pool's
    nodes.  Returns (node names, nodes,
    queue, rng, the time after the queue's newest driver)."""
    from k8s_spark_scheduler_tpu_torch.types.objects import Node, ObjectMeta
    from k8s_spark_scheduler_tpu_torch.types.resources import ZONE_LABEL, Resources

    names, nodes, queue, rng, _ = server_objects(seed)
    prng = np.random.RandomState(seed + 11)
    bands, weights = zip(*POLICY_BANDS)
    now = time.time()
    for i, pod in enumerate(queue):
        pod.labels[BAND_LABEL] = str(prng.choice(bands, p=weights))
        pod.labels[TENANT_LABEL] = f"tenant-{prng.randint(POLICY_TENANTS)}"
        young = i - (N_APPS - POLICY_YOUNG)
        if young >= 0:
            pod.meta.creation_timestamp = now - 300.0 + young
    pool = [
        Node(meta=ObjectMeta(name=f"pool-{i}", labels={ZONE_LABEL: "z0", "resource_channel": POOL_GROUP}),
             allocatable=Resources.of("16", "64Gi"))
        for i in range(POOL_NODES)
    ]
    return names, nodes + pool, queue, prng, now - 200.0


def pod_gone(server, pod) -> bool:
    from k8s_spark_scheduler_tpu_torch.kube.errors import NotFoundError

    try:
        server.api.get("Pod", pod.namespace, pod.name)
    except NotFoundError:
        return True
    return False


def identity_free_policy_state(state: dict) -> dict:
    """/policy/state less the evictions' host-clock stamps."""
    out = json.loads(json.dumps(state))
    for entry in out.get("preemption", {}).get("recent", ()):
        entry.pop("at", None)
    return out


def policy_phase(seed: int, smi: str) -> dict:
    """Phase policy (see the module docstring).  Returns the queue
    kernels' launches on the phase's path; raises SystemExit on any
    failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.config import PolicyConfig
    from k8s_spark_scheduler_tpu_torch.metrics import names as mnames
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.policy import engine as policy_engine
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    t0 = time.perf_counter()
    names, nodes, queue, prng, t_probe = policy_objects(seed)
    pool_names = [n.name for n in nodes[-POOL_NODES:]]
    counts = {b: sum(p.labels[BAND_LABEL] == b for p in queue) for b, _ in POLICY_BANDS}
    config = dict(enabled=True, ordering="priority-then-fifo", backfill=True, preemption_enabled=True)
    servers = {}
    made = [0]

    # the backfill probe (the reference's numpy rule), counted and timed
    real_probe = policy_engine.backfill_cannot_delay
    backfill = {"n": 0, "ms": 0.0}

    def counted_probe(*a, **kw):
        t = time.perf_counter()
        try:
            return real_probe(*a, **kw)
        finally:
            backfill["n"] += 1
            backfill["ms"] += (time.perf_counter() - t) * 1e3

    def probe_driver(tag: str):
        """The driver of a small gang that fits, with a seeded band and
        tenant, newer than the whole queue."""
        bands, weights = zip(*POLICY_BANDS)
        pods = Harness.static_allocation_spark_pods(
            tag, int(prng.randint(1, 5)), executor_cpu=str(int(prng.randint(1, 5))),
            executor_mem=f"{int(prng.randint(2, 9))}Gi", creation_timestamp=t_probe + made[0])
        made[0] += 1
        pods[0].labels[BAND_LABEL] = str(prng.choice(bands, p=weights))
        pods[0].labels[TENANT_LABEL] = f"tenant-{prng.randint(POLICY_TENANTS)}"
        return pods[0]

    def filter_once(side: str, pod, alone: bool = True):
        """(ms, body, backfill probes, their ms) of one granted Filter of
        `pod` on `side`, then the pod retired there."""
        server = servers[side]
        server.api.create(pod.deepcopy())
        backfill["n"], backfill["ms"] = 0, 0.0
        others = [s for k, s in servers.items() if k != side] if alone else []
        ms, status, body = server.post_alone(others, pod, names)
        probes, probe_ms = backfill["n"], backfill["ms"]
        if status != 200 or not json.loads(body).get("NodeNames"):
            raise SystemExit(f"phase policy: {side} did not grant {pod.name}: {status} {body[:300]!r}")
        server.retire([pod])
        return ms, body, probes, probe_ms

    def block_run(side: str, pods) -> dict:
        """One block posted to `side` alone: the other servers paused for
        the block, `side`'s sampler and ledger quiet before it."""
        server = servers[side]
        others = [s for k, s in servers.items() if k != side]
        for other in others:
            other.pause_background()
        try:
            quiet(server, "policy")
            out = {"ms": [], "bodies": [], "probes": [], "probe_ms": [], "traces": []}
            for pod in pods:
                ms, body, probes, probe_ms = filter_once(side, pod, alone=False)
                out["ms"].append(ms)
                out["bodies"].append(body)
                out["probes"].append(probes)
                out["probe_ms"].append(probe_ms)
                out["traces"].append(server.scheduler.tracer.traces(limit=1)[0])
        finally:
            for other in others:
                other.resume_background()
        return out

    def replay(side: str, pods, bodies, against: str) -> float:
        """Post each of `pods` to `side` (untimed), bodies equal to
        `against`'s; returns the seconds it took."""
        t = time.perf_counter()
        for pod, want in zip(pods, bodies):
            _, body, _, _ = filter_once(side, pod, alone=False)
            if body != want:
                raise SystemExit(f"phase policy: {pod.name}: {side} answered {body[:300]!r}, "
                                 f"{against} {want[:300]!r}")
        return time.perf_counter() - t

    def engine_line(side: str, before: dict) -> str:
        after = servers[side].scheduler.extender.delta_engine.stats()
        hits = after["warm_hits"] - before["warm_hits"]
        cold = after["cold_solves"] - before["cold_solves"]
        misses = {k: v - before["misses"].get(k, 0) for k, v in after["misses"].items()
                  if v - before["misses"].get(k, 0)}
        total = hits + cold + sum(misses.values())
        return (f"warm hits {hits} of {total} ({100 * hits / max(total, 1):.1f} %), cold builds {cold}, "
                f"misses {misses or 'none'}")

    def latency_line(run: dict) -> str:
        ms = run["ms"]
        line = (f"/predicates: p50 {statistics.median(ms):.3f} ms, p99 {float(np.percentile(ms, 99)):.3f} ms over "
                f"{len(ms)} probes")
        if any(run["probes"]):
            per = [pm / max(n, 1) for n, pm in zip(run["probes"], run["probe_ms"])]
            line += (f"; backfill probes a Filter median {statistics.median(run['probes'])} (max "
                     f"{max(run['probes'])}), their host ms a Filter median "
                     f"{statistics.median(run['probe_ms']):.3f} (p99 {float(np.percentile(run['probe_ms'], 99)):.3f}),"
                     f" ms a probe {statistics.median(per):.3f}")
        spans = {}
        for trace in run["traces"]:
            span_durations(trace["root"], spans)
        return line + "; span medians (ms) " + ", ".join(
            f"{name} {statistics.median(spans[name]):.3f}" for name in POLICY_SPANS if name in spans)

    policy_engine.backfill_cannot_delay = counted_probe
    try:
        # 1. priority-then-fifo with backfill and preemption against the
        # policy off, bodies equal to a cpu server with the same policy
        servers["on"] = PortServer(POLICY_SERVER, "cuda", nodes, queue,
                                   scheduling_policy=PolicyConfig(**config))
        servers["off"] = PortServer(POLICY_SERVER, "cuda", nodes, queue)
        servers["cpu"] = PortServer(POLICY_SERVER, "cpu", nodes, queue, scheduling_policy=PolicyConfig(**config))
        log(f"phase policy: {POLICY_SERVER}: servers with {config} (cuda, cpu) and the policy off (cuda) ready in "
            f"{time.perf_counter() - t0:.2f} s; queue bands {counts}, {POLICY_TENANTS} tenants, the newest "
            f"{POLICY_YOUNG} queued drivers 201-300 s old")
        qk.reset_launch_counts()  # the path's run starts here
        for i in range(POLICY_WARM):
            pod = probe_driver(f"pol-warm-{i}")
            bodies = {side: filter_once(side, pod)[1] for side in ("on", "off", "cpu")}
            if bodies["on"] != bodies["cpu"]:
                raise SystemExit(f"phase policy: warm probe {i}: on {bodies['on'][:300]!r}, "
                                 f"cpu {bodies['cpu'][:300]!r}")
        before = {side: servers[side].scheduler.extender.delta_engine.stats() for side in ("on", "off")}
        skips_before = servers["on"].scheduler.metrics.get_counter(mnames.POLICY_BACKFILL_SKIPS)
        runs = {"on": [], "off": []}
        replay_s = 0.0
        blocks = ["on", "off", "off", "on"] * (POLICY_PROBES // (2 * POLICY_BLOCK))
        for b, side in enumerate(blocks):
            pods = [probe_driver(f"pol-{b}-{j:02d}") for j in range(POLICY_BLOCK)]
            run = block_run(side, pods)
            runs[side].append(run)
            if side == "on":
                replay_s += replay("cpu", pods, run["bodies"], "on")
        merged = {side: {k: sum((r[k] for r in rs), []) for k in rs[0]} for side, rs in runs.items()}
        for side, what in (("on", "priority-then-fifo, backfill, preemption"), ("off", "no engine")):
            log(f"phase policy: {POLICY_SERVER} policy {side} ({what}): {latency_line(merged[side])}; "
                f"{engine_line(side, before[side])} | {smi}")
        skips = servers["on"].scheduler.metrics.get_counter(mnames.POLICY_BACKFILL_SKIPS) - skips_before
        log(f"phase policy: all {POLICY_PROBES} of the on blocks' Filters equal the cpu server's "
            f"(posted there after each block, {replay_s:.2f} s in all); blocks {', '.join(blocks)}; backfill verdicts that a queued driver's skip is safe "
            f"{skips:.0f}")

        # 2. the same protocol for one block under drf and under fifo: the
        # drf server's bodies equal a cpu server's with drf (the warm
        # probes' too), the fifo engine's the policy-off server's
        for order, against in (("drf", "drf-cpu"), ("fifo", "off")):
            t = time.perf_counter()
            order_policy = PolicyConfig(**dict(config, ordering=order))
            servers[order] = PortServer(POLICY_SERVER, "cuda", nodes, queue, scheduling_policy=order_policy)
            if against == "drf-cpu":
                servers[against] = PortServer(POLICY_SERVER, "cpu", nodes, queue, scheduling_policy=order_policy)
            boot = time.perf_counter() - t
            warm = [probe_driver(f"pol-{order}-warm-{i}") for i in range(ORDER_WARM)]
            warm_bodies = [filter_once(order, pod)[1] for pod in warm]
            stats0 = servers[order].scheduler.extender.delta_engine.stats()
            pods = [probe_driver(f"pol-{order}-{j:02d}") for j in range(ORDER_BLOCK)]
            run = block_run(order, pods)
            checked = replay(against, warm + pods, warm_bodies + run["bodies"], order)
            note = (f"; bodies equal to the {'cpu server' if against == 'drf-cpu' else 'policy-off server'}'s "
                    f"({len(warm) + len(pods)} Filters, {checked:.2f} s)")
            log(f"phase policy: {POLICY_SERVER} ordering {order} (servers built in {boot:.2f} s): "
                + latency_line(run) + f"; {engine_line(order, stats0)}{note} | {smi}")
            servers.pop(order).stop()
            if against == "drf-cpu":
                servers.pop(against).stop()

        # 3. preemption: low-band apps bound in the pool, a high-band gang
        # that fits only after an eviction, on a fresh cuda and cpu server
        # with step 1's policy (fresh: /policy/state counts the apps each
        # server saw)
        for side in list(servers):
            servers.pop(side).stop()
        t = time.perf_counter()
        for side, device in (("on", "cuda"), ("cpu", "cpu")):
            servers[side] = PortServer(POLICY_SERVER, device, nodes, queue,
                                       scheduling_policy=PolicyConfig(**config))
        log(f"phase policy: preemption servers (cuda, cpu) ready in {time.perf_counter() - t:.2f} s")
        pool_apps = {
            "low-a": (3, "low", t_probe + made[0] + 1),
            "low-b": (3, "low", t_probe + made[0] + 2),
            "high": (5, "high", t_probe + made[0] + 3),
        }
        pods_of = {
            app: Harness.static_allocation_spark_pods(
                app, k, executor_cpu=POOL_EXECUTOR[0], executor_mem=POOL_EXECUTOR[1],
                instance_group=POOL_GROUP, creation_timestamp=created)
            for app, (k, band, created) in pool_apps.items()
        }
        for app, pods in pods_of.items():
            for pod in pods:
                pod.labels[BAND_LABEL] = pool_apps[app][1]
        outcome = {}
        for side in ("on", "cpu"):
            server = servers[side]

            def admit(app, server=server, side=side):
                for pod in pods_of[app]:
                    server.api.create(pod.deepcopy())
                    _, status, body = server.post(pod, pool_names)
                    nodes_ = json.loads(body).get("NodeNames") if status == 200 else None
                    if not nodes_:
                        raise SystemExit(f"phase policy: {side}: {pod.name} refused: {body[:300]!r}")
                    server.bind(pod, nodes_[0])

            t = time.perf_counter()
            admit("low-a")
            admit("low-b")
            server.settle_embedded()
            high = pods_of["high"][0]
            server.api.create(high.deepcopy())
            ms, status, refused = server.post(high, pool_names)
            message = next(iter(json.loads(refused).get("FailedNodes", {}).values()), "")
            if "preempting victims: low-b" not in message:
                raise SystemExit(f"phase policy: {side}: the high-band Filter was not refused with the "
                                 f"victim note: {refused[:300]!r}")
            wait_for(lambda: all(pod_gone(server, p) for p in pods_of["low-b"])
                     and server.scheduler.resource_reservation_cache.get("default", "low-b") is None,
                     f"{side}: the victim's pods and reservation to go")
            server.settle_embedded()
            for pod in pods_of["high"][1:]:
                server.api.create(pod.deepcopy())
            _, status, granted = server.post(high, pool_names)
            if not json.loads(granted).get("NodeNames"):
                raise SystemExit(f"phase policy: {side}: the preemptor's retry was refused: {granted[:300]!r}")
            server.bind(high, json.loads(granted)["NodeNames"][0])
            for pod in pods_of["high"][1:]:
                _, status, body = server.post(pod, pool_names)
                if not json.loads(body).get("NodeNames"):
                    raise SystemExit(f"phase policy: {side}: preemptor executor {pod.name} refused")
            _, state = server.get("/policy/state")
            _, record = server.get("/lifecycle/low-b")
            record = json.loads(record)
            outcome[side] = (refused, granted, identity_free_policy_state(json.loads(state)),
                             {k: v for k, v in record.items() if k not in LIFECYCLE_HOST_FIELDS})
            log(f"phase policy: {side}: preemption in the {POOL_NODES}-node pool: the high-band Filter refused in "
                f"{ms:.3f} ms with {message[-60:]!r}; victim low-b's pods and reservation gone; the retry "
                f"and its executors granted ({time.perf_counter() - t:.2f} s in all); /lifecycle/low-b "
                f"{record['phase']} ({record['evictionCause']!r})")
        if outcome["on"] != outcome["cpu"]:
            raise SystemExit(f"phase policy: preemption differs on cuda and cpu: {outcome['on']} / {outcome['cpu']}")
        if outcome["on"][3]["phase"] != "evicted":
            raise SystemExit(f"phase policy: the victim's lifecycle record is {outcome['on'][3]}")
        state = outcome["on"][2]
        log(f"phase policy: preemption messages, /policy/state (less the evictions' clock stamps) and "
            f"/lifecycle/low-b equal on cuda and cpu: evictions {state['preemption']['evictionsTotal']}, "
            f"what-if {state['preemption']['whatif']}, lane {state['preemption']['recent'][-1]['reason']!r}")
        launches = {k: v for k, v in qk.launch_counts.items() if v}
        if launches.get("fifo_queue_tightly_checkpointed", 0) < 1:
            raise SystemExit(f"phase policy: the checkpointed fifo_queue was not launched ({launches})")
        log(f"phase policy: queue-kernel launches on the phase's path {launches}")
        return launches
    finally:
        policy_engine.backfill_cannot_delay = real_probe
        for server in servers.values():
            server.stop()
        logging.disable(logging.NOTSET)


# -- phase ha: the HA failover fabric ----------------------------------------

HA_POLICY = "tpu-batch"
# the lease's TTL travels over REST as whole seconds (a sub-second one
# reads back as 15 s), so the replicas use a whole-second TTL
HA_TTL_S = 2
HA_B_PROBES = 12  # timed probes on the new leader after the planned handoff
HA_A_AFTER = 2  # probes on the re-elected leader after its cold first Filter
# the write paths a deposed replica's gate must refuse (the reference's
# handoff cell)
HA_FENCED_OPS = ("writeback.create", "writeback.update", "writeback.delete", "demand.create", "preempt.commit")
# the crash-matrix cells' binpack algorithm on the card: every cell's
# driver Filter through the delta-solve session's tensor lane on the card
HA_MATRIX_BINPACK = "tpu-batch"
HA_SPANS = ("predicate", "fast_path.snapshot", "fast_path.earlier_drivers", "deltasolve.lookup", "fifo_gate",
            "http.request")


class HAReplica(ClusterServer):
    """One HA replica of the port's server: its own kubeconfig and REST
    backend to the shared FakeKubeAPI, its own intent journal, the HA
    fabric on with background renewal off (the phase steps elections)."""

    def __init__(self, fake, identity: str, workdir: str):
        from k8s_spark_scheduler_tpu_torch.config import HAConfig, Install
        from k8s_spark_scheduler_tpu_torch.server.__main__ import api_backend
        from k8s_spark_scheduler_tpu_torch.server.http import ExtenderHTTPServer
        from k8s_spark_scheduler_tpu_torch.server.wiring import init_server_with_clients

        self.fake, self.api = fake, fake.api
        self.scheduler = self.http = self.backend = None
        try:
            path = os.path.join(workdir, f"kubeconfig-{identity}.json")
            with open(path, "w") as f:
                json.dump({
                    "current-context": "fake",
                    "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "fake"}}],
                    "clusters": [{"name": "fake", "cluster": {"server": fake.host}}],
                    "users": [{"name": "fake", "user": {}}],
                }, f)
            self.backend, _ = api_backend(path, None, False)
            resilience = server_resilience("cuda")
            resilience.journal_path = os.path.join(workdir, f"{identity}.jsonl")
            self.scheduler = init_server_with_clients(
                self.backend,
                Install(binpack_algo=HA_POLICY, fifo=True, resilience=resilience,
                        ha=HAConfig(enabled=True, background=False, identity=identity,
                                    lease_duration_seconds=HA_TTL_S)),
                demand_poll_interval=0.5, unschedulable_polling_interval=3600.0, device="cuda",
            )
            self.http = ExtenderHTTPServer(self.scheduler, port=0, host="127.0.0.1")
            self.http.start()
            if not self.scheduler.wait_ready(timeout=600.0):
                raise SystemExit(f"phase ha: {identity} did not become ready")
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        if self.http is not None:
            self.http.stop()
        if self.scheduler is not None:
            self.scheduler.stop()
        if self.backend is not None:
            self.backend.stop()

    def status(self, path: str) -> int:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.http.port}{path}", timeout=60) as resp:
                return resp.status
        except urllib.error.HTTPError as err:
            return err.code


def find_span(span: dict, name: str):
    if span["name"] == name:
        return span
    for child in span.get("children", ()):
        found = find_span(child, name)
        if found is not None:
            return found
    return None


def ha_phase(seed: int, smi: str) -> dict:
    """Phase ha (see the module docstring).  Returns the checkpointed
    queue kernel's launches on the phase's path; raises SystemExit on any
    failure."""
    import logging
    import tempfile

    from k8s_spark_scheduler_tpu_torch import timesource
    from k8s_spark_scheduler_tpu_torch.ha.fencing import StaleEpochError
    from k8s_spark_scheduler_tpu_torch.kube.crd import DEMAND_CRD_NAME, demand_crd_spec
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.testing.fake_kube_api import FakeKubeAPI
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness

    chk = "fifo_queue_tightly_checkpointed"
    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    gcs = GcWatch()
    gc.callbacks.append(gcs)
    fake = host = None
    replicas = {}
    path_launches = 0
    made = [0]
    try:
        t0 = time.perf_counter()
        names, nodes, queue, rng, base = server_objects(seed)
        fake = FakeKubeAPI().start()
        fake.api.create_crd(DEMAND_CRD_NAME, demand_crd_spec())
        for obj in nodes + queue:
            fake.api.create(obj.deepcopy())
        workdir = tempfile.mkdtemp(prefix="ha-phase-")
        for identity in ("replica-a", "replica-b"):
            replicas[identity] = HAReplica(fake, identity, workdir)
        host = PortServer(HA_POLICY, "cpu", nodes, queue)
        host.pause_background()  # the card's oracle; its answers do not depend on them
        a, b = replicas["replica-a"], replicas["replica-b"]
        log(f"phase ha: {HA_POLICY}: replicas a and b (cuda, each through its own kubeconfig to one FakeKubeAPI "
            f"holding {len(nodes)} nodes in {N_ZONES} zones and {len(queue)} queued drivers, HA on with a "
            f"{HA_TTL_S} s lease over coordination.k8s.io/v1) and a cpu server ready in "
            f"{time.perf_counter() - t0:.2f} s")

        def new_probe(tag: str):
            pods = Harness.static_allocation_spark_pods(
                f"ha-{tag}", int(rng.randint(1, 32)), executor_cpu=str(int(rng.randint(1, 8))),
                executor_mem=f"{int(rng.randint(2, 16))}Gi", creation_timestamp=base + N_APPS + made[0])
            made[0] += 1
            fake.api.create(pods[0].deepcopy())
            host.api.create(pods[0].deepcopy())
            for r in replicas.values():
                r.sees(pods[0])
            return pods[0]

        def retire(pod, reserved_by=()) -> None:
            """Delete the probe everywhere; wait until the replicas in
            `reserved_by` dropped its reservation (owner GC in the fake,
            seen through their watches) and every replica's informer
            dropped the pod."""
            fake.api.delete("Pod", pod.namespace, pod.name)
            host.retire([pod])
            app = pod.labels["spark-app-id"]
            wait_for(lambda: all(r.scheduler.resource_reservation_cache.get(pod.namespace, app) is None
                                 for r in reserved_by)
                     and all(r.scheduler.pod_informer.get(pod.namespace, pod.name) is None
                             for r in replicas.values()),
                     f"the replicas to drop {pod.name}")

        def against_host(pod, status, body, what: str) -> None:
            _, h_status, h_body = host.post(pod, names)
            if (status, body) != (h_status, h_body) or status != 200 or not json.loads(body)["NodeNames"]:
                raise SystemExit(f"phase ha: {what}: cuda answered {status} {body[:300]!r}, "
                                 f"cpu {h_status} {h_body[:300]!r}")

        def gen2_inside(w0: float, w1: float) -> list:
            return [e for e in gcs.between(w0, w1) if e[0] == 2]

        def timed_run(leader, other, tag: str, n: int, warmup: int = 0) -> dict:
            """`warmup` + `n` granted probes on `leader`, each timed alone
            (the other replica's and the cpu server's background paused),
            renewed before each as the background renewal would, each
            body equal to the cpu server's, each retired."""
            engine = leader.scheduler.extender.delta_engine
            out = {"ms": [], "traces": [], "gen2": []}
            for i in range(warmup + n):
                pod = new_probe(f"{tag}-{i:03d}")
                leader.settle()
                if not leader.scheduler.ha.step():
                    raise SystemExit(f"phase ha: {tag}: the leader lost its lease")
                if i == warmup:
                    warm0 = engine.stats()["warm_hits"]
                w0 = time.time()
                ms, status, body = leader.post_alone([other, host], pod, names)
                w1 = time.time()
                if i >= warmup:
                    out["ms"].append(ms)
                    out["traces"].append(leader.scheduler.tracer.traces(limit=1)[0])
                    out["gen2"] += gen2_inside(w0, w1)
                against_host(pod, status, body, f"{tag} probe {i}")
                retire(pod, reserved_by=replicas.values())
            out["warm"] = engine.stats()["warm_hits"] - warm0
            if out["warm"] != n:
                raise SystemExit(f"phase ha: {tag}: {out['warm']} of the {n} timed probes served warm")
            return out

        def run_line(run: dict) -> str:
            spans = {}
            for trace in run["traces"]:
                span_durations(trace["root"], spans)
            gen2 = run["gen2"]
            return (f"p50 {statistics.median(run['ms']):.3f} ms, p99 {float(np.percentile(run['ms'], 99)):.3f} ms "
                    f"over {len(run['ms'])} probes (runs {', '.join(f'{x:.1f}' for x in run['ms'])}); span medians "
                    + ", ".join(f"{k} {statistics.median(spans[k]):.3f}" for k in HA_SPANS if k in spans)
                    + f"; generation-2 collections inside them: "
                    + (f"{len(gen2)}, max {max(e[2] for e in gen2):.1f} ms" if gen2 else "none"))

        def first_filter(leader, others, tag: str, t_start: float) -> tuple:
            """The new leader's first Filter right after its election:
            (ms, ms since t_start) of a cold checkpointed launch from row
            0, body equal to the cpu server's."""
            engine = leader.scheduler.extender.delta_engine
            before = engine.stats()
            qk.reset_launch_counts()
            pod = probes.pop(tag)
            ms, status, body = leader.post(pod, names)
            since = (time.perf_counter() - t_start) * 1e3
            launches = qk.launch_counts[chk]
            after = engine.stats()
            gate = find_span(leader.scheduler.tracer.traces(limit=1)[0]["root"], "fifo_gate")
            tags = gate["tags"] if gate is not None else {}
            if (launches != 1 or after["cold_solves"] != before["cold_solves"] + 1
                    or after["warm_hits"] != before["warm_hits"] or tags.get("warm") is not False
                    or tags.get("resumeFrom") != 0):
                raise SystemExit(f"phase ha: {tag}: the first Filter after the takeover was not one cold "
                                 f"checkpointed launch from row 0: {chk} launches {launches}, engine {before} -> "
                                 f"{after}, fifo_gate tags {tags}")
            for other in others:
                other.resume_background()
            against_host(pod, status, body, f"{tag} first Filter")
            retire(pod, reserved_by=replicas.values())
            return ms, since, launches

        # (a) election
        if not a.scheduler.ha.step() or b.scheduler.ha.step():
            raise SystemExit("phase ha: replica-a did not win epoch 1 with replica-b following")
        if (a.scheduler.ha.fence.epoch(), b.scheduler.ha.fence.epoch()) != (1, 0):
            raise SystemExit("phase ha: the election's epochs are not (1, 0)")
        ready = (a.status("/status/readiness"), b.status("/status/readiness"))
        if ready != (200, 503):
            raise SystemExit(f"phase ha: readiness a / b {ready}, want (200, 503)")
        for r in (a, b):
            _, body = r.get("/status/ha")
            log(f"phase ha: (a) /status/ha of {r.scheduler.ha.elector.identity}: {body.decode()}")
        log("phase ha: (a) election: a holds epoch 1, b follows; readiness a 200, b 503")

        # (b) serving under the fence: phase 5's protocol on replica-a
        qk.reset_launch_counts()  # the path's run starts here
        run_a = timed_run(a, b, "a", SERVER_TIMED_PROBES, warmup=SERVER_WARMUP_PROBES)
        path_launches += qk.launch_counts[chk]
        fence_a = a.scheduler.ha.fence.state()
        if fence_a["refusals"] or fence_a["staleCommits"] or fence_a["commits"] < 1:
            raise SystemExit(f"phase ha: (b) replica-a's fence {fence_a}")
        p5 = SERVER_LATENCY.get(HA_POLICY) or [float("nan")]
        log(f"phase ha: (b) replica-a /predicates under the fence, timed alone: {run_line(run_a)}; phase 5's "
            f"{HA_POLICY} in this call p50 {statistics.median(p5):.3f} ms, p99 {float(np.percentile(p5, 99)):.3f} ms; "
            f"{qk.launch_counts[chk]} {chk} launches (the first probe's cold pass); every body equal to the cpu "
            f"server's; fence {json.dumps(fence_a, sort_keys=True)} | {smi}")

        # (c) planned handoff
        probes = {"b-first": new_probe("b-first")}
        for other in (a, host):
            other.pause_background()
        b.settle()
        t_h0 = time.perf_counter()
        a.scheduler.ha.elector.step_down()
        t_h1 = time.perf_counter()
        won = b.scheduler.ha.step()
        t_h2 = time.perf_counter()
        report = b.scheduler.ha.status()["reconciliation"]
        if not won or b.scheduler.ha.fence.epoch() != 2:
            raise SystemExit(f"phase ha: (c) replica-b did not take epoch 2 ({b.scheduler.ha.status()})")
        first_ms, takeover_ms, launches = first_filter(b, (a, host), "b-first", t_h0)
        path_launches += launches
        if a.scheduler.ha.step() or not a.scheduler.ha.fence.deposed():
            raise SystemExit("phase ha: (c) replica-a did not see itself deposed")
        refused0 = a.scheduler.ha.fence.refusals()
        for op in HA_FENCED_OPS:
            try:
                a.scheduler.ha.writer.check(op)
            except StaleEpochError:
                continue
            raise SystemExit(f"phase ha: (c) deposed replica-a's {op} was not fenced")
        deposed_refusals = a.scheduler.ha.fence.refusals() - refused0
        ready = (a.status("/status/readiness"), b.status("/status/readiness"))
        if deposed_refusals != len(HA_FENCED_OPS) or ready != (503, 200):
            raise SystemExit(f"phase ha: (c) deposedRefusals {deposed_refusals}, readiness a / b {ready}")
        step_ms = (t_h2 - t_h1) * 1e3
        log(f"phase ha: (c) planned handoff: takeover {takeover_ms:.3f} ms from a's step_down to b's first "
            f"/predicates answer = step_down {(t_h1 - t_h0) * 1e3:.3f} ms + b's election step {step_ms:.3f} ms "
            f"(of which the Reconciler {report['elapsedSeconds'] * 1e3:.3f} ms: journalReplays "
            f"{report['journalReplays']}, evictionReplays {report['evictionReplays']}, crdDiffRan "
            f"{report['crdDiffRan']}) + b's first Filter {first_ms:.3f} ms (cold: one {chk} launch from row 0) "
            f"+ {takeover_ms - (t_h2 - t_h0) * 1e3 - first_ms:.3f} ms between; deposedRefusals "
            f"{deposed_refusals}; readiness a 503, b 200 | {smi}")
        qk.reset_launch_counts()
        run_b = timed_run(b, a, "b", HA_B_PROBES)
        path_launches += qk.launch_counts[chk]
        log(f"phase ha: (c) replica-b after the takeover, timed alone: {run_line(run_b)}; {qk.launch_counts[chk]} "
            f"{chk} launches (all warm); every body equal to the cpu server's | {smi}")

        # (d) unplanned failover: b stops renewing, its lease lapses, a
        # takes epoch 3 while b still believes it leads
        probes["a-first"] = new_probe("a-first")
        a.settle()
        if not b.scheduler.ha.step():
            raise SystemExit("phase ha: (d) replica-b's last renewal failed")
        t_renew = time.perf_counter()
        lease = b.scheduler.ha.elector.peek()
        while timesource.now() <= lease.renewed_at + lease.duration_seconds:
            time.sleep(0.01)
        for other in (b, host):
            other.pause_background()
        t_d0 = time.perf_counter()
        won = a.scheduler.ha.step()
        t_d1 = time.perf_counter()
        report = a.scheduler.ha.status()["reconciliation"]
        if not won or a.scheduler.ha.fence.epoch() != 3 or a.scheduler.ha.fence.deposed():
            raise SystemExit(f"phase ha: (d) replica-a did not take epoch 3 ({a.scheduler.ha.status()})")
        first_ms, recover_ms, launches = first_filter(a, (b, host), "a-first", t_renew)
        path_launches += launches
        log(f"phase ha: (d) unplanned failover: time to recover {recover_ms:.3f} ms from b's last renewal to a's "
            f"first /predicates answer (the {HA_TTL_S} s TTL, then a's election step {(t_d1 - t_d0) * 1e3:.3f} ms, "
            f"of which the Reconciler {report['elapsedSeconds'] * 1e3:.3f} ms: journalReplays "
            f"{report['journalReplays']}, evictionReplays {report['evictionReplays']}, crdDiffRan "
            f"{report['crdDiffRan']}; a's first Filter {first_ms:.3f} ms, cold: one {chk} launch from row 0) "
            f"| {smi}")
        # b still believes it leads: its granted probe's write-back is
        # refused by the read-through fence and diverted to b's journal
        pod = new_probe("b-stale")
        b.settle()
        journal = b.scheduler.resilience.journal
        depth0 = journal.depth()
        ms, status, body = b.post(pod, names)
        against_host(pod, status, body, "b's stale probe")
        app = pod.labels["spark-app-id"]
        wait_for(lambda: journal.depth() == depth0 + 1, "b's refused write-back to reach its journal")
        pending = [(i["op"], i["name"], i.get("epoch")) for i in journal.pending()]
        fence_b = b.scheduler.ha.fence.state()
        landed = [rr.name for rr in fake.api.list("ResourceReservation") if rr.name == app]
        if (("create", app, 2) not in pending or landed or not b.scheduler.ha.fence.deposed()
                or fence_b["refusals"] != {"writeback.create": 1} or fence_b["staleCommits"]):
            raise SystemExit(f"phase ha: (d) b's stale write-back: journal {pending}, in the API {landed}, "
                             f"fence {fence_b}")
        retire(pod)
        if journal.depth() != depth0 + 1:
            raise SystemExit("phase ha: (d) b's diverted intent left its journal")
        log(f"phase ha: (d) replica-b (epoch 2, not stepped since) granted {app} in {ms:.3f} ms, body equal to the "
            f"cpu server's; its write-back was refused by the read-through fence and diverted to its journal "
            f"(journaled_fenced: pending {pending}); no reservation of b's reached the API; fence "
            f"{json.dumps(fence_b, sort_keys=True)}")
        qk.reset_launch_counts()
        run_a2 = timed_run(a, b, "a2", HA_A_AFTER)
        path_launches += qk.launch_counts[chk]
        for r in (a, b):
            _, body = r.get("/status/ha")
            log(f"phase ha: (d) /status/ha of {r.scheduler.ha.elector.identity}: {body.decode()}")
        stale = {r.scheduler.ha.elector.identity: r.scheduler.ha.fence.stale_commits() for r in (a, b)}
        if any(stale.values()):
            raise SystemExit(f"phase ha: stale commits {stale}")
        log(f"phase ha: (d) replica-a at epoch 3 after its cold Filter: {run_line(run_a2)}; stale commits {stale}")
    finally:
        for server in [*replicas.values(), host]:
            if server is not None:
                server.stop()
        if fake is not None:
            fake.stop()
        logging.disable(logging.NOTSET)
        gc.callbacks.remove(gcs)

    return {chk: path_launches}


# -- phase concurrent: the concurrent admission engine -----------------------

CONCURRENT_POLICIES = ("tpu-batch", "tpu-batch-minimal-fragmentation")  # (a)
CONCURRENT_DRIVERS = 48  # (a): new drivers a policy, through the engine from CONCURRENT_THREADS threads
CONCURRENT_THREADS = 8
CONCURRENT_CLIENTS = (1, 8)  # (b): HTTP client threads, under CONCURRENT_POLICIES[0]
# (b): Filters a segment, client count and server: each of 8 clients
# sends 8 (128 before phase mesh joined the script; the p99 is then
# interpolated between the two slowest Filters)
CONCURRENT_REQUESTS = 64
CONCURRENT_STREAMS = (1, 2, 4, 8)  # (c): fifo_queue launches at once, each on its own stream
CONCURRENT_REPS = 5  # (c): batches timed for each k
# the kernel (variant) a policy's speculations launch: one plain launch
# each, on the speculating thread's own stream
SPECULATOR_KERNEL = {"tpu-batch": "fifo_queue_tightly", "tpu-batch-minimal-fragmentation": "fifo_queue_min_frag"}
# commit results where the verdict was invalidated and the serial path re-solved
CONFLICT_RESULTS = ("conflict", "queue-drift", "skip-drift", "candidate-drift", "pod-mismatch")


def speculation_outcomes(server) -> dict:
    """The server's speculation counts by outcome."""
    from k8s_spark_scheduler_tpu_torch.metrics import names as mnames

    prefix = mnames.CONCURRENT_SPECULATION_COUNT + "[outcome="
    return {k[len(prefix):-1]: int(v) for k, v in server.scheduler.metrics.snapshot()["counters"].items()
            if k.startswith(prefix)}


def counts_since(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in sorted(after.items()) if v - before.get(k, 0)}


def speculator_launches() -> dict:
    """Queue-kernel launches (by module) on non-default CUDA streams since
    the counts were last reset.  In this phase only the speculating
    threads launch there, each on its own stream: commits, warm solves
    and the observatory launch theirs on the default stream or launch no
    queue kernel."""
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk

    default = torch.cuda.default_stream().cuda_stream
    streams = {h for counts in (qk.stream_launch_counts, mk.stream_launch_counts) for h in counts if h != default}
    return {"queue": sum(qk.stream_launch_counts.get(h, 0) for h in streams),
            "min_frag": sum(mk.stream_launch_counts.get(h, 0) for h in streams), "streams": len(streams)}


def ticket_wait(server) -> tuple:
    """(count, sum in s) of the engine's ticket-wait histogram."""
    from k8s_spark_scheduler_tpu_torch.metrics import names as mnames

    h = server.scheduler.metrics.collect()["histograms"].get((mnames.CONCURRENT_TICKET_WAIT_TIME, ()))
    return (h["count"], h["sum"]) if h else (0, 0.0)


def crash_cells(device: str) -> dict:
    """Phase concurrent (d)'s cells on `device`: every crash-matrix cell,
    the 3 window cells with the policy engine off and the two-replica
    handoff cell under HA_MATRIX_BINPACK: {(cell, policy on): (report,
    seconds, (plain, checkpointed, speculated) queue-kernel launches)}."""
    import logging

    from k8s_spark_scheduler_tpu_torch.ha.crashmatrix import PORTED_POINTS, CrashMatrix
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk

    cells = [(point, True) for point in PORTED_POINTS]
    # the window's cells with the policy engine off: the crashed Filter's
    # verdict solved on its thread's stream, in flight or (commit-written)
    # consumed as a hit before the death
    cells += [(point, False) for point in PORTED_POINTS if point.startswith("concurrent.")]
    out = {}
    logging.disable(logging.CRITICAL)  # each cell's kill -9 logs its stack traces
    try:
        for point, policy in cells + [("handoff", True)]:
            qk.reset_launch_counts()
            mk.reset_launch_counts()
            matrix = CrashMatrix(nodes=2, device=device, binpack_algo=HA_MATRIX_BINPACK, policy=policy)
            t = time.perf_counter()
            report = matrix.run_handoff() if point == "handoff" else matrix.run_point(point)
            seconds = time.perf_counter() - t
            speculated = speculator_launches()["queue"] if device == "cuda" and not policy else 0
            out[(point, policy)] = (report, seconds, (qk.launch_counts["fifo_queue_tightly"],
                                                      qk.launch_counts["fifo_queue_tightly_checkpointed"], speculated))
    finally:
        logging.disable(logging.NOTSET)
    return out


def twin_crash_cells() -> dict:
    """Phase concurrent (d)'s cpu cells, in the twin."""
    return crash_cells("cpu")


def crash_matrix_cells(smi: str, cpu_cells) -> dict:
    """Phase concurrent (d): every crash-matrix cell and the handoff cell
    on cuda, each report against the same cell on cpu (`cpu_cells`: the
    twin's twin_crash_cells).  Returns the cuda cells' queue-kernel
    launches on their Filters' path: the checkpointed ones and the
    speculations' on their own streams."""
    from k8s_spark_scheduler_tpu_torch.ha import crashpoint
    from k8s_spark_scheduler_tpu_torch.ha.crashmatrix import PORTED_POINTS

    t0 = time.perf_counter()
    cuda = crash_cells("cuda")
    if crashpoint.armed() is not None:
        raise SystemExit("phase concurrent: (d) a crash point stayed armed")
    t = time.perf_counter()
    cpu = cpu_cells.get(timeout=1800)
    waited = time.perf_counter() - t
    for (point, policy), (report, seconds, (plain, checkpointed, speculated)) in cuda.items():
        want, cpu_seconds, _ = cpu[(point, policy)]
        cell = f"{point}{'' if policy else ', policy off'}"
        if not report["ok"] or report != want:
            raise SystemExit(f"phase concurrent: (d) cell {cell}: cuda {report}, cpu {want}")
        if point == "handoff":
            log(f"phase concurrent: (d) the two-replica handoff cell: ok, epoch {report['handoffEpoch']}, "
                f"deposedRefusals {report['deposedRefusals']}, equal on cuda and cpu ({seconds:.2f} / "
                f"{cpu_seconds:.2f} s)")
        elif policy:
            log(f"phase concurrent: (d) crash cell {cell}: ok, crashed, recovered at epoch "
                f"{report['recoveredEpoch']}, report equal on cuda and cpu; cuda {seconds:.2f} s (queue kernel: "
                f"{plain} warmup launches, {checkpointed} checkpointed Filter launches), cpu {cpu_seconds:.2f} s")
        else:
            log(f"phase concurrent: (d) crash cell {cell}: ok, speculation {report['speculation']} before the "
                f"crash, reservation present {report['reservationPresent']}, report equal on cuda and cpu; cuda "
                f"{seconds:.2f} s (queue kernel: {speculated} speculation launches on its own stream, "
                f"{checkpointed} checkpointed), cpu {cpu_seconds:.2f} s")
    cells = [c for c in cuda if c[0] != "handoff"]
    totals = {"plain": sum(cuda[c][2][0] for c in cells if c[1]),
              "checkpointed": sum(cuda[c][2][1] for c in cells),
              "speculated": sum(cuda[c][2][2] for c in cells)}
    log(f"phase concurrent: (d) the {len(PORTED_POINTS)} cells (each with the concurrent admission engine on; "
        f"the cells' policy engine makes every speculation decline, as in the reference), the 3 window cells "
        f"with the policy engine off and the handoff under {HA_MATRIX_BINPACK} in {time.perf_counter() - t0:.1f} s "
        f"(the cpu cells in the twin, waited {waited:.1f} s for them), the cuda cells launching the queue kernel "
        f"{totals['plain']} times at their servers' warmup, {totals['speculated']} times on speculators' streams "
        f"and {totals['checkpointed']} times checkpointed on their Filters (a cell's gang has no earlier driver, "
        f"so its session has no queue to pass) | {smi}")
    return {"fifo_queue_tightly": totals["speculated"], "fifo_queue_tightly_checkpointed": totals["checkpointed"]}


def concurrent_launches(queue_args, smi: str) -> None:
    """Phase concurrent (c): fifo_queue at the main path's inputs, k
    launches at once on k streams, each batch timed by CUDA events (the
    batch from before the first launch to after the last, and each
    launch on its own stream), every result equal to the plain version."""
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk

    want = qk.solve_queue_plain(*queue_args)
    main = torch.cuda.current_stream()

    def event():
        return torch.cuda.Event(enable_timing=True)

    for k in CONCURRENT_STREAMS:
        streams = [torch.cuda.Stream() for _ in range(k)]
        batch_ms, launch_ms = [], []
        for rep in range(CONCURRENT_REPS + 1):  # the first batch warms the streams, untimed
            begin, end = event(), event()
            starts, stops = [event() for _ in streams], [event() for _ in streams]
            outs = []
            begin.record(main)
            for stream, start, stop in zip(streams, starts, stops):
                stream.wait_event(begin)
                with torch.cuda.stream(stream):
                    start.record(stream)
                    outs.append(qk.fifo_queue(*queue_args))
                    stop.record(stream)
            for stop in stops:
                main.wait_event(stop)
            end.record(main)
            torch.cuda.synchronize()
            for i, out in enumerate(outs):
                err = compare(out, want)
                if err:
                    raise SystemExit(f"phase concurrent: (c) k={k} launch {i} != plain (max |diff| {err})")
            if rep:
                batch_ms.append(begin.elapsed_time(end))
                launch_ms += [start.elapsed_time(stop) for start, stop in zip(starts, stops)]
        n_b, a_b = queue_args[0].shape[0], queue_args[3].shape[0]
        log(f"phase concurrent: (c) fifo_queue_tightly N={n_b} A={a_b} ({int(queue_args[6].sum())} valid), {k} "
            f"launches at once on {k} streams: batch median {statistics.median(batch_ms):.3f} ms (batches "
            f"{', '.join(f'{x:.3f}' for x in batch_ms)}), a launch median {statistics.median(launch_ms):.3f} ms, "
            f"max {max(launch_ms):.3f}; every result equal to the plain version | {smi}")


def concurrent_phase(seed: int, smi: str, queue_args, crash_cpu) -> dict:
    """Phase concurrent (see the module docstring).  Returns the queue
    kernels' launches on the phase's path: the speculations' plain
    launches on their threads' streams and the cells' checkpointed ones;
    raises SystemExit on any failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.testing.harness import Harness
    from k8s_spark_scheduler_tpu_torch.types import serde
    from k8s_spark_scheduler_tpu_torch.types.extenderapi import ExtenderArgs

    t_phase = time.perf_counter()
    launches = {kname + suffix: 0 for kname in SPECULATOR_KERNEL.values() for suffix in ("", "_checkpointed")}
    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    names, nodes, queue, rng, base = server_objects(seed)
    made = [0]
    servers = {}

    def new_driver(tag: str):
        """A new driver of the queue's distribution, younger than the queue."""
        pod = Harness.static_allocation_spark_pods(
            f"conc-{tag}", int(rng.randint(1, 32)), executor_cpu=str(int(rng.randint(1, 8))),
            executor_mem=f"{int(rng.randint(2, 16))}Gi", creation_timestamp=base + N_APPS + made[0])[0]
        made[0] += 1
        return pod

    def in_turn(server, pods, turns: int, fn):
        """fn(server, pod, k) for every pod from `turns` threads, thread t
        taking pods t, t + turns, ...; returns the results in order."""
        out, errors = [None] * len(pods), []

        def worker(t):
            try:
                for k in range(t, len(pods), turns):
                    out[k] = fn(server, pods[k], k)
            except BaseException as err:  # surfaced below
                errors.append(err)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(turns)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        if errors:
            raise errors[0]
        return out

    try:
        # (a) equality: the engine from 8 threads against the serial extender
        for policy in CONCURRENT_POLICIES:
            t0 = time.perf_counter()
            on = servers[policy, "on"] = PortServer(policy, "cuda", nodes, queue, concurrent=True)
            off = servers[policy, "off"] = PortServer(policy, "cuda", nodes, queue)
            engine = on.scheduler.concurrent
            if engine is None or off.scheduler.concurrent is not None:
                raise SystemExit("phase concurrent: the concurrent switch did not reach the servers")
            drivers = [new_driver(f"{policy}-{i:02d}") for i in range(CONCURRENT_DRIVERS)]
            for server in (on, off):
                for pod in drivers:
                    server.api.create(pod.deepcopy())
            log(f"phase concurrent: (a) {policy}: a cuda server with the engine and one without ready in "
                f"{time.perf_counter() - t0:.2f} s; {len(drivers)} new drivers behind {N_APPS} queued")
            qk.reset_launch_counts()
            mk.reset_launch_counts()
            spec0, results0 = speculation_outcomes(on), engine.stats()["commit_results"]
            tickets = [engine.gate.ticket() for _ in drivers]

            def through_engine(server, pod, k):
                stored = server.api.get("Pod", pod.namespace, pod.name).deepcopy()

                def bind(result):
                    if result.node_names:
                        server.bind(stored, result.node_names[0])

                result = engine.predicate(ExtenderArgs(pod=stored, node_names=names), ticket=tickets[k],
                                          post_commit=bind)
                return bytes(serde.encode_extender_filter_result(result))

            t = time.perf_counter()
            got = in_turn(on, drivers, CONCURRENT_THREADS, through_engine)
            on_s = time.perf_counter() - t
            spec_launched = speculator_launches()
            plain = {**qk.launch_counts, **mk.launch_counts}

            def serially(server, pod, k):
                stored = server.api.get("Pod", pod.namespace, pod.name).deepcopy()
                result = server.scheduler.extender.predicate(ExtenderArgs(pod=stored, node_names=names))
                if result.node_names:
                    server.bind(stored, result.node_names[0])
                return bytes(serde.encode_extender_filter_result(result))

            t = time.perf_counter()
            want = in_turn(off, drivers, 1, serially)
            off_s = time.perf_counter() - t
            for k, (a, b) in enumerate(zip(got, want)):
                if a != b:
                    raise SystemExit(f"phase concurrent: (a) {policy} driver {k}: engine {a[:300]!r}, serial "
                                     f"{b[:300]!r}")
            granted = sum(bool(json.loads(body).get("NodeNames")) for body in want)
            spec = counts_since(speculation_outcomes(on), spec0)
            results = counts_since(engine.stats()["commit_results"], results0)
            kname = SPECULATOR_KERNEL[policy]
            kind = "min_frag" if kname == "fifo_queue_min_frag" else "queue"
            if spec.get("error", 0) or not spec.get("solved") or spec_launched[kind] < 1:
                raise SystemExit(f"phase concurrent: (a) {policy}: speculations {spec}, launches on the "
                                 f"speculators' streams {spec_launched}")
            launches[kname] += spec_launched[kind]
            launches[kname + "_checkpointed"] += plain[kname + "_checkpointed"]  # the engine's commits
            log(f"phase concurrent: (a) {policy}: {len(drivers)} drivers ({granted} granted) through the engine from "
                f"{CONCURRENT_THREADS} threads in {on_s:.2f} s and serially in {off_s:.2f} s, every body "
                f"byte-equal; speculations {spec} (error 0); commit results {results}; {spec_launched[kind]} "
                f"{kname} launches on {spec_launched['streams']} speculator streams (all plain launches of the "
                f"run: {plain}) | {smi}")
            if policy != CONCURRENT_POLICIES[0]:
                for side in ("on", "off"):
                    servers.pop((policy, side)).stop()

        # (b) timing over HTTP under the first policy, on against off
        policy = CONCURRENT_POLICIES[0]
        on, off = servers[policy, "on"], servers[policy, "off"]
        engine = on.scheduler.concurrent
        blocker = Harness.static_allocation_spark_pods(
            "conc-blocker", 1, executor_cpu="97", creation_timestamp=base - 1.0)[0]
        kname = SPECULATOR_KERNEL[policy]
        for segment, granted in (("granted", True), ("refused", False)):
            if not granted:
                # an enforced driver at the head of the queue that fits
                # nowhere: every queued driver's Filter is refused behind it
                for server in (on, off):
                    server.api.create(blocker.deepcopy())
            for clients in CONCURRENT_CLIENTS:
                pods = ([new_driver(f"{segment}-{clients}-{i:02d}") for i in range(CONCURRENT_REQUESTS)]
                        if granted else [queue[int(rng.randint(0, N_APPS))] for _ in range(CONCURRENT_REQUESTS)])
                lines = []
                for side in (("on", "off") if clients % 2 else ("off", "on")):
                    server, other = (on, off) if side == "on" else (off, on)
                    if granted:
                        for pod in pods:
                            server.api.create(pod.deepcopy())
                    qk.reset_launch_counts()
                    mk.reset_launch_counts()
                    spec0, results0 = speculation_outcomes(on), engine.stats()["commit_results"]
                    waits0 = ticket_wait(on)
                    _, cursor = on.scheduler.tracer.completed_since(2**62)

                    def post(server, pod, k):
                        ms, status, body = server.post(pod, names)
                        if status != 200 or bool(json.loads(body).get("NodeNames")) != granted:
                            raise SystemExit(f"phase concurrent: (b) {segment} {side} {pod.name}: {status} "
                                             f"{body[:300]!r}")
                        if granted:
                            server.retire([pod])
                        return ms

                    other.pause_background()
                    try:
                        t = time.perf_counter()
                        lat = in_turn(server, pods, clients, post)
                        wall = time.perf_counter() - t
                    finally:
                        other.resume_background()
                    line = (f"{side}: {len(pods) / wall:.1f} decisions/s, p50 {statistics.median(lat):.3f} ms, p99 "
                            f"{float(np.percentile(lat, 99)):.3f} ms")
                    if side == "on":
                        traces, _ = on.scheduler.tracer.completed_since(cursor)
                        solve_ms = [span["durationMs"] for span in
                                    (find_span(tr["root"], "speculation.solve") for tr in traces) if span]
                        spec = counts_since(speculation_outcomes(on), spec0)
                        results = counts_since(engine.stats()["commit_results"], results0)
                        launched = speculator_launches()
                        if spec.get("error", 0):
                            raise SystemExit(f"phase concurrent: (b) speculation errors {spec}")
                        launches[kname] += launched["queue"]
                        launches[kname + "_checkpointed"] += qk.launch_counts[kname + "_checkpointed"]
                        waits = [a - b for a, b in zip(ticket_wait(on), waits0)]
                        hits = results.get("seq-hit", 0) + results.get("memcmp-hit", 0)
                        conflicts = sum(results.get(r, 0) for r in CONFLICT_RESULTS)
                        line += (f"; speculations {spec}; commits hit {hits} / conflict {conflicts} / serial "
                                 f"{results.get('serial', 0)}; ticket wait mean {waits[1] / waits[0] * 1e3:.3f} ms over "
                                 f"{waits[0]} commits (the engine's histogram); "
                                 f"speculation.solve p50 "
                                 f"{statistics.median(solve_ms) if solve_ms else float('nan'):.3f} ms "
                                 f"({len(solve_ms)} spans); {launched['queue']} {kname} launches on the "
                                 f"speculators' streams")
                    lines.append(line)
                log(f"phase concurrent: (b) {policy} {segment}, {clients} client(s), {len(pods)} Filters a server: "
                    + " | ".join(lines) + f" | {smi}")
        if engine.speculator.inflight():
            raise SystemExit("phase concurrent: a speculation is still in flight")
    finally:
        for server in servers.values():
            server.stop()
        logging.disable(logging.NOTSET)

    # (c) the card's side: k launches at once on k streams
    concurrent_launches(queue_args, smi)
    # (d) the crash matrix, every cell with the engine on
    for kname, n in crash_matrix_cells(smi, crash_cpu).items():
        launches[kname] += n
    log(f"phase concurrent: the phase's path launched {launches} | {smi}")
    return launches


# -- phase sim: the discrete-event simulator on the card ---------------------

SIM_NODES = 10_000  # bench.py:60: the bench's cluster size
SIM_ZONES = ("zone1", "zone2", "zone3")
SIM_OPEN = 5  # nodes the cordon at t = 1 leaves schedulable
SIM_DURATION = 90.0  # virtual seconds of (a); the cordon lifts at two-thirds of it
SIM_SEED = 15
SIM_SCENARIO = "examples/sim/concurrent.json"  # (b)
SIM_KERNEL = "fifo_queue_tightly"


def sim_backlog_scenario(duration: float) -> dict:
    """Phase sim (a): the bench's cluster (16 CPU / 32 Gi nodes in three
    zones) under ``tpu-batch``, bursts of large gangs that outlive the run,
    every node but SIM_OPEN cordoned at t = 1 so drivers queue behind the
    FIFO head, the cordon lifted at two-thirds of the run so the queue
    drains, and one node killed."""
    cordoned = SIM_NODES - SIM_OPEN
    return {
        "name": "sim-backlog-10k", "seed": SIM_SEED, "duration": duration, "retry_interval": 15,
        "binpack_algo": "tpu-batch", "fifo": True,
        "cluster": {"nodes": SIM_NODES, "cpu": "16", "memory": "32Gi", "zones": list(SIM_ZONES)},
        "workload": {"process": "burst", "burst_interval": duration / 2, "burst_size": 6, "burst_offset": 5,
                     "executors": {"min": 6, "max": 10}, "dynamic_fraction": 0.0,
                     "lifetime": {"min": 10 * duration, "max": 20 * duration}},
        "faults": [
            {"at": 1, "kind": "node_cordon", "count": cordoned},
            {"at": round(duration * 2 / 3), "kind": "node_uncordon", "count": cordoned},
            {"at": round(duration * 5 / 6), "kind": "node_kill", "count": 1},
        ],
    }


def sim_phase(smi: str, twin: CpuTwin) -> dict:
    """Phase sim (see the module docstring).  Its cpu runs go to the twin
    process, beside the cuda runs.  Returns the queue kernels' launches of
    its cuda runs; raises SystemExit on any failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.sim import Scenario, Simulation

    # every refused driver of the backlog logs a line a round, and (b)'s
    # lease partition an error a renewal
    logging.disable(logging.ERROR)
    launches = {}

    def run(what: str, spec: dict, device: str):
        """One simulation in this process; logs its figures and returns
        (result, launches by kernel name)."""
        for module in (qk, mk):
            module.reset_launch_counts()
        t = time.perf_counter()
        result = Simulation(Scenario.from_dict(spec), device=device).run()
        wall = time.perf_counter() - t
        counts = {k: v for k, v in {**qk.launch_counts, **mk.launch_counts}.items() if v}
        report(what, device, result, wall, counts)
        return result, counts

    def twin_run(what: str, pending):
        """The twin's simulation on the cpu; logs its figures and returns
        (result, no launches)."""
        result, wall = pending.get(timeout=1800)
        report(what, "cpu", result, wall, {})
        return result, {}

    def report(what: str, device: str, result, wall: float, counts: dict) -> None:
        s = result.summary
        lat = s["decision_latency_ms"]
        log(f"phase sim: {what} on {device}: {s['events_logged']} events, {s['decisions']} decisions, "
            f"{wall:.1f} s wall ({wall * 1e3 / max(s['events_logged'], 1):.1f} host ms an event), decision "
            f"latency p50 {lat['p50']:.3f} / p99 {lat['p99']:.3f} ms (host clock), queue depth max "
            f"{s['queue_depth']['max']}, violations {len(result.violations)}, launches {counts}, "
            f"digest {result.digest} | {smi}")
        if result.violations:
            raise SystemExit(f"phase sim: {what} on {device}: violations {result.violations[:5]}")
        if device == "cuda":
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v

    try:
        # (a) a backlog at the bench's cluster size, cuda against a cpu
        # twin; (b) the concurrent example on cuda, cpu, and cuda with the
        # engine off.  The cpu runs start in the twin process now.
        spec = sim_backlog_scenario(SIM_DURATION)
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), SIM_SCENARIO)) as f:
            conc = json.load(f)
        twin_a, twin_b = twin.submit(twin_simulation, spec), twin.submit(twin_simulation, conc)
        cuda, counts = run("(a) backlog", spec, "cuda")
        cpu, _ = twin_run("(a) backlog (twin process)", twin_a)
        if cuda.digest != cpu.digest:
            first = next((i for i, (x, y) in enumerate(zip(cuda.event_log, cpu.event_log)) if x != y), None)
            raise SystemExit(f"phase sim: (a) digests differ on cuda and cpu (first differing event {first})")
        depth = cuda.summary["queue_depth"]["max"]
        if depth < SIM_OPEN:
            raise SystemExit(f"phase sim: (a) queue depth max {depth} < {SIM_OPEN}: no backlog formed")
        if counts.get(SIM_KERNEL + "_checkpointed", 0) < 1:
            raise SystemExit(f"phase sim: (a) no checkpointed {SIM_KERNEL} launch on the card: {counts}")
        log(f"phase sim: (a) {SIM_NODES} nodes, {SIM_DURATION:.0f} virtual s: digests equal on cuda and cpu, "
            f"0 violations, queue depth max {depth}, {counts[SIM_KERNEL + '_checkpointed']} checkpointed "
            f"{SIM_KERNEL} launches on the card")

        serial = {k: v for k, v in conc.items() if k != "concurrent"}
        engine, _ = run("(b) concurrent.json", conc, "cuda")
        spec_launches = speculator_launches()
        off, _ = run("(b) concurrent.json without its concurrent block", serial, "cuda")
        host, _ = twin_run("(b) concurrent.json (twin process)", twin_b)
        digests = {engine.digest, host.digest, off.digest}
        if len(digests) != 1:
            raise SystemExit(f"phase sim: (b) digests differ: engine {engine.digest}, cpu {host.digest}, "
                             f"serial {off.digest}")
        if spec_launches["queue"] < 1:
            raise SystemExit(f"phase sim: (b) no speculation launched on its own stream: {spec_launches}")
        log(f"phase sim: (b) {SIM_SCENARIO}: the engine's digest on cuda equal to cpu and to the serial "
            f"extender's, {spec_launches['queue']} speculations' launches on {spec_launches['streams']} "
            f"streams of their own")
    finally:
        logging.disable(logging.NOTSET)
    return launches


# -- phase lab: the policy lab and its regression gate on the card's host ----

LAB_DIR = "examples/lab/"
LAB_BASELINE = "tests/baselines/matrix_smoke.json"
LAB_WORKERS = 2  # (a): spawned worker processes, as the CI gate's run
LAB_VERIFY = 2  # (a): cells re-run in-process against the workers' digests
# (b): full_matrix.json's two corner cells, every axis off and every axis
# on, over the whole week trace: the reference's run_cell digest and event
# count on the same trace
LAB_CORNERS = {
    "fifo-nopre-nobf-w-d5c449-as-off": (
        "c3c1f6d228c29f26b8167890f4ac13c9d2e37706b31f55db8102b9123fc15f5b", 268_099),
    "drf-pre-bf-w-d5c449-as120": (
        "611d2acedb46d0b60cec6e259b8814983e76ab5573789c7873f183aa5dc1e20e", 285_273),
}


def rss_mib() -> tuple:
    """(resident MiB from /proc/self/status, peak resident MiB from
    getrusage) of this process."""
    import resource

    rss = 0.0
    with open("/proc/self/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key == "VmRSS":
                rss = int(value.split()[0]) / 1024
    return rss, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


class LabWorker:
    """One spawned lab worker, started with the runner's own initializer
    (the lab's import and the trace's parse) while the parent goes on:
    ``startup`` is the seconds from the pool's start to the worker's
    first answer (the interpreter, this script's imports as the worker's
    main module, torch among them, then the initializer)."""

    def __init__(self, trace: str):
        import multiprocessing

        from k8s_spark_scheduler_tpu_torch.lab import runner

        self.runner = runner
        self.t0 = time.perf_counter()
        self.answered = None
        self.pool = multiprocessing.get_context("spawn").Pool(
            1, initializer=runner._worker_init, initargs=(trace, 0))
        self.first = self.pool.apply_async(os.getpid, callback=self._answer)

    def _answer(self, _pid) -> None:
        self.answered = time.perf_counter()

    def finish(self, cfg: dict) -> tuple:
        """(start-up seconds, whether the worker has a CUDA context after
        running the cell ``cfg``)."""
        self.first.get(timeout=600)
        self.pool.apply(self.runner._worker_run, ({"cfg": cfg},))
        return self.answered - self.t0, self.pool.apply(torch.cuda.is_initialized)

    def stop(self) -> None:
        self.pool.terminate()
        self.pool.join()


def lab_phase(smi: str) -> None:
    """Phase lab (see the module docstring).  The lab is host-only:
    raises SystemExit on a digest that differs, a gate exit code that
    differs, a worker with a CUDA context or a kernel launched."""
    import tempfile

    from k8s_spark_scheduler_tpu_torch.lab import MatrixSpec, SynthSpec, run_cell, run_matrix, synthesize
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.ops import single_az_kernel as sk
    from k8s_spark_scheduler_tpu_torch.sim.workload import dump_trace
    from k8s_spark_scheduler_tpu_torch.tools import policy_regression

    root = os.path.dirname(os.path.abspath(__file__))

    def spec_of(name: str) -> dict:
        with open(os.path.join(root, LAB_DIR, name)) as f:
            return json.load(f)

    def launched() -> int:
        return sum(qk.launch_counts.values()) + sum(mk.launch_counts.values()) + sum(sk.launch_counts.values())

    def cells_line(what: str, matrix: dict) -> None:
        for c in matrix["cells"]:
            log(f"phase lab: {what} {c['cell']}: {c['events']} events in {c['wallSeconds']:.3f} s "
                f"({c['events'] / max(c['wallSeconds'], 1e-9):.0f} events/s), digest {c['digest'][:16]} | {smi}")

    t_phase = time.perf_counter()
    launches_before = launched()
    rss_before = rss_mib()
    with open(os.path.join(root, LAB_BASELINE)) as f:
        baseline = [(c["cell"], c["digest"]) for c in json.load(f)["cells"]]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-lab-") as workdir:
        # (a) the smoke matrix: in-process, then over spawned workers
        t = time.perf_counter()
        apps = synthesize(SynthSpec.from_dict(spec_of("smoke_synth.json")))
        trace = os.path.join(workdir, "smoke.jsonl")
        dump_trace(apps, trace)
        log(f"phase lab: (a) smoke_synth.json: {len(apps)} arrivals synthesized and written in "
            f"{time.perf_counter() - t:.3f} s")
        worker = LabWorker(trace)
        try:
            smoke = spec_of("smoke_matrix.json")
            t = time.perf_counter()
            local = run_matrix(MatrixSpec.from_dict(smoke), apps=apps)
            log(f"phase lab: (a) smoke_matrix.json in-process: {len(local['cells'])} cells on "
                f"{smoke['cluster']['nodes']} nodes in {time.perf_counter() - t:.3f} s")
            cells_line("(a) in-process", local)
            got = [(c["cell"], c["digest"]) for c in local["cells"]]
            if got != baseline:
                raise SystemExit(f"phase lab: (a) in-process digests {got} differ from {LAB_BASELINE}'s {baseline}")
            t = time.perf_counter()
            spread = run_matrix(MatrixSpec.from_dict(dict(smoke, trace=trace)), workers=LAB_WORKERS,
                                verify=LAB_VERIFY)
            wall = time.perf_counter() - t
            verification = spread.get("verification", {})
            got = [(c["cell"], c["digest"]) for c in spread["cells"]]
            if got != baseline or not verification.get("ok") or len(verification.get("cells", [])) != LAB_VERIFY:
                raise SystemExit(f"phase lab: (a) workers={LAB_WORKERS} verify={LAB_VERIFY}: digests {got}, "
                                 f"verification {verification}")
            log(f"phase lab: (a) workers={LAB_WORKERS} verify={LAB_VERIFY}: {wall:.3f} s (spawn, the workers' "
                f"import and trace parse, the cells, {LAB_VERIFY} re-runs in-process); digests equal "
                f"{LAB_BASELINE}'s and the in-process run's, verification ok")
            cells_line(f"(a) workers={LAB_WORKERS}", spread)
            startup, cuda_context = worker.finish(MatrixSpec.from_dict(smoke).expand()[0].cfg)
        finally:
            worker.stop()
        log(f"phase lab: a spawned worker answered {startup:.3f} s after its start (the interpreter, this "
            f"script's imports with torch's, the lab's import and a {len(apps)}-app trace parse; started "
            f"beside the runs above); CUDA context in the worker after a cell: {cuda_context}")
        if cuda_context:
            raise SystemExit("phase lab: a lab worker opened a CUDA context")

        # the port's gate on that document: 0, then 1 with one KPI altered
        current = os.path.join(workdir, "matrix.json")
        with open(current, "w") as f:
            json.dump(local, f)
        clean = policy_regression.main(["--matrix-current", current])
        altered = json.loads(json.dumps(local))
        altered["cells"][0]["kpis"]["wait_seconds"]["p50"] += 1.0
        drifted = os.path.join(workdir, "drifted.json")
        with open(drifted, "w") as f:
            json.dump(altered, f)
        drift = policy_regression.main(["--matrix-current", drifted])
        if (clean, drift) != (0, 1):
            raise SystemExit(f"phase lab: the gate exited {clean} on the smoke matrix (0 expected) and {drift} "
                             "with one KPI altered (1 expected)")
        log(f"phase lab: (a) the port's gate: exit 0 against {LAB_BASELINE}, exit 1 with "
            f"{altered['cells'][0]['cell']}'s wait p50 altered")

    # (b) the week trace's corner cells on full_matrix.json's 96 nodes
    t = time.perf_counter()
    week = synthesize(SynthSpec.from_dict(spec_of("week_synth.json")))
    log(f"phase lab: (b) week_synth.json: {len(week)} arrivals synthesized in {time.perf_counter() - t:.3f} s")
    full = MatrixSpec.from_dict(spec_of("full_matrix.json"))
    cfgs = {c.cell_id: c.cfg for c in full.expand()}
    for cell_id, (want, want_events) in LAB_CORNERS.items():
        doc = run_cell(week, cfgs[cell_id]).to_dict()
        log(f"phase lab: (b) {cell_id} on {full.cluster['nodes']} nodes: {doc['events']} events in "
            f"{doc['wallSeconds']:.3f} s ({doc['events'] / max(doc['wallSeconds'], 1e-9):.0f} events/s), "
            f"digest {doc['digest']} | {smi}")
        if (doc["digest"], doc["events"]) != (want, want_events):
            raise SystemExit(f"phase lab: (b) {cell_id}: digest {doc['digest']} ({doc['events']} events), "
                             f"the reference's {want} ({want_events})")
    if launched() != launches_before:
        raise SystemExit(f"phase lab: {launched() - launches_before} kernel launches in a host-only phase")
    rss_after = rss_mib()
    log(f"phase lab: (b) the corner digests equal the reference's; parent RSS {rss_before[0]:.0f} MiB before, "
        f"{rss_after[0]:.0f} MiB after, peak {rss_after[1]:.0f} MiB (the whole script's, getrusage); 0 kernel "
        f"launches; "
        f"the phase {time.perf_counter() - t_phase:.1f} s | {smi}")


# -- phase classes: class-compressed stepping ---------------------------------------

CLASSES_NODES, CLASSES_APPS = 100_000, 10_000  # (a): bench.py:1130-1168, the reference's class lane
CLASSES_CHECK_NODES, CLASSES_CHECK_APPS = 20_480, 1_000  # (b), (c): the 10,240 bucket twice, past 20,000
CLASSES_STRIDE = 64  # the session's checkpoint stride (ops/deltasolve.py)
CLASSES_SUFFIX = 6 * CLASSES_STRIDE  # (b): the suffix pass starts at this queue position
CLASSES_STREAM_STEPS = 10  # (c): delta-stream steps a policy
CLASSES_SERVER_FILTERS = 4  # (d): queued drivers' Filters on each server
CLASSES_REPS = 3  # CUDA-event timings of each launch
CLASSES_ODD_CASES = ((7, 20), (300, 100), (2000, 300))  # random_queue's odd inputs
CLASSES_CROSS_NODES = 40_960  # (g): the crossover point, x CLASSES_CHECK_APPS
CLASSES_CROSSING_K = 520  # (e): executors an app, past the 512-node rebuild limit
CLASS_POLICIES = {0: "tightly-pack", 1: "distribute-evenly", 2: "minimal-fragmentation"}
ROW_KERNEL = {0: "fifo_queue_tightly", 1: "fifo_queue_evenly", 2: "fifo_queue_min_frag"}


def class_fleet(n: int, a: int):
    """bench.py:1153-1168's class-lane inputs at n nodes x a apps: seed 20,
    24 machine shapes, 2 % near-duplicates one unit off, 5 % not exec_ok;
    (avail, driver_rank, exec_ok, packed [a, 8])."""
    rng = np.random.RandomState(20)
    shapes = rng.randint(20, 200, size=(24, 3)).astype(np.int32)
    avail = shapes[rng.randint(0, 24, size=n)].copy()
    near = rng.choice(n, size=max(1, n // 50), replace=False)
    avail[near, rng.randint(0, 3, size=len(near))] += 1
    rank = np.arange(n, dtype=np.int32)
    rng.shuffle(rank)
    eok = rng.rand(n) > 0.05
    drv = rng.randint(0, 3, size=(a, 3)).astype(np.int32)
    exe = rng.randint(1, 5, size=(a, 3)).astype(np.int32)
    cnt = rng.randint(1, 8, size=a).astype(np.int32)
    packed = np.hstack([drv, exe, cnt[:, None], np.ones((a, 1), np.int32)]).astype(np.int32)
    return avail, rank, eok, packed


def class_cases():
    """tests/torch_class_cases.py (the budget-crossing queue and its
    placements), imported from its file."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_class_cases

    return torch_class_cases


def unique_fleet(n: int, a: int):
    """class_fleet with every node's triple moved by -20..20 (as phase
    classes (c)'s churn moves its basis): nearly every node a class."""
    avail, rank, eok, packed = class_fleet(n, a)
    rng = np.random.RandomState(21)
    return np.maximum(avail + rng.randint(-20, 21, size=avail.shape), 0).astype(np.int32), rank, eok, packed


def crossing_queue():
    """Phase classes (e)'s queue at the launch's whole shared-memory budget."""
    cases = class_cases()
    return cases.budget_crossing(cases.real_budget_pairs(CLASSES_CROSSING_K), CLASSES_CROSSING_K)


def twin_classes_plain() -> dict:
    """Phase classes' plain halves, in the twin: per policy, (b) the class
    pass's plain version over the whole queue (outputs, checkpoints,
    evidence, seconds) and over the suffix from its own checkpoint at
    CLASSES_SUFFIX; (e) and (f) the plain pass over the crossing and the
    unique-node queues, (e) with the placements the kernel must make."""
    from k8s_spark_scheduler_tpu_torch.ops import class_kernel as ck
    from k8s_spark_scheduler_tpu_torch.ops.fifo_session import MAX_CHECKPOINTS, class_pass

    def plain_pass(p, arrays):
        avail_, rank_, eok_, packed_ = arrays
        st_ = ck.ClassState(avail_.shape[0], "cpu")
        got = class_pass(p, torch.as_tensor(avail_), ck.candidates(torch.as_tensor(rank_)), torch.as_tensor(eok_),
                         packed_, st_, True)
        return tuple(x.numpy() for x in got), st_.evidence()

    crossing, unique = crossing_queue(), unique_fleet(CLASSES_CHECK_NODES, CLASSES_CHECK_APPS)
    smem = ck.dynamic_smem_bytes(crossing[0].shape[0])

    avail, rank, eok, packed = class_fleet(CLASSES_CHECK_NODES, CLASSES_CHECK_APPS)
    n = avail.shape[0]
    a_t, e_t = torch.as_tensor(avail), torch.as_tensor(eok)
    cand = ck.candidates(torch.as_tensor(rank))
    out = {}
    for p in CLASS_POLICIES:
        chk = torch.full((MAX_CHECKPOINTS, n, 3), -7, dtype=torch.int32)
        st = ck.ClassState(n, "cpu")
        t = time.perf_counter()
        f, d, after = class_pass(p, a_t, cand, e_t, packed, st, True, chk_base=0, chk_stride=CLASSES_STRIDE,
                                 chk_out=chk)
        seconds = time.perf_counter() - t
        start = chk[CLASSES_SUFFIX // CLASSES_STRIDE - 1].clone()
        chk_s = torch.full((MAX_CHECKPOINTS, n, 3), -7, dtype=torch.int32)
        st_s = ck.ClassState(n, "cpu")
        fs, ds, after_s = class_pass(p, start, cand, e_t, packed[CLASSES_SUFFIX:], st_s, True,
                                     chk_base=CLASSES_SUFFIX, chk_stride=CLASSES_STRIDE, chk_out=chk_s)
        out[p] = {"whole": tuple(x.numpy() for x in (f, d, after, chk)), "evidence": st.evidence(),
                  "seconds": seconds, "suffix": tuple(x.numpy() for x in (fs, ds, after_s, chk_s)),
                  "suffix_evidence": st_s.evidence(), "crossing": plain_pass(p, crossing),
                  "placements": class_cases().placements(*crossing, p, smem), "unique": plain_pass(p, unique)}
    return out


def class_launch_total() -> dict:
    from k8s_spark_scheduler_tpu_torch.ops import class_kernel as ck

    return dict(ck.launch_counts)


def classes_phase(seed: int, smi: str, plain: dict, servers_base: float, servers_cpu: dict,
                  device: str = "cuda") -> tuple:
    """Phase classes (see the module docstring): (a) the class kernels
    against the row kernels at 100,000 x 10,000, (b) against their plain
    version at 20,480 x 1,000 (`plain`: twin_classes_plain's result, from
    the twin), (c) class-mode
    sessions against row-mode ones, (d) the server with class stepping on
    against off, (j) servers on the default config at 20,480 nodes (the
    queue created from `servers_base`; `servers_cpu`: the server twins'
    twin_classes_servers by name).  Returns (the class kernels' entries of
    the kernels line, {row kernel: launches on (j)'s class-off servers});
    raises SystemExit on any failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.config import ClassesConfig
    from k8s_spark_scheduler_tpu_torch.ops import class_kernel as ck
    from k8s_spark_scheduler_tpu_torch.ops.fifo_session import (MAX_CHECKPOINTS, FifoSession, class_pass,
                                                                 queue_pass)

    dev = torch.device(device)
    t_phase = time.perf_counter()

    def row_and_class(p, planes, rank_t, eok_t, cand, packed):
        """One row-kernel and one class-kernel pass (a fresh partition):
        outputs, the evidence."""
        st = ck.ClassState(planes.shape[0], dev)
        got = class_pass(p, planes, cand, eok_t, packed, st, True)
        want = queue_pass(p, planes, rank_t, eok_t, packed)
        torch.cuda.synchronize()
        return got, want, st.evidence()

    def times(p, planes, rank_t, eok_t, cand, packed):
        st = ck.ClassState(planes.shape[0], dev)
        cls_ms = [time_cuda(lambda: class_pass(p, planes, cand, eok_t, packed, st, True), 1)
                  for _ in range(CLASSES_REPS)]
        row_ms = [time_cuda(lambda: queue_pass(p, planes, rank_t, eok_t, packed), 1) for _ in range(CLASSES_REPS)]
        return cls_ms, row_ms

    # odd inputs first (random_queue: negative availability, k = 0, zero
    # requests, invalid apps, non-candidates): each class kernel against
    # its plain version and the row kernel
    for ci, (n, a) in enumerate(CLASSES_ODD_CASES):
        arrays = random_queue(np.random.RandomState(seed * 1000 + 990 + ci), n, a)
        packed = np.hstack([arrays[3], arrays[4], arrays[5][:, None], arrays[6][:, None]]).astype(np.int32)
        planes, rank_t, eok_t = on(dev, arrays[:3])
        cand = ck.candidates(rank_t)
        for p in CLASS_POLICIES:
            got, want, ev = row_and_class(p, planes, rank_t, eok_t, cand, packed)
            st = ck.ClassState(n, "cpu")
            ref = class_pass(p, planes.cpu(), cand.cpu(), eok_t.cpu(), packed, st, True)
            if compare(got, want) or compare(got, on(dev, ref)) or ev != st.evidence():
                raise SystemExit(f"phase classes: {ck.KERNEL_NAMES[p]} differs from its plain version or "
                                 f"{ROW_KERNEL[p]} on odd inputs N={n} A={a}")
        log(f"phase classes: odd inputs N={n} A={a}: the class kernels equal their plain version (outputs, "
            f"evidence) and the row kernels")

    # (a) the reference's bench shape: class kernel = row kernel, both timed
    avail, rank, eok, packed = class_fleet(CLASSES_NODES, CLASSES_APPS)
    planes, rank_t, eok_t = on(dev, (avail, rank, eok))
    cand = ck.candidates(rank_t)
    for p, name in CLASS_POLICIES.items():
        got, want, ev = row_and_class(p, planes, rank_t, eok_t, cand, packed)
        if compare(got, want):
            raise SystemExit(f"phase classes: (a) {ck.KERNEL_NAMES[p]} differs from {ROW_KERNEL[p]} at "
                             f"{CLASSES_NODES} x {CLASSES_APPS}")
        cls_ms, row_ms = times(p, planes, rank_t, eok_t, cand, packed)
        log(f"phase classes: (a) {name} {CLASSES_NODES} x {CLASSES_APPS}: {int(got[0].sum())} feasible, class "
            f"kernel byte-equal to the row kernel; class {statistics.median(cls_ms):.3f} ms (runs "
            f"{', '.join(f'{x:.3f}' for x in cls_ms)}), row {statistics.median(row_ms):.3f} ms (runs "
            f"{', '.join(f'{x:.3f}' for x in row_ms)}); evidence {ev}, compression "
            f"{CLASSES_NODES / ev['classes_initial']:.1f} nodes a class | {smi}")
    del planes, rank_t, eok_t, cand

    # (b) against the plain version at 20,480 x 1,000: whole queue and a
    # suffix from a checkpoint, every checkpoint compared
    avail, rank, eok, packed = class_fleet(CLASSES_CHECK_NODES, CLASSES_CHECK_APPS)
    n = avail.shape[0]
    planes, rank_t, eok_t = on(dev, (avail, rank, eok))
    cand = ck.candidates(rank_t)
    n_valid = int(packed[:, 7].sum())
    n_bytes = 4 * 3 * n * 2 + n + 4 * int(cand.shape[0]) + packed.nbytes + 5 * packed.shape[0]
    timing, max_err = {}, {}
    for p, name in CLASS_POLICIES.items():
        kname = ck.KERNEL_NAMES[p]
        want = plain[p]
        chk = torch.full((MAX_CHECKPOINTS, n, 3), -7, dtype=torch.int32, device=dev)
        st = ck.ClassState(n, dev)
        got = class_pass(p, planes, cand, eok_t, packed, st, True, chk_base=0, chk_stride=CLASSES_STRIDE,
                         chk_out=chk)
        torch.cuda.synchronize()
        got_np = tuple(x.cpu().numpy() for x in got + (chk,))
        max_err[kname] = compare(got + (chk,), on(dev, want["whole"]))
        if max_err[kname] or st.evidence() != want["evidence"]:
            raise SystemExit(f"phase classes: (b) {kname} differs from its plain version (outputs and checkpoints "
                             f"by {max_err[kname]}, evidence {st.evidence()} vs {want['evidence']})")
        start = chk[CLASSES_SUFFIX // CLASSES_STRIDE - 1].clone()
        chk_s = torch.full((MAX_CHECKPOINTS, n, 3), -7, dtype=torch.int32, device=dev)
        st_s = ck.ClassState(n, dev)
        got_s = class_pass(p, start, cand, eok_t, packed[CLASSES_SUFFIX:], st_s, True, chk_base=CLASSES_SUFFIX,
                           chk_stride=CLASSES_STRIDE, chk_out=chk_s)
        torch.cuda.synchronize()
        got_s_np = tuple(x.cpu().numpy() for x in got_s + (chk_s,))
        if not all(np.array_equal(g, w) for g, w in zip(got_s_np, want["suffix"])) \
                or st_s.evidence() != want["suffix_evidence"]:
            raise SystemExit(f"phase classes: (b) {kname}'s suffix pass differs from its plain version")
        if not (np.array_equal(got_s_np[0], got_np[0][CLASSES_SUFFIX:])
                and np.array_equal(got_s_np[1], got_np[1][CLASSES_SUFFIX:])
                and np.array_equal(got_s_np[2], got_np[2])
                and np.array_equal(got_s_np[3][CLASSES_SUFFIX // CLASSES_STRIDE:],
                                   got_np[3][CLASSES_SUFFIX // CLASSES_STRIDE:])):
            raise SystemExit(f"phase classes: (b) {kname}'s suffix pass differs from the whole-queue pass")
        row = queue_pass(p, planes, rank_t, eok_t, packed)
        if compare(got, row):
            raise SystemExit(f"phase classes: (b) {kname} differs from {ROW_KERNEL[p]}")
        cls_ms, row_ms = times(p, planes, rank_t, eok_t, cand, packed)
        ev = st.evidence()
        # the app's capacity formula once a class instead of once a node
        ops = n_valid * ev["classes_last"] * OPS_PER_NODE_VALID_APP
        timing[kname] = (cls_ms, want["seconds"] * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3)
        log(f"phase classes: (b) {name} {n} x {CLASSES_CHECK_APPS}: {kname} equal to its plain version (outputs, "
            f"{MAX_CHECKPOINTS} checkpoint slots, evidence {ev}), its suffix pass from position {CLASSES_SUFFIX} "
            f"too (evidence {st_s.evidence()}), and to {ROW_KERNEL[p]}; class {statistics.median(cls_ms):.3f} ms "
            f"(runs {', '.join(f'{x:.3f}' for x in cls_ms)}), row {statistics.median(row_ms):.3f} ms (runs "
            f"{', '.join(f'{x:.3f}' for x in row_ms)}), plain {want['seconds'] * 1e3:.1f} ms (twin) | {smi}")

    # (e) the partition outgrows shared memory at a rebuild and fits again
    # at a later one, inside one launch; (f) every node unique
    crossing, unique = crossing_queue(), unique_fleet(CLASSES_CHECK_NODES, CLASSES_CHECK_APPS)
    for label, arrays in (("crossing", crossing), ("unique", unique)):
        c_planes, c_rank, c_eok = on(dev, arrays[:3])
        c_cand, c_packed, c_n = ck.candidates(c_rank), arrays[3], arrays[0].shape[0]
        for p, name in CLASS_POLICIES.items():
            kname = ck.KERNEL_NAMES[p]
            st = ck.ClassState(c_n, dev)
            got = class_pass(p, c_planes, c_cand, c_eok, c_packed, st, True)
            row = queue_pass(p, c_planes, c_rank, c_eok, c_packed)
            torch.cuda.synchronize()
            ev = st.evidence()
            want, want_ev = plain[p][label]
            if compare(got, row) or compare(got, on(dev, want)) or ev != want_ev:
                raise SystemExit(f"phase classes: ({label}) {kname} differs from its plain version or "
                                 f"{ROW_KERNEL[p]} at {c_n} x {c_packed.shape[0]}")
            placed = st.placements()
            if label == "crossing" and dev.type == "cuda":  # the plain version places nothing
                expect = plain[p]["placements"]
                if placed != {"shared": expect["shared"], "global": expect["global"]} or not expect["global"] \
                        or expect["shared"] < 2:
                    raise SystemExit(f"phase classes: (e) {kname} placed the partition {placed}, the rule "
                                     f"{expect}")
            cls_ms, row_ms = times(p, c_planes, c_rank, c_eok, c_cand, c_packed)
            log(f"phase classes: ({'e' if label == 'crossing' else 'f'}) {name} {label} {c_n} x "
                f"{c_packed.shape[0]}: {kname} equal to its plain version (outputs, evidence {ev}) and to "
                f"{ROW_KERNEL[p]}; placements {placed}"
                + (f" (classes at the builds {plain[p]['placements']['classes']})" if label == "crossing" else "")
                + f"; class {statistics.median(cls_ms):.3f} ms, row {statistics.median(row_ms):.3f} ms | {smi}")
        del c_planes, c_rank, c_eok, c_cand

    # (i) where a step's time goes at 20,480 x 1,000: the same queue with
    # every app invalid (the loop), with k past any total (pass A: values
    # and probe, no driver), with k = 0 (pass A and the driver's row), whole
    avail, rank, eok, packed = class_fleet(CLASSES_CHECK_NODES, CLASSES_CHECK_APPS)
    i_planes, i_rank, i_eok = on(dev, (avail, rank, eok))
    i_cand = ck.candidates(i_rank)
    variants = {"invalid": (7, 0), "pass A": (6, 2**30), "k=0": (6, 0), "whole": (None, None)}
    for p, name in CLASS_POLICIES.items():
        pieces = {}
        for label, (col, value) in variants.items():
            queue = packed.copy()
            if col is not None:
                queue[:, col] = value
            st = ck.ClassState(CLASSES_CHECK_NODES, dev)
            pieces[label] = statistics.median(
                time_cuda(lambda: class_pass(p, i_planes, i_cand, i_eok, queue, st, True), 1)
                for _ in range(CLASSES_REPS))
        log(f"phase classes: (i) {name} {CLASSES_CHECK_NODES} x {CLASSES_CHECK_APPS} by piece: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in pieces.items())
            + f"; per app: loop {pieces['invalid'] / CLASSES_CHECK_APPS * 1e3:.2f} us, pass A "
            f"{(pieces['pass A'] - pieces['invalid']) / CLASSES_CHECK_APPS * 1e3:.2f} us, the driver's row "
            f"{(pieces['k=0'] - pieces['pass A']) / CLASSES_CHECK_APPS * 1e3:.2f} us, the rest "
            f"{(pieces['whole'] - pieces['k=0']) / CLASSES_CHECK_APPS * 1e3:.2f} us | {smi}")
    del i_planes, i_rank, i_eok, i_cand

    # (g) the crossover at 40,960 x 1,000 and (h) the serial floor at
    # 1,024 x 1,000, both on bench.py's fleet
    floor = {}
    for label, n_nodes in (("g", CLASSES_CROSS_NODES), ("h", FLOOR_NODES)):
        g_arrays = class_fleet(n_nodes, CLASSES_CHECK_APPS)
        g_planes, g_rank, g_eok = on(dev, g_arrays[:3])
        g_cand = ck.candidates(g_rank)
        for p, name in CLASS_POLICIES.items():
            kname = ck.KERNEL_NAMES[p]
            got, row, ev = row_and_class(p, g_planes, g_rank, g_eok, g_cand, g_arrays[3])
            if compare(got, row):
                raise SystemExit(f"phase classes: ({label}) {kname} differs from {ROW_KERNEL[p]} at {n_nodes} nodes")
            cls_ms, row_ms = times(p, g_planes, g_rank, g_eok, g_cand, g_arrays[3])
            if label == "h":
                floor[kname] = statistics.median(cls_ms)
            log(f"phase classes: ({label}) {name} {n_nodes} x {CLASSES_CHECK_APPS}: {kname} byte-equal to "
                f"{ROW_KERNEL[p]}, evidence {ev}; class {statistics.median(cls_ms):.3f} ms (runs "
                f"{', '.join(f'{x:.3f}' for x in cls_ms)}), row {statistics.median(row_ms):.3f} ms (runs "
                f"{', '.join(f'{x:.3f}' for x in row_ms)}) | {smi}")
        del g_planes, g_rank, g_eok, g_cand

    # (c) and (d) are the class kernels' main path: every count at 0 first
    ck.reset_launch_counts()

    # (c) a class-mode session and a row-mode one on the card replay one
    # random delta stream (tests/test_torch_class_compression.py's ops)
    for p, name in CLASS_POLICIES.items():
        rng = np.random.RandomState(seed * 100 + p)
        cls_s, row_s = FifoSession(device=dev), FifoSession(device=dev)
        cls_s.set_classes(True)
        basis = avail.copy()
        rows = packed.copy()
        for s in (cls_s, row_s):
            s.load(basis, rank, eok, p, stride=CLASSES_STRIDE)
        ops = []
        for step in range(CLASSES_STREAM_STEPS):
            op = int(rng.randint(0, 5)) if step else -1
            if op == 0 and len(rows) > 1:
                rows = rows[1:]
            elif op == 1:
                k = int(rng.randint(1, 4))
                more = np.hstack([rng.randint(0, 3, size=(k, 3)), rng.randint(1, 5, size=(k, 3)),
                                  rng.randint(1, 8, size=(k, 1)), np.ones((k, 1))]).astype(np.int32)
                rows = np.vstack([rows, more])
            elif op == 2:
                rows = rows.copy()
                rows[int(rng.randint(0, len(rows))), 3:6] = rng.randint(1, 5, size=3)
            elif op == 3:
                basis = np.maximum(basis + rng.randint(-20, 21, size=basis.shape), 0).astype(np.int32)
                for s in (cls_s, row_s):
                    s.load(basis, rank, eok, p, stride=CLASSES_STRIDE)
            got, want = cls_s.solve(rows), row_s.solve(rows)
            if not (np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
                    and torch.equal(got[3], want[3])):
                raise SystemExit(f"phase classes: (c) {name} step {step} (op {op}): the class-mode session "
                                 f"differs from the row-mode session")
            ops.append(f"{op}:{got[0]}")
        log(f"phase classes: (c) {name} at {n} nodes: class-mode and row-mode sessions equal at every step of "
            f"{CLASSES_STREAM_STEPS} (op:resume {' '.join(ops)}); class_stats {cls_s.class_stats()} | {smi}")

    # (d) the server path: one tpu-batch server stepping by class
    # (min-nodes 0) against one with class mode off (min-nodes above the
    # cluster), queued drivers' Filters byte-equal
    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    names, nodes, queue, rng, base = server_objects(seed)
    servers = {}
    try:
        servers["on"] = PortServer("tpu-batch", device, nodes, queue, classes=ClassesConfig(min_nodes=0))
        servers["off"] = PortServer("tpu-batch", device, nodes, queue)
        before = class_launch_total()
        lat = {"on": [], "off": []}
        for f in range(CLASSES_SERVER_FILTERS):
            pod = queue[int(rng.randint(N_APPS // 2, N_APPS))]
            answers = {}
            for side in (("on", "off") if f % 2 else ("off", "on")):
                ms, status, body = servers[side].post(pod, names)
                answers[side] = (status, body)
                lat[side].append(ms)
            if answers["on"] != answers["off"] or answers["on"][0] != 200:
                raise SystemExit(f"phase classes: (d) Filter {f}: on {answers['on'][1][:300]!r}, "
                                 f"off {answers['off'][1][:300]!r}")
        after = class_launch_total()
        rose = after["fifo_queue_classes_tightly"] - before["fifo_queue_classes_tightly"]
        sessions = list(servers["on"].scheduler.extender.delta_engine._sessions.values())
        if rose < 1 or not sessions or not all(s.use_classes for s in sessions):
            raise SystemExit(f"phase classes: (d) the class kernel launched {rose} times on the class-mode server")
        off_sessions = list(servers["off"].scheduler.extender.delta_engine._sessions.values())
        if any(s.use_classes for s in off_sessions):
            raise SystemExit("phase classes: (d) the server with class mode off stepped by class")
        log(f"phase classes: (d) tpu-batch server, {N_NODES} nodes x {N_APPS} queued drivers: "
            f"{CLASSES_SERVER_FILTERS} queued drivers' Filters byte-equal with class stepping on and off; "
            f"{rose} class-kernel launches on the on server; ms on {', '.join(f'{x:.1f}' for x in lat['on'])}, "
            f"off {', '.join(f'{x:.1f}' for x in lat['off'])}; session class_stats "
            f"{sessions[0].native.class_stats()} | {smi}")
    finally:
        for server in servers.values():
            server.stop()
        logging.disable(logging.NOTSET)

    # (j) the default classes config through servers past its threshold
    recorded, row_launches = classes_servers(seed, smi, servers_base, device)
    t = time.perf_counter()
    cpu = {policy: result.get(timeout=1800) for policy, result in servers_cpu.items()}
    log(f"phase classes: (j) waited {time.perf_counter() - t:.1f} s for the server twins' cpu servers")
    classes_server_check(recorded, cpu, smi)

    launches = class_launch_total()
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise SystemExit(f"phase classes: {missing} not launched on the main path ((c), (d) and (j))")
    log(f"phase classes: launches on the main path ((c), (d) and (j)) {launches}; the phase "
        f"{time.perf_counter() - t_phase:.1f} s | {smi}")
    entries = []
    for p in CLASS_POLICIES:
        kname = ck.KERNEL_NAMES[p]
        ms, plain_ms, t_bytes, t_ops = timing[kname]
        entries.append(kernel_entry(kname, "classes_min_frag" if p == 2 else "classes", launches[kname],
                                    max_err[kname], ms, plain_ms, t_bytes, t_ops, floor_ms=floor[kname]))
    return entries, row_launches


# phase classes (j): default class stepping through servers at 20,480 nodes
CLASSES_SERVER_NODES = 20_480  # bench.py's HTTP snapshot at the 20,480 bucket, past classes.min-nodes
CLASSES_SERVER_WARM, CLASSES_SERVER_NEW, CLASSES_SERVER_RETRIES = 2, 8, 8  # Filters a name
# the warmups' bodies and every CLASSES_SERVER_CPU_EVERY-th Filter's after
# them are held to a cpu server's, which answers them in a server twin
CLASSES_SERVER_CPU_EVERY = 4
# each tensor-lane name and its class kernel
CLASSES_SERVER_KERNEL = {"tpu-batch": "fifo_queue_classes_tightly",
                         "tpu-batch-distribute-evenly": "fifo_queue_classes_evenly",
                         "tpu-batch-minimal-fragmentation": "fifo_queue_min_frag_classes"}


def classes_server_compared(f: int) -> bool:
    """Whether phase classes (j)'s Filter f is held to the cpu server's."""
    return f < CLASSES_SERVER_WARM or (f - CLASSES_SERVER_WARM) % CLASSES_SERVER_CPU_EVERY == 0


def classes_server_filters(rng: np.random.RandomState, queue, pi: int, base: float) -> list:
    """Phase classes (j)'s Filters of one name, in order, drawn from `rng`:
    (the pods created for the Filter, each retired after it; the pod
    Filtered): the warmups and the new drivers, then retries of queued
    drivers (which leave their reservations)."""
    filters = []
    for f in range(CLASSES_SERVER_WARM + CLASSES_SERVER_NEW):
        pods = probe_pods(rng, f"classes-{pi}-{f:03d}", base + N_APPS + f)
        filters.append((pods[:1], pods[0]))
    for _ in range(CLASSES_SERVER_RETRIES):
        filters.append(([], queue[int(rng.randint(N_APPS // 2, N_APPS))]))
    return filters


def classes_servers(seed: int, smi: str, base: float, device: str = "cuda") -> tuple:
    """Phase classes (j) (see the module docstring), the card's half: for
    each tensor-lane name a server on the default ``classes`` config and
    one with class stepping off, at CLASSES_SERVER_NODES nodes (the queue
    created from `base`).  Returns ({policy: {Filter: (status, body)}},
    the bodies held to the server twins' cpu servers, and {row kernel:
    launches on the class-off servers}).  Raises SystemExit on any
    failure."""
    import logging

    from k8s_spark_scheduler_tpu_torch.config import ClassesConfig
    from k8s_spark_scheduler_tpu_torch.ops import class_kernel as ck
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk

    logging.disable(logging.WARNING)  # a queue 10,000 s old: every Filter would log a slow-pod line
    t0 = time.perf_counter()
    names, nodes, queue, rng, _ = server_objects(seed, CLASSES_SERVER_NODES, base)
    log(f"phase classes: (j) snapshot {len(nodes)} nodes in {N_ZONES} zones, {len(queue)} queued drivers built in "
        f"{time.perf_counter() - t0:.2f} s")
    recorded, row_launches = {}, {}
    try:
        for pi, (policy, ckname) in enumerate(CLASSES_SERVER_KERNEL.items()):
            rkname = SERVER_KERNEL[policy] + "_checkpointed"

            def counts():
                return ck.launch_counts[ckname], {**qk.launch_counts, **mk.launch_counts}[rkname]

            filters = classes_server_filters(rng, queue, pi, base)
            t0 = time.perf_counter()
            servers = {}
            try:
                servers["default"] = PortServer(policy, device, nodes, queue)
                servers["off"] = PortServer(policy, device, nodes, queue, classes=ClassesConfig(enabled=False))
                log(f"phase classes: (j) {policy}: default and class-off servers ready in "
                    f"{time.perf_counter() - t0:.2f} s")
                lat = {side: [] for side in servers}
                launched = {side: [0, 0] for side in servers}  # class, row kernel launches
                bodies = {}
                for f, (created, pod) in enumerate(filters):
                    for server in servers.values():
                        for p in created:
                            server.api.create(p.deepcopy())
                    answers = {}
                    for side in (("default", "off") if f % 2 else ("off", "default")):
                        before = counts()
                        ms, status, body = servers[side].post_alone(
                            [s for other, s in servers.items() if other != side], pod, names)
                        launched[side] = [n + a - b for n, a, b in zip(launched[side], counts(), before)]
                        answers[side] = (status, body)
                        if f >= CLASSES_SERVER_WARM:
                            lat[side].append(ms)
                    if answers["default"] != answers["off"] or answers["default"][0] != 200:
                        raise SystemExit(f"phase classes: (j) {policy} Filter {f} of {pod.name}: default "
                                         f"{answers['default'][1][:300]!r}, class stepping off "
                                         f"{answers['off'][1][:300]!r}")
                    if classes_server_compared(f):
                        bodies[f] = answers["default"]
                    if created:
                        for server in servers.values():
                            server.retire(created)
                sessions = {side: list(s.scheduler.extender.delta_engine._sessions.values())
                            for side, s in servers.items()}
                if not sessions["default"] or not all(s.use_classes for s in sessions["default"]):
                    raise SystemExit(f"phase classes: (j) {policy}: a session of the default server does not step "
                                     f"by class at {CLASSES_SERVER_NODES} nodes")
                if any(s.use_classes for s in sessions["off"]):
                    raise SystemExit(f"phase classes: (j) {policy}: the server with class stepping off stepped by class")
                if launched["default"][0] < 1 or launched["off"][1] < 1 or launched["off"][0]:
                    raise SystemExit(f"phase classes: (j) {policy}: launches (class, row) {launched}: want {ckname} on "
                                     f"the default server and {rkname} on the other")
                stats = [s.native.class_stats() for s in sessions["default"]]
                log(f"phase classes: (j) {policy} {CLASSES_SERVER_NODES} nodes x {N_APPS} queued drivers: "
                    f"{len(filters)} Filters ({CLASSES_SERVER_NEW} new drivers, {CLASSES_SERVER_RETRIES} retries of "
                    f"queued ones, after {CLASSES_SERVER_WARM} warmups) byte-equal on the default server and with "
                    f"class stepping off; launches (class, row) {launched}; class rebuilds "
                    f"{sum(s['rebuilds'] for s in stats)}; class_stats {stats} | {smi}")
                log(f"phase classes: (j) {policy}: /predicates p50 / p99 default "
                    f"{statistics.median(lat['default']):.3f} / {float(np.percentile(lat['default'], 99)):.3f} ms, "
                    f"class stepping off {statistics.median(lat['off']):.3f} / "
                    f"{float(np.percentile(lat['off'], 99)):.3f} ms (runs default "
                    f"{', '.join(f'{x:.1f}' for x in lat['default'])}; off "
                    f"{', '.join(f'{x:.1f}' for x in lat['off'])}) | {smi}")
                recorded[policy] = bodies
                row_launches[rkname] = launched["off"][1]
            finally:
                for server in servers.values():
                    server.stop()
    finally:
        logging.disable(logging.NOTSET)
    return recorded, row_launches


def twin_classes_servers(seed: int, base: float, policy: str) -> tuple:
    """Phase classes (j)'s cpu half for one name, in a server twin: a
    device="cpu" server on the default ``classes`` config and the same
    objects, through the same draws of the same random state (the earlier
    names' Filters drawn and dropped), answers the Filters
    classes_server_compared names, and every retry before the last of them
    (a retry leaves its reservation; a new driver is retired): ({Filter:
    (status, body)}, seconds)."""
    t = time.perf_counter()
    names, nodes, queue, rng, _ = server_objects(seed, CLASSES_SERVER_NODES, base)
    n_filters = CLASSES_SERVER_WARM + CLASSES_SERVER_NEW + CLASSES_SERVER_RETRIES
    last = max(f for f in range(n_filters) if classes_server_compared(f))
    pi = list(CLASSES_SERVER_KERNEL).index(policy)
    for earlier in range(pi):
        classes_server_filters(rng, queue, earlier, base)
    filters = classes_server_filters(rng, queue, pi, base)
    server = PortServer(policy, "cpu", nodes, queue)
    try:
        server.pause_background()
        bodies = {}
        for f, (created, pod) in enumerate(filters[: last + 1]):
            if created and not classes_server_compared(f):
                continue
            for p in created:
                server.api.create(p.deepcopy())
            _, status, body = server.post(pod, names)
            if classes_server_compared(f):
                bodies[f] = (status, body)
            if created:
                server.retire(created)
        return bodies, time.perf_counter() - t
    finally:
        server.stop()


def classes_server_check(recorded: dict, cpu: dict, smi: str) -> None:
    """Phase classes (j)'s bodies against the server twins' cpu servers
    (`cpu`: twin_classes_servers' result by name)."""
    for policy, bodies in recorded.items():
        want, twin_s = cpu[policy]
        if sorted(bodies) != sorted(want):
            raise SystemExit(f"phase classes: (j) {policy}: compared Filters {sorted(bodies)} vs {sorted(want)}")
        for f, answer in bodies.items():
            if answer != want[f]:
                raise SystemExit(f"phase classes: (j) {policy} Filter {f}: cuda {answer[1][:300]!r}, cpu "
                                 f"{want[f][1][:300]!r}")
        log(f"phase classes: (j) {policy}: Filters {sorted(bodies)} ({len(bodies)} bodies) equal to a cpu "
            f"server's on the default config (its Filters and start {twin_s:.1f} s in a server twin) | {smi}")


# -- phase mesh: GangPacker on a node-axis mesh ----------------------------------

MESH_SMALL_APPS = 16  # (a): min-frag and single-AZ at 10,240 x 16, the dry run's north-star shape
MESH_REPS = 3  # (a): timed solves of each 16-app program and of the fifo_queue launch
MESH_DRYRUN_RANKS = (2, 4)  # (b): gloo worlds whose ranks share the card


def mesh_rank(mesh, problem, az_inputs) -> list:
    """Phase mesh (a), in a world of one NCCL rank on the card: the sharded
    programs against the unsharded ones on phase 4's inputs.  Returns the
    log lines (the script logs them)."""
    from k8s_spark_scheduler_tpu_torch.models.gang_packer import GangPacker, GangPackerConfig
    from k8s_spark_scheduler_tpu_torch.ops import batch_solver as bs
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk

    qk.LIBRARY.load()  # built by the script: the file is there, nothing compiles
    dev = mesh.device
    if dev.type != "cuda":
        raise SystemExit(f"phase mesh: (a) the world's rank runs on {dev}, not on the card")
    n = problem.avail.shape[0]
    whole = lambda xs: [torch.as_tensor(x, device=dev) for x in xs]

    def timed(fn, reps):
        """(output, median ms, collectives a call) over `reps` calls, host
        clock around each up to a synchronize."""
        ms, before = [], mesh.collectives
        for _ in range(reps):
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return out, statistics.median(ms), (mesh.collectives - before) // reps

    def same(got, want, what):
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                raise SystemExit(f"phase mesh: (a) {what}: output {i} differs from the unsharded program")

    lines = [f"(a) a world of {mesh.size} {mesh.backend} rank on {torch.cuda.get_device_name(dev)}"]
    # 10,240 x 16 first: the first collective sets NCCL up, so each program
    # runs once untimed
    queue = (problem.avail, problem.driver_rank, problem.exec_ok, problem.driver, problem.executor,
             problem.count, problem.app_valid)
    small = [x[:MESH_SMALL_APPS] for x in queue[3:]]
    node = [mesh.shard(x) for x in queue[:3]]
    axis = mesh.axis(n)
    mf = lambda: bs.solve_queue_min_frag(*node, *map(mesh.replicate, small), axis=axis)
    mf_plain = lambda: bs.solve_queue_min_frag(*whole(queue[:3] + tuple(small)))
    timed(mf, 1)
    got, mesh_ms, spent = timed(mf, MESH_REPS)
    want, plain_ms, _ = timed(mf_plain, MESH_REPS)
    same((got.feasible, got.driver_idx, mesh.gather_nodes(got.avail_after), mesh.gather_nodes(got.exec_counts, 1)),
         (want.feasible, want.driver_idx, want.avail_after, want.exec_counts), "solve_queue_min_frag")
    lines.append(f"(a) solve_queue_min_frag N={n} A={MESH_SMALL_APPS}: {int(got.feasible.sum())} feasible, equal to "
                 f"the unsharded program; {mesh_ms:.1f} ms a solve ({spent} collectives), unsharded {plain_ms:.1f} ms")
    arrays, (scale_c, scale_g, n_zones) = az_inputs
    zone_masks = np.stack([arrays[3] == z for z in range(n_zones)])
    az_node = [arrays[i] for i in (0, 1, 2)]
    az_apps = [x[:MESH_SMALL_APPS] for x in arrays[4:8]]
    az_eff = list(arrays[8:12])
    for name, flags in (("az-aware", dict(az_aware=True)), ("min-frag strict", dict(minfrag=True, strict=True))):
        az = lambda: bs.solve_queue_single_az(
            *map(mesh.shard, az_node), mesh.shard(zone_masks, 1), *map(mesh.replicate, az_apps),
            *map(mesh.shard, az_eff), scale_c, scale_g, axis=axis, **flags)
        got, mesh_ms, spent = timed(az, MESH_REPS)
        want, plain_ms, _ = timed(lambda: bs.solve_queue_single_az(
            *whole(az_node), torch.as_tensor(zone_masks, device=dev), *whole(az_apps), *whole(az_eff),
            scale_c, scale_g, **flags), MESH_REPS)
        same(tuple(got[:4]) + (mesh.gather_nodes(got.avail_after),), want, f"solve_queue_single_az {name}")
        lines.append(f"(a) solve_queue_single_az {name} N={n} A={MESH_SMALL_APPS} zones={n_zones}: "
                     f"{int(got.feasible.sum())} placed, equal to the unsharded program; {mesh_ms:.1f} ms a solve "
                     f"({spent} collectives), unsharded {plain_ms:.1f} ms")
    # the main path's inputs: one timed solve of the mesh GangPacker (seconds)
    n_valid = int(problem.app_valid.sum())
    for policy in ("tightly-pack", "distribute-evenly"):
        evenly = policy == "distribute-evenly"
        packer = GangPacker(GangPackerConfig(assignment_policy=policy, use_mesh=True), mesh=mesh)
        single = GangPacker(GangPackerConfig(assignment_policy=policy), device=dev)
        got, mesh_ms, spent = timed(lambda: packer.solve(problem), 1)
        single.solve(problem)
        want, single_ms, _ = timed(lambda: single.solve(problem), MESH_REPS)
        same((got.feasible, got.driver_idx, got.avail_after), (want.feasible, want.driver_idx, want.avail_after),
             f"GangPacker(use_mesh=True) {policy} against the fifo_queue launch")
        placed, plain_ms, _ = timed(lambda: bs.solve_queue(*whole(queue), evenly=evenly, with_placements=True), 1)
        same((got.exec_counts, got.exec_capacity), (placed.exec_counts, placed.exec_capacity),
             f"GangPacker(use_mesh=True) {policy} placements against solve_queue")
        lines.append(
            f"(a) GangPacker(use_mesh=True) {policy} N={n} A={problem.driver.shape[0]} ({n_valid} valid): "
            f"{int(got.feasible.sum())} feasible, decisions and avail_after equal to the unsharded GangPacker "
            f"(one fifo_queue launch), placements equal to solve_queue(with_placements=True); "
            f"{mesh_ms:.1f} ms a solve ({spent} collectives, the 3 gathers included) against the launch's "
            f"{single_ms:.3f} ms ({mesh_ms / single_ms:.0f}x) and the unsharded program's {plain_ms:.1f} ms")
    return lines


def mesh_phase(problem, az_inputs, smi: str) -> None:
    """Phase mesh: (a) one NCCL rank on the card at phase 4's inputs; (b)
    the dry run in gloo worlds of 2 and 4 ranks sharing the card.  Every
    world runs in spawned processes: no process group is made here."""
    import contextlib
    import io

    from k8s_spark_scheduler_tpu_torch.entry import dryrun_multichip
    from k8s_spark_scheduler_tpu_torch.parallel.launch import run_world

    t = time.perf_counter()
    # no device: run_world's default is the card
    lines = run_world(mesh_rank, 1, backend="nccl", args=(problem, az_inputs), timeout_s=600)[0]
    for line in lines:
        log(f"phase mesh: {line} | {smi}")
    log(f"phase mesh: (a) took {time.perf_counter() - t:.1f} s, the rank's start included")
    for ranks in MESH_DRYRUN_RANKS:
        t = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            facts = dryrun_multichip(ranks, device="cuda")
        if facts["backend"] != "gloo" or not facts["device"].startswith("cuda") or len(facts["shard_bytes"]) != ranks:
            raise SystemExit(f"phase mesh: (b) the dry run of {ranks} ranks ran as {facts['backend']} on "
                             f"{facts['device']}")
        for line in printed.getvalue().splitlines():
            log(f"phase mesh: (b) {line} | {smi}")
        log(f"phase mesh: (b) {ranks} ranks took {time.perf_counter() - t:.1f} s, the ranks' start included")


# -- phase analysis: the model checker -------------------------------------------

ANALYSIS_SCHEDULES = 120  # the reference's tier-1 budget (tests/test_modelcheck.py:298)
ANALYSIS_SEED = 7


def analysis_corpus(device: str) -> tuple:
    """Phase analysis, in a spawned process of its own (its race
    detector and the scheduler's threads apart from this process's):
    (the sampler scenario's probe device and stream, [(scenario,
    schedules, decisions, seconds, violation or ""), ...], the hand
    kernels launched)."""
    import logging

    from k8s_spark_scheduler_tpu_torch.analysis.mcscenarios import corpus
    from k8s_spark_scheduler_tpu_torch.analysis.modelcheck import explore
    from k8s_spark_scheduler_tpu_torch.ops import class_kernel as ck
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.ops import single_az_kernel as sk

    # the fencing scenario's refused writes log a warning a schedule
    logging.disable(logging.WARNING)
    modules = (qk, mk, sk, ck)
    for module in modules:
        module.reset_launch_counts()
    scenarios = corpus(device=device)
    sampler = next(s for s in scenarios if s.name == "capacity-sampler-freshen").setup().sampler
    probes = (str(sampler.device), sampler._stream is not None)
    results = []
    for scenario in scenarios:
        t = time.perf_counter()
        res = explore(scenario, max_schedules=ANALYSIS_SCHEDULES, seed=ANALYSIS_SEED)
        results.append((scenario.name, res.schedules, res.decisions, time.perf_counter() - t,
                        "" if res.ok else str(res.violation)))
    launched = {k: v for module in modules for k, v in module.launch_counts.items() if v}
    return probes, results, launched


def analysis_start(device: str = "cuda") -> tuple:
    """Starts phase analysis beside the phase before it (host work, and
    the sampler scenario's small probe programs): ``analysis_corpus`` in
    a spawned process."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    return time.perf_counter(), pool, pool.submit(analysis_corpus, device)


def analysis_phase(smi: str, started: tuple = None, device: str = "cuda") -> None:
    """Phase analysis (see the module docstring): reads what
    ``analysis_start`` started (or starts it now).  Raises SystemExit on
    a scenario that is not clean, or a kernel launched.  ``device="cpu"``
    rehearses it without a card."""
    t0, pool, corpus_future = started or analysis_start(device)
    try:
        (probe_device, stream), results, launched = corpus_future.result(timeout=1200)
    finally:
        pool.shutdown()
    if not probe_device.startswith(device) or (device == "cuda" and not stream):
        raise SystemExit(f"phase analysis: the sampler scenario's probes run on {probe_device}, own stream {stream}")
    for name, schedules, decisions, seconds, violation in results:
        log(f"phase analysis: {name}: {schedules} schedules, {decisions} decisions in {seconds:.2f} s, "
            f"{'clean' if not violation else 'VIOLATION'} | {smi}")
        if violation or schedules != ANALYSIS_SCHEDULES:
            raise SystemExit(f"phase analysis: {name}: {schedules} schedules\n{violation}")
    if launched:
        raise SystemExit(f"phase analysis: kernels launched in a host-only phase: {launched}")
    log(f"phase analysis: {len(results)} scenarios clean at {ANALYSIS_SCHEDULES} schedules, seed "
        f"{ANALYSIS_SEED}, device {device}, in {sum(r[3] for r in results):.1f} s in its process, done "
        f"{time.perf_counter() - t0:.1f} s after its start; 0 kernel launches in the phase")


def session_stream(problem, n_earlier: int, smi: str) -> None:
    """Phase delta, step 3 at the library layer: one FifoSession on the
    card and one on the CPU fed the same stream of queues from the main
    path's snapshot (a whole queue, an identical resubmit, arrivals, one
    app changed mid-queue, the head popped, a cut), every step equal on
    both, resume positions included, and equal to the stateless pass."""
    from k8s_spark_scheduler_tpu_torch.ops.fifo_session import FifoSession, solve_packed_cold

    rows = np.zeros((problem.driver.shape[0], 8), np.int32)
    rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7] = (problem.driver, problem.executor, problem.count,
                                                          problem.app_valid)
    queue = rows[:n_earlier]
    changed = queue.copy()
    changed[n_earlier // 2] = queue[7]
    first = 9 * n_earlier // 10
    stream = [("whole queue", queue[:first]), ("identical resubmit", queue[:first]), ("arrivals", queue),
              ("one app changed mid-queue", changed), ("head popped", changed[1:]),
              ("cut", changed[1: 3 * n_earlier // 10])]
    card, host = FifoSession(device="cuda"), FifoSession(device="cpu")
    for s in (card, host):
        s.load(problem.avail, problem.driver_rank, problem.exec_ok, 0, stride=DELTA_STRIDE)
    steps = []
    for what, q in stream:
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = card.solve(q)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        want = host.solve(q)
        cold = solve_packed_cold(0, card.basis, card.driver_rank, card.exec_ok, q, device="cuda")
        if got[0] != want[0] or not (np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
                                     and torch.equal(got[3].cpu(), want[3])):
            raise SystemExit(f"session stream, {what}: the card's session differs from the cpu session")
        if not (np.array_equal(got[1], cold[0]) and np.array_equal(got[2], cold[1]) and torch.equal(got[3], cold[2])):
            raise SystemExit(f"session stream, {what}: the session differs from the stateless pass")
        steps.append(f"{what} ({len(q)} apps): resume {got[0]}, {ms:.3f} ms")
    log(f"phase delta: session stream at the library layer (tightly-pack, {problem.avail.shape[0]} nodes, "
        f"stride {DELTA_STRIDE}), equal on cuda and cpu and to the stateless pass: " + "; ".join(steps)
        + f"; {card.checkpoints()} live checkpoints, {card.mem_bytes()} bytes | {smi}")


def serde_rr(rr) -> dict:
    from k8s_spark_scheduler_tpu_torch.types import serde

    return serde.rr_to_dict_v1beta2(rr)


def build_snapshot(seed: int):
    """bench.py's 10k × 1k snapshot distribution, in the port's types:
    avail 4–96 CPU / 8–256 Gi on 96 CPU / 256 Gi nodes in 3 zones,
    executors 1–8 CPU / 2–16 Gi, drivers 1 CPU / 2 Gi, gangs of 1–32."""
    from k8s_spark_scheduler_tpu_torch.convert import app_from_plain, metadata_from_plain

    rng = np.random.RandomState(seed)
    metadata = {}
    for i in range(N_NODES):
        metadata[f"node-{i:05d}"] = metadata_from_plain(
            available=(str(int(rng.randint(4, 96))), f"{int(rng.randint(8, 256))}Gi", 0),
            schedulable=("96", "256Gi", 0),
            zone_label=f"z{i % N_ZONES}",
        )
    apps = [
        app_from_plain(
            ("1", "2Gi", 0),
            (str(int(rng.randint(1, 8))), f"{int(rng.randint(2, 16))}Gi", 0),
            int(rng.randint(1, 32)),
        )
        for _ in range(N_APPS + 8)
    ]
    skip = [bool(x) for x in rng.rand(N_APPS) < 0.3]
    return metadata, apps[:N_APPS], skip, apps[N_APPS:]


# each kernel library's launch function, timed by traced_device_time
LAUNCH_FUNCTIONS = {"queue": "fifo_queue_launch", "min_frag": "fifo_queue_min_frag_launch",
                    "single_az": "fifo_queue_single_az_launch"}


def traced_device_time(fn):
    """Run fn once under torch.profiler, with every live PortServer's
    background work (the sampler, the ledger) paused and every HTTP
    request thread ended from before the profiler starts until after it
    stops: stopping the profiler while another thread makes CUDA calls
    can crash the process (a segmentation fault on the H100, a sampler's
    program in flight).  Returns (device busy ms, host-clock ms of
    the call with the profiler's overhead, the port's kernel launches in
    the call, those of them the trace holds), or busy None when the call
    left no device work.  The busy time is the union of the trace's device
    intervals other than the port's kernels, plus each launch of the
    port's kernels timed by CUDA events recorded around it on its stream:
    a trace of a server's Filter does not always hold the kernel the
    Filter launched through its ctypes library (PERF.md section 7)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.ops import single_az_kernel as sk

    launches = []
    patched = []
    for module, kind in ((qk, "queue"), (mk, "min_frag"), (sk, "single_az")):
        lib = module.LIBRARY.load()
        name = LAUNCH_FUNCTIONS[kind]
        launch = getattr(lib, name)

        def timed_launch(*a, _launch=launch):
            stream = torch.cuda.current_stream()
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin.record(stream)
            err = _launch(*a)
            end.record(stream)
            launches.append((begin, end))
            return err

        setattr(lib, name, timed_launch)
        patched.append((lib, name, launch))
    paused = [server for server in PortServer.live if not server.background_paused]
    for server in paused:
        server.pause_background()
    join_request_threads()
    # a speculation runs on its request's thread, so none is in flight now
    for server in PortServer.live:
        engine = server.scheduler.concurrent
        if engine is not None and engine.speculator.inflight():
            raise SystemExit("a speculation is in flight at the profiler's start")
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
            # the request's handler thread may still be closing its
            # connection: the profiler stops once it has ended
            join_request_threads()
    finally:
        for lib, name, launch in patched:
            setattr(lib, name, launch)
        for server in paused:
            server.resume_background()
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    seen = sum("fifo_queue" in e.name for e in device_events)
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events if "fifo_queue" not in e.name)
    kernel_ms = sum(begin.elapsed_time(end) for begin, end in launches)
    if not spans and not launches:
        return None, wall_ms, 0, 0
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return busy_us / 1e3 + kernel_ms, wall_ms, len(launches), seen


def join_request_threads() -> None:
    """Wait for every in-process HTTP request thread to end (the script
    sends its requests one at a time, so these are finishing the last
    one)."""
    for thread in threading.enumerate():
        if thread.name.endswith("(process_request_thread)") and thread is not threading.current_thread():
            thread.join()


def busy_share(fn) -> str:
    busy_ms, wall_ms, n_launches, seen = traced_device_time(fn)
    if busy_ms is None:
        return "not measured (no device work in the call)"
    return (f"device busy {busy_ms:.3f} ms of {wall_ms:.1f} ms, idle {100 * (1 - busy_ms / wall_ms):.2f} % "
            f"({n_launches} kernel launches of the port, timed by events; the profiler's trace holds "
            f"{seen} of them)")


def outcome_key(o):
    r = o.result
    return (
        o.supported, o.earlier_ok,
        None if r is None else (r.has_capacity, r.driver_node, tuple(r.executor_nodes)),
    )


def host_fifo(metadata, driver_order, executor_order, earlier, skip, current, packer):
    """The reference's fitEarlierDrivers + final pack on the host oracles,
    with its usage-subtraction quirk (per-node entries assigned, the
    executor entry overwriting the driver's)."""
    from k8s_spark_scheduler_tpu_torch.types.resources import (
        copy_metadata,
        subtract_usage_if_exists,
    )

    meta = copy_metadata(metadata)

    def pack(app):
        return packer(
            app.driver_resources, app.executor_resources, app.min_executor_count,
            driver_order, executor_order, meta,
        )

    for app, skippable in zip(earlier, skip):
        result = pack(app)
        if not result.has_capacity:
            if skippable:
                continue
            return (True, False, None)
        usage = {result.driver_node: app.driver_resources}
        for node in result.executor_nodes:
            usage[node] = app.executor_resources
        subtract_usage_if_exists(meta, usage)
    r = pack(current)
    return (True, True, (r.has_capacity, r.driver_node, tuple(r.executor_nodes)))


def fifo_solvers(device: str):
    """The main path's FIFO solvers by policy name, on `device`."""
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import TpuFifoSolver, TpuSingleAzFifoSolver

    return {
        "tightly-pack": TpuFifoSolver("tightly-pack", device=device),
        "distribute-evenly": TpuFifoSolver("distribute-evenly", device=device),
        "minimal-fragmentation": TpuFifoSolver("minimal-fragmentation", device=device),
        "single-az-tightly-pack": TpuSingleAzFifoSolver(device=device),
        "az-aware-tightly-pack": TpuSingleAzFifoSolver(az_aware=True, device=device),
        "single-az-minimal-fragmentation": TpuSingleAzFifoSolver(
            inner_policy="minimal-fragmentation", device=device
        ),
    }


class CpuTwin:
    """Spawned processes that compute cpu halves of cuda-against-cpu
    comparisons while this process drives the card: the same functions on
    the same inputs (shipped, or made from the same seeds), only in
    another process (the module docstring says which).  Started before
    the build (the interpreters and torch's import overlap nvcc);
    ``workers`` processes of ``threads`` torch threads (half the host's
    cores by default); ``submit`` queues a task for the next free
    worker."""

    def __init__(self, threads: int = None, workers: int = 1):
        import atexit
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(workers, initializer=twin_init, initargs=(threads,))
        atexit.register(self.stop)

    def submit(self, fn, *args):
        return self.pool.apply_async(fn, args)

    def stop(self) -> None:
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None


def twin_init(threads: int = None) -> None:
    # by default half the host's cores for its torch ops, the rest for the
    # card's driver, which also comes first when the cores are all busy
    torch.set_num_threads(threads or max(1, (os.cpu_count() or 2) // 2))
    os.nice(10)
    # phase sim: every refused driver of the backlog logs a line a round
    import logging

    logging.disable(logging.ERROR)


def twin_decisions(seed: int, policy: str, n: int) -> tuple:
    """Phase 4's first n decisions under `policy` on the CPU (the plain
    versions), in a twin: ([outcome_key, ...], seconds)."""
    from k8s_spark_scheduler_tpu_torch.ops.nodesort import NodeSorter

    t = time.perf_counter()
    metadata, earlier, skip, currents = build_snapshot(seed)
    driver_order, executor_order = NodeSorter().potential_nodes(metadata, list(metadata))
    solver = fifo_solvers("cpu")[policy]
    keys = [outcome_key(solver.solve(metadata, driver_order, executor_order, earlier, skip, current))
            for current in currents[:n]]
    return keys, time.perf_counter() - t


# phase 3's random queues: (nodes, apps), and (nodes, apps, zones) for the
# single-AZ kernel
QUEUE_CASES = ((2, 5), (31, 17), (100, 40), (129, 64), (300, 100), (1000, 200), (4099, 64),
               (12345, 48), (10240, 1024))
AZ_CASES = ((2, 5, 1), (31, 17, 0), (129, 64, 2), (1000, 200, 3), (4099, 64, 3),
            (12345, 48, 3), (1000, 24, 200), (12345, 8, 150), (10800, 8, 3),
            (12345, 16, 1), (12000, 4, 4000), (10240, 1024, 3))


def queue_case(seed: int, ci: int):
    n, a = QUEUE_CASES[ci]
    return random_queue(np.random.RandomState(seed * 1000 + ci), n, a)


def az_case(seed: int, ci: int):
    n, a, zones = AZ_CASES[ci]
    return random_single_az_queue(np.random.RandomState(seed * 1000 + 500 + ci), n, a, zones)


def plain_on_card(n: int, zones: int = 0) -> bool:
    """Whether phase 3 runs a kernel's plain version on the card beside
    it: a wide, short queue (100,000 nodes or 100 zones, a few dozen
    apps), whose plain ops the card spreads over the nodes and one CPU
    thread walks (4,000 zones: under a second there, 336 s on a thread).
    A long queue's plain version is a loop of small launches, cheaper in
    the plain twins."""
    return n >= 100_000 or zones >= 100


def twin_plain(kind: str, fn: str, args: tuple, kwargs: dict, chk: np.ndarray = None) -> tuple:
    """A plain version on the CPU, in a plain twin: ``fn`` of
    ``ops/<kind>.py`` on `args` and `kwargs` (numpy arrays become
    tensors); `chk`, a blank checkpoint buffer, goes in as chk_out and
    comes back after the outputs: (outputs as numpy, ms)."""
    def tensor(x):
        return torch.from_numpy(x.copy()) if isinstance(x, np.ndarray) else x

    module = importlib.import_module(f"k8s_spark_scheduler_tpu_torch.ops.{kind}")
    kwargs = {k: tensor(v) for k, v in kwargs.items()}
    if chk is not None:
        kwargs["chk_out"] = tensor(chk)
    t = time.perf_counter()
    out = tuple(getattr(module, fn)(*(tensor(x) for x in args), **kwargs))
    ms = (time.perf_counter() - t) * 1e3
    if chk is not None:
        out += (kwargs["chk_out"],)
    return tuple(x.numpy() for x in out), ms


def twin_simulation(spec: dict) -> tuple:
    """One simulation on the CPU, in the twin: (result, wall s)."""
    from k8s_spark_scheduler_tpu_torch.sim import Scenario, Simulation

    t = time.perf_counter()
    result = Simulation(Scenario.from_dict(spec), device="cpu").run()
    return result, time.perf_counter() - t


def small_oracle_check(seed: int) -> int:
    """FIFO decisions on the card against the host oracles on small
    random snapshots, for every policy; returns the number of decisions
    checked."""
    from k8s_spark_scheduler_tpu_torch.convert import app_from_plain, metadata_from_plain
    from k8s_spark_scheduler_tpu_torch.ops import packers
    from k8s_spark_scheduler_tpu_torch.ops.nodesort import NodeSorter

    oracles = {
        "tightly-pack": packers.tightly_pack,
        "distribute-evenly": packers.distribute_evenly,
        "minimal-fragmentation": packers.minimal_fragmentation_pack,
        "single-az-tightly-pack": packers.single_az_tightly_pack,
        "az-aware-tightly-pack": packers.az_aware_tightly_pack,
        "single-az-minimal-fragmentation": packers.single_az_minimal_fragmentation,
    }
    rng = random.Random(seed)
    checked = 0
    for policy, solver in fifo_solvers("cuda").items():
        for _ in range(10):
            metadata = {
                f"n{i:02d}": metadata_from_plain(
                    available=(rng.randint(-2, 32), f"{rng.randint(-1, 64)}Gi", rng.choice([0, 0, 1, 4])),
                    schedulable=(32, "64Gi", 4),
                    zone_label=f"z{rng.randint(0, 2)}",
                    unschedulable=rng.random() < 0.1,
                )
                for i in range(rng.randint(2, 20))
            }
            driver_order, executor_order = NodeSorter().potential_nodes(metadata, list(metadata))

            def app():
                return app_from_plain(
                    (rng.choice(["1", "500m"]), rng.choice(["1Gi", "512Mi"]), 0),
                    (rng.choice(["1", "2", "0"]), rng.choice(["1Gi", "2Gi", "0"]), rng.choice([0, 0, 1])),
                    rng.randint(0, 20),
                )

            earlier = [app() for _ in range(rng.randint(0, 8))]
            skip = [rng.random() < 0.3 for _ in earlier]
            current = app()
            want = host_fifo(metadata, driver_order, executor_order, earlier, skip, current, oracles[policy])
            got = outcome_key(
                solver.solve(metadata, driver_order, executor_order, earlier, skip, current)
            )
            if got != want:
                raise SystemExit(f"small-snapshot {policy} decision differs from the host oracle: {got} vs {want}")
            checked += 1
    return checked


def ptxas_report(build_log: str):
    """(kernel<template arguments>, registers, spill stores) for each entry
    function in nvcc's -Xptxas=-v output."""
    out, entry, spills = [], None, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(\d+)(fifo_queue\w*?_kernel)(?:I(\w*?)EEv|E)", line)
        if m and m.group(3) is None:  # not a template (the class kernel)
            entry = m.group(2)
        elif m:
            entry = f"{m.group(2)}<{','.join(re.findall(r'L[bi](\d+)E', m.group(3) + 'E'))}>"
        elif "spill stores" in line:
            spills = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif "Used" in line and "registers" in line and entry:
            out.append((entry, int(re.search(r"Used (\d+) registers", line).group(1)), spills))
            entry = None
    return out


def kernel_entry(name, kind, launches, max_err, ms, plain_ms, t_bytes, t_ops, floor_ms=None):
    entry = {
        "name": name, "route": "cuda", "source": SOURCES[kind], "replaces": REPLACES[kind],
        "launches": launches, "max_abs_err": max_err,
        "ms": statistics.median(ms), "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
    }
    if floor_ms is not None:
        entry["serial_floor_ms"] = floor_ms  # the same queue at FLOOR_NODES nodes
    return entry


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    # a fatal signal (a crash in native code) prints every thread's Python stack to stderr
    faulthandler.enable(all_threads=True)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU only", file=sys.stderr)
        return 2

    from k8s_spark_scheduler_tpu_torch.ops import class_kernel as ck
    from k8s_spark_scheduler_tpu_torch.ops import minfrag_kernel as mk
    from k8s_spark_scheduler_tpu_torch.ops import queue_kernel as qk
    from k8s_spark_scheduler_tpu_torch.ops import single_az_kernel as sk
    from k8s_spark_scheduler_tpu_torch.ops.batch_adapter import candidate_zone_masks
    from k8s_spark_scheduler_tpu_torch.ops.fifo_solver import single_az_queue_inputs
    from k8s_spark_scheduler_tpu_torch.ops.nodesort import NodeSorter
    from k8s_spark_scheduler_tpu_torch.ops.registry import TPU_BATCH_NAMES, select_binpacker
    from k8s_spark_scheduler_tpu_torch.ops.tensorize import scale_problem, tensorize_cluster

    dev = torch.device("cuda")
    t_script = time.perf_counter()
    # ---- phase 1: device
    name = torch.cuda.get_device_name(0)
    smi = gpu_line()
    log(f"phase device: {name} | torch {torch.__version__} | cuda {torch.version.cuda} | {smi}")

    # the cpu halves of phase 4's decisions, a policy a task beside the
    # build: the tensor-lane policies' in the twin, the single-AZ ones' (the
    # heavier plain passes) in the plain twins, which then compute the plain
    # versions as phases 3-4 launch the kernels
    twin = CpuTwin()
    plain_twins = CpuTwin(threads=1, workers=PLAIN_WORKERS)
    server_twins = CpuTwin(threads=1, workers=SERVER_WORKERS)
    n_decisions = {p: DECISIONS if p in ("tightly-pack", "distribute-evenly") else NEW_DECISIONS
                   for p in POLICY_KERNEL}
    cpu_decisions = {p: (plain_twins if POLICY_KERNEL[p] in SINGLE_AZ else twin).submit(
        twin_decisions, args.seed, p, n) for p, n in n_decisions.items()}

    # ---- phase 2: build, one nvcc per source, all started together
    t0 = time.perf_counter()
    libraries = {"queue": qk.LIBRARY, "min_frag": mk.LIBRARY, "single_az": sk.LIBRARY, "classes": ck.LIBRARY}
    with ThreadPoolExecutor(len(libraries)) as pool:
        for future in [pool.submit(lib.load) for lib in libraries.values()]:
            future.result()
    log(f"phase build: {len(libraries)} kernels ready in {time.perf_counter() - t0:.2f} s")

    # ---- phase 3: kernel vs plain, the kernels on the card and their
    # plain versions on the CPU in the plain twins (compared before phase 5)
    max_err = {"fifo_queue_tightly": 0, "fifo_queue_evenly": 0, "fifo_queue_min_frag": 0}
    max_err.update({kname: 0 for kname in SINGLE_AZ})
    max_err.update({kname + "_checkpointed": 0 for kname in ("fifo_queue_tightly", "fifo_queue_evenly",
                                                             "fifo_queue_min_frag")})

    def check(kname, got, want, where):
        torch.cuda.synchronize()
        err = compare(got, want)
        max_err[kname] = max(max_err[kname], err)
        if err:
            raise SystemExit(f"{kname} != plain at {where} (max |diff| {err})")

    # kernel outputs held against their plain versions, which the plain
    # twins compute meanwhile: [(kernel, outputs, the twin's answer, where,
    # key of the plain version's ms or None)]
    deferred, plain_ms = [], {}

    def defer(kname, got, kind, fn, args, where, chk=None, key=None, card=False, **kwargs):
        """Hold `got` to ops/<kind>.<fn>(*args, **kwargs) on the CPU, later,
        or with `card` on the card now (plain_on_card); `chk` (a blank
        checkpoint buffer) is passed as chk_out and compared after the
        outputs."""
        if card:
            extra = {} if chk is None else {"chk_out": chk.clone()}
            plain = getattr(importlib.import_module(f"k8s_spark_scheduler_tpu_torch.ops.{kind}"), fn)
            check(kname, got, tuple(plain(*args, **kwargs, **extra)) + tuple(extra.values()), where)
            return
        arrays = tuple(x.cpu().numpy() if torch.is_tensor(x) else x for x in args)
        kw = {k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in kwargs.items()}
        spec = None if chk is None else chk.cpu().numpy()
        deferred.append((kname, got, plain_twins.submit(twin_plain, kind, fn, arrays, kw, spec), where, key))

    def check_queue(arrays, where, evenly):
        kname = "fifo_queue_evenly" if evenly else "fifo_queue_tightly"
        defer(kname, qk.fifo_queue(*arrays, evenly=evenly), "queue_kernel", "solve_queue_plain", arrays, where,
              card=plain_on_card(arrays[0].shape[0]), evenly=evenly)

    def check_min_frag(arrays, where):
        defer("fifo_queue_min_frag", mk.fifo_queue_min_frag(*arrays), "minfrag_kernel", "solve_queue_min_frag_plain",
              arrays, where)

    def check_single_az(arrays, scalars, where):
        """Every variant, both strict values for min-frag."""
        card = plain_on_card(arrays[0].shape[0], scalars[2])
        for kname, (az_aware, minfrag) in SINGLE_AZ.items():
            for strict in ((True, False) if minfrag else (True,)):
                flags = dict(az_aware=az_aware, minfrag=minfrag, strict=strict)
                defer(kname, sk.fifo_queue_single_az(*arrays, *scalars, **flags), "single_az_kernel",
                      "solve_queue_single_az_plain", arrays + tuple(scalars), f"{where} strict={strict}", card=card,
                      **flags)

    for ci, (n, a) in enumerate(QUEUE_CASES):
        arrays = on(dev, queue_case(args.seed, ci))
        for evenly in (False, True):
            check_queue(arrays, f"N={n} A={a}", evenly)
        check_min_frag(arrays, f"N={n} A={a}")
        log(f"phase kernel-vs-plain: queue and min-frag kernels N={n} A={a} launched (queue kernel: "
            f"{queue_layout(qk, n, dev)})")
    # the queue kernel on fewer nodes than its cluster has blocks, above the
    # cluster's shared memory (global scratch), and near the int32 range
    queue_cases = [("N=7 A=20", random_queue, 7, 20), ("N=100000 A=32", random_queue, 100000, 32),
                   ("large values N=7 A=20", random_queue_large, 7, 20),
                   ("large values N=3000 A=128", random_queue_large, 3000, 128),
                   ("large values N=10240 A=256", random_queue_large, 10240, 256),
                   ("large values N=100000 A=16", random_queue_large, 100000, 16)]
    for ci, (what, make, n, a) in enumerate(queue_cases):
        arrays = on(dev, make(np.random.RandomState(args.seed * 1000 + 900 + ci), n, a))
        for evenly in (False, True):
            check_queue(arrays, what, evenly)
        log(f"phase kernel-vs-plain: queue kernel {what} launched ({queue_layout(qk, n, dev)})")
    # min-frag queues whose apps ask for 1-4 executors (the placing pass's
    # largest capacity reaches k) or 100-300 (capacities stay under 64 < k)
    for ci, (n, a) in enumerate([(3000, 256), (10240, 256)]):
        rng = np.random.RandomState(args.seed * 1000 + 300 + ci)
        arrays = random_queue(rng, n, a)
        arrays[4][:] = rng.randint(1, 9, size=(a, 3))
        arrays[5][:] = np.where(rng.rand(a) < 0.5, rng.randint(1, 5, size=a), rng.randint(100, 300, size=a))
        check_min_frag(on(dev, arrays), f"m >= k and m < k, N={n} A={a}")
        log(f"phase kernel-vs-plain: min-frag kernel, k in 1-4 and 100-300, N={n} A={a} launched")
    # the explainer's launches: probe flags (a verdict, nothing subtracted)
    # and the per-app usage output, on the queue and min-frag kernels
    for ci, (n, a) in enumerate([(7, 20), (31, 17), (1000, 200), (12345, 48), (10240, 257), (100000, 16)]):
        rng = np.random.RandomState(args.seed * 1000 + 950 + ci)
        arrays = on(dev, random_queue(rng, n, a))
        probe = torch.as_tensor(rng.rand(a) < 0.5, device=dev)
        where = f"probes and usage, N={n} A={a}"
        for evenly in (False, True):
            defer("fifo_queue_evenly" if evenly else "fifo_queue_tightly", qk.fifo_queue_explain(*arrays, probe, evenly=evenly),
                  "queue_kernel", "queue_plain", arrays, where, card=plain_on_card(n), evenly=evenly, probe=probe)
        if n <= 12345:
            defer("fifo_queue_min_frag", mk.fifo_queue_min_frag_explain(*arrays, probe), "minfrag_kernel",
                  "queue_min_frag_plain", arrays, where, probe=probe)
        log(f"phase kernel-vs-plain: queue{' and min-frag' if n <= 12345 else ''} kernels with probe "
            f"flags and the usage output, N={n} A={a} launched")
    # the delta-solve session's checkpointed launches: the carry before
    # every stride-th queue position into a [K, N, 3] buffer, from a queue
    # position chk_base on (queue and min-frag kernels; the queue kernel
    # also with its node planes in global scratch), slots past K skipped
    for ci, (n, a, stride, chk_base, slots) in enumerate([(7, 20, 3, 0, 6), (129, 64, 7, 13, 10),
                                                          (3000, 200, 16, 0, 8), (100000, 40, 8, 5, 5)]):
        arrays = on(dev, random_queue(np.random.RandomState(args.seed * 1000 + 970 + ci), n, a))
        chk_args = dict(chk_base=chk_base, chk_stride=stride)
        blank = torch.full((slots, n, 3), -7, dtype=torch.int32, device=dev)
        where = f"checkpoints N={n} A={a} stride={stride} base={chk_base} slots={slots}"
        for evenly, kname in ((False, "fifo_queue_tightly"), (True, "fifo_queue_evenly")):
            chk = blank.clone()
            defer(kname + "_checkpointed", qk.fifo_queue(*arrays, evenly=evenly, chk_out=chk, **chk_args) + (chk,),
                  "queue_kernel", "solve_queue_plain", arrays, where, chk=blank, card=plain_on_card(n), evenly=evenly,
                  **chk_args)
        if n <= 12345:
            chk = blank.clone()
            defer("fifo_queue_min_frag_checkpointed", mk.fifo_queue_min_frag(*arrays, chk_out=chk, **chk_args) + (chk,),
                  "minfrag_kernel", "solve_queue_min_frag_plain", arrays, where, chk=blank, **chk_args)
        log(f"phase kernel-vs-plain: checkpointed launches of the queue{' and min-frag' if n <= 12345 else ''} "
            f"kernels, N={n} A={a} stride {stride} from position {chk_base} into {slots} slots launched")
    # 200 and 150 zones: many zones a block; one zone over 12,345 nodes:
    # that block's node planes in global memory; 4,000 zones: the zone
    # table in global memory
    for ci, (n, a, zones) in enumerate(AZ_CASES):
        arrays, scalars = az_case(args.seed, ci)
        arrays = on(dev, arrays)
        check_single_az(arrays, scalars, f"N={n} A={a} zones={zones}")
        log(f"phase kernel-vs-plain: single-AZ kernel, {len(SINGLE_AZ)} variants, N={n} A={a} "
            f"zones={zones} launched (cluster {sk.zone_layout(arrays[3], zones).cluster})")
    # zone layouts the main path does not take: one zone holding every
    # node, an empty zone, more zones than the cluster has blocks
    layouts = {
        "1 zone holds every node": (1, lambda rng, n: np.zeros(n, np.int32)),
        "3 zones, zone 1 empty": (3, lambda rng, n: rng.choice([0, 2], size=n).astype(np.int32)),
        "9 zones": (9, lambda rng, n: rng.randint(0, 9, size=n).astype(np.int32)),
        "17 zones": (17, lambda rng, n: rng.randint(-1, 17, size=n).astype(np.int32)),
    }
    for ci, (what, (zones, zone_ids)) in enumerate(layouts.items()):
        rng = np.random.RandomState(args.seed * 1000 + 700 + ci)
        arrays, scalars = random_single_az_queue(rng, 10240, 64, zones)
        arrays[3][:] = zone_ids(rng, 10240)
        arrays = on(dev, arrays)
        check_single_az(arrays, scalars, f"{what}, N=10240 A=64")
        log(f"phase kernel-vs-plain: single-AZ kernel, {what}, N=10240 A=64 launched "
            f"(cluster {sk.zone_layout(arrays[3], zones).cluster})")
    # an az-aware queue where many apps fit no single zone: 150 zones of
    # about 20 nodes and gangs of 60-150 executors
    rng = np.random.RandomState(args.seed * 1000 + 800)
    arrays, scalars = random_single_az_queue(rng, 3000, 128, 150)
    arrays[5][:] = rng.randint(1, 4, size=(128, 3))
    arrays[6][:] = rng.randint(60, 150, size=128)
    arrays = on(dev, arrays)
    check_single_az(arrays, scalars, "cross-zone queue N=3000 A=128 zones=150")
    az_got = sk.fifo_queue_single_az(*arrays, *scalars, az_aware=True)
    n_cross = int(((az_got[1] == 150) & az_got[0]).sum())
    if n_cross < 10:
        raise SystemExit(f"the cross-zone queue sent only {n_cross} apps to the cross-zone solve")
    log(f"phase kernel-vs-plain: single-AZ kernel, az-aware queue with {n_cross} of 128 apps on the "
        f"cross-zone solve, N=3000 zones=150 launched")

    # ---- phase 4: main path at full size
    t0 = time.perf_counter()
    metadata, earlier, skip, currents = build_snapshot(args.seed)
    driver_order, executor_order = NodeSorter().potential_nodes(metadata, list(metadata))
    log(f"phase main-path: snapshot {len(metadata)} nodes in {N_ZONES} zones x {len(earlier)} "
        f"queued apps built in {time.perf_counter() - t0:.2f} s")
    n_checked = small_oracle_check(args.seed)
    log(f"phase main-path: {n_checked} small-snapshot FIFO decisions equal the host oracles")

    solvers = fifo_solvers("cuda")
    solve_ms = {p: [] for p in solvers}
    decisions = {p: [] for p in solvers}
    paths = {p: [] for p in solvers}
    launches = {}  # kernel -> launches in the run of its policy's path
    for p, solver in solvers.items():
        # each policy's path is driven with every count at 0 and read just after
        for module in (qk, mk, sk):
            module.reset_launch_counts()
        for current in currents[: n_decisions[p]]:
            t = time.perf_counter()
            out = solver.solve(metadata, driver_order, executor_order, earlier, skip, current)
            torch.cuda.synchronize()
            solve_ms[p].append((time.perf_counter() - t) * 1e3)
            decisions[p].append(outcome_key(out))
            path = getattr(solver, "last_path", None) or solver.last_queue_lane
            paths[p].append(path)
            if path not in ("cuda", "fused", "host"):
                raise SystemExit(f"{p} queue pass ran on {path!r}, not on the card")
        counts = {**qk.launch_counts, **mk.launch_counts, **sk.launch_counts}
        log(f"phase main-path: {p} launches {counts}")
        kname = POLICY_KERNEL[p]
        if counts[kname] < 1:
            raise SystemExit(f"{kname} was not launched on the {p} path")
        launches[kname] = counts[kname]
    cur = currents[0]
    bp_args = (cur.driver_resources, cur.executor_resources, cur.min_executor_count,
               driver_order, executor_order, metadata)
    bp = {}
    for bname in TPU_BATCH_NAMES:
        bp[bname] = select_binpacker(bname, device="cuda").binpack_func(*bp_args)
    torch.cuda.synchronize()
    for p in solvers:
        log(f"phase main-path: {p} last path per decision {paths[p]}")

    # each kernel alone, at the main path's shapes and inputs
    cluster = tensorize_cluster(metadata, driver_order, executor_order)
    problem = scale_problem(cluster, solvers["tightly-pack"]._tensorize_with_cache(earlier, currents[0]))
    valid = problem.app_valid.copy()
    valid[len(earlier):] = False
    queue_args = on(dev, (problem.avail, problem.driver_rank, problem.exec_ok, problem.driver,
                          problem.executor, problem.count, valid))
    n_b, a_b = problem.avail.shape[0], problem.driver.shape[0]
    n_valid = int(valid.sum())
    queue_bytes = 4 * (3 * n_b + n_b) + n_b + a_b * (4 * 3 * 2 + 4 + 1) + a_b * (1 + 4) + 4 * 3 * n_b

    def timed(kname, kind, fn, floor_fn, ops, n_bytes):
        """The kernel's entry; its plain_ms is the plain twin's one call,
        filled in when the twin answers."""
        ms = [time_cuda(fn, 5) for _ in range(3)]
        floor_ms = time_cuda(floor_fn, 5)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        log(f"phase main-path: {kname} N={n_b} A={a_b} ({n_valid} valid): "
            f"{statistics.median(ms):.3f} ms (runs {', '.join(f'{x:.3f}' for x in ms)}), "
            f"bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
            f"operations {t_ops:.4f}), serial floor at N={FLOOR_NODES} {floor_ms:.3f} ms | {smi}")
        return kernel_entry(kname, kind, launches[kname], max_err[kname], ms, None, t_bytes, t_ops,
                            floor_ms=floor_ms)

    kernels = []
    floor_args = tuple(x[:FLOOR_NODES] for x in queue_args[:3]) + queue_args[3:]
    for evenly, kname in ((False, "fifo_queue_tightly"), (True, "fifo_queue_evenly")):
        got = qk.fifo_queue(*queue_args, evenly=evenly)
        defer(kname, got, "queue_kernel", "solve_queue_plain", queue_args, "the main-path inputs", key=kname,
              evenly=evenly)
        n_feasible = int(got[0].sum())
        ops = n_b * (n_valid * OPS_PER_NODE_VALID_APP + n_feasible * OPS_PER_NODE_FEASIBLE_APP)
        log(f"phase main-path: {kname}: {n_feasible} feasible; {queue_layout(qk, n_b, dev)}")
        kernels.append(timed(
            kname, "queue", lambda: qk.fifo_queue(*queue_args, evenly=evenly),
            lambda: qk.fifo_queue(*floor_args, evenly=evenly), ops, queue_bytes,
        ))

    got = mk.fifo_queue_min_frag(*queue_args)
    defer("fifo_queue_min_frag", got, "minfrag_kernel", "solve_queue_min_frag_plain", queue_args,
          "the main-path inputs", key="fifo_queue_min_frag")
    n_feasible = int(got[0].sum())
    log(f"phase main-path: fifo_queue_min_frag: {n_feasible} feasible; cluster of "
        f"{mk.CLUSTER_BLOCKS} blocks of {mk.THREADS} threads")
    ops = n_b * (n_valid * OPS_PER_NODE_VALID_APP + n_feasible * MF_OPS_PER_NODE_FEASIBLE_APP)
    kernels.append(timed(
        "fifo_queue_min_frag", "min_frag", lambda: mk.fifo_queue_min_frag(*queue_args),
        lambda: mk.fifo_queue_min_frag(*floor_args), ops, queue_bytes,
    ))

    # the refusal explainer's launch at the main path's inputs: the queue
    # with a probe of the current app before every earlier app and after
    # the last (ops/explain.py), against the plain version on the card
    n_e = len(earlier)

    def explain_args(n_apps):
        idx = np.empty(2 * n_apps + 1, dtype=np.int64)
        idx[0::2], idx[1::2] = n_e, np.arange(n_apps)
        probe = np.zeros(idx.shape[0], dtype=bool)
        probe[0::2] = True
        inter_valid = np.where(probe, True, valid[np.minimum(idx, n_e)])
        return queue_args[:3] + on(dev, (problem.driver[idx], problem.executor[idx], problem.count[idx],
                                          inter_valid, probe))

    ex_args = explain_args(n_e)
    for evenly, kname in ((False, "fifo_queue_tightly"), (True, "fifo_queue_evenly")):
        defer(kname, qk.fifo_queue_explain(*ex_args, evenly=evenly), "queue_kernel", "queue_plain", ex_args[:7],
              "the explainer's main-path launch", evenly=evenly, probe=ex_args[7])
        ms = [time_cuda(lambda: qk.fifo_queue_explain(*ex_args, evenly=evenly), 3) for _ in range(3)]
        log(f"phase main-path: {kname} explainer launch, {ex_args[3].shape[0]} apps ({n_e} probes of the "
            f"current app between the {n_e} earlier ones): {statistics.median(ms):.3f} ms (held to the plain "
            f"version) | {smi}")
    ex_small = explain_args(256)
    defer("fifo_queue_min_frag", mk.fifo_queue_min_frag_explain(*ex_small), "minfrag_kernel", "queue_min_frag_plain",
          ex_small[:7], "the explainer's launch, 256 earlier apps", probe=ex_small[7])
    ms = [time_cuda(lambda: mk.fifo_queue_min_frag_explain(*ex_args), 3) for _ in range(3)]
    log(f"phase main-path: fifo_queue_min_frag explainer launch, {ex_args[3].shape[0]} apps: "
        f"{statistics.median(ms):.3f} ms (held to the plain version over the first 256 earlier apps) | {smi}")

    # phase delta, steps 1 and 3: the checkpointed launches at these
    # inputs, and a session stream at the library layer
    delta_timing = delta_kernels(queue_args, n_valid, queue_bytes, check, defer, smi)
    session_stream(problem, len(earlier), smi)

    zones, zone_masks = candidate_zone_masks(driver_order, executor_order, metadata, cluster.node_names, n_b)
    inputs = single_az_queue_inputs(cluster, problem, zone_masks, len(zones), len(earlier))
    if inputs is None:
        raise SystemExit("the main-path snapshot is outside the fused single-AZ lane's bounds")
    az_arrays, az_scalars = on(dev, inputs[0]), inputs[1]
    per_node = (0, 1, 2, 3, 8, 9, 10, 11)  # the single-AZ arguments with a node axis
    az_floor = tuple(x[:FLOOR_NODES] if i in per_node else x for i, x in enumerate(az_arrays))
    az_bytes = 4 * 3 * n_b + 4 * n_b + n_b + n_b + 16 * n_b + a_b * 29 + a_b * 10 + 4 * 3 * n_b
    for kname, (az_aware, minfrag) in SINGLE_AZ.items():
        flags = dict(az_aware=az_aware, minfrag=minfrag, strict=True)
        got = sk.fifo_queue_single_az(*az_arrays, *az_scalars, **flags)
        defer(kname, got, "single_az_kernel", "solve_queue_single_az_plain", az_arrays + tuple(az_scalars),
              "the main-path inputs", key=kname, **flags)
        n_placed, n_uncertain = int(got[0].sum()), int(got[3][: len(earlier)].sum())
        n_cross = int((got[1][: len(earlier)] == len(zones)).sum())
        log(f"phase main-path: {kname}: {n_placed} placed, {n_uncertain} of {len(earlier)} "
            f"queued apps uncertain, {n_cross} on the cross-zone solve; cluster of "
            f"{sk.zone_layout(az_arrays[3], len(zones)).cluster} blocks of {sk.THREADS} threads")
        # every app's zone solves (its zone compare and gang core on every
        # node), the placing zone's fill or drain and the carry update
        work = MF_OPS_PER_NODE_FEASIBLE_APP if minfrag else OPS_PER_NODE_FEASIBLE_APP
        ops = n_b * a_b * (len(zones) + OPS_PER_NODE_VALID_APP) + n_placed * (n_b // len(zones) * work + 3 * n_b)
        kernels.append(timed(
            kname, "single_az", lambda: sk.fifo_queue_single_az(*az_arrays, *az_scalars, **flags),
            lambda: sk.fifo_queue_single_az(*az_floor, *az_scalars, **flags), ops, az_bytes,
        ))
    for kind, lib in libraries.items():
        for entry, registers, spills in ptxas_report(lib.build_log):
            log(f"phase main-path: ptxas {kind} {entry}: {registers} registers, {spills} bytes spill stores")
    for p in solvers:
        log(f"phase main-path: {p} Filter decision median {median_ms(solve_ms[p])} | {smi}")

    # where a Filter decision's time goes (host clock): tensorizing the
    # cluster, the solve with vectorized efficiency rows, and the solve with
    # exact Quantity efficiencies (what solve() runs), for tightly-pack and
    # minimal-fragmentation; the single-AZ decision against its tensorizing
    for p in ("tightly-pack", "minimal-fragmentation"):
        solver = solvers[p]
        parts = {"tensorize_cluster": [], "solve_tensor_rows": [], "solve_tensor_metadata": []}
        for _ in range(3):
            t = time.perf_counter()
            cluster = tensorize_cluster(metadata, driver_order, executor_order)
            parts["tensorize_cluster"].append((time.perf_counter() - t) * 1e3)
            for key, meta in (("solve_tensor_rows", None), ("solve_tensor_metadata", metadata)):
                t = time.perf_counter()
                solver.solve_tensor(cluster, earlier, skip, currents[0], metadata=meta)
                torch.cuda.synchronize()
                parts[key].append((time.perf_counter() - t) * 1e3)
        log(f"phase main-path: {p} breakdown (median ms) " + ", ".join(
            f"{k} {statistics.median(v):.1f}" for k, v in parts.items()) + f" | {smi}")
    t = time.perf_counter()
    tensorize_cluster(metadata, driver_order, executor_order)
    tensorize_ms = (time.perf_counter() - t) * 1e3
    log(f"phase main-path: single-az-minimal-fragmentation breakdown (ms): decision "
        f"{statistics.median(solve_ms['single-az-minimal-fragmentation']):.1f}, of which "
        f"tensorize_cluster {tensorize_ms:.1f} and the queue kernel "
        f"{kernels[-1]['ms']:.1f} (path {paths['single-az-minimal-fragmentation'][0]}) | {smi}")
    for p in ("tightly-pack", "minimal-fragmentation", "single-az-minimal-fragmentation"):
        share = busy_share(
            lambda: solvers[p].solve(metadata, driver_order, executor_order, earlier, skip, currents[0])
        )
        log(f"phase main-path: profiler trace of one {p} decision: {share} | {smi}")

    # the same decisions on the CPU (the plain versions), from the twin:
    # read last, so that the twin's work overlaps the rest of phase 4
    t = time.perf_counter()
    cpu_keys = {p: result.get(timeout=1800) for p, result in cpu_decisions.items()}
    log(f"phase main-path: the cpu decisions took " + ", ".join(f"{p} {s:.1f} s" for p, (_, s) in cpu_keys.items())
        + f" in the twins beside the build and phases 3-4; waited {time.perf_counter() - t:.1f} s for them here")
    for p in solvers:
        for i, want in enumerate(cpu_keys[p][0]):
            if decisions[p][i] != want:
                raise SystemExit(f"{p} decision {i} on cuda differs from cpu: {decisions[p][i]} vs {want}")
            if not want[1] or not want[2][0]:
                raise SystemExit(f"{p} decision {i} placed nothing: {want}")
        log(f"phase main-path: {p} {n_decisions[p]} decisions equal on cuda and cpu "
            f"(first driver {decisions[p][0][2][1]}, {len(decisions[p][0][2][2])} executors)")
    for bname, got in bp.items():
        want = select_binpacker(bname, device="cpu").binpack_func(*bp_args)
        if (got.has_capacity, got.driver_node, got.executor_nodes) != (
            want.has_capacity, want.driver_node, want.executor_nodes
        ) or not got.has_capacity:
            raise SystemExit(f"{bname} binpack_func on cuda differs from cpu or placed nothing")
        log(f"phase main-path: {bname} binpack_func equal on cuda and cpu (driver {got.driver_node})")
    # phases 3-4's kernel outputs against the plain twins' plain versions
    # (a difference exits here, so the kernels line's errors stand)
    t = time.perf_counter()
    for kname, got, result, where, key in deferred:
        want, ms = result.get(timeout=1800)
        check(kname, got, on(dev, want), where)
        if key is not None:
            plain_ms[key] = ms
    for entry in kernels:
        entry["plain_ms"] = plain_ms[entry["name"]]
    log(f"phase kernel-vs-plain: {len(deferred)} kernel outputs of phases 3-4 equal to their plain versions, "
        f"computed on the cpu in {PLAIN_WORKERS} plain twins beside them; waited {time.perf_counter() - t:.1f} s "
        f"for them here; plain ms (one call, cpu) " + ", ".join(f"{k} {v:.1f}" for k, v in plain_ms.items()))
    deferred.clear()
    plain_twins.stop()

    log(f"phase main-path: phases 1-4 took {time.perf_counter() - t_script:.1f} s")

    # ---- phase 5: the Filter server on the card
    servers_base = time.time() - 10_000.0  # the queue's creation base of phases 5, az-server and classes (j)
    t = time.perf_counter()
    server_launches, server_recorded = server_phase(args.seed, smi, servers_base)
    log(f"phase server: took {time.perf_counter() - t:.1f} s (the bodies held to the cpu servers' before phase "
        f"classes); the script so far {time.perf_counter() - t_script:.1f} s")

    # ---- phase az-server: the single-AZ family through the port's server;
    # the cpu servers of phases 5, az-server and classes (j) answer in the
    # server twins, one a name, beside the phases from here on
    server_cpu = {p: server_twins.submit(twin_server_phase, args.seed, servers_base, p) for p in SERVER_POLICIES}
    az_cpu = {p: server_twins.submit(twin_az_server, args.seed, servers_base, p) for p in AZ_SERVER_KERNEL}
    classes_cpu = {p: server_twins.submit(twin_classes_servers, args.seed, servers_base, p)
                   for p in CLASSES_SERVER_KERNEL}
    t = time.perf_counter()
    az_launches, az_recorded = az_server_phase(args.seed, smi, servers_base)
    for entry in kernels:
        entry["launches"] += az_launches.get(entry["name"], 0)
    log(f"phase az-server: took {time.perf_counter() - t:.1f} s (the bodies held to the cpu servers' before phase "
        f"classes); the script so far {time.perf_counter() - t_script:.1f} s")

    # ---- phase 6: the server against a cluster over REST
    t = time.perf_counter()
    cluster_phase(args.seed, smi)
    log(f"phase cluster: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase 7: resilience and provenance through the server
    t = time.perf_counter()
    resilience_phase(args.seed, smi)
    log(f"phase resilience: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase delta: the delta-solve engine on against off through the server
    t = time.perf_counter()
    # the checkpointed launches of the main path: phase delta's engine-on
    # servers (tightly-pack, min-frag), phase 5's (distribute-evenly)
    delta_launches = {**server_launches, **delta_phase(args.seed, smi)}
    for kname, (ms, t_bytes, t_ops) in delta_timing.items():
        kind = "min_frag" if kname.startswith("fifo_queue_min_frag") else "queue"
        kernels.append(kernel_entry(kname, kind, delta_launches.get(kname, 0), max_err[kname], ms, plain_ms[kname],
                                    t_bytes, t_ops))
    missing = [kname for kname in delta_timing if delta_launches.get(kname, 0) < 1]
    if missing:
        raise SystemExit(f"phase delta: {missing} not launched on the engine-on servers' path")
    log(f"phase delta: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase observatory: the capacity observatory and the lifecycle ledger
    t = time.perf_counter()
    observatory_phase(args.seed, smi)
    log(f"phase observatory: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase contention: lock telemetry, the critical path, the race detector
    t = time.perf_counter()
    contention_phase(args.seed, smi)
    log(f"phase contention: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase policy: the scheduling-policy engine through the server
    t = time.perf_counter()
    policy_phase(args.seed, smi)
    log(f"phase policy: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase ha: the HA failover fabric through the server
    t = time.perf_counter()
    ha_launches = ha_phase(args.seed, smi)
    for entry in kernels:
        entry["launches"] += ha_launches.get(entry["name"], 0)
    log(f"phase ha: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase concurrent: the concurrent admission engine through the server
    t = time.perf_counter()
    # (d)'s cpu cells in the twin, beside (a)-(c)
    concurrent_path = concurrent_phase(args.seed, smi, queue_args, twin.submit(twin_crash_cells))
    for entry in kernels:
        entry["launches"] += concurrent_path.get(entry["name"], 0)
    log(f"phase concurrent: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase sim: the discrete-event simulator on the card
    t = time.perf_counter()
    sim_launches = sim_phase(smi, twin)
    # phase classes (b)'s plain passes, beside phase lab (before phase 5,
    # they would run beside its timed probes)
    classes_plain = twin.submit(twin_classes_plain)
    for entry in kernels:
        entry["launches"] += sim_launches.get(entry["name"], 0)
    log(f"phase sim: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase lab: the policy lab and its gate (host-only: no launch),
    # with phase analysis's corpus (host work) started beside it
    analysis = analysis_start()
    t = time.perf_counter()
    lab_phase(smi)
    log(f"phase lab: took {time.perf_counter() - t:.1f} s (phase analysis's corpus and the twin's phase "
        f"classes (b) passes beside it); the script so far {time.perf_counter() - t_script:.1f} s")

    # ---- phase analysis: the model checker (host-only: no
    # launch), read before phase classes times the card
    t = time.perf_counter()
    analysis_phase(smi, analysis)
    log(f"phase analysis: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # phases 5's and az-server's bodies against the server twins' cpu servers
    t = time.perf_counter()
    server_check(server_recorded, {p: result.get(timeout=1800) for p, result in server_cpu.items()})
    az_server_check(az_recorded, {p: result.get(timeout=1800) for p, result in az_cpu.items()})
    log(f"phases server and az-server: waited {time.perf_counter() - t:.1f} s for the server twins' cpu servers")

    # ---- phase classes: class-compressed stepping on the card
    t = time.perf_counter()
    classes_plain = classes_plain.get(timeout=1800)
    twin.stop()
    log(f"phase classes: waited {time.perf_counter() - t:.1f} s for the twin's plain passes")
    class_entries, row_launches = classes_phase(args.seed, smi, classes_plain, servers_base, classes_cpu)
    server_twins.stop()
    for entry in kernels:
        entry["launches"] += row_launches.get(entry["name"], 0)
    kernels += class_entries
    log(f"phase classes: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase mesh: GangPacker and the whole-queue programs on a node-axis mesh
    t = time.perf_counter()
    mesh_phase(dataclasses.replace(problem, app_valid=valid), (inputs[0], inputs[1]), smi)
    log(f"phase mesh: took {time.perf_counter() - t:.1f} s; the script so far "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- phase 19: results
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
