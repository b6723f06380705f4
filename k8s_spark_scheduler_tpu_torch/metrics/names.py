"""Metric name catalog (reference internal/metrics/metrics.go:30-68):
the names this package emits."""

# per-request scheduling metrics (extender)
REQUEST_COUNTER = "foundry.spark.scheduler.requests"
SCHEDULING_PROCESSING_TIME = "foundry.spark.scheduler.schedule.time"
RECONCILIATION_TIME = "foundry.spark.scheduler.reconciliation.time"
SCHEDULING_WAIT_TIME = "foundry.spark.scheduler.wait.time"
SCHEDULING_RETRY_TIME = "foundry.spark.scheduler.retry.time"
PACKING_EFFICIENCY_MAX = "foundry.spark.scheduler.packing.efficiency.max"
DRIVER_EXECUTOR_COLLOCATION = "foundry.spark.scheduler.driver.executor.collocation"
EXECUTOR_NODE_COUNT = "foundry.spark.scheduler.executor.node.count"
APP_CROSS_ZONE = "foundry.spark.scheduler.app.cross.zone"
SINGLE_AZ_DA_PACK_FAILURE_ZONED = (
    "foundry.spark.scheduler.single.az.dynamic.allocation.pack.failure"
)
TIME_TO_FIRST_BIND = "foundry.spark.scheduler.reservations.timetofirstbind"
TIME_TO_FIRST_BIND_MEDIAN = "foundry.spark.scheduler.reservations.timetofirstbind.median"
TIME_TO_FIRST_BIND_MEAN = "foundry.spark.scheduler.reservations.timetofirstbind.mean"

# which lane served a decision: the tensor-mirror lane (lane=fast) or
# the Quantity path (lane=slow), per path=driver|executor; the single-AZ
# queue solver's fused or host lane
TPU_FASTPATH = "foundry.spark.scheduler.tpu.fastpath"
SINGLEAZ_LANE = "foundry.spark.scheduler.tpu.singleaz.lane"

# kernel profiling (tracing/profiling.py), tagged kernel= and lane=
KERNEL_COMPILE_TIME = "foundry.spark.scheduler.tpu.kernel.compile.time"
KERNEL_EXECUTE_TIME = "foundry.spark.scheduler.tpu.kernel.execute.time"
KERNEL_CACHE_HITS = "foundry.spark.scheduler.tpu.kernel.cache.hit.count"
KERNEL_CACHE_MISSES = "foundry.spark.scheduler.tpu.kernel.cache.miss.count"
# per-span duration distributions (tracing/spans.py), tagged span=
TRACE_SPAN_TIME = "foundry.spark.scheduler.trace.span.time"

# node-name interning (types/serde.py)
SERDE_INTERN_HITS = "foundry.spark.scheduler.serde.names.intern.hit.count"
SERDE_INTERN_MISSES = "foundry.spark.scheduler.serde.names.intern.miss.count"

# 409 conflict retries of the write-back (kube/conflict.py)
KUBE_CONFLICT_RETRIES = (
    "foundry.spark.scheduler.tpu.kube.conflict.retry.count"
)

# periodic reporters (metrics/reporters.py): reserved usage per node
# (usage.go), pending-pod ages (queue.go), cache drift and write-back
# queue depths (cache.go), unbound reservations
# (resourcereservations.go), soft reservations (softreservations.go),
# informer delivery lag (informer.go), and the registry's own
# per-name label-set cardinality
RESOURCE_USAGE_CPU = "foundry.spark.scheduler.resource.usage.cpu"
RESOURCE_USAGE_MEMORY = "foundry.spark.scheduler.resource.usage.memory"
RESOURCE_USAGE_NVIDIA_GPUS = "foundry.spark.scheduler.resource.usage.nvidia.com/gpu"
LIFECYCLE_AGE_MAX = "foundry.spark.scheduler.pod.lifecycle.max"
LIFECYCLE_AGE_P95 = "foundry.spark.scheduler.pod.lifecycle.p95"
LIFECYCLE_AGE_P50 = "foundry.spark.scheduler.pod.lifecycle.p50"
LIFECYCLE_COUNT = "foundry.spark.scheduler.pod.lifecycle.count"
CACHED_OBJECT_COUNT = "foundry.spark.scheduler.cache.objects.count"
CACHED_OBJECT_DRIFT = "foundry.spark.scheduler.cache.objects.count.drift"
INFLIGHT_REQUEST_COUNT = "foundry.spark.scheduler.cache.inflight.count"
UNBOUND_CPU_RESERVATIONS = "foundry.spark.scheduler.reservations.unbound.cpu"
UNBOUND_MEMORY_RESERVATIONS = "foundry.spark.scheduler.reservations.unbound.memory"
UNBOUND_NVIDIA_GPU_RESERVATIONS = "foundry.spark.scheduler.reservations.unbound.nvidiagpu"
SOFT_RESERVATION_COUNT = "foundry.spark.scheduler.softreservation.count"
SOFT_RESERVATION_EXECUTOR_COUNT = "foundry.spark.scheduler.softreservation.executorcount"
EXECUTORS_WITH_NO_RESERVATION_COUNT = (
    "foundry.spark.scheduler.softreservation.executorswithnoreservations"
)
POD_INFORMER_DELAY = "foundry.spark.scheduler.informer.delay"
POD_INFORMER_DELAY_MAX = "foundry.spark.scheduler.informer.delay.max"
METRICS_REGISTRY_SERIES = (
    "foundry.spark.scheduler.tpu.metrics.registry.series"
)

# scheduling waste around demand creation / fulfilment (metrics/waste.py)
SCHEDULING_WASTE = "foundry.spark.scheduler.scheduling.waste"
SCHEDULING_WASTE_PER_INSTANCE_GROUP = (
    "foundry.spark.scheduler.scheduling.wasteperinstancegroup"
)

# resilience layer (resilience/): overload protection + degraded mode
RESILIENCE_SHED_COUNT = "foundry.spark.scheduler.resilience.shed.count"
RESILIENCE_DEADLINE_EXPIRED_COUNT = (
    "foundry.spark.scheduler.resilience.deadline.expired.count"
)
RESILIENCE_BREAKER_STATE = "foundry.spark.scheduler.resilience.breaker.state"
RESILIENCE_BREAKER_TRANSITIONS = (
    "foundry.spark.scheduler.resilience.breaker.transitions.count"
)
RESILIENCE_JOURNAL_DEPTH = "foundry.spark.scheduler.resilience.journal.depth"
RESILIENCE_JOURNAL_APPENDED = (
    "foundry.spark.scheduler.resilience.journal.appended.count"
)
RESILIENCE_JOURNAL_REPLAYED = (
    "foundry.spark.scheduler.resilience.journal.replayed.count"
)
RESILIENCE_HEALTH_STATE = "foundry.spark.scheduler.resilience.health.state"
RESILIENCE_GATE_INFLIGHT = "foundry.spark.scheduler.resilience.gate.inflight"
# background compactions triggered by the acked-fraction threshold
RESILIENCE_JOURNAL_COMPACTIONS = (
    "foundry.spark.scheduler.resilience.journal.compaction.count"
)
# torn tails truncated at recovery (bad CRC / partial final records)
RESILIENCE_JOURNAL_TORN_TAIL = (
    "foundry.spark.scheduler.resilience.journal.torn.tail.count"
)

# policy engine (policy/): priority ordering, backfill, gang-aware
# preemption, DRF fair share
# committed preemptions (one per validated victim plan)
POLICY_PREEMPTION_COUNT = "foundry.spark.scheduler.tpu.policy.preemption.count"
# whole applications evicted across all preemptions
POLICY_PREEMPTION_VICTIMS = (
    "foundry.spark.scheduler.tpu.policy.preemption.victims"
)
# victim-set what-if validation latency (milliseconds; histogram)
POLICY_WHATIF_MS = "foundry.spark.scheduler.tpu.policy.preemption.whatif.ms"
# per-tenant weighted dominant share (gauge, tagged tenant=)
POLICY_DRF_SHARE = "foundry.spark.scheduler.tpu.policy.drf.share"
# blocked queue heads safely skipped by the conservative backfill probe
POLICY_BACKFILL_SKIPS = "foundry.spark.scheduler.tpu.policy.backfill.skips"

# HA failover fabric (ha/): lease-fenced multi-replica operation
# 1 while this replica holds the lease, 0 as follower
HA_LEADER_STATE = "foundry.spark.scheduler.tpu.ha.leader.state"
# the fencing epoch this replica holds (0 = never elected)
HA_EPOCH = "foundry.spark.scheduler.tpu.ha.epoch"
# leadership transitions, tagged to=leader|follower
HA_TRANSITIONS = "foundry.spark.scheduler.tpu.ha.transitions.count"
# fenced writes refused with StaleEpochError, tagged op=
HA_FENCE_REFUSALS = "foundry.spark.scheduler.tpu.ha.fence.refused.count"
# writes that committed while a newer epoch was observed — ALWAYS 0
# (the I-H3 invariant witness; any nonzero value is a split-brain bug)
HA_FENCE_STALE_COMMITS = (
    "foundry.spark.scheduler.tpu.ha.fence.stale.commit.count"
)
# takeover reconciliation wall time (seconds)
HA_RECONCILE_TIME = "foundry.spark.scheduler.tpu.ha.reconcile.time"
# repairs applied by the takeover reconciler, tagged class=
HA_RECONCILE_REPAIRS = (
    "foundry.spark.scheduler.tpu.ha.reconcile.repairs.count"
)

# decision provenance (provenance/): unschedulability explainer,
# shortfall telemetry, anomaly flight recorder
# per-dimension cluster shortfall (executors short when that dimension
# alone were the constraint), tagged dim=cpu|memory|nvidia.com/gpu
PROVENANCE_SHORTFALL = "foundry.spark.scheduler.tpu.provenance.shortfall"
# blocker-set size distribution of explained refusals
PROVENANCE_BLOCKERS = "foundry.spark.scheduler.tpu.provenance.blockers"
# explain invocations, tagged source=refusal|refusal-cached|http|debug
PROVENANCE_EXPLAIN_COUNT = (
    "foundry.spark.scheduler.tpu.provenance.explain.count"
)
# decision-record ring depth
PROVENANCE_RECORDS = "foundry.spark.scheduler.tpu.provenance.records"
# flight-recorder persists, tagged trigger=; bytes of the last bundle file
PROVENANCE_BUNDLE_PERSISTED = (
    "foundry.spark.scheduler.tpu.provenance.bundle.persisted.count"
)
PROVENANCE_BUNDLE_BYTES = (
    "foundry.spark.scheduler.tpu.provenance.bundle.bytes"
)
# warm≠cold parity guard outcomes, tagged result=ok|mismatch
PROVENANCE_PARITY_CHECKS = (
    "foundry.spark.scheduler.tpu.provenance.parity.check.count"
)

# delta-solve engine (ops/deltasolve.py): device-resident solver
# sessions + prefix-feasibility reuse for the earlier-drivers-fit loop
DELTASOLVE_WARM_HITS = "foundry.spark.scheduler.tpu.deltasolve.warm.hit.count"
DELTASOLVE_WARM_MISSES = "foundry.spark.scheduler.tpu.deltasolve.warm.miss.count"
DELTASOLVE_RESUME_DEPTH = "foundry.spark.scheduler.tpu.deltasolve.resume.depth"
DELTASOLVE_SESSIONS = "foundry.spark.scheduler.tpu.deltasolve.sessions"
DELTASOLVE_SESSION_BYTES = "foundry.spark.scheduler.tpu.deltasolve.session.bytes"

# equivalence-class aggregation (state/classindex.py): fleet shape
# diversity and compression health (the reference's names)
# distinct node equivalence classes in the mirror (gauge)
CLASSES_COUNT = "foundry.spark.scheduler.tpu.classes.count"
# nodes per class
CLASSES_COMPRESSION_RATIO = (
    "foundry.spark.scheduler.tpu.classes.compression.ratio"
)
# session partition rebuilds (the reference's native class mode)
CLASSES_REBUILD_COUNT = "foundry.spark.scheduler.tpu.classes.rebuild.count"
# bind-time expansion latency: class placements → concrete node rows
# (milliseconds; histogram)
CLASSES_EXPAND_MS = "foundry.spark.scheduler.tpu.classes.expand.ms"

# capacity observatory (capacity/): fragmentation/headroom analytics,
# queue-pressure forecasts, and the /state/capacity timeline
# per-dim total free capacity over schedulable nodes (base units)
CAPACITY_FREE = "foundry.spark.scheduler.tpu.capacity.free"
# per-dim largest single-node free chunk (base units)
CAPACITY_LARGEST_CHUNK = "foundry.spark.scheduler.tpu.capacity.largest.chunk"
# per-dim fragmentation index: 1 − largest-chunk/total-free
CAPACITY_FRAGMENTATION = "foundry.spark.scheduler.tpu.capacity.fragmentation"
# largest admissible gang per (shape, instance-group, zone); empty
# group/zone tags = cluster-wide
CAPACITY_HEADROOM = "foundry.spark.scheduler.tpu.capacity.headroom"
# per-instance-group max-dimension reserved/allocatable ratio
CAPACITY_UTILIZATION = "foundry.spark.scheduler.tpu.capacity.utilization"
# pending driver gangs / the subset that does not fit right now
CAPACITY_QUEUED_GANGS = "foundry.spark.scheduler.tpu.capacity.queued.gangs"
CAPACITY_QUEUE_PRESSURE = (
    "foundry.spark.scheduler.tpu.capacity.queue.pressure"
)
# forecast seconds until a fitting queued gang admits
CAPACITY_TIME_TO_ADMIT = "foundry.spark.scheduler.tpu.capacity.time.to.admit"
# sampler self-observability
CAPACITY_SAMPLE_COUNT = "foundry.spark.scheduler.tpu.capacity.sample.count"
CAPACITY_SAMPLE_TIME = "foundry.spark.scheduler.tpu.capacity.sample.time"
CAPACITY_PROBE_SOLVES = "foundry.spark.scheduler.tpu.capacity.probe.solves"

# contention observatory (contention/): lock wait/hold telemetry and
# per-request critical-path decomposition
# time blocked in acquire, per lock site (seconds; histogram)
LOCK_WAIT_TIME = "foundry.spark.scheduler.tpu.lock.wait.time"
# time the lock was held, tagged with the holder's span phase
LOCK_HOLD_TIME = "foundry.spark.scheduler.tpu.lock.hold.time"
# cumulative acquires / contended acquires per lock site (gauges)
LOCK_ACQUIRE_COUNT = "foundry.spark.scheduler.tpu.lock.acquire.count"
LOCK_CONTENDED_COUNT = "foundry.spark.scheduler.tpu.lock.contended.count"
# cumulative wait seconds charged to the phase that HELD the lock
# (tagged lock=, holder=): the top-blocker table as a metric
LOCK_BLOCKED_SECONDS = "foundry.spark.scheduler.tpu.lock.blocked.seconds"
# per-request latency attributed to one named segment (seconds, tagged
# segment=gate-queue|lock-wait|serde|solve|speculate|write-back|other)
CRITICALPATH_SEGMENT_TIME = "foundry.spark.scheduler.tpu.criticalpath.segment.time"
# fraction of each request attributed to a named (non-other) segment
CRITICALPATH_COVERAGE = "foundry.spark.scheduler.tpu.criticalpath.coverage"
# requests whose largest segment was <segment>
CRITICALPATH_DOMINANT_COUNT = "foundry.spark.scheduler.tpu.criticalpath.dominant.count"

# gang lifecycle ledger (lifecycle/ledger.py)
# phase transitions (counter, tagged phase=)
LIFECYCLE_TRANSITIONS = (
    "foundry.spark.scheduler.tpu.lifecycle.transitions.count"
)
# gangs currently in each phase (gauge, tagged phase=)
LIFECYCLE_GANGS = "foundry.spark.scheduler.tpu.lifecycle.gangs"
# gang queue wait submitted→bound (seconds; histogram)
LIFECYCLE_QUEUE_WAIT = (
    "foundry.spark.scheduler.tpu.lifecycle.queue.wait.time"
)
# per-request solver tenure attributed to a gang (seconds; histogram)
LIFECYCLE_SOLVE_TENURE = (
    "foundry.spark.scheduler.tpu.lifecycle.solve.tenure.time"
)
# gangs evicted, by coarse cause bucket (counter, tagged cause=)
LIFECYCLE_EVICTIONS = (
    "foundry.spark.scheduler.tpu.lifecycle.evictions.count"
)

# SLO engine (lifecycle/slo.py)
# good/bad samples per objective (counter, tagged objective=, outcome=)
SLO_EVENTS = "foundry.spark.scheduler.tpu.slo.events.count"
# burn rate per objective and alert window (gauge, tagged objective=,
# window=page-long|page-short|warn-long|warn-short)
SLO_BURN_RATE = "foundry.spark.scheduler.tpu.slo.burn.rate"
# error budget remaining over the long ticket window (gauge, 0..1)
SLO_BUDGET_REMAINING = "foundry.spark.scheduler.tpu.slo.budget.remaining"
# alert state per objective (gauge: 0 ok, 1 warn, 2 page)
SLO_STATE = "foundry.spark.scheduler.tpu.slo.state"

TAG_OUTCOME = "outcome"
TAG_INSTANCE_GROUP = "instance-group"
TAG_ZONE = "zone"
TAG_PHASE = "phase"
TAG_OBJECTIVE = "objective"
TAG_WINDOW = "window"
TAG_CAUSE = "cause"
TAG_HOST = "nodename"
TAG_LIFECYCLE = "lifecycle"
TAG_QUEUE_INDEX = "queueIndex"
TAG_WASTE_TYPE = "wastetype"
TAG_KERNEL = "kernel"
TAG_LANE = "lane"
TAG_SPAN = "span"
TAG_LOCK = "lock"
# the span phase that held a lock while another thread waited on it
TAG_HOLDER = "holder"
TAG_SEGMENT = "segment"
# the policy-lab matrix cell a per-cell series belongs to
TAG_CELL = "cell"

TICK_INTERVAL_SECONDS = 30.0
SLOW_LOG_THRESHOLD_SECONDS = 45.0
STUCK_POD_LOG_THRESHOLD_SECONDS = 12 * 3600.0

# concurrent admission engine (concurrent/): parallel speculative
# solves + FIFO-ordered commit gate
# speculation attempts, tagged outcome=solved|overlap|inflight-cap|
# replay|not-driver|policy-engine|... (every decline names its reason)
CONCURRENT_SPECULATION_COUNT = (
    "foundry.spark.scheduler.tpu.concurrent.speculation.count"
)
# speculative work abandoned because the request deadline expired,
# tagged phase=speculation-start|speculation-solved|commit-gate
CONCURRENT_SPECULATION_CANCELLED = (
    "foundry.spark.scheduler.tpu.concurrent.speculation.cancelled"
)
# commit-gate revalidation results, tagged result=seq-hit|memcmp-hit|
# conflict|queue-drift|skip-drift|candidate-drift|serial
CONCURRENT_COMMIT_RESULT = (
    "foundry.spark.scheduler.tpu.concurrent.commit.result"
)
# commits whose speculative verdict was invalidated (re-solved under
# the lock on the warm delta path) — the conflict-rate numerator
CONCURRENT_COMMIT_CONFLICTS = (
    "foundry.spark.scheduler.tpu.concurrent.commit.conflicts.count"
)
# time a request waited for its FIFO commit turn (seconds; histogram)
CONCURRENT_TICKET_WAIT_TIME = (
    "foundry.spark.scheduler.tpu.concurrent.ticket.wait.time"
)
# speculations currently in flight (gauge)
CONCURRENT_INFLIGHT = "foundry.spark.scheduler.tpu.concurrent.inflight.count"
# multi-active commit intents received, tagged result=committed|
# stale-epoch (stale intents are refused before reaching the gate)
CONCURRENT_INTENTS_FORWARDED = (
    "foundry.spark.scheduler.tpu.concurrent.intents.forwarded.count"
)

# sim runner decision instrumentation (sim/runner.py) — virtual-clock
# scenario metrics, namespaced so the catalog contract covers them
SIM_DECISION_LATENCY = "foundry.spark.scheduler.tpu.sim.decision.latency"
SIM_QUEUE_DEPTH = "foundry.spark.scheduler.tpu.sim.queue.depth"
# auditor coverage (sim/auditor.py): events audited / invariant hits
SIM_AUDIT_EVENTS = "foundry.spark.scheduler.tpu.sim.audit.events"
SIM_AUDIT_VIOLATIONS = (
    "foundry.spark.scheduler.tpu.sim.audit.violations.count"
)

# policy lab (lab/): trace synthesis + matrix evaluation harness
# apps emitted by one synthesizer invocation
LAB_TRACE_APPS = "foundry.spark.scheduler.tpu.lab.trace.apps"
# cells executed per matrix run
LAB_MATRIX_CELLS = "foundry.spark.scheduler.tpu.lab.matrix.cells"
# per-cell replay wall time (seconds; histogram, tagged cell=)
LAB_CELL_WALL_TIME = "foundry.spark.scheduler.tpu.lab.cell.wall.time"
# per-cell replay event count (gauge, tagged cell=)
LAB_CELL_EVENTS = "foundry.spark.scheduler.tpu.lab.cell.events.count"
# per-cell gang evictions (gauge, tagged cell=)
LAB_CELL_EVICTIONS = "foundry.spark.scheduler.tpu.lab.cell.evictions.count"
