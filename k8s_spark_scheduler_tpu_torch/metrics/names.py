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

TAG_KERNEL = "kernel"
TAG_LANE = "lane"
TAG_SPAN = "span"

SLOW_LOG_THRESHOLD_SECONDS = 45.0
