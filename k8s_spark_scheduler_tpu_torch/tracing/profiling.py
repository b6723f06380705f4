"""Kernel-level profiling hooks for the queue solvers.

A flat request timer can't tell an operator whether a slow Filter paid a
kernel *build* (a new library: nvcc at first use, tens of seconds) or
*execution* (steady state), so the profiler splits every profiled
dispatch into:

- **compile time** — wall time of the first dispatch of a (kernel,
  shape key), which includes building and loading the library
  (``KERNEL_COMPILE_TIME``),
- **execute time** — time until the device finished the dispatch
  (``KERNEL_EXECUTE_TIME``),
- **cache hits/misses** — ``KERNEL_CACHE_HITS`` / ``KERNEL_CACHE_MISSES``,

all tagged with the kernel name and the lane ("cuda", "torch"), and
mirrored onto the active trace span (``kernel:<name>``) so a span tree
shows which kernel built mid-request.

``record.sync(*tensors)`` marks the end of the dispatch and waits for
the device with ``torch.cuda.synchronize`` when a tensor lies on a CUDA
device.  All of it runs only while the profiler is enabled: a disabled
profiler hands out a shared no-op whose ``sync`` does nothing, so the
solver path is then untouched.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional, Set, Tuple

import torch

from ..metrics import names as mnames
from .spans import NOOP_SPAN, Tracer, current_span, default_tracer
from ..analysis.guarded import guarded_by


class _KernelRecord:
    """Per-dispatch timing marks.  ``sync(*tensors)`` must be called
    right after the dispatch returns, with its outputs — it stamps the
    dispatch end, then waits until the device has finished."""

    __slots__ = ("t0", "t_dispatch", "t_end")

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.t_dispatch: Optional[float] = None
        self.t_end: Optional[float] = None

    def sync(self, *tensors: Any) -> None:
        self.t_dispatch = time.perf_counter()
        for device in {t.device for t in tensors if t.device.type == "cuda"}:
            torch.cuda.synchronize(device)
        self.t_end = time.perf_counter()


class _NoopRecord:
    __slots__ = ()

    def sync(self, *tensors: Any) -> None:
        pass


class _NoopProfile:
    __slots__ = ()

    def __enter__(self) -> _NoopRecord:
        return _NOOP_RECORD

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP_RECORD = _NoopRecord()
_NOOP_PROFILE = _NoopProfile()


class _Profile:
    __slots__ = ("_profiler", "_kernel", "_lane", "_shape_key", "_rec", "_span")

    def __init__(self, profiler, kernel, lane, shape_key):
        self._profiler = profiler
        self._kernel = kernel
        self._lane = lane
        self._shape_key = shape_key
        self._rec: Optional[_KernelRecord] = None
        self._span = NOOP_SPAN

    def __enter__(self) -> _KernelRecord:
        # kernel spans are always sub-phases: attach only when a request
        # span is active, so background solves (warmup) don't litter the
        # ring with root traces
        if current_span() is not None:
            self._span = self._profiler.tracer.span(
                f"kernel:{self._kernel}", {mnames.TAG_LANE: self._lane}
            )
        self._span.__enter__()
        self._rec = _KernelRecord()
        return self._rec

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self._rec
        now = time.perf_counter()
        t_end = rec.t_end if rec.t_end is not None else now
        t_dispatch = rec.t_dispatch if rec.t_dispatch is not None else t_end
        try:
            if exc is None:
                self._record(rec.t0, t_dispatch, t_end)
        finally:
            self._span.__exit__(exc_type, exc, tb)
        return False

    def _record(self, t0: float, t_dispatch: float, t_end: float) -> None:
        prof = self._profiler
        metrics = prof.metrics
        tags = {mnames.TAG_KERNEL: self._kernel, mnames.TAG_LANE: self._lane}
        miss = prof._classify_miss(self._kernel, self._shape_key)
        if miss:
            compile_s = t_dispatch - t0
            execute = t_end - t_dispatch
            metrics.counter(mnames.KERNEL_CACHE_MISSES, tags)
            metrics.histogram(mnames.KERNEL_COMPILE_TIME, compile_s, tags)
            self._span.tag("compileMs", round(compile_s * 1000.0, 4))
        else:
            # steady state: dispatch is µs-level, fold it into execute
            execute = t_end - t0
            metrics.counter(mnames.KERNEL_CACHE_HITS, tags)
        metrics.histogram(mnames.KERNEL_EXECUTE_TIME, execute, tags)
        self._span.tag("executeMs", round(execute * 1000.0, 4))
        self._span.tag("cacheHit", not miss)


@guarded_by("_seen_lock", "_seen")
class KernelProfiler:
    """Profiling sink: records into a metrics registry and the active
    trace.  One module-level instance (``default_profiler``), disabled
    until the server wiring enables it with its registry and tracer."""

    def __init__(self, metrics=None, tracer: Optional[Tracer] = None, enabled: bool = False):
        from ..metrics.registry import default_registry

        self.metrics = metrics if metrics is not None else default_registry
        self.tracer = tracer if tracer is not None else default_tracer
        self.enabled = enabled
        self._seen: Set[Tuple[str, Any]] = set()
        self._seen_lock = threading.Lock()

    def configure(self, metrics=None, tracer: Optional[Tracer] = None, enabled: Optional[bool] = None) -> None:
        if metrics is not None:
            self.metrics = metrics
        if tracer is not None:
            self.tracer = tracer
        if enabled is not None:
            self.enabled = enabled

    def profile(self, kernel: str, lane: str = "", shape_key: Any = None):
        """Context manager around one kernel dispatch.  The managed
        value is a record whose ``sync(*outputs)`` the caller invokes
        immediately after the dispatch returns."""
        if not self.enabled:
            return _NOOP_PROFILE
        return _Profile(self, kernel, lane, shape_key)

    def _classify_miss(self, kernel, shape_key) -> bool:
        key = (kernel, shape_key)
        with self._seen_lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            return True


default_profiler = KernelProfiler()
