"""Span-based tracing for the scheduling hot path.

The reference scheduler runs inside the witchcraft runtime, which gives
every request a zipkin-style trace (trc1 log lines, span ids on every
log statement).  This package is that runtime's analog for the
reproduction: lightweight in-process spans with parent/child links and
tags, a bounded ring of completed traces served over ``GET /traces``,
and kernel-level profiling hooks that split queue-solver time into
build vs execute (``tracing.profiling``).

Design constraints (the hot path is ~1ms end to end):

- a span is a handful of attribute writes + one ``perf_counter`` pair;
- context propagation uses one ``contextvars.ContextVar`` shared by all
  tracers, so events/logs can stamp ``trace_id`` without knowing which
  tracer opened the trace;
- a disabled tracer returns a shared no-op context manager (zero
  allocation), so tracing can never regress an untraced deployment.
"""

from .spans import (  # noqa: F401
    NOOP_SPAN,
    Span,
    Tracer,
    add_tag,
    child_span,
    current_span,
    current_trace_id,
    default_tracer,
)
