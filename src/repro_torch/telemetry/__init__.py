"""Telemetry: span tracing, typed counters, drift records, logging.

Port of ``src/repro/telemetry/`` (plain Python, kept as is).

The observability layer of the planning stack (the reference's docs/OBSERVABILITY.md).
Zero-dependency and off by default — every instrumented call site costs
one attribute load and a falsy check until :func:`configure` (or the
``REPRO_TRACE`` env var) enables the process-wide tracer.  Exporters
write a JSONL event stream or Chrome trace-event JSON (Perfetto).

Typical instrumentation::

    from repro_torch import telemetry as tm

    with tm.span("csse.stage1", engine=engine):
        ...
    tm.inc("csse.cache.misses")
    tm.drift("autotune.step", predicted_s=analytic, measured_s=best_s)

Cross-thread handoff (spans survive the autotune worker thread)::

    ctx = tm.current_context()
    def job():
        with tm.attach(ctx):
            ...                      # spans parent under the caller's
    pool.submit(job)
"""

from repro_torch.telemetry.log import Logger, get_logger
from repro_torch.telemetry.tracer import (
    SpanContext, Tracer, attach, complete_span, configure, counters,
    current_context, drift, drift_records, enabled, event, finalize, inc,
    now_us, reset, sample, snapshot, span, suspended, warn_once_key,
)

__all__ = [
    "Logger", "SpanContext", "Tracer", "attach", "complete_span",
    "configure", "counters", "current_context", "drift", "drift_records",
    "enabled", "event", "finalize", "get_logger", "inc", "now_us",
    "reset", "sample", "snapshot", "span", "suspended", "warn_once_key",
]
