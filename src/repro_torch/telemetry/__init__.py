"""Unified telemetry: tracing spans, metrics, exporters, as
``repro.telemetry``.

Quickstart::

    from repro_torch import telemetry

    telemetry.enable()
    ... serve ...
    telemetry.write_chrome_trace("trace.json",
                                 telemetry.get_tracer().drain())
    # then load trace.json at https://ui.perfetto.dev

Disabled (the default unless REPRO_TELEMETRY=1) every ``span()`` site
costs one flag check and returns the shared no-op ``NULL_SPAN``.
Enabled, the ``engine.kernel`` span fences its result by synchronizing
the calling thread's current CUDA stream (``Span.clock == "device"``).
"""
from .tracer import (NULL_SPAN, Span, Tracer, disable, enable, enabled,
                     get_tracer, set_tracer, span)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .export import (chrome_trace_events, read_metrics_jsonl,
                     summarize_spans, validate_chrome_trace,
                     validate_metrics_lines, write_chrome_trace,
                     write_metrics_jsonl)

__all__ = [
    "NULL_SPAN", "Span", "Tracer", "span", "enable", "disable", "enabled",
    "get_tracer", "set_tracer",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "chrome_trace_events", "write_chrome_trace", "validate_chrome_trace",
    "write_metrics_jsonl", "read_metrics_jsonl", "validate_metrics_lines",
    "summarize_spans",
]
