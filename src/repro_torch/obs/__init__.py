"""Always-on, clock-injected observability: causal request tracing, a
bounded flight recorder, deterministic exporters, and critical-path
attribution feeding measured costs back into the fusion policy."""
from repro_torch.obs.critical_path import EdgeCostModel, attribute, attribute_trace, build_trees, summarize
from repro_torch.obs.export import (
    chrome_trace,
    dumps_chrome,
    export_all_chrome,
    export_chrome,
    prometheus_text,
    serve_prometheus,
)
from repro_torch.obs.trace import (
    CONTROL_TRACE_ID,
    PHASES,
    FlightRecorder,
    SpanContext,
    SpanRecord,
    Tracer,
    live_tracers,
    retain_tracers,
)

__all__ = [
    "CONTROL_TRACE_ID",
    "PHASES",
    "EdgeCostModel",
    "FlightRecorder",
    "SpanContext",
    "SpanRecord",
    "Tracer",
    "attribute",
    "attribute_trace",
    "build_trees",
    "chrome_trace",
    "dumps_chrome",
    "export_all_chrome",
    "export_chrome",
    "live_tracers",
    "prometheus_text",
    "retain_tracers",
    "serve_prometheus",
    "summarize",
]
