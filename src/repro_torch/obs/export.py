"""Trace exporters: Chrome ``trace_event`` JSON and Prometheus text.

Chrome export is deterministic by construction: events are emitted in the
recorder's canonical order (start time, trace id, span id), timestamps are
microseconds from the injected clock's origin, ``pid`` is the tracer's
registration ordinal within the process and ``tid`` the trace id — no
wall-clock, thread-ident, or object-id field ever reaches the file, and
``json.dumps(sort_keys=True)`` with fixed separators pins the bytes.  Load
the file at ``ui.perfetto.dev`` or ``chrome://tracing``.

The Prometheus dump flattens ``platform.stats()`` plus recorder
aggregates, dispatch-tracer counters, and edge-cost EWMAs into standard
text exposition; ``serve_prometheus`` exposes it on a stdlib HTTP
endpoint for scrape-based setups.
"""
from __future__ import annotations

import json
import re

from repro_torch.obs.trace import CONTROL_TRACE_ID, FlightRecorder, SpanRecord, live_tracers

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_LABEL_ESC = str.maketrans({"\\": "\\\\", '"': '\\"', "\n": "\\n"})


# ------------------------------------------------------------ chrome JSON


def chrome_events(records: list[SpanRecord], *, pid: int = 1) -> list[dict]:
    events: list[dict] = [
        {"ph": "M", "pid": pid, "tid": CONTROL_TRACE_ID, "name": "thread_name",
         "args": {"name": "control-plane"}},
    ]
    for r in records:
        args = dict(r.args or {})
        args["span_id"] = r.span_id
        args["parent_id"] = r.parent_id
        ev = {
            "name": r.name,
            "cat": r.cat,
            "ph": r.ph,
            "ts": round(r.t0 * 1e6, 3),
            "pid": pid,
            "tid": r.trace_id,
            "args": args,
        }
        if r.ph == "X":
            ev["dur"] = round((r.t1 - r.t0) * 1e6, 3)
        else:
            ev["s"] = "t"  # instant event scoped to its thread (trace)
        events.append(ev)
    return events


def chrome_trace(records: list[SpanRecord], *, pid: int = 1) -> dict:
    return {"traceEvents": chrome_events(records, pid=pid),
            "displayTimeUnit": "ms"}


def dumps_chrome(doc: dict) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def export_chrome(path: str, recorder: FlightRecorder) -> int:
    """Write one recorder's trace; returns the number of events."""
    doc = chrome_trace(recorder.snapshot())
    with open(path, "w") as fh:
        fh.write(dumps_chrome(doc))
    return len(doc["traceEvents"])


def export_all_chrome(path: str) -> int:
    """Merge every live tracer in the process into one file, one ``pid``
    per tracer in registration order (load_bench ``--trace``)."""
    events: list[dict] = []
    for i, tracer in enumerate(live_tracers(), start=1):
        events.extend(chrome_events(tracer.recorder.snapshot(), pid=i))
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        fh.write(dumps_chrome(doc))
    return len(events)


# ------------------------------------------------------------ prometheus


def _metric_name(parts: tuple[str, ...]) -> str:
    return "repro_" + "_".join(_NAME_RE.sub("_", p).strip("_") or "x" for p in parts)


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    return f"{v:.10g}"


def _flatten(prefix: tuple[str, ...], obj, lines: list[str]) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = str(k)
            # map-like keys (edge names, instance ids, percentiles) become
            # labels; plain identifier keys extend the metric name
            if _NAME_RE.search(key) and not isinstance(v, dict):
                if isinstance(v, (int, float)):
                    lines.append(
                        f'{_metric_name(prefix)}{{key="{key.translate(_LABEL_ESC)}"}} {_fmt(v)}')
                continue
            _flatten(prefix + (key,), v, lines)
    elif isinstance(obj, (int, float)):
        lines.append(f"{_metric_name(prefix)} {_fmt(obj)}")
    # strings / lists / None are skipped: gauges only


def prometheus_text(platform=None, *, stats: dict | None = None) -> str:
    """Text-exposition dump: flattened ``platform.stats()`` + flight
    recorder aggregates + dispatch tracer compile/sync counters."""
    lines: list[str] = []
    if stats is None and platform is not None:
        stats = platform.stats()
    if stats:
        _flatten(("stats",), stats, lines)
    tracer = getattr(platform, "tracer", None)
    if tracer is not None:
        agg = tracer.recorder.aggregates()
        lines.append(f"repro_trace_spans_total {agg['spans']}")
        lines.append(f"repro_trace_events_total {agg['events']}")
        lines.append(f"repro_trace_dropped_total {agg['dropped']}")
        for cat, d in sorted(agg["phases"].items()):
            esc = cat.translate(_LABEL_ESC)
            lines.append(f'repro_trace_phase_count{{phase="{esc}"}} {d["count"]}')
            lines.append(
                f'repro_trace_phase_seconds{{phase="{esc}"}} {_fmt(d["seconds"])}')
    edge_costs = getattr(platform, "edge_costs", None)
    if edge_costs is not None:
        cm = edge_costs.stats()
        for edge, w in cm["edges"].items():
            lines.append(
                f'repro_edge_sync_wait_ewma_seconds{{edge="{edge.translate(_LABEL_ESC)}"}} {_fmt(w)}')
        if cm["merge_stall_ewma_s"] is not None:
            lines.append(
                f"repro_merge_stall_ewma_seconds {_fmt(cm['merge_stall_ewma_s'])}")
        lines.append(f"repro_merge_stall_samples_total {cm['merge_samples']}")
    try:
        from repro_torch.analysis.dispatch import TRACER

        snap = TRACER.snapshot()
        lines.append(f"repro_dispatch_compiles_total {snap.compiles}")
        lines.append(f"repro_dispatch_host_syncs_total {snap.host_syncs}")
        lines.append(f"repro_dispatch_decode_steps_total {snap.decode_steps}")
        lines.append(f"repro_dispatch_kernel_calls_total {snap.kernel_calls}")
    except Exception:  # pragma: no cover - dispatch tracer is optional
        pass
    return "\n".join(lines) + "\n"


def serve_prometheus(platform, port: int = 0):
    """Minimal scrape endpoint on ``/metrics``; returns the started
    ``http.server`` instance (``server.server_address[1]`` is the bound
    port, ``server.shutdown()`` stops it)."""
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - stdlib API name
            body = prometheus_text(platform).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # silence per-request stderr noise
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="prometheus-exporter").start()
    return server
