"""Critical-path attribution over span trees + measured edge-cost EWMAs.

Attribution model
-----------------
A trace is the span tree rooted at span id 1. Each span's *self-time* is
its duration minus the summed durations of its direct children; a span's
category accumulates its self-time. The root's own self-time — wall time
no instrumented phase claims (dispatch glue, retry gaps) — lands in
``"unattributed"``. Summed self-times telescope to the root duration
algebraically, so ``sum(phases.values()) == wall_s`` up to float rounding;
``residual_s`` reports the difference and tests pin it at ~0. A span whose
children overlap it (children durations exceed the parent) marks the trace
``conserved=False`` instead of silently clamping.

:class:`EdgeCostModel` is the feedback half: the platform feeds measured
cross-function sync waits (``remote_call``) and merge build stalls
(``note_provisioning``) into per-edge EWMAs, and ``FusionPolicy`` weighs
those *measurements* instead of its static ``saturation_penalty`` /
``mean_wait_s`` knobs when deciding merge vs replicate.
"""
from __future__ import annotations

import threading

from repro_torch.obs.trace import CONTROL_TRACE_ID, SpanRecord

_ROOT = 1
_EPS = 1e-9


def build_trees(records: list[SpanRecord]) -> dict[int, dict[int, SpanRecord]]:
    """Group complete (``ph == "X"``) spans by trace id, keyed by span id.
    The control-plane pseudo-trace is excluded."""
    trees: dict[int, dict[int, SpanRecord]] = {}
    for r in records:
        if r.ph != "X" or r.trace_id == CONTROL_TRACE_ID:
            continue
        trees.setdefault(r.trace_id, {})[r.span_id] = r
    return trees


def attribute_trace(spans) -> dict | None:
    """Per-category latency attribution for one trace; ``None`` when the
    root span never finished (request still in flight when sampled).
    Accepts a ``{span_id: record}`` tree (from :func:`build_trees`) or a
    plain list of one trace's records."""
    if not isinstance(spans, dict):
        spans = {r.span_id: r for r in spans if r.ph == "X"}
    root = spans.get(_ROOT)
    if root is None:
        return None
    children: dict[int, list[SpanRecord]] = {}
    for sid, r in spans.items():
        if sid == _ROOT:
            continue
        children.setdefault(r.parent_id, []).append(r)
    phases: dict[str, float] = {}
    conserved = True
    for sid, r in spans.items():
        kids = children.get(sid, ())
        self_s = r.dur_s - sum(k.dur_s for k in kids)
        if self_s < -_EPS:  # children overlap / exceed their parent
            conserved = False
        cat = "unattributed" if sid == _ROOT else r.cat
        phases[cat] = phases.get(cat, 0.0) + self_s
    # a child whose parent record was dropped by the ring breaks the
    # telescoping sum — its duration was never subtracted anywhere
    if any(pid not in spans for pid in children):
        conserved = False
    wall = root.dur_s
    residual = wall - sum(phases.values())
    return {
        "trace_id": root.trace_id,
        "name": root.name,
        "kind": root.cat,
        "wall_s": wall,
        "phases": phases,
        "residual_s": residual,
        "conserved": conserved and abs(residual) <= max(_EPS, 1e-9 + 1e-12 * abs(wall)),
        "attrs": root.args,
    }


def attribute(records: list[SpanRecord]) -> list[dict]:
    """Attribution for every finished trace in ``records``, trace-id order."""
    trees = build_trees(records)
    out = []
    for tid in sorted(trees):
        res = attribute_trace(trees[tid])
        if res is not None:
            out.append(res)
    return out


def summarize(results: list[dict]) -> dict:
    """Fleet-level rollup of :func:`attribute` output: per-category total
    seconds and the share of summed wall time each category claims."""
    totals: dict[str, float] = {}
    wall = 0.0
    for res in results:
        wall += res["wall_s"]
        for cat, s in res["phases"].items():
            totals[cat] = totals.get(cat, 0.0) + s
    shares = {c: (s / wall if wall > 0 else 0.0) for c, s in totals.items()}
    return {"requests": len(results), "wall_s": wall,
            "phase_seconds": totals, "phase_share": shares}


class EdgeCostModel:
    """Measured costs the fusion policy consumes instead of static knobs.

    * per-edge EWMA of the *blocking* cross-function sync wait observed at
      ``platform.remote_call`` (what fusing the edge would eliminate);
    * EWMA of the merge build stall and of the admission-queue depth the
      stall was inflicted on (what fusing *costs* the queued requests).
    """

    GUARDED_FIELDS = {
        "_edges": "_lock",
        "_merge_stall_s": "_lock",
        "_merge_depth": "_lock",
        "_merge_samples": "_lock",
    }

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._edges: dict[tuple[str, str], float] = {}
        self._merge_stall_s: float | None = None
        self._merge_depth: float = 0.0
        self._merge_samples: int = 0

    def _ewma(self, old: float | None, x: float) -> float:
        return x if old is None else (1.0 - self.alpha) * old + self.alpha * x

    def observe_sync_edge(self, caller: str, callee: str, wait_s: float) -> None:
        key = (caller, callee)
        with self._lock:
            self._edges[key] = self._ewma(self._edges.get(key), float(wait_s))

    def sync_edge_ewma(self, caller: str, callee: str) -> float | None:
        with self._lock:
            return self._edges.get((caller, callee))

    def observe_merge_stall(self, build_s: float, queue_depth: int = 0) -> None:
        with self._lock:
            self._merge_stall_s = self._ewma(self._merge_stall_s, float(build_s))
            self._merge_depth = self._ewma(
                self._merge_depth if self._merge_samples else None, float(queue_depth))
            self._merge_samples += 1

    def merge_stall_ewma(self) -> float | None:
        with self._lock:
            return self._merge_stall_s

    def stats(self) -> dict:
        with self._lock:
            edges = {f"{a}->{b}": w for (a, b), w in sorted(self._edges.items())}
            return {
                "edges": edges,
                "merge_stall_ewma_s": self._merge_stall_s,
                "merge_depth_ewma": self._merge_depth,
                "merge_samples": self._merge_samples,
            }
