"""GB-second billing accounting — quantifies the *double billing* effect.

FaaS bills each function instance for wall-time x allocated memory, including
time the instance spends *blocked* on a synchronous downstream call
[Baldini et al., serverless trilemma]. The meter records every invocation's
(duration, resident_bytes, blocked_time); billed GB-s therefore double-counts
chains exactly like a real provider would — and the fusion benchmark's
before/after delta on this meter is the paper's cost-reduction claim.
"""
from __future__ import annotations

import dataclasses
import threading

from repro_torch.scheduler.metrics import LatencyWindow


@dataclasses.dataclass
class InvocationRecord:
    function: str
    instance: str
    t_start: float
    t_end: float
    resident_bytes: int
    blocked_s: float = 0.0

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def gb_seconds(self) -> float:
        return self.duration_s * self.resident_bytes / 1e9


class BillingMeter:
    GUARDED_FIELDS = {"records": "_lock"}

    def __init__(self, clock=None):
        self._lock = threading.Lock()
        self.records: list[InvocationRecord] = []
        # the platform's time source stamps each completion to compute
        # sustained throughput alongside the tail percentiles
        self._latency = LatencyWindow(clock=clock)

    def record(self, rec: InvocationRecord) -> None:
        with self._lock:
            self.records.append(rec)

    def observe_latency(self, function: str, seconds: float) -> None:
        """One *external* request completed end-to-end after ``seconds``.
        Only client traffic reports here — the Merger's canary replays bypass
        this — so percentiles cover exactly the external request stream."""
        self._latency.observe(seconds)

    def reset(self) -> None:
        with self._lock:
            self.records = []
        self._latency.reset()

    def blocked_gb_seconds(self) -> float:
        """The double-billed component: memory held while blocked downstream."""
        with self._lock:
            return sum(r.blocked_s * r.resident_bytes / 1e9 for r in self.records)

    def snapshot(self) -> dict:
        """One coherent view of the meter: the records are copied under a
        single lock acquisition, then every derived view is computed from
        that one copy."""
        with self._lock:
            records = list(self.records)
        by_fn: dict[str, dict] = {}
        for r in records:
            d = by_fn.setdefault(r.function, {"calls": 0, "gb_s": 0.0, "blocked_gb_s": 0.0})
            d["calls"] += 1
            d["gb_s"] += r.gb_seconds
            d["blocked_gb_s"] += r.blocked_s * r.resident_bytes / 1e9
        billing = {
            "total_gb_s": sum(d["gb_s"] for d in by_fn.values()),
            "blocked_gb_s": sum(d["blocked_gb_s"] for d in by_fn.values()),
            "by_function": by_fn,
        }
        return {"billing": billing, "latency": self._latency.snapshot()}

    def summary(self) -> dict:
        return self.snapshot()["billing"]
