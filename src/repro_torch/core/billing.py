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
class ArenaLease:
    """One request's stay in the paged KV arena: the per-request RAM bill.

    With per-client cache pytrees every request was billed (implicitly) for
    a full ``max_len`` cache; under paging a request holds only the pages
    its tokens occupy, so its GB-s is ``pages x page_bytes x residency`` —
    the platform-side RAM reduction the paper claims, made billable."""

    function: str
    request_id: str
    pages: int          # peak pages held
    page_bytes: int     # bytes per page across the whole chain (all stages)
    t_alloc: float
    t_free: float
    # pages weighted by 1/refcount at release: a fleet sharing a prompt
    # prefix splits the prefix pages' bill across the sharers. None means
    # unshared serving — the nominal `pages` count is billed.
    amortized_pages: float | None = None

    @property
    def duration_s(self) -> float:
        return self.t_free - self.t_alloc

    @property
    def billed_pages(self) -> float:
        return float(self.pages) if self.amortized_pages is None else self.amortized_pages

    @property
    def gb_seconds(self) -> float:
        return self.duration_s * self.billed_pages * self.page_bytes / 1e9


@dataclasses.dataclass
class ProvisioningRecord:
    """One provisioning transition's bill. Restore/resurrect time IS billed
    (the function is being readied on a customer's invoke path); time spent
    idle as a snapshot is not billed at all — scale-to-zero's whole point —
    so parks and platform-initiated merges/splits carry ``billed=False`` and
    appear in the summary only as counts."""

    kind: str  # "resurrect" | "park" | "merge" | "split"
    functions: tuple[str, ...]
    seconds: float
    resident_bytes: int
    warm: bool
    billed: bool = False

    @property
    def gb_seconds(self) -> float:
        return self.seconds * self.resident_bytes / 1e9


@dataclasses.dataclass
class InvocationRecord:
    function: str
    instance: str
    t_start: float
    t_end: float
    resident_bytes: int
    blocked_s: float = 0.0
    # Requests co-batched into this execution. Each request in a micro-batch
    # gets its own record, but the instance was held ONCE for the batch
    # duration — so billed GB-s splits evenly across the co-batched requests
    # (summing the batch's records reproduces the instance's true cost).
    batch_size: int = 1

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def gb_seconds(self) -> float:
        return self.duration_s * self.resident_bytes / 1e9 / max(1, self.batch_size)


class BillingMeter:
    GUARDED_FIELDS = {
        "records": "_lock",
        "arena_leases": "_lock",
        "provisioning": "_lock",
    }

    def __init__(self, clock=None):
        self._lock = threading.Lock()
        self.records: list[InvocationRecord] = []
        self.arena_leases: list[ArenaLease] = []
        self.provisioning: list[ProvisioningRecord] = []
        # the platform's time source: latency durations arrive already
        # measured, but the window stamps each completion to compute
        # sustained throughput — mixing a virtual duration with a wall-clock
        # stamp would put the two on different axes
        self._latency = LatencyWindow(clock=clock)

    def record(self, rec: InvocationRecord) -> None:
        with self._lock:
            self.records.append(rec)

    def record_arena(self, lease: ArenaLease) -> None:
        """One request left the paged KV arena; bill its page residency."""
        with self._lock:
            self.arena_leases.append(lease)

    def record_provisioning(self, rec: ProvisioningRecord) -> None:
        with self._lock:
            self.provisioning.append(rec)

    def observe_latency(self, function: str, seconds: float) -> None:
        """One *external* request completed end-to-end (admission/arrival ->
        response ready) after ``seconds``. Serial `invoke` and the scheduler's
        batched path both report here — and only client traffic does; the
        Merger's canary replays bypass this — so percentiles cover exactly
        the external request stream regardless of dispatch mode."""
        self._latency.observe(seconds)

    def reset(self) -> None:
        with self._lock:
            self.records = []
            self.arena_leases = []
            self.provisioning = []
        self._latency.reset()

    def arena_summary(self) -> dict:
        """Per-request page residency: the serve path's RAM story."""
        with self._lock:
            leases = list(self.arena_leases)
        if not leases:
            return {
                "requests": 0, "gb_s": 0.0, "mean_pages": 0.0, "max_pages": 0,
                "mean_billed_pages": 0.0,
            }
        return {
            "requests": len(leases),
            "gb_s": sum(l.gb_seconds for l in leases),
            "mean_pages": sum(l.pages for l in leases) / len(leases),
            "max_pages": max(l.pages for l in leases),
            # amortized by sharing: the RAM the platform ACTUALLY spent per
            # request (shared prefix pages counted once across the fleet)
            "mean_billed_pages": sum(l.billed_pages for l in leases) / len(leases),
            "mean_residency_s": sum(l.duration_s for l in leases) / len(leases),
        }

    def blocked_gb_seconds(self) -> float:
        """The double-billed component: memory held while blocked downstream."""
        with self._lock:
            return sum(r.blocked_s * r.resident_bytes / 1e9 for r in self.records)

    @staticmethod
    def _by_instance(records: list[InvocationRecord]) -> dict[str, dict]:
        """Billing split by the execution unit that served each request:
        each client request lands in exactly one instance's bucket, and
        micro-batched requests already split their shared GB-s by batch."""
        out: dict[str, dict] = {}
        for r in records:
            d = out.setdefault(r.instance, {"calls": 0, "gb_s": 0.0})
            d["calls"] += 1
            d["gb_s"] += r.gb_seconds
        return out

    def snapshot(self) -> dict:
        """One COHERENT view of the meter: records, leases, and provisioning
        are copied under a single lock acquisition, then every derived view
        (summary, per-instance split, arena, latency) is computed from that
        one copy. ``platform.stats()`` assembles from this, so its totals
        are conserved even while invokes land concurrently — summing the
        per-instance calls always equals summing the per-function calls
        (regression-tested in test_obs.py)."""
        with self._lock:
            records = list(self.records)
            leases = list(self.arena_leases)
            prov = list(self.provisioning)
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
        if leases:
            billing["arena"] = {
                "requests": len(leases),
                "gb_s": sum(l.gb_seconds for l in leases),
                "mean_pages": sum(l.pages for l in leases) / len(leases),
                "max_pages": max(l.pages for l in leases),
                "mean_billed_pages": sum(l.billed_pages for l in leases) / len(leases),
                "mean_residency_s": sum(l.duration_s for l in leases) / len(leases),
            }
        if prov:
            # a SEPARATE line item, not folded into total_gb_s: invocation
            # GB-s is the paper's double-billing comparison and must not
            # shift when provisioning accounting is enabled
            billing["provisioning"] = {
                "events": len(prov),
                "billed_gb_s": sum(p.gb_seconds for p in prov if p.billed),
                "billed_s": sum(p.seconds for p in prov if p.billed),
                "warm": sum(1 for p in prov if p.warm),
                "cold": sum(1 for p in prov if not p.warm),
            }
        return {
            "billing": billing,
            "by_instance": self._by_instance(records),
            "latency": self._latency.snapshot(),
        }

    def summary(self) -> dict:
        return self.snapshot()["billing"]
