"""The Function Handler: dispatch coordination + synchronous-call detection.

Every invocation — external (client) or internal (function-to-function) —
flows through the handler. For internal calls it observes, at run time,
whether the issuing execution *blocked* waiting for the callee (the paper's
blocking-socket observation; here the caller's eager glue is parked inside
``remote_call`` until the callee responds). Observed synchronous edges
accumulate per (caller, callee) and are reported to the fusion policy; when
the policy fires, a fusion request with the two function identifiers is
submitted to the Merger — exactly the §3 control flow.

The handler also:
* captures the latest request per function as the *canary* used by the
  Merger's health check;
* maintains the per-thread invocation stack so blocked time is attributed
  to the right billing record (the double-billing measurement).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable

from repro_torch.core.billing import BillingMeter, InvocationRecord
from repro_torch.scheduler.clock import SYSTEM_CLOCK

_RECENT_WAITS = 64  # bounded per-edge wait history for the tail estimate


@dataclasses.dataclass
class EdgeStats:
    sync_count: int = 0
    async_count: int = 0
    total_wait_s: float = 0.0

    def __post_init__(self):
        # Deliberately NOT a dataclass field: asdict()/replace() snapshots
        # stay plain scalars (JSON-serializable stats, cheap copies).
        self.recent_waits: list[float] = []

    @property
    def mean_wait_s(self) -> float:
        return self.total_wait_s / self.sync_count if self.sync_count else 0.0

    @property
    def p95_wait_s(self) -> float:
        """Nearest-rank p95 over the recent sync waits — the fusion policy's
        promote rule keys on tail blocking, which a mean over a mostly-fast
        edge hides. Falls back to the mean when no history is retained."""
        if not self.recent_waits:
            return self.mean_wait_s
        ordered = sorted(self.recent_waits)
        rank = min(len(ordered), max(1, math.ceil(0.95 * len(ordered))))
        return ordered[rank - 1]


@dataclasses.dataclass
class _ActiveInvocation:
    function: str
    instance_id: str
    t_start: float
    resident_bytes: int
    blocked_s: float = 0.0


class FunctionHandler:
    GUARDED_FIELDS = {"edges": "_lock", "canaries": "_lock"}

    def __init__(self, meter: BillingMeter, on_fusion_candidate: Callable[[str, str], None] | None = None,
                 clock=None):
        self.meter = meter
        self.clock = clock or SYSTEM_CLOCK
        self.on_fusion_candidate = on_fusion_candidate
        self.edges: dict[tuple[str, str], EdgeStats] = {}
        self.canaries: dict[str, tuple] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()

    # ------------------------------------------------------- invocation stack

    def _stack(self) -> list[_ActiveInvocation]:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def enter(self, function: str, instance) -> None:
        self._stack().append(_ActiveInvocation(
            function, instance.instance_id, self.clock.now(), instance.resident_bytes(),
        ))

    def exit(self, function: str) -> None:
        inv = self._stack().pop()
        self.meter.record(
            InvocationRecord(
                function=inv.function,
                instance=inv.instance_id,
                t_start=inv.t_start,
                t_end=self.clock.now(),
                resident_bytes=inv.resident_bytes,
                blocked_s=inv.blocked_s,
            )
        )

    def abort(self, function: str) -> None:
        """Pop the invocation WITHOUT billing — used when an attempt fails
        and will be retried (billing the failed attempt would double-count
        the request once the retry lands)."""
        self._stack().pop()

    def attribute_blocked(self, seconds: float) -> None:
        stack = self._stack()
        if stack:
            stack[-1].blocked_s += seconds

    # ------------------------------------------------------- observation

    def record_canary(self, function: str, args: tuple) -> None:
        """Keep the latest request by reference. Safe because the port's
        functions never write their arguments in place: prefill and decode
        return NEW cache tensors, so a replayed canary sees what the original
        request saw."""
        with self._lock:
            self.canaries[function] = args

    def canary(self, function: str):
        with self._lock:
            return self.canaries.get(function)

    def observe_edge(self, caller: str, callee: str, *, sync: bool, wait_s: float = 0.0) -> None:
        notify = False
        with self._lock:
            st = self.edges.setdefault((caller, callee), EdgeStats())
            if sync:
                st.sync_count += 1
                st.total_wait_s += wait_s
                st.recent_waits.append(wait_s)
                if len(st.recent_waits) > _RECENT_WAITS:
                    del st.recent_waits[0]
                notify = True
            else:
                st.async_count += 1
        if notify and self.on_fusion_candidate is not None:
            self.on_fusion_candidate(caller, callee)

    def stats(self) -> dict:
        with self._lock:
            return {
                f"{a}->{b}": dataclasses.asdict(v)
                for (a, b), v in sorted(self.edges.items())
            }
