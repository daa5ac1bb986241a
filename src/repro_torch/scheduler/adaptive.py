"""Live scheduler signals consumed by the fusion policy, and the shared
service-time estimate.

The request scheduler itself is not ported yet; the policy already takes its
signals type, so ``FusionPolicy.decide`` keeps one signature across slices.
:class:`ServiceTimeEstimate` is the EWMA the continuous batcher prices its
prefill chunks with (``serving/continuous.py``).
"""
from __future__ import annotations

import dataclasses
import math
import threading


class ServiceTimeEstimate:
    """Batch-service-time EWMA shared across one function's SLO lanes.

    Service time is a property of the FUNCTION (its compiled batch
    program), not of the admission class — but each lane used to keep its
    own EWMA, so every new class lane cold-started its M/G/1 model with no
    service estimate and spent its first batches flying blind. Sharing one
    estimate per function means a fresh strict lane prices its slack
    correctly from its very first window.

    Thread-safe: lanes' dispatcher threads update concurrently."""

    # provlint: the `value` property reads _value unlocked by design — a
    # GIL-atomic reference read of a float; only writes take the lock.
    GUARDED_WRITES = {"_value": "_lock"}

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._lock = threading.Lock()
        self._value: float | None = None

    @property
    def value(self) -> float | None:
        return self._value

    def observe(self, service_s: float) -> None:
        if service_s < 0:
            return
        a = self.alpha
        with self._lock:
            v = self._value
            self._value = service_s if v is None else (1 - a) * v + a * service_s

    def reset(self) -> None:
        with self._lock:
            self._value = None


@dataclasses.dataclass(frozen=True)
class SchedulerSignals:
    """Live scheduler state for one (caller, callee) chain, consumed by the
    fusion policy: hot-but-saturated chains deprioritize merges (the stall
    hurts most exactly when batching is already absorbing the load), cold
    chains with long waits promote them, and per-class tail violations
    promote merges that would remove the violating wait."""

    queue_depth: int = 0        # pending requests across the chain's keys
    mean_occupancy: float = 0.0  # mean batch size / max_batch, 0..1
    p95_ms: float = 0.0          # worst per-function p95 latency in the chain
    # RECENT per-class tails across the chain: (class name, p95_ms,
    # target_ms). Classes with a finite POSITIVE target only.
    class_p95_ms: tuple[tuple[str, float, float], ...] = ()

    def worst_violation(self) -> tuple[str, float, float] | None:
        """The violated class with the largest p95/target overshoot, or None
        when every class with traffic is meeting its target."""
        worst = None
        worst_ratio = 1.0
        for name, p95, target in self.class_p95_ms:
            if target > 0 and math.isfinite(target) and p95 > target:
                ratio = p95 / target
                if ratio > worst_ratio:
                    worst, worst_ratio = (name, p95, target), ratio
        return worst
