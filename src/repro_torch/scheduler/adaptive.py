"""Live scheduler signals consumed by the fusion policy.

The request scheduler itself is not ported yet; the policy already takes its
signals type, so ``FusionPolicy.decide`` keeps one signature across slices.
"""
from __future__ import annotations

import dataclasses
import math


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
