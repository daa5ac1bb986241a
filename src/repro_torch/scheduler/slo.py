"""Multi-level SLO classes for admission control.

The two-level ``priority=PRIORITY_HIGH`` admission generalizes to N
*classes*, each carrying a latency target: ``invoke_async(..., slo=
SLOClass("interactive", target_p95_ms=50.0))``. The class rides with the
request into its own per-(function, shape, class) admission lane, where the
window controller turns the target into a batching window via the queueing
model (see :mod:`repro_torch.scheduler.adaptive`): strict targets buy small
windows (low added delay), loose or absent targets buy big ones
(throughput). Batches never mix classes — a best-effort convoy can never
drag a strict request's latency with it.

Class semantics:

* ``target_p95_ms`` is the class's end-to-end (admission -> completion) p95
  target. ``inf`` means *best effort*: no target, window tuned purely for
  occupancy — exactly the pre-SLO behavior.
* A class with target ``0`` never waits: its window is always zero (greedy
  drain), and its arrival preempts open windows of looser classes on the
  same (function, shape) — this is what ``PRIORITY_HIGH`` maps to, so the
  old two-level API keeps its exact semantics.
* Ordering is by target: tighter targets are admitted first when multiple
  classes contend, and only a *strictly tighter* arrival preempts an open
  window.

Classes are identified by name; two SLOClass values with the same name must
carry the same target (the scheduler keys lanes and metrics by name).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One admission class: a name and a p95 latency target (ms).

    ``math.inf`` (the default) marks best-effort traffic — no deadline, the
    window controller optimizes occupancy. Finite targets make the class
    *strict*: the controller spends the target's slack (target minus
    predicted queue wait minus service) on batching and nothing more.
    """

    name: str
    target_p95_ms: float = math.inf

    def __post_init__(self):
        if self.target_p95_ms < 0:
            raise ValueError(f"SLO target must be >= 0, got {self.target_p95_ms}")

    @property
    def best_effort(self) -> bool:
        return not math.isfinite(self.target_p95_ms)

    @property
    def target_s(self) -> float:
        return self.target_p95_ms / 1e3

    def tighter_than(self, other: "SLOClass") -> bool:
        return self.target_p95_ms < other.target_p95_ms


#: The default class for untagged traffic: no deadline, occupancy-tuned
#: window — byte-for-byte the pre-SLO scheduler behavior.
BEST_EFFORT = SLOClass("best-effort", math.inf)

#: What ``priority=PRIORITY_HIGH`` maps to: a zero-slack class that never
#: waits out a window and preempts open looser-class windows on its key.
IMMEDIATE = SLOClass("immediate", 0.0)


def slo_for_priority(priority: int) -> SLOClass:
    """Back-compat shim for the two-level priority API."""
    return IMMEDIATE if priority > 0 else BEST_EFFORT


class ClassLanes:
    """Per-SLO-class FIFO lanes with strictest-target-first pop — the
    slot-assignment analogue of the admission queues.

    The continuous batcher feeds its fixed-capacity decode batch from
    these: when an in-flight slot frees, ``pop()`` hands out the waiting
    request of the *tightest* class first (FIFO within a class), so a
    strict arrival preempts best-effort traffic for slot assignment exactly
    the way it preempts batching windows in the admission queues. Not
    thread-safe by itself — callers hold their own lock."""

    def __init__(self):
        self._lanes: dict[str, list] = {}
        self._classes: dict[str, SLOClass] = {}

    def push(self, item, slo: SLOClass = BEST_EFFORT) -> None:
        known = self._classes.get(slo.name)
        if known is not None and known.target_p95_ms != slo.target_p95_ms:
            raise ValueError(
                f"SLO class {slo.name!r} redefined: target "
                f"{slo.target_p95_ms} != {known.target_p95_ms}"
            )
        self._classes[slo.name] = slo
        self._lanes.setdefault(slo.name, []).append(item)

    def pop(self):
        """The next (item, slo) by class tightness, or None when empty."""
        for name in sorted(
            (n for n, lane in self._lanes.items() if lane),
            key=lambda n: self._classes[n].target_p95_ms,
        ):
            lane = self._lanes[name]
            return lane.pop(0), self._classes[name]
        return None

    def requeue(self, item, slo: SLOClass) -> None:
        """Put an item back at the FRONT of its lane (e.g. admission failed
        transiently — arena full — and must retry first next round)."""
        self._classes[slo.name] = slo
        self._lanes.setdefault(slo.name, []).insert(0, item)

    def depth(self, class_name: str | None = None) -> int:
        if class_name is not None:
            return len(self._lanes.get(class_name, ()))
        return sum(len(l) for l in self._lanes.values())

    def best_effort_depth(self) -> int:
        """Queued items across best-effort (targetless) lanes only — the
        backlog an overload shed bound applies to."""
        return sum(
            len(lane)
            for name, lane in self._lanes.items()
            if self._classes[name].best_effort
        )

    def counts(self) -> dict[str, int]:
        return {n: len(l) for n, l in self._lanes.items() if l}
