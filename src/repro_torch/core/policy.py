"""Fusion policy: which observed synchronous edges become fusion requests.

Constraints carried over from the paper (§3, §6):
* only *synchronous* edges fuse (async/non-blocking calls never do);
* both functions must share a trust domain (fusion reduces isolation);
* fusion cost (rebuild + redeploy, here: a shape-only meta run plus the
  canary health check) is amortized over subsequent invocations — the
  policy requires the projected saving over the amortization horizon to
  exceed the merge cost.

Fusion groups are maintained by union-find: A+B merged, then (B->C) observed
=> the next merge hosts {A, B, C}. The platform converges to one execution
unit per synchronous chain, which is the paper's Fig. 5 staircase.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

from repro_torch.scheduler.adaptive import SchedulerSignals
from repro_torch.scheduler.clock import SYSTEM_CLOCK


class UnionFind:
    def __init__(self):
        self._parent: dict[str, str] = {}

    def find(self, x: str) -> str:
        self._parent.setdefault(x, x)
        root = x
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[x] != root:  # path compression
            self._parent[x], x = root, self._parent[x]
        return root

    def union(self, a: str, b: str) -> str:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self._parent[rb] = ra
        return ra

    def group(self, x: str) -> frozenset[str]:
        root = self.find(x)
        return frozenset(m for m in self._parent if self.find(m) == root)


@dataclasses.dataclass
class FusionDecision:
    fuse: bool
    reason: str
    group: frozenset[str] = frozenset()


@dataclasses.dataclass
class FusionPolicy:
    """min_observations: sync-edge observations before fusing (lets the
    platform be sure the edge is hot, not incidental).
    merge_cost_s: assumed cost of one merge (meta run + health check);
    measured values are fed back by the Merger after each merge.
    amortization_horizon: invocations over which the merge must pay off.

    Scheduler-feedback knobs (used when `decide` receives live
    :class:`SchedulerSignals`): a chain whose batches already run at least
    ``saturation_occupancy`` full with ``saturation_depth`` requests queued
    is *saturated* and must beat ``saturation_penalty x`` the merge cost; a
    cold chain whose per-edge sync-wait tail (p95) reaches ``promote_wait_s``
    is promoted — half the observation floor at ``promote_discount x`` the
    merge cost.
    """

    # provlint: un-annotated, so dataclasses ignores it (not a field).
    GUARDED_FIELDS = {
        "merge_cost_s": "_lock",
        "groups": "_lock",
        "_fused_edges": "_lock",
    }

    min_observations: int = 3
    amortization_horizon: int = 500
    merge_cost_s: float = 2.0
    enabled: bool = True
    saturation_occupancy: float = 0.85
    saturation_depth: int = 1
    saturation_penalty: float = 4.0
    promote_wait_s: float = 0.05
    promote_discount: float = 0.5
    clock: Any = None

    # provlint: un-annotated — not a dataclass field. The platform assigns
    # its obs.EdgeCostModel here at construction (write-once, before
    # traffic); when present, `decide` weighs MEASURED sync-edge waits and
    # merge stalls instead of the static mean_wait_s / saturation_penalty
    # knobs. The model has its own lock; reading the attribute is safe.
    cost_model = None

    def __post_init__(self):
        if self.clock is None:
            self.clock = SYSTEM_CLOCK
        self.groups = UnionFind()
        self._lock = threading.Lock()
        self._fused_edges: set[tuple[str, str]] = set()

    def feedback_merge_cost(self, seconds: float) -> None:
        # exponential moving average of observed merge costs; `decide` reads
        # merge_cost_s under the lock, so the read-modify-write takes it too
        with self._lock:
            self.merge_cost_s = 0.5 * self.merge_cost_s + 0.5 * seconds

    def decide(
        self,
        caller: str,
        callee: str,
        stats,
        trust_a: str,
        trust_b: str,
        signals: SchedulerSignals | Callable[[], SchedulerSignals] | None = None,
    ) -> FusionDecision:
        """``signals``: a :class:`SchedulerSignals`, or a zero-arg callable
        returning one — resolved only past the cheap early-outs."""
        with self._lock:
            if not self.enabled:
                return FusionDecision(False, "fusion disabled")
            if (caller, callee) in self._fused_edges:
                return FusionDecision(False, "edge already fused")
            if trust_a != trust_b:
                return FusionDecision(False, f"trust domains differ ({trust_a} vs {trust_b})")
            if self.groups.find(caller) == self.groups.find(callee):
                return FusionDecision(False, "already in same fusion group")
            if stats.sync_count < max(1, self.min_observations // 2):
                # below even the promoted floor: no signal can change this
                return FusionDecision(False, f"only {stats.sync_count} observations")
            min_obs = self.min_observations
            required_cost = self.merge_cost_s
            note = ""
            # Measured costs (obs.EdgeCostModel, fed by the tracing layer)
            # displace the static knobs when samples exist: the edge's OWN
            # observed sync-wait EWMA prices the saving, and the measured
            # merge stall prices the saturation cost below.
            cm = self.cost_model
            measured_edge_s = cm.sync_edge_ewma(caller, callee) if cm is not None else None
            measured_stall_s = cm.merge_stall_ewma() if cm is not None else None
            if callable(signals):
                signals = signals()
            if signals is not None:
                saturated = (
                    signals.mean_occupancy >= self.saturation_occupancy
                    and signals.queue_depth >= self.saturation_depth
                )
                # Promotion keys on the edge's own SYNC-WAIT tail — the time
                # fusion actually removes; end-to-end p95 only gates it.
                edge_wait_s = getattr(stats, "p95_wait_s", stats.mean_wait_s)
                blocking_matters = (
                    signals.p95_ms == 0.0 or edge_wait_s >= 0.2 * signals.p95_ms / 1e3
                )
                viol = signals.worst_violation()
                slo_fixable = (
                    viol is not None
                    and viol[1] - edge_wait_s * 1e3 <= viol[2]
                    and edge_wait_s > 0.0
                )
                if saturated:
                    if measured_stall_s is not None:
                        # merging NOW serializes the measured build stall in
                        # front of every queued request, so that — not a
                        # fixed 4x — is what the saving must beat
                        required_cost = (
                            self.merge_cost_s
                            + measured_stall_s * max(1, signals.queue_depth)
                        )
                        note = (
                            f" [saturated: measured stall ~{measured_stall_s:.3f}s"
                            f" x depth {signals.queue_depth}]"
                        )
                    else:
                        required_cost *= self.saturation_penalty
                        note = " [deprioritized: chain saturated]"
                elif slo_fixable:
                    required_cost *= self.promote_discount
                    min_obs = max(1, min_obs // 2)
                    note = (
                        f" [promoted: class {viol[0]!r} at p95 {viol[1]:.1f}ms vs "
                        f"target {viol[2]:.1f}ms; merge removes ~{edge_wait_s * 1e3:.1f}ms wait]"
                    )
                elif edge_wait_s >= self.promote_wait_s and blocking_matters:
                    required_cost *= self.promote_discount
                    min_obs = max(1, min_obs // 2)
                    note = " [promoted: cold chain, long sync waits]"
            if stats.sync_count < min_obs:
                return FusionDecision(False, f"only {stats.sync_count} observations{note}")
            edge_mean_s = stats.mean_wait_s if measured_edge_s is None else measured_edge_s
            projected_saving = edge_mean_s * self.amortization_horizon
            if projected_saving < required_cost:
                return FusionDecision(
                    False,
                    f"not amortizable: saving {projected_saving:.3f}s "
                    f"< cost {required_cost:.3f}s{note}",
                )
            group = self.groups.group(caller) | self.groups.group(callee) | {caller, callee}
            return FusionDecision(True, f"sync edge hot + amortizable{note}", frozenset(group))

    def commit(self, caller: str, callee: str) -> frozenset[str]:
        with self._lock:
            self._fused_edges.add((caller, callee))
            self.groups.union(caller, callee)
            return self.groups.group(caller)
