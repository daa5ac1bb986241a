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
from typing import Any, Callable, Iterable

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

    def split_cells(self, cells: Iterable[frozenset[str]]) -> None:
        """Dissolve one group into the given partition cells: members of a
        cell stay unioned with each other and disconnected from every other
        cell. Only valid when the cells' union is a complete group (no
        outside member roots through it) — which is how fission uses it."""
        for cell in cells:
            root = min(cell)
            for member in cell:
                self._parent[member] = root


@dataclasses.dataclass
class FusionDecision:
    fuse: bool
    reason: str
    group: frozenset[str] = frozenset()
    # The alternative arm of the fuse decision (Konflux frames fusion as a
    # cost-model choice): don't merge — add a replica of the saturated callee
    # instead. Set only when replica spin-up is estimated cheaper than the
    # merge; the Merger forwards it to the autoscaler as a scale-out hint.
    replicate: bool = False


@dataclasses.dataclass
class SplitDecision:
    split: bool
    reason: str
    # Partition of the fused group's members: each cell becomes one rebuilt
    # execution unit (singletons for saturation/tail regret; hot singletons +
    # one cold residual cell for traffic divergence).
    partition: tuple[frozenset[str], ...] = ()


@dataclasses.dataclass
class FusionPolicy:
    """min_observations: sync-edge observations before fusing (lets the
    platform be sure the edge is hot, not incidental).
    merge_cost_s: assumed cost of one merge (meta run + health check);
    measured values are fed back by the Merger after each merge.
    amortization_horizon: invocations over which the merge must pay off.

    Scheduler-feedback knobs (used when `decide` receives live
    :class:`SchedulerSignals` from the request scheduler):
    saturation_occupancy/saturation_depth: a chain whose batches already
    run at least this full with at least this many requests queued is
    *saturated* — micro-batching is absorbing the load, and the merge's
    rebuild stall lands exactly when clients are waiting, so the
    projected saving must beat ``saturation_penalty x`` the merge cost.
    promote_wait_s: a *cold* (unsaturated) chain whose per-edge sync-wait
    tail (p95) reaches this long gets promoted — half the observation floor
    and ``promote_discount x`` the merge cost — because per-request blocking
    dominates and fusion removes it directly. The chain's end-to-end p95
    gates this: blocking must be a meaningful share of observed latency.
    """

    # provlint: un-annotated, so dataclasses ignores it (not a field).
    # merge_cost_s is RMW'd by feedback_merge_cost while decide reads it —
    # both must hold _lock.
    GUARDED_FIELDS = {
        "merge_cost_s": "_lock",
        "groups": "_lock",
        "_fused_edges": "_lock",
        "_edge_backoff": "_lock",
        "_sat_streak": "_lock",
        "_slo_streak": "_lock",
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
    # ---- fuse-vs-replicate knobs ----
    # A SATURATED callee poses a choice: merging drags the caller into the
    # hot instance (and pays a rebuild stall mid-overload), while a replica
    # is warm (restore-not-rebuild) and adds capacity directly. When the
    # measured replica spin-up time is <= replicate_bias x the merge cost,
    # `decide` returns replicate=True instead of weighing the penalized
    # merge. max_replica_hint stops hinting once the callee already holds
    # that many replicas — more capacity isn't the fix at that point, and
    # the penalized-merge arm gets its turn again.
    replicate_enabled: bool = True
    replicate_bias: float = 1.0
    max_replica_hint: int = 4
    # ---- fission (reversible fusion) knobs ----
    # split_occupancy/split_depth/split_sustain: a fused group whose batches
    # run at least split_occupancy full with split_depth+ requests queued for
    # split_sustain consecutive regret evaluations is *saturated*: its one
    # serialized unit has become the bottleneck, so fission rebuilds
    # per-partition units to win back parallel dispatch.
    # regret_p95_factor: post-merge tail regret — the group splits when its
    # recent p95 exceeds this multiple of the pre-merge baseline snapshotted
    # at commit time.
    # cold_rate_ratio: traffic-divergence regret — members whose recent
    # request rate fell below this fraction of the hottest member's are
    # "cold"; hot members split out as singletons, cold ones stay co-located.
    # min_group_age_s / remerge_backoff_s: hysteresis. A fresh merge cannot
    # split before min_group_age_s (no reacting to its own swap transient),
    # and a split group's edges cannot re-merge within remerge_backoff_s —
    # together they bound merge<->split flapping to one transition per
    # backoff period even under pathological oscillating load.
    fission_enabled: bool = True
    split_occupancy: float = 0.9
    split_depth: int = 2
    split_sustain: int = 3
    regret_p95_factor: float = 1.5
    cold_rate_ratio: float = 0.05
    min_group_age_s: float = 1.0
    remerge_backoff_s: float = 10.0
    # Injectable time source (hysteresis backoffs, streak bookkeeping):
    # tests drive merge<->split flap windows on a virtual clock, no sleeps.
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
        self._edge_backoff: dict[tuple[str, str], float] = {}
        self._sat_streak: dict[frozenset[str], int] = {}
        self._slo_streak: dict[frozenset[str], int] = {}

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
        *,
        replica_spinup_s: float | None = None,
        callee_replicas: int = 1,
    ) -> FusionDecision:
        """``signals``: a :class:`SchedulerSignals`, or a zero-arg callable
        returning one — resolved only past the cheap early-outs so hot
        unfusable edges (observed on every sync call) don't pay for a
        scheduler snapshot per invocation.

        ``replica_spinup_s``: the platform's measured warm replica spin-up
        estimate (None when no replica has ever spun up — the replicate arm
        then never fires, so callers without an autoscaler are unaffected).
        ``callee_replicas``: how many replicas already serve the callee."""
        with self._lock:
            if not self.enabled:
                return FusionDecision(False, "fusion disabled")
            if (caller, callee) in self._fused_edges:
                return FusionDecision(False, "edge already fused")
            if self._edge_backoff.get((caller, callee), 0.0) > self.clock.now():
                # the group this edge belonged to was just split — immediately
                # re-merging on the same (still-warm) observation counters
                # would flap merge<->split on every oscillation of the load
                return FusionDecision(False, "recently split (fission hysteresis)")
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
                # fusion actually removes. End-to-end p95 (queueing + compute)
                # only gates it: a chain whose latency is dominated by slow
                # compute, not blocking, gains nothing from an early merge.
                edge_wait_s = getattr(stats, "p95_wait_s", stats.mean_wait_s)
                blocking_matters = (
                    signals.p95_ms == 0.0 or edge_wait_s >= 0.2 * signals.p95_ms / 1e3
                )
                # An SLO class violating its target on this chain promotes
                # the merge IF removing the edge's sync-wait tail would
                # plausibly un-violate it — fusion is then not a throughput
                # optimization but the mechanism that restores the target.
                viol = signals.worst_violation()
                slo_fixable = (
                    viol is not None
                    and viol[1] - edge_wait_s * 1e3 <= viol[2]
                    and edge_wait_s > 0.0
                )
                if saturated:
                    if (
                        self.replicate_enabled
                        and replica_spinup_s is not None
                        and callee_replicas < self.max_replica_hint
                        and replica_spinup_s <= self.merge_cost_s * self.replicate_bias
                    ):
                        return FusionDecision(
                            False,
                            f"saturated callee: warm replica "
                            f"(~{replica_spinup_s:.3f}s) beats merge "
                            f"(~{self.merge_cost_s:.3f}s) — replicate instead",
                            replicate=True,
                        )
                    if measured_stall_s is not None:
                        # Measured replacement for the static multiplier:
                        # merging NOW serializes the measured build stall in
                        # front of every queued request, so that — not a
                        # fixed 4x — is what the saving must beat.
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
            group = self.groups.group(caller)
            self._sat_streak.pop(group, None)
            self._slo_streak.pop(group, None)
            return group

    # ------------------------------------------------------------- fission

    def decide_split(
        self,
        members: frozenset[str],
        *,
        signals: SchedulerSignals | None = None,
        member_rates: dict[str, float] | None = None,
        baseline_rates: dict[str, float] | None = None,
        baseline_p95_ms: float = 0.0,
        current_p95_ms: float = 0.0,
        age_s: float = 0.0,
        replica_count: int = 1,
    ) -> SplitDecision:
        """Regret check for one committed fusion group, evaluated off the
        data path by the control plane's reconciler.

        ``signals`` is the group's live scheduler snapshot, ``member_rates``
        the per-member recent request rates (handler.recent_rate),
        ``baseline_p95_ms`` the pre-merge tail snapshotted at commit,
        ``current_p95_ms`` the recent post-merge tail, ``age_s`` time since
        the merge committed. Four regret signals, checked in order:
        sustained saturation, a sustained SLO-class violation on the group,
        post-merge tail regression, member traffic divergence (edge gone
        cold).

        ``replica_count``: how many replicas the platform already runs of
        this fused unit. Replication is itself a fission-pressure signal —
        the autoscaler had to clone the WHOLE group to keep up, so the
        co-located unit is the bottleneck replica_count times over, and
        splitting wins back per-member parallel dispatch on every replica.
        A replicated group therefore needs only half the sustained-streak
        evidence before the saturation/SLO checks fire."""
        members = frozenset(members)
        with self._lock:
            if not self.fission_enabled or len(members) < 2:
                return SplitDecision(False, "fission disabled or singleton group")
            if age_s < self.min_group_age_s:
                return SplitDecision(
                    False, f"group too young ({age_s:.2f}s < {self.min_group_age_s}s hysteresis)"
                )
            singletons = tuple(frozenset((m,)) for m in sorted(members))
            # replication pressure (see docstring): a cloned group halves the
            # sustained-evidence requirement for the streak-based checks
            sustain = (
                self.split_sustain
                if replica_count <= 1
                else max(1, self.split_sustain // 2)
            )
            pressure = "" if replica_count <= 1 else (
                f"; replica pressure: {replica_count} replicas halved the "
                f"sustain floor"
            )
            # --- sustained saturation: the fused unit serializes a load the
            # scheduler could be running in parallel across per-member units
            saturated = (
                signals is not None
                and signals.mean_occupancy >= self.split_occupancy
                and signals.queue_depth >= self.split_depth
            )
            if saturated:
                streak = self._sat_streak.get(members, 0) + 1
                self._sat_streak[members] = streak
                if streak >= sustain:
                    self._sat_streak.pop(members, None)
                    return SplitDecision(
                        True,
                        f"sustained saturation ({streak} consecutive evaluations at "
                        f"occupancy {signals.mean_occupancy:.2f}, depth "
                        f"{signals.queue_depth}{pressure})",
                        singletons,
                    )
            else:
                self._sat_streak.pop(members, None)
            # --- SLO-class regret: a strict class sustained above its target
            # on the fused group means the one serialized unit is violating a
            # deadline per-member units could meet in parallel. Sustained
            # (same streak discipline as saturation) so one tail blip — or
            # the merge's own swap transient — cannot trigger fission; the
            # min_group_age_s/remerge_backoff_s hysteresis bounds flapping
            # when the target is simply unachievable either way.
            viol = signals.worst_violation() if signals is not None else None
            if viol is not None:
                streak = self._slo_streak.get(members, 0) + 1
                self._slo_streak[members] = streak
                if streak >= sustain:
                    self._slo_streak.pop(members, None)
                    return SplitDecision(
                        True,
                        f"SLO class {viol[0]!r} violated on fused group ({streak} "
                        f"consecutive evaluations at p95 {viol[1]:.1f}ms vs target "
                        f"{viol[2]:.1f}ms{pressure})",
                        singletons,
                    )
            else:
                self._slo_streak.pop(members, None)
            # --- post-merge tail regret vs the baseline snapshotted at commit
            if (
                baseline_p95_ms > 0.0
                and current_p95_ms >= self.regret_p95_factor * baseline_p95_ms
            ):
                return SplitDecision(
                    True,
                    f"post-merge p95 regressed ({current_p95_ms:.1f}ms >= "
                    f"{self.regret_p95_factor}x baseline {baseline_p95_ms:.1f}ms)",
                    singletons,
                )
            # --- traffic divergence: the fused members no longer share a
            # workload — hot members split out, cold ones stay co-located.
            # Only members that had DIRECT demand at commit time can go cold:
            # an interior chain member is served by inlined calls, so its
            # direct rate reads 0 whether the chain is hot or dead.
            if member_rates:
                hottest = max(member_rates.values())
                cold = frozenset(
                    m for m in members
                    if member_rates.get(m, 0.0) <= self.cold_rate_ratio * hottest
                    and (baseline_rates or {}).get(m, 0.0) > 0.0
                )
                hot = members - cold
                if hottest > 0.0 and cold and hot:
                    partition = tuple(frozenset((m,)) for m in sorted(hot)) + (cold,)
                    return SplitDecision(
                        True,
                        f"member traffic diverged (cold: {sorted(cold)} at <= "
                        f"{self.cold_rate_ratio:.0%} of hottest member's rate)",
                        partition,
                    )
            return SplitDecision(False, "no regret signal")

    def dissolve(self, cells: Iterable[frozenset[str]], backoff_s: float | None = None) -> None:
        """Un-commit a fused group along the given partition: fused edges
        crossing cells are forgotten, the union-find group dissolves into
        the cells, and every crossing pair enters the re-merge backoff
        window (hysteresis — see ``remerge_backoff_s``)."""
        cells = [frozenset(c) for c in cells]
        members = frozenset().union(*cells) if cells else frozenset()
        cell_of = {m: i for i, cell in enumerate(cells) for m in cell}
        until = self.clock.now() + (self.remerge_backoff_s if backoff_s is None else backoff_s)
        with self._lock:
            for a in members:
                for b in members:
                    if a != b and cell_of[a] != cell_of[b]:
                        self._edge_backoff[(a, b)] = until
            self._fused_edges = {
                (a, b)
                for (a, b) in self._fused_edges
                if not (a in cell_of and b in cell_of and cell_of[a] != cell_of[b])
            }
            self.groups.split_cells(cells)
            self._sat_streak.pop(members, None)
            self._slo_streak.pop(members, None)
