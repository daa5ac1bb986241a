"""The Merger: builds, health-checks, and swaps in fused execution units.

Mirrors §3/§4 of the paper:
  fusion request (caller, callee identifiers) from the Function Handler
    -> policy decision (sync-only, trust domain, amortization)
    -> build a NEW execution unit hosting every function of the fusion
       group, preserving each function's identifier (the members dict is
       keyed by name, the analogue of the preserved directory structure)
    -> health check: canary requests through the new unit must match the
       live (unfused) path's output
    -> atomic traffic swap in the routing table
    -> drain + terminate the originals, freeing their memory.

Fission reverses a merge: ``split`` rebuilds a committed group as one unit
per partition cell, health-checks each against the fused unit, and swaps
them in by a compare-and-swap epoch that retires the fused unit.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from repro_torch import tree
from repro_torch.core.function import FunctionInstance
from repro_torch.scheduler.clock import SYSTEM_CLOCK


@dataclasses.dataclass
class MergeEvent:
    t_completed: float
    members: tuple[str, ...]
    freed_bytes: int
    build_s: float
    healthy: bool
    reason: str = ""
    # Members whose canary was replayed through the live path during the
    # health check — each replay is one extra (control-plane) invocation on
    # the billing meter, so tests can account for merge traffic exactly.
    checked_members: tuple[str, ...] = ()
    epoch: int = 0  # routing epoch this merge published (0: never swapped)
    # True when every entry the merged unit's health check built came from
    # the executable index (no shape-only run) — the restore-not-rebuild
    # signal. None: unknown (unhealthy merges abort before the profile is read).
    warm: bool | None = None


@dataclasses.dataclass
class SplitEvent:
    """One fission transaction: a fused group rebuilt as per-partition units."""

    t_completed: float
    members: tuple[str, ...]
    partition: tuple[tuple[str, ...], ...]
    healthy: bool
    reason: str = ""
    checked_members: tuple[str, ...] = ()
    epoch: int = 0
    build_s: float = 0.0
    warm: bool | None = None  # every rebuilt unit hit the executable index


@dataclasses.dataclass
class GroupRecord:
    """Control-plane memory of one committed fusion group — everything the
    regret check needs to decide the merge should be undone."""

    members: frozenset[str]
    instance: FunctionInstance
    committed_t: float
    epoch: int
    # Pre-merge per-member tails/rates snapshotted at commit: the regret
    # comparison is always against what the platform looked like BEFORE it
    # fused, never against an aspiration.
    baseline_p95_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    baseline_rates: dict[str, float] = dataclasses.field(default_factory=dict)


def _allclose_tree(a, b, rtol: float, atol: float) -> bool:
    """Leafwise closeness, computed with torch on each tensor's own device
    in float32 (np.asarray would fail on CUDA and on bfloat16 tensors)."""
    la, lb = tree.leaves(a), tree.leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.shape != y.shape:
            return False
        y = y.to(x.device)
        if x.is_floating_point() or y.is_floating_point():
            if not torch.allclose(x.float(), y.float(), rtol=rtol, atol=atol):
                return False
        elif not torch.equal(x, y):
            return False
    return True


class Merger:
    SWAP_ATTEMPTS = 4  # builds of one merge whose compare-and-swap publish lost a race
    # provlint: merge_log/split_log are append-only observability lists
    # read after quiesce; the operational state below is lock-guarded.
    GUARDED_FIELDS = {
        "_groups": "_lock",
        "_inflight": "_lock",
        "_quarantined": "_lock",
        "_failed_groups": "_lock",
        "_failed_splits": "_lock",
        "_threads": "_lock",
    }

    def _trace_outcome(self, kind: str, event) -> None:
        """Stamp the merge/split transaction outcome on the control-plane
        trace timeline — policy decisions land next to the traffic that
        caused them (successful builds also get a duration span via
        ``note_provisioning``; this instant carries the verdict)."""
        self.platform.tracer.control_event(
            f"{kind}:{'+'.join(event.members)}", t=event.t_completed,
            args={"members": list(event.members),
                  "healthy": event.healthy, "reason": event.reason})

    def __init__(self, platform, policy, *, health_rtol: float = 2e-2, health_atol: float = 1e-2,
                 async_build: bool = False):
        self.platform = platform
        self.policy = policy
        # share the platform's time source (virtual in simulation tests) so
        # group ages / event timestamps sit on the same axis as the
        # scheduler's and the policy's hysteresis windows
        self._clock = getattr(platform, "clock", None) or SYSTEM_CLOCK
        self.health_rtol = health_rtol
        self.health_atol = health_atol
        self.async_build = async_build
        self.merge_log: list[MergeEvent] = []
        self._inflight: set[tuple[str, str]] = set()
        # Edges/groups whose merged unit FAILED its health check. The merged
        # unit is a pure function of the specs, so retrying without a code
        # change fails identically — and because the health check's own
        # reference invocation re-observes the hot edge, retry-on-observation
        # would spin the control plane forever. Failed rollouts stay failed.
        # The group set catches OTHER edges that resolve to the same doomed
        # member set (e.g. (A,C) after (B,C) failed to extend committed
        # {A,B}) before they pay the build cost again.
        self._quarantined: set[tuple[str, str]] = set()
        self._failed_groups: set[frozenset[str]] = set()
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self.split_log: list[SplitEvent] = []
        self._groups: dict[frozenset[str], GroupRecord] = {}
        # (member set, partition) pairs whose rebuilt units FAILED the split
        # health check. Like _failed_groups for merges: the rebuilt units
        # are pure functions of the specs, so retrying the SAME partition
        # fails identically — without this, a persistent regret signal would
        # rebuild + re-check the doomed partition on every reconciler tick. Keyed per partition: a different partition of the
        # same group builds different units and deserves its own attempt.
        self._failed_splits: set[tuple[frozenset[str], frozenset[frozenset[str]]]] = set()

    # ------------------------------------------------------------ entry

    def submit(self, caller: str, callee: str) -> None:
        """Fusion request from the Function Handler."""
        stats = self.platform.handler.edges.get((caller, callee))
        if stats is None:
            return
        with self._lock:
            # before the (costlier) policy decision: quarantined or already
            # in-flight edges are re-submitted on every sync observation of
            # a hot chain — they must not pay for scheduler snapshots
            if (caller, callee) in self._inflight or (caller, callee) in self._quarantined:
                return
        spec_a = self.platform.spec_of(caller)
        spec_b = self.platform.spec_of(callee)
        # Live scheduler feedback (queue depth, occupancy, tail latency)
        # modulates the decision: saturated chains wait, cold slow ones jump.
        # Passed lazily — decide only snapshots it past its cheap early-outs.
        signals_fn = getattr(self.platform, "scheduler_signals", None)
        signals = (lambda: signals_fn((caller, callee))) if signals_fn is not None else None
        # Fuse-vs-replicate inputs: the platform's measured warm spin-up
        # estimate and the callee's current replica count. Both None/1 on
        # platforms without the replicated data plane — the replicate arm
        # then never fires and decide() behaves exactly as before.
        spinup_fn = getattr(self.platform, "replica_spinup_estimate", None)
        replica_spinup_s = spinup_fn(callee) if spinup_fn is not None else None
        registry = getattr(self.platform, "registry", None)
        callee_replicas = (
            registry.replica_count(callee)
            if registry is not None and hasattr(registry, "replica_count")
            else 1
        )
        decision = self.policy.decide(
            caller, callee, stats, spec_a.trust_domain, spec_b.trust_domain,
            signals=signals, replica_spinup_s=replica_spinup_s,
            callee_replicas=callee_replicas,
        )
        if decision.replicate:
            # The cost model chose capacity over consolidation: hint the
            # autoscaler to clone the saturated callee instead of merging.
            request = getattr(self.platform, "request_replica", None)
            if request is not None:
                request(callee, reason=decision.reason)
            return
        if not decision.fuse:
            return
        with self._lock:
            if (caller, callee) in self._inflight or (caller, callee) in self._quarantined:
                return
            if frozenset(decision.group) in self._failed_groups:
                return  # another edge already proved this exact unit unhealthy
            self._inflight.add((caller, callee))
        lifecycle = getattr(self.platform, "lifecycle", None)
        if lifecycle is not None and getattr(self.platform, "trough_merges", False):
            # Deferred merge: the reconciler runs the build+swap at the next
            # observed traffic trough (or after its max-defer deadline), so
            # the rebuild stall lands in a quiet gap instead of mid-burst.
            t_queued = self._clock.now()
            lifecycle.enqueue(
                lambda: self._do_merge(caller, callee, decision.group,
                                       deferred_s=self._clock.now() - t_queued,
                                       revalidate=True),
                kind="merge", names=tuple(sorted(decision.group)),
                reason=decision.reason,
            )
        elif self.async_build:
            th = threading.Thread(target=self._do_merge, args=(caller, callee, decision.group), daemon=True)
            with self._lock:
                # prune-on-submit keeps the list bounded under sustained
                # async_build traffic; append under the SAME lock wait_idle
                # snapshots under (append/prune used to race it)
                self._threads = [t for t in self._threads if t.is_alive()]
                self._threads.append(th)
            th.start()
        else:
            self._do_merge(caller, callee, decision.group)

    def wait_idle(self, timeout: float = 120.0) -> None:
        lifecycle = getattr(self.platform, "lifecycle", None)
        if lifecycle is not None and getattr(self.platform, "trough_merges", False):
            # run anything still queued now, then wait out transitions the
            # reconciler already popped and is mid-way through executing
            lifecycle.run_pending(force=True)
            lifecycle.wait_idle(timeout)
        with self._lock:
            threads = list(self._threads)
        for th in threads:
            th.join(timeout)
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]

    # ------------------------------------------------------------ merge

    def _do_merge(self, caller: str, callee: str, group: frozenset[str],
                  deferred_s: float = 0.0, revalidate: bool = False) -> None:
        t0 = self._clock.now()
        platform = self.platform
        try:
            if revalidate:
                # Deferred merges re-run the decision at execution time: up
                # to max_defer_s passed since decide(), during which a split
                # may have put these edges into remerge backoff or the group
                # may have changed shape — publishing the stale group would
                # bypass the flap hysteresis and desync policy from routing.
                stats = platform.handler.edges.get((caller, callee))
                if stats is None:
                    return
                decision = self.policy.decide(
                    caller, callee, stats,
                    platform.spec_of(caller).trust_domain,
                    platform.spec_of(callee).trust_domain,
                )
                if not decision.fuse:
                    return
                with self._lock:
                    if frozenset(decision.group) in self._failed_groups:
                        return  # the (possibly re-shaped) group is already
                        # proven unhealthy — don't pay the build again
                group = decision.group
            # A merge whose group overlaps one committed since its decision
            # (two client threads, or the reconciler and wait_idle, each
            # deciding before the other swaps) must not swap in a unit beside
            # it: the group grows to every member of the units its functions
            # are routed to, and the publish is a compare-and-swap on those
            # routes. A swap that lost the race rebuilds over the new union.
            # (The reference publishes unguarded: A->{A,B} and C->{B,C} can
            # both stay, and the fused edges never merge again.)
            for _ in range(self.SWAP_ATTEMPTS):
                group = self._live_closure(group)
                expect = {name: platform.registry.get(name) for name in group}
                if None not in expect.values() and len({id(i) for i in expect.values()}) == 1:
                    return  # a merge that raced this one already fused the whole group
                merged, checked = self._build_checked(group, caller, callee, t0)
                if merged is None:
                    return
                # --- pre-merge baseline snapshot: what regret will compare against ---
                scheduler = getattr(platform, "scheduler", None)
                baseline_p95 = {
                    m: (scheduler.recent_p95_ms(m) if scheduler is not None else 0.0)
                    for m in group
                }
                baseline_rates = {m: self._member_demand(m, group) for m in group}

                merged.mark_ready()
                # Epoch transaction: atomic route publish + lifecycle transitions
                # (merged -> SERVING, unrouted originals -> DRAINING under the
                # routing lock), then drain + retire outside it.
                event = platform.lifecycle.publish(
                    {name: merged for name in group}, kind="merge",
                    reason=f"fused {caller}->{callee}", expect=expect, deferred_s=deferred_s,
                )
                if event is not None:
                    break
                platform.detach_instance(merged)
            else:
                return  # lost every attempt to concurrent swaps: the edge is re-observed later
            self.policy.commit(caller, callee)
            freed = event.freed_bytes

            with self._lock:
                # the new group subsumes any committed subgroup's record (its
                # instance was displaced by this very publish)
                for members in [k for k in self._groups if k <= frozenset(group)]:
                    del self._groups[members]
                self._groups[frozenset(group)] = GroupRecord(
                    members=frozenset(group), instance=merged,
                    committed_t=self._clock.now(), epoch=event.epoch,
                    baseline_p95_ms=baseline_p95, baseline_rates=baseline_rates,
                )

            build_s = self._clock.now() - t0
            self.policy.feedback_merge_cost(build_s)
            # Warm iff the canary warm-up above ran NO shape-only run — every
            # entry came out of the executable index. A re-merge of a
            # previously-seen group reads warm; the first merge of this
            # shape reads cold.
            profile = merged.provision_profile()
            warm = profile["cache_misses"] == 0 and profile["cache_hits"] > 0
            platform.note_provisioning("merge", build_s, warm=warm, functions=tuple(sorted(group)),
                                       resident_bytes=merged.resident_bytes())
            merge_event = MergeEvent(
                self._clock.now(), tuple(sorted(group)), freed, build_s, True,
                checked_members=tuple(checked), epoch=event.epoch, warm=warm)
            self.merge_log.append(merge_event)
            self._trace_outcome("merge", merge_event)
        finally:
            with self._lock:
                self._inflight.discard((caller, callee))

    def _live_closure(self, group) -> frozenset[str]:
        """``group`` with every member of each unit its functions are routed
        to now, to a fixed point."""
        registry = self.platform.registry
        out = set(group)
        while True:
            grown = set(out)
            for name in out:
                inst = registry.get(name)
                if inst is not None:
                    grown.update(inst.members)
            if grown == out:
                return frozenset(out)
            out = grown

    def _build_checked(self, group, caller: str, callee: str,
                       t0: float) -> tuple[FunctionInstance | None, list[str]]:
        """A new unit hosting ``group``, health-checked on captured canary
        traffic against the live path, and the members checked; the unit is
        None (the abort logged) when it fails or has no canary to check."""
        platform = self.platform
        specs = {name: platform.spec_of(name) for name in group}
        merged = FunctionInstance(specs, platform)
        platform.attach_instance(merged)

        # --- health check on captured canary traffic ---
        healthy = True
        checked: list[str] = []
        for name in sorted(group):
            canary = platform.handler.canary(name)
            if canary is None:
                continue
            ref = platform._invoke_with_retry(name, canary)  # old (still-routed) path
            got = merged.execute(name, canary)
            checked.append(name)
            if not _allclose_tree(ref, got, self.health_rtol, self.health_atol):
                healthy = False
                break
        if not checked:
            healthy = False  # no canary -> cannot verify; do not swap
        if healthy:
            return merged, checked

        # Abort: never swap an unverified unit. Originals keep serving.
        platform.detach_instance(merged)
        reason = "health check failed" if checked else "no canary traffic captured"
        if checked:  # no-canary aborts may retry once traffic arrives
            with self._lock:
                self._quarantined.add((caller, callee))
                self._failed_groups.add(frozenset(group))
        event = MergeEvent(self._clock.now(), tuple(sorted(group)), 0,
                           self._clock.now() - t0, False, reason, tuple(checked))
        self.merge_log.append(event)
        self._trace_outcome("merge", event)
        return None, checked

    def forget_instance(self, instance: FunctionInstance) -> None:
        """Drop the committed-group record backing ``instance`` (a
        scale-to-zero park retired it). Members resurrect as SINGLETON units, so the policy's
        group state must dissolve too — with zero backoff: the park was an
        idleness decision, not a flap, and the first hot edge after resurrect
        should be free to re-fuse immediately."""
        members = frozenset(instance.members)
        with self._lock:
            rec = self._groups.get(members)
            if rec is not None and rec.instance is instance:
                del self._groups[members]
        if len(members) >= 2:
            self.policy.dissolve([frozenset([m]) for m in members], backoff_s=0.0)

    # ------------------------------------------------------------ fission

    def committed_groups(self) -> list[GroupRecord]:
        with self._lock:
            return list(self._groups.values())

    def _member_demand(self, member: str, group) -> float:
        """Demand one fused member sees: direct client traffic plus sync
        dispatches from units OUTSIDE the group (calls from inside the group
        are inlined post-merge and excluded both pre and post so baseline
        and current measure the same thing)."""
        handler = self.platform.handler
        return handler.recent_rate(member) + handler.recent_inbound_rate(
            member, exclude=group
        )

    def evaluate_splits(self) -> list[SplitEvent]:
        """Regret pass over every committed fusion group (reconciler-tick
        work, never data-path): gather live signals, ask the policy's
        ``decide_split``, and execute any split it orders. Returns the split
        events performed."""
        platform = self.platform
        events: list[SplitEvent] = []
        for rec in self.committed_groups():
            routed = {m: platform.registry.get(m) for m in rec.members}
            if any(inst is not rec.instance for inst in routed.values()):
                # superseded by a later merge or redeploy — drop the record
                with self._lock:
                    if self._groups.get(rec.members) is rec:
                        del self._groups[rec.members]
                continue
            signals_fn = getattr(platform, "scheduler_signals", None)
            signals = signals_fn(tuple(sorted(rec.members))) if signals_fn else None
            scheduler = getattr(platform, "scheduler", None)
            rates = {m: self._member_demand(m, rec.members) for m in rec.members}
            current_p95 = max(
                (scheduler.recent_p95_ms(m) for m in rec.members), default=0.0
            ) if scheduler is not None else 0.0
            count_fn = getattr(platform.registry, "replica_count", None)
            replica_count = (
                max(count_fn(m) for m in rec.members) if count_fn is not None else 1
            )
            decision = self.policy.decide_split(
                rec.members,
                signals=signals,
                member_rates=rates,
                baseline_rates=rec.baseline_rates,
                baseline_p95_ms=max(rec.baseline_p95_ms.values(), default=0.0),
                current_p95_ms=current_p95,
                age_s=self._clock.now() - rec.committed_t,
                replica_count=replica_count,
            )
            if decision.split:
                event = self.split(rec.members, decision.partition, reason=decision.reason)
                if event is not None:
                    events.append(event)
        return events

    def split(self, members, partition, reason: str = "") -> SplitEvent | None:
        """Fission transaction: rebuild the fused group as one execution unit
        per partition cell, health-check each rebuilt unit against the fused
        unit's canaries, and epoch-swap them in (retiring the fused unit).

        Returns the SplitEvent, or None when the group is no longer routed as
        expected (a concurrent merge/redeploy won the race — the publish is
        guarded by compare-and-swap, so a stale split aborts cleanly)."""
        t0 = self._clock.now()
        platform = self.platform
        members = frozenset(members)
        cells = [frozenset(c) for c in partition]
        covered = frozenset().union(*cells) if cells else frozenset()
        if covered != members or sum(len(c) for c in cells) != len(members):
            raise ValueError(f"partition {cells!r} does not partition {sorted(members)!r}")
        if len(cells) < 2:
            return None  # a single cell is not a split
        with self._lock:
            if (members, frozenset(cells)) in self._failed_splits:
                return None  # this exact partition already proved unhealthy
            rec = self._groups.get(members)
        fused = rec.instance if rec is not None else platform.registry.get(next(iter(members)))
        if fused is None or any(platform.registry.get(m) is not fused for m in members):
            return None  # group already superseded

        if not any(platform.handler.canary(m) is not None for m in members):
            # nothing to verify against — refuse before paying for the
            # rebuilds (may retry once traffic has produced a canary)
            event = SplitEvent(
                self._clock.now(), tuple(sorted(members)),
                tuple(tuple(sorted(c)) for c in cells), False,
                "no canary traffic captured", (), build_s=self._clock.now() - t0,
            )
            self.split_log.append(event)
            self._trace_outcome("split", event)
            return event

        units: dict[frozenset, FunctionInstance] = {}
        try:
            for cell in cells:
                specs = {m: platform.spec_of(m) for m in cell}
                unit = FunctionInstance(specs, platform)
                platform.attach_instance(unit)
                units[cell] = unit

            # --- health check: each rebuilt unit must reproduce the fused
            # unit's outputs on the captured canaries (the fused unit IS the
            # live reference — it is what clients have been getting answers
            # from). Holding a request slot on the fused unit keeps a
            # concurrent epoch transition from retiring it (and freeing its
            # params) mid-check.
            fused.begin_request()
            healthy = True
            checked: list[str] = []
            try:
                for cell in cells:
                    for m in sorted(cell):
                        canary = platform.handler.canary(m)
                        if canary is None:
                            continue
                        if units[cell].get_compiled(m, canary) is None:
                            # Boundary entry: replaying it would dispatch the
                            # outbound call through live routing — i.e. queue
                            # behind the saturated fused pod this split exists
                            # to relieve, blocking the reconciler for the
                            # backlog's duration and polluting edge stats and
                            # billing with control-plane traffic. Co-members'
                            # self-contained entries cover the rebuilt units;
                            # the shape-only run here still records the entry
                            # as glue for the post-split traffic.
                            continue
                        ref = fused.execute(m, canary)
                        got = units[cell].execute(m, canary)
                        checked.append(m)
                        if not _allclose_tree(ref, got, self.health_rtol, self.health_atol):
                            healthy = False
                            break
                    if not healthy:
                        break
            finally:
                fused.end_request()
            if not healthy or not checked:
                for unit in units.values():
                    platform.detach_instance(unit)
                if not healthy:  # deterministic: this partition cannot pass
                    with self._lock:
                        self._failed_splits.add((members, frozenset(cells)))
                event = SplitEvent(
                    self._clock.now(), tuple(sorted(members)),
                    tuple(tuple(sorted(c)) for c in cells), False,
                    "health check failed" if not healthy else "no self-contained entry to verify",
                    tuple(checked), build_s=self._clock.now() - t0,
                )
                self.split_log.append(event)
                self._trace_outcome("split", event)
                return event

            for unit in units.values():
                unit.mark_ready()
            routes = {m: units[cell] for cell in cells for m in cell}
            epoch_event = platform.lifecycle.publish(
                routes, kind="split", reason=reason,
                expect={m: fused for m in members},
            )
            if epoch_event is None:
                # routing moved underneath us (raced a merge/redeploy): abort
                for unit in units.values():
                    platform.detach_instance(unit)
                return None
        except BaseException:
            # an unexpected failure (fused unit retired mid-check, a run
            # that raises) must not leak attached units — on the orchestrated
            # backend each would pin a worker thread forever
            for unit in units.values():
                platform.detach_instance(unit)
            raise
        self.policy.dissolve(cells)
        with self._lock:
            self._groups.pop(members, None)
            # multi-member cells remain committed groups in their own right:
            # their members still share one unit and can split again later
            for cell in cells:
                if len(cell) > 1:
                    self._groups[cell] = GroupRecord(
                        members=cell, instance=units[cell],
                        committed_t=self._clock.now(), epoch=epoch_event.epoch,
                        baseline_p95_ms={m: v for m, v in (rec.baseline_p95_ms if rec else {}).items() if m in cell},
                        baseline_rates={m: v for m, v in (rec.baseline_rates if rec else {}).items() if m in cell},
                    )
        build_s = self._clock.now() - t0
        profiles = [units[cell].provision_profile() for cell in cells]
        warm = (all(p["cache_misses"] == 0 for p in profiles)
                and any(p["cache_hits"] > 0 for p in profiles))
        platform.note_provisioning("split", build_s, warm=warm, functions=tuple(sorted(members)),
                                   resident_bytes=sum(u.resident_bytes() for u in units.values()))
        event = SplitEvent(
            self._clock.now(), tuple(sorted(members)),
            tuple(tuple(sorted(c)) for c in cells), True, reason,
            tuple(checked), epoch=epoch_event.epoch, build_s=build_s, warm=warm,
        )
        self.split_log.append(event)
        self._trace_outcome("split", event)
        return event
