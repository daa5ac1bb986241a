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
    # provlint: merge_log is an append-only observability list read after
    # quiesce; the operational state below is lock-guarded.
    GUARDED_FIELDS = {
        "_inflight": "_lock",
        "_quarantined": "_lock",
        "_failed_groups": "_lock",
        "_threads": "_lock",
    }

    def _trace_outcome(self, kind: str, event) -> None:
        """Stamp the merge transaction's outcome on the control-plane trace
        timeline — policy decisions land next to the traffic that caused
        them (successful builds also get a duration span via
        ``note_provisioning``; this instant carries the verdict)."""
        self.platform.tracer.control_event(
            f"{kind}:{'+'.join(event.members)}", t=event.t_completed,
            args={"members": list(event.members),
                  "healthy": event.healthy, "reason": event.reason})

    def __init__(self, platform, policy, *, health_rtol: float = 2e-2, health_atol: float = 1e-2,
                 async_build: bool = False):
        self.platform = platform
        self.policy = policy
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
        self._quarantined: set[tuple[str, str]] = set()
        self._failed_groups: set[frozenset[str]] = set()
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------ entry

    def submit(self, caller: str, callee: str) -> None:
        """Fusion request from the Function Handler."""
        stats = self.platform.handler.edges.get((caller, callee))
        if stats is None:
            return
        with self._lock:
            if (caller, callee) in self._inflight or (caller, callee) in self._quarantined:
                return
        spec_a = self.platform.spec_of(caller)
        spec_b = self.platform.spec_of(callee)
        # Live scheduler feedback (queue depth, occupancy, tail latency)
        # modulates the decision: saturated chains wait, cold slow ones jump.
        # Passed lazily — decide only snapshots it past its cheap early-outs.
        # (The replicate arm's inputs wait for the port's autoscaler.)
        signals_fn = getattr(self.platform, "scheduler_signals", None)
        signals = (lambda: signals_fn((caller, callee))) if signals_fn is not None else None
        decision = self.policy.decide(caller, callee, stats, spec_a.trust_domain, spec_b.trust_domain,
                                      signals=signals)
        if not decision.fuse:
            return
        with self._lock:
            if (caller, callee) in self._inflight or (caller, callee) in self._quarantined:
                return
            if frozenset(decision.group) in self._failed_groups:
                return  # another edge already proved this exact unit unhealthy
            self._inflight.add((caller, callee))
        if self.async_build:
            th = threading.Thread(target=self._do_merge, args=(caller, callee, decision.group), daemon=True)
            with self._lock:
                self._threads = [t for t in self._threads if t.is_alive()]
                self._threads.append(th)
            th.start()
        else:
            self._do_merge(caller, callee, decision.group)

    def wait_idle(self, timeout: float = 120.0) -> None:
        with self._lock:
            threads = list(self._threads)
        for th in threads:
            th.join(timeout)
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]

    # ------------------------------------------------------------ merge

    def _do_merge(self, caller: str, callee: str, group: frozenset[str]) -> None:
        t0 = self._clock.now()
        platform = self.platform
        try:
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

            if not healthy:
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
                return

            merged.mark_ready()
            # Epoch transaction: atomic route publish + lifecycle transitions
            # (merged -> SERVING, unrouted originals -> DRAINING under the
            # routing lock), then drain + retire outside it.
            event = platform.lifecycle.publish(
                {name: merged for name in group}, kind="merge", reason=f"fused {caller}->{callee}",
            )
            self.policy.commit(caller, callee)
            build_s = self._clock.now() - t0
            self.policy.feedback_merge_cost(build_s)
            # always cold: the port has no executable index yet
            platform.note_provisioning("merge", build_s, warm=False, functions=tuple(sorted(group)),
                                       resident_bytes=merged.resident_bytes())
            merge_event = MergeEvent(
                self._clock.now(), tuple(sorted(group)), event.freed_bytes, build_s, True,
                checked_members=tuple(checked), epoch=event.epoch)
            self.merge_log.append(merge_event)
            self._trace_outcome("merge", merge_event)
        finally:
            with self._lock:
                self._inflight.discard((caller, callee))
