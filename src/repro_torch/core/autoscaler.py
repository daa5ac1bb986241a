"""Rho-driven replica autoscaler: scale out on sustained predicted overload,
scale in through the reconciler's trough windows.

The scaler consumes ONLY signals the platform already computes — the
scheduler's M/G/1 offered-load prediction (``predicted_rho``: summed lane
arrival rates x EWMA service / max_batch) and ``signals_for`` queue depth —
so scaling needs no new measurement path. It runs as a reconciler tick hook
(control-plane thread, never the data path):

- **out**: a name whose predicted rho stays >= ``rho_high`` (or whose queue
  depth stays >= ``depth_high``) for ``sustain`` consecutive evaluations
  gains a replica via ``platform._spawn_replica`` — with the executable
  index warm, spin-up is restore-not-rebuild.
- **in**: a name whose rho stays <= ``rho_low`` for ``sustain`` evaluations
  sheds its newest replica through ``ControlPlane.scale_in`` — enqueued on
  the reconciler so the drain lands in a traffic trough, and the DRAINING
  path guarantees in-flight requests finish first.

The fusion policy's replicate arm (``FusionDecision.replicate``) feeds
:meth:`request_scale_out`: a saturated callee gets a warm replica instead of
a merge that would drag the caller into the hot instance. Hints respect the
same ``max_replicas``/cooldown guards as organic scaling.

Note the rho signal requires the scheduler's adaptive windows (service-time
EWMAs); on a non-adaptive platform only ``depth_high`` hints and policy
requests can trigger scale-out.
"""
from __future__ import annotations

import collections
import threading

_EVENT_LOG_MAX = 256


class Autoscaler:
    GUARDED_FIELDS = {
        "_hi_streak": "_lock",
        "_lo_streak": "_lock",
        "_cooldown_until": "_lock",
        "_requests": "_lock",
        "_pending_in": "_lock",
        "_last_eval": "_lock",
        "events": "_lock",
    }

    def __init__(self, platform, *, rho_high: float = 0.9, rho_low: float = 0.3,
                 depth_high: int | None = None, sustain: int = 3,
                 max_replicas: int = 4, min_replicas: int = 1,
                 cooldown_s: float = 1.0, eval_interval_s: float = 0.05):
        if max_replicas < min_replicas:
            raise ValueError("max_replicas < min_replicas")
        self.platform = platform
        self.clock = platform.clock
        self.rho_high = rho_high
        self.rho_low = rho_low
        self.depth_high = depth_high
        self.sustain = max(1, sustain)
        self.max_replicas = max_replicas
        self.min_replicas = max(1, min_replicas)
        self.cooldown_s = cooldown_s
        self.eval_interval_s = eval_interval_s
        self._lock = threading.Lock()
        self._hi_streak: dict[str, int] = {}
        self._lo_streak: dict[str, int] = {}
        self._cooldown_until: dict[str, float] = {}
        self._requests: list[tuple[str, str]] = []  # policy replicate hints
        self._pending_in: set[str] = set()  # victim ids queued for scale-in
        self._last_eval = 0.0
        self.events: collections.deque[dict] = collections.deque(maxlen=_EVENT_LOG_MAX)

    # ------------------------------------------------------------- triggers

    def request_scale_out(self, name: str, reason: str = "") -> None:
        """Explicit scale-out hint (the fusion policy's replicate arm). The
        spin-up itself happens on the next reconciler tick — never on the
        data-path thread that observed the saturation."""
        with self._lock:
            if all(n != name for n, _ in self._requests):
                self._requests.append((name, reason or "replicate hint"))

    def tick(self) -> None:
        """Reconciler tick hook: drain explicit hints, then evaluate every
        routed name's rho/queue-depth streaks."""
        now = self.clock.now()
        with self._lock:
            due = now - self._last_eval >= self.eval_interval_s
            requests, self._requests = self._requests, []
            if due:
                self._last_eval = now
        for name, reason in requests:
            self._try_scale_out(name, reason=reason)
        if not due:
            return
        platform = self.platform
        for name in platform.registry.names():
            rho = platform.scheduler.predicted_rho(name)
            depth = 0
            if self.depth_high is not None:
                depth = platform.scheduler.signals_for((name,)).queue_depth
            hot = rho >= self.rho_high or (
                self.depth_high is not None and depth >= self.depth_high
            )
            cold = not hot and rho <= self.rho_low
            with self._lock:
                if hot:
                    hi = self._hi_streak[name] = self._hi_streak.get(name, 0) + 1
                    self._lo_streak.pop(name, None)
                    lo = 0
                elif cold:
                    lo = self._lo_streak[name] = self._lo_streak.get(name, 0) + 1
                    self._hi_streak.pop(name, None)
                    hi = 0
                else:
                    self._hi_streak.pop(name, None)
                    self._lo_streak.pop(name, None)
                    hi = lo = 0
            if hi >= self.sustain:
                self._try_scale_out(
                    name,
                    reason=f"sustained rho {rho:.2f} >= {self.rho_high}"
                    if rho >= self.rho_high
                    else f"sustained queue depth {depth} >= {self.depth_high}",
                )
            elif lo >= self.sustain:
                self._schedule_scale_in(
                    name, reason=f"sustained rho {rho:.2f} <= {self.rho_low}"
                )

    # ------------------------------------------------------------ scale out

    def _try_scale_out(self, name: str, *, reason: str) -> None:
        platform = self.platform
        now = self.clock.now()
        with self._lock:
            if now < self._cooldown_until.get(name, 0.0):
                return
        n = platform.registry.replica_count(name)
        if n == 0 or n >= self.max_replicas:
            return
        replica = platform._spawn_replica(name)
        if replica is None:
            return
        with self._lock:
            self._hi_streak.pop(name, None)
            until = self.clock.now() + self.cooldown_s
            for member in replica.members:
                self._cooldown_until[member] = until
            self.events.append({
                "kind": "scale-out", "name": name, "replicas": n + 1,
                "instance": replica.instance_id, "reason": reason,
                "t": round(now, 4),
            })
        platform.tracer.control_event(
            f"scale-out:{name}",
            args={"name": name, "replicas": n + 1,
                  "instance": replica.instance_id, "reason": reason})

    # ------------------------------------------------------------- scale in

    def _schedule_scale_in(self, name: str, *, reason: str) -> None:
        platform = self.platform
        replicas = platform.registry.replicas(name)
        if len(replicas) <= self.min_replicas:
            with self._lock:
                self._lo_streak.pop(name, None)
            return
        victim = replicas[-1]  # newest replica first: the primary persists
        now = self.clock.now()
        with self._lock:
            if now < self._cooldown_until.get(name, 0.0):
                return
            if victim.instance_id in self._pending_in:
                return
            self._pending_in.add(victim.instance_id)
            self._lo_streak.pop(name, None)
        platform.lifecycle.enqueue(
            lambda: self._do_scale_in(victim, reason),
            kind="scale-in",
            names=tuple(sorted(victim.members)),
            reason=reason,
        )

    def _do_scale_in(self, victim, reason: str) -> None:
        try:
            event = self.platform.lifecycle.scale_in(victim, reason=reason)
            if event is not None:
                with self._lock:
                    until = self.clock.now() + self.cooldown_s
                    for member in victim.members:
                        self._cooldown_until[member] = until
                    self.events.append({
                        "kind": "scale-in", "name": ",".join(event.names),
                        "instance": victim.instance_id, "reason": reason,
                        "t": round(event.t_completed, 4),
                    })
                self.platform.tracer.control_event(
                    f"scale-in:{','.join(event.names)}",
                    t=event.t_completed,
                    args={"instance": victim.instance_id, "reason": reason})
        finally:
            with self._lock:
                self._pending_in.discard(victim.instance_id)

    # -------------------------------------------------------------- metrics

    def stats(self) -> dict:
        with self._lock:
            return {
                "rho_high": self.rho_high,
                "rho_low": self.rho_low,
                "sustain": self.sustain,
                "max_replicas": self.max_replicas,
                "hi_streaks": dict(self._hi_streak),
                "lo_streaks": dict(self._lo_streak),
                "pending_scale_in": sorted(self._pending_in),
                "events": list(self.events)[-32:],
            }
