"""Queueing-model micro-batch window control with per-class SLO targets.

Each (function, shape, class) admission lane sets its window from an
explicit M/G/1-style model (rather than gap heuristics — multiplicative
nudges toward ``(target_occupancy * max_batch - 1) * gap``), fed by two
EWMAs the lane already observes:

* **arrival rate** ``lambda = 1 / ewma_gap`` (per class — each class's
  arrival process is its own),
* **batch service time** ``S`` (measured wall time of the lane's dispatches).

From those, the predicted queue wait behind the lane's own backlog is the
classic utilization blow-up::

    k_hat = clamp(1 + lambda * window, 1, max_batch)   # expected batch fill
    rho   = lambda * S / k_hat                         # offered / capacity
    W_q   = S * rho / (1 - rho)                        # M/G/1-flavored wait
                                                       # (rho >= 1 -> inf)

and the window decision is class-driven:

* **best-effort** (no target): window = time to fill ``target_occupancy *
  max_batch`` at the observed rate — the same steady-state the old
  heuristics converged to, now computed directly instead of approached by
  multiplicative steps.
* **strict** (finite ``target_p95_ms``): window = ``min(fill time, slack)``
  where ``slack = target - W_q - S``. The lane spends the target's slack on
  batching and *nothing more*; when load (or an unachievable target) eats
  the slack, the window collapses to zero and the class degrades to greedy
  FIFO draining — the old pre-SLO behavior.
* **trickle** (either kind): if the observed gap exceeds the window cap, no
  second arrival can be caught by waiting; the window goes to the minimum.

A relative hysteresis dead-band plus bounded multiplicative steps keep
noisy arrivals from flapping the window batch-to-batch.

:class:`SchedulerSignals` grows per-class tail latencies: the fusion policy
promotes merges whose removed sync-wait would un-violate a class's target,
and treats a sustained violated class on a fused group as regret (fission).
"""
from __future__ import annotations

import dataclasses
import math
import threading

from repro_torch.scheduler.slo import BEST_EFFORT, SLOClass

#: Priority levels of the two-level API (HIGH maps to the zero-target
#: ``IMMEDIATE`` class — see :mod:`repro_torch.scheduler.slo`).
PRIORITY_NORMAL = 0
PRIORITY_HIGH = 1


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
    chains with long waits promote them, and per-class tail violations both
    promote merges that would remove the violating wait and count as regret
    against merges that caused one."""

    queue_depth: int = 0        # pending requests across the chain's keys
    mean_occupancy: float = 0.0  # mean batch size / max_batch, 0..1
    p95_ms: float = 0.0          # worst per-function p95 latency in the chain
    # RECENT per-class tails across the chain: (class name, p95_ms,
    # target_ms) over the scheduler's trailing window. Classes with a
    # finite POSITIVE target only: best-effort has no target to violate,
    # and a zero target (the IMMEDIATE / PRIORITY_HIGH shim) promises zero
    # *admission* delay, not zero end-to-end latency — service time alone
    # would read it as violated forever and flap fission on every group.
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


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Knobs for the per-lane window controller.

    target_occupancy: fill fraction best-effort lanes steer batches toward;
        the fill time is how long that many arrivals take at the EWMA rate.
    min_delay_s / max_delay_s: hard bounds of the retuned window.
    alpha: EWMA smoothing for arrival gaps, occupancy, and service time.
    grow / shrink: bounded multiplicative step per retune.
    hysteresis: relative dead-band — desired values within ±hysteresis of
        the current window leave it untouched (no per-batch flapping).
    floor_s: windows shrinking below this snap to min_delay_s (a
        sub-floor window buys nothing but timer churn).
    slack_fraction: the share of a strict class's modeled slack the window
        may spend (the rest absorbs model error — an EWMA under-estimating
        the queue wait must not convert the whole target into batching
        delay and violate it by construction).
    """

    target_occupancy: float = 0.75
    min_delay_s: float = 0.0
    max_delay_s: float = 0.020
    alpha: float = 0.3
    grow: float = 1.6
    shrink: float = 0.6
    hysteresis: float = 0.2
    floor_s: float = 0.00025
    slack_fraction: float = 0.5


def static_window_s(slo: SLOClass, max_delay_s: float) -> float:
    """The non-adaptive (static) window for a class: best-effort lanes use
    the configured window unchanged; a zero-target class never waits; other
    strict classes bound the added delay to a quarter of their target (no
    estimates exist without a controller, so the bound is structural)."""
    if slo.best_effort:
        return max_delay_s
    return min(max_delay_s, 0.25 * slo.target_s)


class QueueingWindow:
    """One admission lane's window controller. Single-writer: only the
    lane's dispatcher thread calls :meth:`observe_batch`; ``snapshot()``
    readers see torn-free floats under the GIL. Pure — it never reads a
    clock; every timestamp it sees arrived via ``observe_batch``, which is
    what makes it drivable by a scripted virtual-clock trace."""

    def __init__(
        self,
        max_batch: int,
        initial_delay_s: float,
        config: AdaptiveConfig | None = None,
        slo: SLOClass = BEST_EFFORT,
        service: ServiceTimeEstimate | None = None,
    ):
        self.cfg = config or AdaptiveConfig()
        self.max_batch = max(1, int(max_batch))
        self.slo = slo
        # service time is per FUNCTION: the scheduler hands every lane of a
        # function the same estimate, so new class lanes start warm; a
        # standalone controller owns a private one (same behavior as before)
        self.service = service if service is not None else ServiceTimeEstimate(self.cfg.alpha)
        self.delay_s = self._clamp_seed(initial_delay_s)
        self.retunes = 0
        self._ewma_gap_s: float | None = None
        self._ewma_intra_s: float | None = None
        self._ewma_occupancy: float | None = None
        self._last_arrival_t: float | None = None

    def _clamp_seed(self, delay_s: float) -> float:
        seed = min(max(float(delay_s), self.cfg.min_delay_s), self.cfg.max_delay_s)
        if not self.slo.best_effort:
            # a strict lane's first window must already respect the target:
            # with no estimates yet the structural static bound governs
            seed = min(seed, static_window_s(self.slo, self.cfg.max_delay_s))
        return seed

    def reset(self, initial_delay_s: float | None = None) -> None:
        """Forget learned traffic state (benchmark warmup isolation);
        optionally re-seed the window."""
        if initial_delay_s is not None:
            self.delay_s = self._clamp_seed(initial_delay_s)
        self._ewma_gap_s = None
        self._ewma_intra_s = None
        self._ewma_occupancy = None
        self.service.reset()
        self._last_arrival_t = None

    # ------------------------------------------------------------- model

    @property
    def arrival_rate_rps(self) -> float:
        gap = self._ewma_gap_s
        return 1.0 / gap if gap and gap > 0 else 0.0

    def offered_rho(self) -> float:
        """This lane's offered load vs its batched capacity:
        ``lambda * S / k_hat``. >= 1 means the lane cannot keep up."""
        lam = self.arrival_rate_rps
        svc = self.service.value or 0.0
        if lam <= 0 or svc <= 0:
            return 0.0
        k_hat = min(float(self.max_batch), max(1.0, 1.0 + lam * self.delay_s))
        return lam * svc / k_hat

    def predicted_wait_s(self) -> float:
        """M/G/1-style queue-wait prediction behind this lane's backlog:
        ``S * rho / (1 - rho)`` with ``rho = lambda * S / k_hat``. Infinite
        once the lane is offered more than its batched capacity."""
        svc = self.service.value or 0.0
        rho = self.offered_rho()
        if rho <= 0.0:
            return 0.0
        if rho >= 1.0:
            return math.inf
        return svc * rho / (1.0 - rho)

    def observe_batch(
        self,
        arrival_ts: list[float],
        closed_full: bool,
        service_s: float | None = None,
    ) -> float:
        """Feed one closed batch's arrival timestamps (and the batch's
        measured service wall time); returns the retuned window (seconds).
        Gaps are measured across batch boundaries too, so a string of
        singleton batches still yields a rate estimate."""
        a = self.cfg.alpha
        ts = sorted(arrival_ts)
        gaps = []
        if self._last_arrival_t is not None and ts:
            gaps.append(max(0.0, ts[0] - self._last_arrival_t))
        gaps.extend(t1 - t0 for t0, t1 in zip(ts, ts[1:]))
        if ts:
            self._last_arrival_t = ts[-1]
        for g in gaps:
            self._ewma_gap_s = g if self._ewma_gap_s is None else (1 - a) * self._ewma_gap_s + a * g
            if g < self.cfg.max_delay_s:
                # "catchable" gaps only: the intra-burst spacing estimate that
                # drives idle_close_s — burst-boundary gaps would inflate it
                self._ewma_intra_s = (
                    g if self._ewma_intra_s is None else (1 - a) * self._ewma_intra_s + a * g
                )
        occ = len(ts) / self.max_batch
        self._ewma_occupancy = occ if self._ewma_occupancy is None else (1 - a) * self._ewma_occupancy + a * occ
        if service_s is not None and service_s >= 0:
            self.service.observe(service_s)
        new = self._retune(closed_full)
        if new != self.delay_s:
            self.retunes += 1
            self.delay_s = new
        return self.delay_s

    def _desired_window(self) -> float | None:
        """The model's raw window choice, before hysteresis/steps. None when
        no rate estimate exists yet (the seed window governs)."""
        cfg = self.cfg
        if not self.slo.best_effort and self.slo.target_p95_ms == 0.0:
            # zero-target (IMMEDIATE / PRIORITY_HIGH shim): never waits, by
            # contract — even an operator min_delay_s floor (a best-effort
            # timer-churn knob) must not re-open a window on this lane
            return 0.0
        gap = self._ewma_gap_s
        if gap is None:
            return None
        if gap >= cfg.max_delay_s:
            # trickle: even the longest window can't catch one more arrival,
            # for ANY class — waiting buys queueing delay and nothing else
            return cfg.min_delay_s if self.slo.best_effort else 0.0
        # time to fill target_occupancy * max_batch; the first request opens
        # the window, so one fewer arrival is needed
        need = max(0.0, cfg.target_occupancy * self.max_batch - 1.0)
        fill_s = need * gap
        desired = min(cfg.max_delay_s, max(cfg.min_delay_s, fill_s))
        if not self.slo.best_effort:
            svc = self.service.value or 0.0
            slack = self.slo.target_s - self.predicted_wait_s() - svc
            budget = cfg.slack_fraction * slack
            if budget <= cfg.min_delay_s:
                # no slack left: degrade to greedy FIFO. Explicitly 0, not
                # min_delay_s — a strict lane out of slack must stop adding
                # delay entirely
                return 0.0
            desired = min(desired, budget)
        return desired

    def _retune(self, closed_full: bool) -> float:
        cfg, cur = self.cfg, self.delay_s
        desired = self._desired_window()
        if desired is None:
            return cur
        if (
            desired > cur
            and self._ewma_occupancy is not None
            and self._ewma_occupancy >= cfg.target_occupancy
        ):
            desired = cur  # batches already fill to target: growth buys nothing
        step_floor = cfg.max_delay_s / 32.0
        if desired > cur * (1.0 + cfg.hysteresis):
            return min(desired, max(cur * cfg.grow, step_floor))
        if desired < cur * (1.0 - cfg.hysteresis) or (desired < cur and closed_full):
            new = max(desired, cur * cfg.shrink)
            # sub-floor windows buy nothing but timer churn: snap straight
            # to the model's floor — min_delay_s for best-effort trickle,
            # 0.0 for a strict lane that must stop waiting (desired <= new,
            # so the snap never moves the window up)
            return desired if new < cfg.floor_s else new
        return cur

    def idle_close_s(self) -> float | None:
        """Early-close cutoff for an OPEN window: when no arrival lands
        within ~3 smoothed intra-burst gaps, the burst this window was
        grown for is over — holding the collected requests for the rest of
        the window is pure convoy tax. None until a spacing estimate exists
        (then the window alone governs)."""
        if self._ewma_intra_s is None:
            return None
        return min(self.cfg.max_delay_s, max(3.0 * self._ewma_intra_s, 1e-3))

    def snapshot(self) -> dict:
        idle = self.idle_close_s()
        wait = self.predicted_wait_s()
        return {
            "window_ms": self.delay_s * 1e3,
            "ewma_gap_ms": (self._ewma_gap_s or 0.0) * 1e3,
            "ewma_occupancy": self._ewma_occupancy or 0.0,
            "idle_close_ms": (idle or 0.0) * 1e3,
            "retunes": self.retunes,
            "slo": self.slo.name,
            "target_ms": self.slo.target_p95_ms,
            "arrival_rps": round(self.arrival_rate_rps, 3),
            "service_ms": (self.service.value or 0.0) * 1e3,
            "predicted_wait_ms": wait * 1e3 if math.isfinite(wait) else math.inf,
            "rho": round(self.offered_rho(), 4),
        }
