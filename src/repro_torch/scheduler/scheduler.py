"""RequestScheduler: the front door for concurrent invocations.

``submit(name, args)`` returns a Future immediately; behind it, requests are
routed to a per-(function, shape, SLO-class) :class:`AdmissionQueue` whose
coalescer groups them into micro-batches and hands each batch to the
platform's batched dispatch path. The scheduler is backend-agnostic — it
only knows the dispatch callable — and tracks end-to-end (admission ->
completion) latency per request plus batch-size occupancy, the numbers
`stats()` reports as p50/p95/p99 and throughput.

Admission classes: ``submit(..., slo=SLOClass(name, target_p95_ms))`` keys
the request into its class's own lane — batches never mix classes — and
each lane's window comes from the queueing-model controller
(:class:`QueueingWindow`): best-effort lanes tune for occupancy, strict
lanes spend their target's modeled slack on batching and degrade to greedy
FIFO when load eats it. A strict-class arrival *preempts* open windows of
looser classes on the same (function, shape) — the in-flight coalesce
timer is closed immediately, never waited out (see
``AdmissionQueue.preempt_window``). The two-level API works too:
``priority=PRIORITY_HIGH`` maps to the zero-target ``IMMEDIATE`` class.

The scheduler is also a *signal source* for the fusion policy:
``signals_for(names)`` snapshots queue depth, mean batch occupancy, the
worst per-function p95 across a chain, and per-class tails vs their targets
— the live feedback that decides whether a merge's control-plane stall is
worth paying right now, and whether a committed merge is violating a
class's target (fission regret).

Every timing operation goes through the injected :class:`Clock`
(``clock=None`` = wall clock), so windows, idle timeouts, quiesce barriers,
and trough detection are all drivable by a deterministic virtual clock in
tests — no real sleeps.

Queue lifecycle: dispatcher threads are created lazily on a key's first
request and retire themselves after ``idle_timeout_s`` without traffic, so
shape-diverse workloads don't accumulate idle threads. All queue-map
mutations (submit, retire, shutdown) serialize on one lock — a request can
never be enqueued behind a stop flag or into a retired queue.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
from concurrent.futures import Future
from typing import Callable

from repro_torch.analysis.guards import guarded_by
from repro_torch.scheduler.adaptive import (
    AdaptiveConfig,
    QueueingWindow,
    SchedulerSignals,
    ServiceTimeEstimate,
    static_window_s,
)
from repro_torch.scheduler.batching import largest_pow2_le, request_key
from repro_torch.scheduler.clock import SYSTEM_CLOCK
from repro_torch.scheduler.coalescer import AdmissionQueue, PendingRequest
from repro_torch.scheduler.metrics import LatencyWindow, percentiles_ms  # noqa: F401 — re-exported
from repro_torch.scheduler.slo import SLOClass, slo_for_priority

_BATCH_WINDOW = 200_000  # bounded batch-size history
_PER_NAME_WINDOW = 8_192  # per-function latency history (tail estimate only)
_PER_CLASS_WINDOW = 8_192  # per-class latency history (SLO conformance)
_RECENT_BATCHES = 256  # per-function recent batch sizes: the "right now"
# occupancy the fusion policy's saturation guard keys on — an all-time
# average would stay cold for hours after traffic actually saturates
_SIGNALS_TTL_S = 0.05  # signals_for memo: a hot unfused edge asks on every
# sync observation; sorting the latency window per request would put an
# O(n log n) snapshot on the data path for a control-plane answer
_RECENT_LATS = 1024  # per-function (t_done, latency) pairs: the fission
# regret check compares post-merge tails against a pre-merge baseline, so it
# needs a p95 over the trailing seconds, not over the whole 8k-sample window
_CLASS_SIGNAL_WINDOW_S = 5.0  # lookback for the per-class tails handed to
# the fusion policy: SLO regret must see whether a class is violated NOW —
# an all-time window would keep reporting a long-recovered burst for
# thousands of samples (same discipline as recent_p95_ms)


class OverloadShedError(RuntimeError):
    """Best-effort request rejected at admission: the function's predicted
    offered load is at/over its batched capacity (rho >= 1) and the
    best-effort backlog already holds its bound — queueing more background
    traffic would only push strict classes toward misses. Fail fast so the
    client can back off."""


class RequestScheduler:
    # provlint: _cond is Condition(self._lock), so holding either counts.
    GUARDED_FIELDS = {
        "_queues": "_lock",
        "_lanes_by_base": "_lock",
        "_queues_by_name": "_lock",
        "_shed": "_lock",
        "_strict_fns": "_lock",
        "_slo_classes": "_lock",
        "_inflight": "_lock",
        "_per_name": "_lock",
        "_per_class": "_lock",
        "_recent_class_lats": "_lock",
        "_recent_by_name": "_lock",
        "_recent_lat_by_name": "_lock",
        "_batch_sizes": "_lock",
        "_batches": "_lock",
        "_signals_cache": "_lock",
        "_last_strict_submit_t": "_lock",
        "_closed": "_lock",
        "_service_by_fn": "_lock",
    }

    def __init__(
        self,
        dispatch_batch: Callable[[str, list[tuple]], list],
        *,
        max_batch: int = 8,
        max_delay_ms: float = 2.0,
        idle_timeout_s: float = 60.0,
        adaptive: bool = False,
        adaptive_config: AdaptiveConfig | None = None,
        on_request_done: Callable[[str, float, int], None] | None = None,
        be_shed_depth: int | None = None,
        clock=None,
        tracer=None,
    ):
        self._dispatch = dispatch_batch
        self.clock = clock or SYSTEM_CLOCK
        # obs.Tracer (duck-typed; scheduler stays import-free of obs): when
        # present, every submit mints a trace rooted at its enqueue time
        self._tracer = tracer
        # clamp to the largest power of two <= max_batch: the coalescer then
        # never forms a batch the pow2 bucket set can't serve in one
        # execution (a batch of 6 against buckets {1,2,4} would dispatch
        # twice, forever — worse than the one-off compile it avoids)
        self.max_batch = largest_pow2_le(max_batch)
        self.max_delay_s = max(0.0, float(max_delay_ms)) / 1e3
        self.idle_timeout_s = idle_timeout_s
        self.adaptive = bool(adaptive) or adaptive_config is not None
        if self.adaptive and adaptive_config is None:
            adaptive_config = AdaptiveConfig()
            if self.max_delay_s > adaptive_config.max_delay_s / 2:
                # a seed near/above the default cap must not be silently
                # clamped — leave headroom to grow past what was asked for
                adaptive_config = dataclasses.replace(
                    adaptive_config, max_delay_s=2.0 * self.max_delay_s
                )
        self.adaptive_config = adaptive_config
        self._on_request_done = on_request_done
        # Per-class overload shedding: when a function's predicted rho >= 1
        # (offered load at/over batched capacity, from the shared service
        # estimate), best-effort arrivals beyond this many queued requests
        # per function are failed fast instead of admitted — background
        # backlog must not grow without bound while strict classes fight
        # for the same capacity. None = auto (2 x max_batch). Armed ONLY for
        # functions that have seen strict-class traffic: shedding exists to
        # protect deadlines, and an all-best-effort overload is the fission
        # path's job (the churn scenario saturates on purpose). Only
        # adaptive schedulers shed (the rho estimate needs the controllers).
        self.be_shed_depth = be_shed_depth if be_shed_depth is not None else 2 * self.max_batch
        self._shed: dict[str, int] = {}
        self._strict_fns: set[str] = set()
        # one batch-service-time estimate per FUNCTION, shared by all of its
        # class lanes — a new lane starts with a warm M/G/1 model instead of
        # cold-starting its service EWMA (see ServiceTimeEstimate)
        self._service_by_fn: dict[str, ServiceTimeEstimate] = {}
        self._queues: dict[tuple, AdmissionQueue] = {}
        self._lock = threading.Lock()
        # Drain-barrier state: per-function in-flight batch counts, signalled
        # on completion so the control plane's quiesce() can wait for an
        # epoch's affected traffic to clear without polling the data path.
        self._cond = threading.Condition(self._lock)
        self._inflight: dict[str, int] = {}
        self._dispatch_tls = threading.local()  # name this thread is dispatching
        # Only strict-class (finite-target) arrivals are tracked for the
        # trough detector — a best-effort trickle has no deadline a
        # control-plane stall could violate, and letting it block troughs
        # would keep deferred merges pinned behind low-priority background
        # traffic.
        self._last_strict_submit_t: float | None = None
        self._closed = False
        self._latency = LatencyWindow()
        self._per_name: dict[str, LatencyWindow] = {}
        self._per_class: dict[str, LatencyWindow] = {}
        # (function, class) -> recent (t_done, latency) pairs, kept ONLY for
        # classes with a finite positive target (the ones the policy can act
        # on): the signals' per-class p95 is computed over a trailing time
        # window, never all-time
        self._recent_class_lats: dict[tuple[str, str], collections.deque] = {}
        self._slo_classes: dict[str, SLOClass] = {}
        # (function, shape) base key -> lanes, so a strict submit preempts
        # its siblings without scanning every queue under the global lock
        self._lanes_by_base: dict[tuple, list[AdmissionQueue]] = {}
        # function -> lanes, so the shed check and rho prediction stay
        # O(lanes of this function) on the hot admission path
        self._queues_by_name: dict[str, list[AdmissionQueue]] = {}
        self._recent_by_name: dict[str, collections.deque] = {}
        self._recent_lat_by_name: dict[str, collections.deque] = {}
        self._batch_sizes: collections.deque = collections.deque(maxlen=_BATCH_WINDOW)
        self._batches = 0
        self._signals_cache: dict[tuple, tuple[float, SchedulerSignals]] = {}

    # ----------------------------------------------------------------- API

    def submit(
        self,
        name: str,
        args: tuple,
        *,
        priority: int = 0,
        slo: SLOClass | None = None,
    ) -> Future:
        """Admit one request. ``slo`` selects the admission class (defaults
        to best-effort; ``priority=PRIORITY_HIGH`` is the two-level shim for
        the zero-target class). Returns the request's Future."""
        if slo is None:
            slo = slo_for_priority(priority)
        elif priority > 0 and slo.best_effort:
            slo = slo_for_priority(priority)
        req = PendingRequest(args, Future(), self.clock.now(), slo=slo)
        if self._tracer is not None:
            req.span = self._tracer.begin_request(
                name, "invoke_async", t0=req.t_enqueue, attrs={"slo": slo.name})
        key = request_key(name, args, slo.name)
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is shut down")
            known = self._slo_classes.get(slo.name)
            if known is not None and known.target_p95_ms != slo.target_p95_ms:
                raise ValueError(
                    f"SLO class {slo.name!r} redefined: target "
                    f"{slo.target_p95_ms} != {known.target_p95_ms}"
                )
            self._slo_classes[slo.name] = slo
            if slo.best_effort and self.adaptive and name in self._strict_fns:
                # overload shedding: with the function predicted past its
                # batched capacity, bound the best-effort backlog and fail
                # fast past it — strict classes keep admitting. Armed only
                # once the function serves strict traffic (see __init__).
                be_depth = sum(
                    lane.depth()
                    for lane in self._queues_by_name.get(name, ())
                    if lane.slo.best_effort
                )
                if be_depth >= self.be_shed_depth and self._predicted_rho_locked(name) >= 1.0:
                    self._shed[slo.name] = self._shed.get(slo.name, 0) + 1
                    req.future.set_exception(OverloadShedError(
                        f"{name}: predicted rho >= 1 with {be_depth} best-effort "
                        f"queued (bound {self.be_shed_depth})"
                    ))
                    if req.span is not None:
                        req.span.finish(args={"error": "shed"})
                    return req.future
            if not slo.best_effort:
                self._last_strict_submit_t = req.t_enqueue
                self._strict_fns.add(name)
            q = self._queues.get(key)
            if q is None:
                q = self._make_queue(name, key, slo)
                self._queues[key] = q
                self._lanes_by_base.setdefault(key[:-1], []).append(q)
                self._queues_by_name.setdefault(name, []).append(q)
            q.put(req)  # same lock as retire/shutdown: never lands post-stop
            if not slo.best_effort:
                # Early-close preemption: a strict arrival must never leave
                # sibling lanes' open throughput windows running their full
                # residual delay — the platform is about to serve urgent
                # traffic, so collected batches dispatch now. Preempting the
                # in-flight coalesce timer (not just sorting the request
                # first) is what closes the residual-delay hole the
                # two-level port opened (see coalescer docstring). The
                # per-base index keeps this O(classes on this shape), not
                # O(all lanes), on the urgent path.
                for other in self._lanes_by_base.get(key[:-1], ()):
                    if other is not q and slo.tighter_than(other.slo):
                        other.preempt_window()
        return req.future

    @guarded_by("_lock")
    def _predicted_rho_locked(self, name: str) -> float:
        """Function-level offered load vs full-batch capacity:
        ``sum(lane arrival rates) x shared service / max_batch``. 0.0 until
        estimates exist. Caller holds the scheduler lock."""
        est = self._service_by_fn.get(name)
        svc = est.value if est is not None else None
        if not svc:
            return 0.0
        lam = sum(
            q.adaptive.arrival_rate_rps
            for q in self._queues_by_name.get(name, ())
            if q.adaptive is not None
        )
        return lam * svc / self.max_batch

    def predicted_rho(self, name: str) -> float:
        """Public snapshot of the M/G/1 offered-load prediction for ``name``
        (sum of lane arrival rates x shared service / max_batch) — the
        autoscaler's scale-out signal. 0.0 until adaptive estimates exist."""
        with self._lock:
            return self._predicted_rho_locked(name)

    @guarded_by("_lock")
    def _make_queue(self, name: str, key: tuple, slo: SLOClass) -> AdmissionQueue:
        controller = None
        if self.adaptive:
            est = self._service_by_fn.get(name)
            if est is None:
                alpha = (self.adaptive_config or AdaptiveConfig()).alpha
                est = self._service_by_fn[name] = ServiceTimeEstimate(alpha)
            controller = QueueingWindow(
                self.max_batch, self.max_delay_s, self.adaptive_config,
                slo=slo, service=est,
            )
        # the controller clamps its seed into [min, max] and under the
        # class's structural bound; a static lane applies the same bound
        first_delay = (
            controller.delay_s
            if controller is not None
            else static_window_s(slo, self.max_delay_s)
        )
        return AdmissionQueue(
            name,
            self._tracked_dispatch,
            key=key,
            max_batch=self.max_batch,
            max_delay_s=first_delay,
            idle_timeout_s=self.idle_timeout_s,
            slo=slo,
            adaptive=controller,
            on_batch_done=self._record_batch,
            on_idle=self._retire_queue,
            clock=self.clock,
            tracer=self._tracer,
        )

    def _tracked_dispatch(self, name: str, args_list: list[tuple]) -> list:
        """Dispatch wrapper that maintains the per-function in-flight batch
        count the drain barrier (quiesce) and trough detector key on."""
        with self._cond:
            self._inflight[name] = self._inflight.get(name, 0) + 1
        self._dispatch_tls.name = name
        try:
            return self._dispatch(name, args_list)
        finally:
            self._dispatch_tls.name = None
            with self._cond:
                n = self._inflight.get(name, 1) - 1
                if n <= 0:
                    self._inflight.pop(name, None)
                else:
                    self._inflight[name] = n
                self._cond.notify_all()

    def quiesce(self, names=None, timeout: float = 10.0, *, include_queued: bool = True) -> bool:
        """Drain barrier for epoch transitions: block until the named
        functions (all functions when ``names`` is None) have no batch in
        flight — and, with ``include_queued``, nothing queued either (any
        class: the barrier is about the pipe being empty, not about
        deadlines). The control plane's reconciler runs the in-flight-only
        form (bounded) before executing a deferred transition, so the
        control-plane stall starts on a drained pipe; queued requests never
        need draining because they re-resolve the NEW routes at dispatch
        time. A dispatcher thread's own in-flight batch is excluded — the
        redeploy retry path can reach a barrier from inside a dispatch, and
        waiting on one's own batch would deadlock until timeout. Returns
        False on timeout (traffic never went quiet)."""
        names = None if names is None else set((names,) if isinstance(names, str) else names)
        own = getattr(self._dispatch_tls, "name", None)
        deadline = self.clock.now() + timeout
        with self._cond:
            while True:
                busy = any(
                    c - (1 if n == own else 0) > 0
                    for n, c in self._inflight.items()
                    if names is None or n in names
                )
                depth = sum(
                    q.depth()
                    for key, q in self._queues.items()
                    if names is None or key[0] in names
                ) if include_queued else 0
                if not busy and depth == 0:
                    return True
                remaining = deadline - self.clock.now()
                if remaining <= 0:
                    return False
                # queue depth changes don't signal the condition, so bound
                # each wait: the barrier is control-plane-only, a few ms of
                # poll granularity is invisible next to a drain
                self.clock.wait_on(self._cond, min(remaining, 0.01))

    def is_trough(self, *, min_quiet_s: float = 0.01, gap_mult: float = 3.0) -> bool:
        """Trough detector for the control plane's reconciler: True when a
        control-plane stall would land on no deadline-bearing traffic.
        Strict-class (finite-target) traffic governs: nothing strict may be
        queued, the time since the last strict submit must exceed
        ``gap_mult`` smoothed strict inter-arrival gaps (from the strict
        lanes' controller EWMAs), and no batch of ANY class may be mid
        dispatch (stalling an execution in flight delays work already
        admitted). Queued or trickling BEST-EFFORT traffic does NOT defeat
        the trough — it has no target a deferral could violate, and letting
        it block kept deferred merges pinned behind background trickle."""
        now = self.clock.now()
        with self._lock:
            if any(self._inflight.values()):
                return False
            if any(
                q.depth() for q in self._queues.values() if not q.slo.best_effort
            ):
                return False
            last = self._last_strict_submit_t
            gaps = [
                q.adaptive.snapshot()["ewma_gap_ms"] / 1e3
                for q in self._queues.values()
                if q.adaptive is not None and not q.slo.best_effort
            ]
        if last is None:
            return True  # never saw strict traffic: always a trough
        need = max(min_quiet_s, gap_mult * max(gaps)) if any(g > 0 for g in gaps) else min_quiet_s
        return now - last >= need

    def shutdown(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._closed = True
            queues = list(self._queues.values())
            for q in queues:
                q.stop()
        for q in queues:
            q.thread.join(timeout)

    # ------------------------------------------------------------ lifecycle

    def _retire_queue(self, q: AdmissionQueue) -> bool:
        """Idle-timeout callback from a dispatcher thread: drop the queue if
        no request snuck in; the dispatcher exits on True."""
        with self._lock:
            if not q.empty():
                return False
            if self._queues.get(q.key) is q:
                del self._queues[q.key]
                base = q.key[:-1]
                lanes = self._lanes_by_base.get(base)
                if lanes is not None:
                    lanes = [l for l in lanes if l is not q]
                    if lanes:
                        self._lanes_by_base[base] = lanes
                    else:
                        del self._lanes_by_base[base]
                by_name = self._queues_by_name.get(q.name)
                if by_name is not None:
                    by_name = [l for l in by_name if l is not q]
                    if by_name:
                        self._queues_by_name[q.name] = by_name
                    else:
                        del self._queues_by_name[q.name]
            return True

    # ------------------------------------------------------------- metrics

    def _record_batch(self, name: str, batch: list[PendingRequest], t_done: float) -> None:
        k = len(batch)
        slo = batch[0].slo  # lanes are single-class: one class per batch
        with self._lock:
            self._batch_sizes.append(k)
            self._batches += 1
            win = self._per_name.get(name)
            if win is None:
                win = self._per_name[name] = LatencyWindow(maxlen=_PER_NAME_WINDOW)
            cls_win = self._per_class.get(slo.name)
            if cls_win is None:
                cls_win = self._per_class[slo.name] = LatencyWindow(maxlen=_PER_CLASS_WINDOW)
            if not slo.best_effort and slo.target_p95_ms > 0:
                nc_key = (name, slo.name)
                nc_recent = self._recent_class_lats.get(nc_key)
                if nc_recent is None:
                    nc_recent = self._recent_class_lats[nc_key] = collections.deque(
                        maxlen=_RECENT_LATS
                    )
                for r in batch:
                    nc_recent.append((t_done, t_done - r.t_enqueue))
            recent = self._recent_by_name.get(name)
            if recent is None:
                recent = self._recent_by_name[name] = collections.deque(maxlen=_RECENT_BATCHES)
            recent.append(k)
            lat_recent = self._recent_lat_by_name.get(name)
            if lat_recent is None:
                lat_recent = self._recent_lat_by_name[name] = collections.deque(maxlen=_RECENT_LATS)
            for r in batch:
                lat_recent.append((t_done, t_done - r.t_enqueue))
        for r in batch:
            lat = t_done - r.t_enqueue
            self._latency.observe(lat, t_done)
            win.observe(lat, t_done)
            cls_win.observe(lat, t_done)
            if self._on_request_done is not None:
                try:
                    self._on_request_done(name, lat, k)
                except Exception:  # noqa: BLE001 — a raising billing/metrics sink
                    pass  # must not lose the rest of the batch's observations

    def signals_for(self, names) -> SchedulerSignals:
        """Live feedback for the fusion policy about the chain ``names``:
        summed queue depth over the chain's keys, mean occupancy of the
        chain's RECENT batches (last _RECENT_BATCHES per function — the
        saturation guard must see now, not an all-time average diluted by
        hours of idle history), the worst per-function p95, and each strict
        class's tail vs its target across the chain (the policy's
        SLO-violation promote/regret input)."""
        names = (names,) if isinstance(names, str) else tuple(names)
        now = self.clock.now()
        with self._lock:
            hit = self._signals_cache.get(names)
            if hit is not None and now - hit[0] < _SIGNALS_TTL_S:
                return hit[1]
            depth = sum(q.depth() for key, q in self._queues.items() if key[0] in names)
            sizes = [s for n in names for s in self._recent_by_name.get(n, ())]
            windows = [self._per_name[n] for n in names if n in self._per_name]
            cutoff = now - _CLASS_SIGNAL_WINDOW_S
            class_samples: dict[str, list[float]] = {}
            for (n, cls), recent in self._recent_class_lats.items():
                if n in names:
                    class_samples.setdefault(cls, []).extend(
                        lat for (t, lat) in recent if t >= cutoff
                    )
            targets = {cls: s.target_p95_ms for cls, s in self._slo_classes.items()}
        mean_occ = (sum(sizes) / len(sizes)) / self.max_batch if sizes else 0.0
        p95 = max((w.snapshot()["p95_ms"] for w in windows), default=0.0)
        class_p95 = tuple(
            sorted(
                (cls, percentiles_ms(samples, points=(95,))["p95_ms"],
                 targets.get(cls, math.inf))
                for cls, samples in class_samples.items()
                if samples
            )
        )
        sig = SchedulerSignals(
            queue_depth=depth, mean_occupancy=mean_occ, p95_ms=p95, class_p95_ms=class_p95
        )
        with self._lock:
            if len(self._signals_cache) > 256:  # bounded: chains are few
                self._signals_cache.clear()
            self._signals_cache[names] = (now, sig)
        return sig

    def recent_p95_ms(self, name: str, window_s: float = 5.0) -> float:
        """Nearest-rank p95 of the function's end-to-end latency over the
        trailing ``window_s`` seconds (0.0 with no recent samples). The
        fission regret check compares this against the pre-merge baseline
        snapshotted at commit — an all-time window would dilute a fresh
        regression with hours of healthy history."""
        cutoff = self.clock.now() - window_s
        with self._lock:
            recent = self._recent_lat_by_name.get(name)
            samples = [lat for (t, lat) in recent if t >= cutoff] if recent else []
        return percentiles_ms(samples, points=(95,))["p95_ms"] if samples else 0.0

    def reset_stats(self) -> None:
        """Forget latency/batch history and learned adaptive state; live
        queues keep serving and windows re-seed at (clamped) max_delay_s.
        Benchmarks call this after warmup so compiles and warmup bursts
        don't pollute the measured occupancy, tails, or the controllers'
        EWMAs. Call while traffic is quiescent (warmup responses collected):
        a dispatcher mid-batch would apply one retune from pre-reset state."""
        with self._lock:
            self._batch_sizes.clear()
            self._batches = 0
            self._per_name = {}
            self._per_class = {}
            self._recent_class_lats = {}
            self._recent_by_name = {}
            self._recent_lat_by_name = {}
            self._signals_cache = {}
            self._shed = {}
            # shedding re-arms only when strict traffic is seen again: a
            # strict request during a forgotten warmup must not leave
            # best-effort shedding armed forever (all-best-effort overloads
            # belong to the fission path)
            self._strict_fns = set()
            queues = list(self._queues.values())
        self._latency.reset()
        for q in queues:
            if q.adaptive is not None:
                q.adaptive.reset(self.max_delay_s)
                q.max_delay_s = q.adaptive.delay_s

    def window_snapshot(self) -> list[dict]:
        """Per-queue view of the (possibly retuned) batching windows."""
        with self._lock:
            queues = list(self._queues.values())
        out = []
        for q in queues:
            row = {
                "name": q.name,
                "slo": q.slo.name,
                "max_delay_ms": q.max_delay_s * 1e3,
                "depth": q.depth(),
            }
            if q.adaptive is not None:
                row.update(q.adaptive.snapshot())
            out.append(row)
        return out

    def class_stats(self) -> dict:
        """Per-class latency/conformance: percentiles, target, and whether
        the class's p95 currently meets it. ``met`` is None for classes
        without an actionable end-to-end target: best-effort (no target)
        and zero-target classes (IMMEDIATE promises zero *admission* delay;
        end-to-end latency always includes service time)."""
        with self._lock:
            windows = dict(self._per_class)
            classes = dict(self._slo_classes)
            shed = dict(self._shed)
        out = {}
        for cls_name, win in sorted(windows.items()):
            snap = win.snapshot()
            slo = classes.get(cls_name)
            target = slo.target_p95_ms if slo is not None else math.inf
            actionable = math.isfinite(target) and target > 0
            out[cls_name] = {
                **snap,
                "target_p95_ms": target,
                "met": (snap["p95_ms"] <= target) if actionable else None,
                "shed": shed.get(cls_name, 0),
            }
        for cls_name, n in shed.items():  # classes that ONLY shed still report
            if cls_name not in out:
                out[cls_name] = {"shed": n, "count": 0}
        return out

    def stats(self) -> dict:
        with self._lock:
            sizes = list(self._batch_sizes)
            batches = self._batches
            n_keys = len(self._queues)
            queues = list(self._queues.values())
        out = self._latency.snapshot()
        out.update(
            {
                "batches": batches,
                "queues": n_keys,
                "mean_batch": (sum(sizes) / len(sizes)) if sizes else 0.0,
                "max_batch_seen": max(sizes) if sizes else 0,
            }
        )
        classes = self.class_stats()
        if classes:
            out["classes"] = classes
        if self.adaptive:
            delays = [q.max_delay_s * 1e3 for q in queues]
            out["adaptive"] = {
                "window_min_ms": round(min(delays), 4) if delays else 0.0,
                "window_max_ms": round(max(delays), 4) if delays else 0.0,
                "retunes": sum(q.adaptive.retunes for q in queues if q.adaptive is not None),
            }
        return out
