"""Per-(function, shape, class) admission lane with a micro-batching
coalescer thread.

Each (function, request-shape, SLO-class) key owns one queue and one
dispatcher thread. The dispatcher blocks for the first request, then keeps
the batch open for up to the lane's window past that first arrival
(ProFaaStinate's "briefly delay to group", with the window set per class by
the queueing-model controller — see :mod:`repro_torch.scheduler.adaptive`),
closing early when ``max_batch`` requests have been admitted, when the
burst goes quiet (idle-close), or when a *preempt* lands. With a zero
window the lane degenerates to greedy draining: whatever is already queued
rides along, nothing waits.

Batches are single-class by construction — the class is part of the queue
key — so a strict request can never be convoyed by best-effort traffic.
Cross-class coupling happens through exactly one mechanism:
:meth:`AdmissionQueue.preempt_window`, called by the scheduler when a
strictly tighter-class request arrives for the same (function, shape). It
*preempts the in-flight coalesce timer*: the dispatcher parked on the
window wait wakes immediately, closes the window, and dispatches what it
has, so neither the urgent request (behind the platform's dispatch path)
nor the already-collected batch waits out a residual throughput window.
The preempt is edge-triggered and only armed while a window is actually
open — a preempt with no window in flight must not shorten the NEXT
window (regression-tested).

All blocking goes through the injected :class:`Clock`, which is what makes
every window/idle/priority behavior testable on a virtual clock with zero
real sleeps.

A dispatcher that sees no traffic for ``idle_timeout_s`` offers itself back
via ``on_idle`` (the scheduler drops the queue under its lock unless a
request raced in) and exits — shape-diverse workloads don't leak threads.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from concurrent.futures import Future
from typing import Callable

from repro_torch.scheduler.adaptive import QueueingWindow
from repro_torch.scheduler.clock import SYSTEM_CLOCK, SystemClock
from repro_torch.scheduler.slo import BEST_EFFORT, SLOClass


@dataclasses.dataclass
class PendingRequest:
    args: tuple
    future: Future
    t_enqueue: float
    # the admission class carries ALL priority semantics: lane selection,
    # window length, and cross-lane preemption (the old integer priority
    # field became write-only after the class-lane redesign and was removed)
    slo: SLOClass = BEST_EFFORT
    # per-request trace handle (obs.SpanContext) — None when tracing is off
    # or the caller predates the tracing layer; duck-typed so the scheduler
    # layer stays import-free of obs
    span: object = None


class AdmissionQueue:
    """One (function, shape, class) lane: queue + dispatcher. ``dispatch``
    receives (name, [args...]) and must return one result per request, in
    order."""

    GUARDED_FIELDS = {
        "_items": "_cv",
        "_stopped": "_cv",
        "_window_open": "_cv",
        "_preempted": "_cv",
    }

    def __init__(
        self,
        name: str,
        dispatch: Callable[[str, list[tuple]], list],
        *,
        key: tuple = (),
        max_batch: int,
        max_delay_s: float,
        idle_timeout_s: float = 60.0,
        slo: SLOClass = BEST_EFFORT,
        adaptive: QueueingWindow | None = None,
        on_batch_done: Callable[[str, list[PendingRequest], float], None] | None = None,
        on_idle: Callable[["AdmissionQueue"], bool] | None = None,
        clock: SystemClock | None = None,
        tracer=None,
    ):
        self.name = name
        self.key = key
        self.slo = slo
        self._tracer = tracer
        # window-open timestamp of the batch being collected; written and
        # read only by the single dispatcher thread
        self._t_open = 0.0
        self._dispatch = dispatch
        self.max_batch = max(1, int(max_batch))
        self.max_delay_s = max(0.0, float(max_delay_s))
        self.idle_timeout_s = idle_timeout_s
        self.adaptive = adaptive
        self.clock = clock or SYSTEM_CLOCK
        self._on_batch_done = on_batch_done
        self._on_idle = on_idle
        # One condition guards the lane state: items, stop flag, and the
        # window bookkeeping (open flag + preempt latch). Lock ordering is
        # scheduler._lock -> this cv (submit/stop hold the scheduler lock
        # while putting); the dispatcher NEVER takes the scheduler lock
        # while holding the cv (on_idle / on_batch_done run outside it).
        self._cv = threading.Condition()
        self._items: collections.deque[PendingRequest] = collections.deque()
        self._stopped = False
        self._window_open = False
        self._preempted = False
        self.thread = threading.Thread(target=self._loop, daemon=True, name=f"coalesce-{name}")
        self.thread.start()

    # ----------------------------------------------------------------- API

    def put(self, req: PendingRequest) -> None:
        with self._cv:
            self._items.append(req)
            self._cv.notify_all()

    def preempt_window(self) -> bool:
        """Close the currently open batching window, if any: the dispatcher
        parked on the window timer wakes and dispatches what it has
        collected NOW. Edge-triggered and armed only while a window is
        open — calling this on an idle lane is a no-op (the next window
        must open at full length). Returns whether a window was preempted."""
        with self._cv:
            if not self._window_open:
                return False
            self._preempted = True
            self._cv.notify_all()
            return True

    def empty(self) -> bool:
        with self._cv:
            return not self._items

    def depth(self) -> int:
        with self._cv:
            return len(self._items)

    def stop(self) -> None:
        """Stop after draining already-admitted traffic (a queued request
        must never be stranded behind a shutdown)."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    # ------------------------------------------------------------- internals

    def _collect(self, first: PendingRequest) -> tuple[list[PendingRequest], bool]:
        """Admit up to max_batch requests within the lane's window of the
        first arrival. The window closes early on: max_batch reached, stop,
        idle-close (burst went quiet), or a cross-lane preempt (a tighter
        class arrived on this function+shape)."""
        clock = self.clock
        batch = [first]
        self._t_open = clock.now()
        deadline = self._t_open + self.max_delay_s
        stopped = False
        with self._cv:
            self._window_open = True
            self._preempted = False
            try:
                while len(batch) < self.max_batch:
                    while self._items and len(batch) < self.max_batch:
                        batch.append(self._items.popleft())
                    if len(batch) >= self.max_batch:
                        break
                    if self._stopped:
                        stopped = True
                        break
                    if self._preempted:
                        self._preempted = False
                        break  # tighter-class arrival: dispatch what we have
                    remaining = deadline - clock.now()
                    if remaining <= 0:
                        break  # window expired: serve the batch
                    timeout = remaining
                    if self.adaptive is not None:
                        # idle-close: a grown window is for catching a burst
                        # in flight; once arrivals pause longer than the
                        # smoothed intra-burst spacing allows, waiting out
                        # the rest of the window just convoys the batch
                        idle_cut = self.adaptive.idle_close_s()
                        if idle_cut is not None and idle_cut < timeout:
                            timeout = idle_cut
                    woke_at = clock.now()
                    clock.wait_on(self._cv, timeout)
                    if not self._items and self.adaptive is not None:
                        idle_cut = self.adaptive.idle_close_s()
                        if idle_cut is not None and clock.now() - woke_at >= idle_cut:
                            break  # burst went quiet: serve the batch
            finally:
                self._window_open = False
                self._preempted = False
        return batch, stopped

    def _loop(self) -> None:
        clock = self.clock
        while True:
            first = None
            with self._cv:
                idle_deadline = clock.now() + self.idle_timeout_s
                while not self._items:
                    if self._stopped:
                        return
                    remaining = idle_deadline - clock.now()
                    if remaining <= 0:
                        break
                    clock.wait_on(self._cv, remaining)
                if self._items:
                    first = self._items.popleft()
            if first is None:
                # idle: ask the scheduler to retire us (outside the cv — the
                # retire path re-enters empty()); a concurrent submit makes
                # it refuse, and we keep serving
                if self._on_idle is not None and self._on_idle(self):
                    return
                continue
            batch, stopped = self._collect(first)
            self._run_batch(batch)
            if stopped:
                with self._cv:
                    if not self._items:
                        return
                # stop raced new work in: keep draining (stop() is only
                # called under the scheduler lock after _closed is set, so
                # this tail is bounded)

    def _run_batch(self, batch: list[PendingRequest]) -> None:
        clock = self.clock
        t_exec = clock.now()
        # The batched dispatch gets its OWN trace (activated for the
        # duration so spans minted during execution — handler enters,
        # cross-function hops — nest under it); each member request's trace
        # gets exact [enqueue, window-open, dispatch, done] phase tiles
        # referencing the batch trace, so per-request attribution never
        # double-counts the shared execution.
        tracer = self._tracer
        bctx = None
        if tracer is not None and any(r.span is not None for r in batch):
            bctx = tracer.begin_request(
                f"batch:{self.name}", "batch", t0=t_exec,
                attrs={
                    "lane": self.name,
                    "size": len(batch),
                    "slo": self.slo.name,
                    "members": [r.span.trace_id for r in batch if r.span is not None],
                },
            )
        activation = (tracer.activate(bctx) if tracer is not None
                      else contextlib.nullcontext())
        try:
            with activation:
                results = self._dispatch(self.name, [r.args for r in batch])
            if len(results) != len(batch):
                raise RuntimeError(
                    f"batched dispatch for {self.name!r} returned {len(results)} "
                    f"results for {len(batch)} requests"
                )
        except BaseException as exc:  # noqa: BLE001 — every caller must hear about it
            for r in batch:
                _resolve(r.future, exc=exc)
            t_fail = clock.now()
            service_s = t_fail - t_exec
            self._emit_phases(batch, t_exec, t_fail, bctx, error=type(exc).__name__)
        else:
            t_done = clock.now()
            service_s = t_done - t_exec
            # Futures FIRST, metrics second: a raising metrics sink must
            # never strand a batch of clients blocked on unresolved futures.
            for r, out in zip(batch, results):
                _resolve(r.future, result=out)
            if self._on_batch_done is not None:
                try:
                    self._on_batch_done(self.name, batch, t_done)
                except Exception:  # noqa: BLE001 — observability is best-effort
                    pass
            self._emit_phases(batch, t_exec, t_done, bctx)
        if self.adaptive is not None:
            # fed AFTER dispatch so the controller's service EWMA sees the
            # measured batch wall time (the queueing model's S)
            self.max_delay_s = self.adaptive.observe_batch(
                [r.t_enqueue for r in batch],
                len(batch) >= self.max_batch,
                service_s=service_s,
            )

    def _emit_phases(self, batch: list[PendingRequest], t_exec: float,
                     t_done: float, bctx, error: str | None = None) -> None:
        """Tile each traced member's wall interval exactly: queue-wait
        [enqueue, window-open], window-wait [open, dispatch], batch-compute
        [dispatch, done] — their sum IS the request's end-to-end latency
        (the conservation invariant the obs tests pin)."""
        t_open = self._t_open
        err_args = {"error": error} if error else None
        for r in batch:
            span = r.span
            if span is None:
                continue
            open_r = min(max(t_open, r.t_enqueue), t_exec)
            cargs = {"size": len(batch)}
            if bctx is not None:
                cargs["batch_trace"] = bctx.trace_id
            if error:
                cargs["error"] = error
            span.tile([("queue-wait", "queue-wait", r.t_enqueue, open_r, None),
                       ("window-wait", "window-wait", open_r, t_exec, None),
                       ("batch-compute", "batch-compute", t_exec, t_done, cargs)],
                      t_done, args=err_args)
        if bctx is not None:
            bctx.finish(t_done, args=err_args)


def _resolve(future: Future, *, result=None, exc=None) -> None:
    """Deliver to a future that the client may have cancelled meanwhile —
    an InvalidStateError must not kill the dispatcher thread (it would
    orphan the rest of the batch and permanently hang the key's queue)."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except Exception:
        if not future.cancelled():
            raise
