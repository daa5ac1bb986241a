"""The Function Handler: dispatch coordination + synchronous-call detection.

Every invocation — external (client) or internal (function-to-function) —
flows through the handler. For internal calls it observes, at run time,
whether the issuing execution *blocked* waiting for the callee (the paper's
blocking-socket observation; here the caller's eager glue is parked inside
``remote_call`` until the callee responds). Observed synchronous edges
accumulate per (caller, callee) and are reported to the fusion policy; when
the policy fires, a fusion request with the two function identifiers is
submitted to the Merger — exactly the §3 control flow.

The handler also:
* captures the latest request per function as the *canary* used by the
  Merger's health check;
* maintains the per-thread invocation stack so blocked time is attributed
  to the right billing record (the double-billing measurement);
* counts direct client demand per function (``note_demand``) and reports
  windowed rates of it and of each edge, which fission's regret check reads.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading
import time
from typing import Callable

from repro_torch.core.billing import BillingMeter, InvocationRecord
from repro_torch.scheduler.clock import SYSTEM_CLOCK

_RECENT_WAITS = 64  # bounded per-edge wait history for the tail estimate
_RECENT_TS = 256  # bounded per-edge / per-function timestamp history: the
# fission regret path must see whether an edge or a member is hot NOW —
# all-time counters stay "hot" forever after traffic moves away
RECENT_WINDOW_S = 5.0  # default lookback for the windowed rates


def _windowed_rate(ts, window_s: float, now: float) -> float:
    """Events/s over the trailing window from a bounded timestamp deque.
    When the deque overflowed INSIDE the window (high-rate source: 256
    entries can span well under 5s), the denominator is the span the deque
    actually covers — dividing the capped count by the full window would
    clamp every hot source to maxlen/window_s (~51 req/s) and compress the
    rate ratios the divergence check compares."""
    if not ts:
        return 0.0
    cutoff = now - window_s
    count = sum(1 for t in ts if t >= cutoff)
    if count == 0:
        return 0.0
    span = window_s
    maxlen = getattr(ts, "maxlen", None)
    if maxlen is not None and len(ts) == maxlen and ts[0] >= cutoff:
        # ONLY an overflowed deque truncates the window. Shortening the span
        # just because the oldest retained sample is recent would turn a
        # function's first two requests into a thousands-req/s reading.
        span = max(now - ts[0], 1e-6)
    return count / span


@dataclasses.dataclass
class EdgeStats:
    sync_count: int = 0
    async_count: int = 0
    total_wait_s: float = 0.0

    def __post_init__(self):
        # Deliberately NOT dataclass fields: asdict()/replace() snapshots
        # stay plain scalars (JSON-serializable stats, cheap copies).
        self.recent_waits: list[float] = []
        self.recent_ts: collections.deque[float] = collections.deque(maxlen=_RECENT_TS)

    def recent_sync_rate(self, window_s: float = RECENT_WINDOW_S, now: float | None = None) -> float:
        """Sync observations per second over the trailing ``window_s`` — the
        *windowed* view of edge heat: a chain whose traffic moved away reads
        ~0 here while sync_count stays frozen at its all-time total."""
        now = time.perf_counter() if now is None else now
        return _windowed_rate(self.recent_ts, window_s, now)

    @property
    def mean_wait_s(self) -> float:
        return self.total_wait_s / self.sync_count if self.sync_count else 0.0

    @property
    def p95_wait_s(self) -> float:
        """Nearest-rank p95 over the recent sync waits — the fusion policy's
        promote rule keys on tail blocking, which a mean over a mostly-fast
        edge hides. Falls back to the mean when no history is retained."""
        if not self.recent_waits:
            return self.mean_wait_s
        ordered = sorted(self.recent_waits)
        rank = min(len(ordered), max(1, math.ceil(0.95 * len(ordered))))
        return ordered[rank - 1]


@dataclasses.dataclass
class _ActiveInvocation:
    function: str
    instance_id: str
    t_start: float
    resident_bytes: int
    blocked_s: float = 0.0
    batch_size: int = 1
    # (SpanContext, outer parent id, this execute span's id) when a trace
    # was active at enter — exit/abort close the span and pop the activation
    span: tuple | None = None


class FunctionHandler:
    GUARDED_FIELDS = {"edges": "_lock", "canaries": "_lock", "_recent_calls": "_lock"}

    def __init__(self, meter: BillingMeter, on_fusion_candidate: Callable[[str, str], None] | None = None,
                 clock=None, tracer=None):
        self.meter = meter
        self.clock = clock or SYSTEM_CLOCK
        # obs.Tracer: enter/exit bracket every execution, so the handler is
        # where per-execution "execute" spans (with the serving instance id)
        # enter the active request's trace.
        self._tracer = tracer
        self.on_fusion_candidate = on_fusion_candidate
        self.edges: dict[tuple[str, str], EdgeStats] = {}
        self.canaries: dict[str, tuple] = {}
        self._recent_calls: dict[str, collections.deque] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()

    # ------------------------------------------------------- invocation stack

    def _stack(self) -> list[_ActiveInvocation]:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def enter(self, function: str, instance, batch_size: int = 1) -> None:
        """``batch_size > 1`` marks a micro-batched execution: k co-batched
        requests holding the instance once. `exit` then emits one record PER
        request (each carrying batch_size, so billed GB-s splits k ways and
        per-function call counts still count client requests)."""
        inv = _ActiveInvocation(
            function, instance.instance_id, self.clock.now(), instance.resident_bytes(),
            batch_size=max(1, batch_size),
        )
        if self._tracer is not None:
            cur = self._tracer.current()
            if cur is not None:
                ctx, parent = cur
                sid = ctx.alloc_id()
                # activate so nested cross-function hops parent under this
                # execute span (exit/abort pops)
                self._tracer.push(ctx, sid)
                inv.span = (ctx, parent, sid)
        self._stack().append(inv)

    def exit(self, function: str) -> None:
        inv = self._stack().pop()
        t_end = self.clock.now()
        self._close_span(inv, t_end)
        for _ in range(inv.batch_size):
            self.meter.record(
                InvocationRecord(
                    function=inv.function,
                    instance=inv.instance_id,
                    t_start=inv.t_start,
                    t_end=t_end,
                    resident_bytes=inv.resident_bytes,
                    blocked_s=inv.blocked_s / inv.batch_size,
                    batch_size=inv.batch_size,
                )
            )

    def abort(self, function: str) -> None:
        """Pop the invocation WITHOUT billing — used when an attempt fails
        and will be retried (billing the failed attempt would double-count
        the request once the retry lands). The aborted attempt still closes
        its trace span (flagged) — the retry emits its own."""
        inv = self._stack().pop()
        self._close_span(inv, self.clock.now(), aborted=True)

    def _close_span(self, inv: _ActiveInvocation, t_end: float,
                    aborted: bool = False) -> None:
        if inv.span is None:
            return
        ctx, parent, sid = inv.span
        self._tracer.pop()
        args = {"instance": inv.instance_id, "batch": inv.batch_size}
        if aborted:
            args["aborted"] = True
        ctx.emit(f"execute:{inv.function}", "execute", inv.t_start, t_end,
                 parent_id=parent, span_id=sid, args=args)

    def attribute_blocked(self, seconds: float) -> None:
        stack = self._stack()
        if stack:
            stack[-1].blocked_s += seconds

    # ------------------------------------------------------- observation

    def record_canary(self, function: str, args: tuple) -> None:
        """Keep the latest request by reference. Safe because a recorded
        request's arguments are never written in place: dense prefill and
        decode return NEW cache tensors, so a replayed canary sees what the
        original request saw. The paged routes write the KV arena in place,
        so they run under :meth:`no_canaries` and record nothing."""
        if getattr(self._tls, "no_canary", False):
            return
        with self._lock:
            self.canaries[function] = args

    @contextlib.contextmanager
    def no_canaries(self):
        """Record no canary on this thread, at any hop of the chain, while
        the block runs: for requests whose arguments the functions write in
        place (the paged KV arena), a later replay would write stale rows
        into pages that may belong to another sequence by then."""
        prev = getattr(self._tls, "no_canary", False)
        self._tls.no_canary = True
        try:
            yield
        finally:
            self._tls.no_canary = prev

    def canary(self, function: str):
        with self._lock:
            return self.canaries.get(function)

    def note_demand(self, function: str) -> None:
        """One unit of direct external demand (a client invoke) landed on
        ``function`` — the platform's entry points call this; internal
        function-to-function dispatches and control-plane canary replays
        deliberately do not."""
        with self._lock:
            recent = self._recent_calls.get(function)
            if recent is None:
                recent = self._recent_calls[function] = collections.deque(maxlen=_RECENT_TS)
            recent.append(self.clock.now())

    def recent_rate(self, function: str, window_s: float = RECENT_WINDOW_S) -> float:
        """Direct external demand (requests/s) on this function over the
        trailing window — the per-member signal the fission divergence check
        compares against its commit-time baseline."""
        now = self.clock.now()
        with self._lock:
            recent = self._recent_calls.get(function)
            return _windowed_rate(recent, window_s, now) if recent else 0.0

    def recent_inbound_rate(self, function: str, exclude=frozenset(),
                            window_s: float = RECENT_WINDOW_S) -> float:
        """Windowed rate of synchronous dispatches INTO ``function`` from
        callers outside ``exclude`` — demand a fused member receives from
        other execution units, invisible to `recent_rate` (eager-glue calls
        are not client traffic). The fission divergence check sums this with
        the direct rate so a member fed by an external caller never reads
        cold. Calls from inside ``exclude`` (the member's own fusion group)
        are inlined post-merge and must not count either way."""
        now = self.clock.now()
        with self._lock:
            return sum(
                st.recent_sync_rate(window_s, now=now)
                for (caller, callee), st in self.edges.items()
                if callee == function and caller not in exclude
            )

    def observe_edge(self, caller: str, callee: str, *, sync: bool, wait_s: float = 0.0) -> None:
        notify = False
        with self._lock:
            st = self.edges.setdefault((caller, callee), EdgeStats())
            if sync:
                st.sync_count += 1
                st.total_wait_s += wait_s
                st.recent_waits.append(wait_s)
                st.recent_ts.append(self.clock.now())
                if len(st.recent_waits) > _RECENT_WAITS:
                    del st.recent_waits[0]
                notify = True
            else:
                st.async_count += 1
        if notify and self.on_fusion_candidate is not None:
            self.on_fusion_candidate(caller, callee)

    def last_activity(self, function: str) -> float | None:
        """Most recent timestamp this function saw ANY traffic: direct
        external demand or an inbound synchronous dispatch. None if it has
        never been called — the idle-park tick treats never-invoked functions
        by their deploy time instead."""
        with self._lock:
            last: float | None = None
            recent = self._recent_calls.get(function)
            if recent:
                last = recent[-1]
            for (caller, callee), st in self.edges.items():
                if callee == function and st.recent_ts:
                    t = st.recent_ts[-1]
                    last = t if last is None else max(last, t)
            return last

    def stats(self) -> dict:
        now = self.clock.now()
        with self._lock:
            return {
                f"{a}->{b}": {
                    **dataclasses.asdict(v),
                    "recent_sync_rate": round(v.recent_sync_rate(now=now), 3),
                }
                for (a, b), v in sorted(self.edges.items())
            }
