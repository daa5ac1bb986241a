"""Causal request tracing: span contexts and a lock-cheap flight recorder.

Span model
----------
Every externally-visible request (``platform.invoke``, ``invoke_async``,
``ContinuousBatcher.submit``) mints a :class:`SpanContext` — one *trace* —
at its entry point.  The context travels with the request object (a field
on ``PendingRequest`` / ``serving._Request``; a thread-local activation for
the serial path) and accumulates *spans*: ``[t0, t1)`` intervals tagged
with a phase category (``cat``).  Leaf phases are laid out so they tile the
request's wall interval exactly — ``critical_path.attribute`` then recovers
per-category latency whose sum (plus the parent self-time gaps) equals the
end-to-end latency *by construction*, and tests assert the residual is zero.

Determinism: trace ids are minted from a single counter in submission
order, span ids from a per-trace counter, and every timestamp comes from
the injected :class:`~repro_torch.scheduler.clock.Clock`.  Nothing in a
record depends on wall time, thread identity, or object ids, so a same-seed
``VirtualClock`` simulation exports byte-identical traces run to run.

Hot-path cost: recording a span is one append to the *calling thread's*
bounded ring buffer behind that buffer's own (uncontended) lock; overflow
drops the oldest record and bumps a drop counter.  The recorder never
blocks the request path on a reader — ``snapshot()`` copies buffers one at
a time.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager

from repro_torch.scheduler.clock import SYSTEM_CLOCK

#: Phase taxonomy (span ``cat`` values).  Roots carry their entry-point
#: kind; attribution maps a root's self-time to "unattributed".
PHASES = frozenset(
    {
        "queue-wait",            # admission lane: enqueue -> window open
        "window-wait",           # coalescer window: open -> dispatch
        "batch-compute",         # batched program / decode loop
        "execute",               # handler-bracketed function execution
        "cross-function-sync",   # ctx.call boundary hop (blocking wait)
        "call-inline",           # ctx.call co-located fused-inline run
        "prefill-stall",         # serve path: alloc -> seated (self-time)
        "prefill-chunk",         # one budgeted chunk inside the stall
        "cold-provision",        # resurrect / restore on the invoke path
        "control-plane",         # merge / split / park / scale spans
    }
)

#: Reserved trace id for the platform-wide control-plane timeline.
CONTROL_TRACE_ID = 0

_ROOT_SPAN_ID = 1


@dataclasses.dataclass(frozen=True, slots=True)
class SpanRecord:
    """One immutable trace event. ``ph`` is ``"X"`` (complete span over
    ``[t0, t1)``) or ``"i"`` (instant event at ``t0``)."""

    trace_id: int
    span_id: int
    parent_id: int
    name: str
    cat: str
    t0: float
    t1: float
    ph: str = "X"
    args: dict | None = None

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0


class _ThreadBuffer:
    """One thread's bounded ring. Only its owner appends; readers copy."""

    GUARDED_FIELDS = {"items": "_lock", "dropped": "_lock", "_head": "_lock"}

    def __init__(self, capacity: int):
        self._lock = threading.Lock()
        self.capacity = capacity
        self.items: list[SpanRecord] = []
        self.dropped = 0
        #: ring cursor: index of the oldest record once the buffer wrapped
        self._head = 0

    def append(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self.items) < self.capacity:
                self.items.append(rec)
            else:
                self.items[self._head] = rec
                self._head = (self._head + 1) % self.capacity
                self.dropped += 1

    def snapshot(self) -> tuple[list[SpanRecord], int]:
        with self._lock:
            ordered = self.items[self._head:] + self.items[: self._head]
            return ordered, self.dropped

    def clear(self) -> None:
        with self._lock:
            self.items = []
            self._head = 0
            self.dropped = 0


class FlightRecorder:
    """Bounded per-thread span sink.

    ``append`` touches only the calling thread's buffer; the shared
    registry lock is taken once per thread lifetime (first append) and by
    readers. Overflow is drop-oldest with an exported drop counter.
    """

    GUARDED_FIELDS = {"_buffers": "_lock"}

    def __init__(self, capacity_per_thread: int = 8192):
        self.capacity_per_thread = int(capacity_per_thread)
        self._lock = threading.Lock()
        self._buffers: list[_ThreadBuffer] = []
        self._tls = threading.local()

    def append(self, rec: SpanRecord) -> None:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = _ThreadBuffer(self.capacity_per_thread)
            self._tls.buf = buf
            with self._lock:
                self._buffers.append(buf)
        buf.append(rec)

    def snapshot(self) -> list[SpanRecord]:
        """All retained records, globally ordered for deterministic export:
        by start time, then trace id, then span id."""
        with self._lock:
            buffers = list(self._buffers)
        records: list[SpanRecord] = []
        for buf in buffers:
            items, _ = buf.snapshot()
            records.extend(items)
        records.sort(key=lambda r: (r.t0, r.trace_id, r.span_id))
        return records

    def dropped(self) -> int:
        with self._lock:
            buffers = list(self._buffers)
        return sum(buf.snapshot()[1] for buf in buffers)

    def clear(self) -> None:
        with self._lock:
            buffers = list(self._buffers)
        for buf in buffers:
            buf.clear()

    def aggregates(self) -> dict:
        """Recorder-level counters for the Prometheus dump: span/event
        totals, drops, and per-phase count + wall seconds."""
        records = self.snapshot()
        phases: dict[str, dict] = {}
        spans = events = 0
        for r in records:
            if r.ph == "i":
                events += 1
                continue
            spans += 1
            agg = phases.setdefault(r.cat, {"count": 0, "seconds": 0.0})
            agg["count"] += 1
            agg["seconds"] += r.dur_s
        return {
            "spans": spans,
            "events": events,
            "dropped": self.dropped(),
            "phases": phases,
        }


class SpanContext:
    """Per-request (or per-batch) trace handle.

    Thread-safe: the span-id counter and the finished flag sit behind the
    context's own lock, so a request whose phases are emitted from the
    coalescer thread while cross-function children land from a worker
    thread never collides.
    """

    GUARDED_FIELDS = {"_next_id": "_lock", "_finished": "_lock"}

    __slots__ = ("tracer", "trace_id", "name", "kind", "t0", "attrs",
                 "_lock", "_next_id", "_finished")

    def __init__(self, tracer: "Tracer", trace_id: int, name: str,
                 kind: str, t0: float, attrs: dict | None = None):
        self.tracer = tracer
        self.trace_id = trace_id
        self.name = name
        self.kind = kind
        self.t0 = t0
        self.attrs = attrs
        self._lock = threading.Lock()
        self._next_id = _ROOT_SPAN_ID
        self._finished = False

    def alloc_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def emit(self, name: str, cat: str, t0: float, t1: float, *,
             parent_id: int = _ROOT_SPAN_ID, span_id: int | None = None,
             args: dict | None = None) -> int:
        """Record a completed ``[t0, t1)`` child span; returns its id.
        Pass a pre-allocated ``span_id`` (from :meth:`alloc_id`) when
        children were minted under it while it was still open."""
        sid = self.alloc_id() if span_id is None else span_id
        self.tracer.recorder.append(SpanRecord(
            self.trace_id, sid, parent_id, name, cat,
            float(t0), float(max(t0, t1)), "X", args))
        return sid

    def event(self, name: str, t: float | None = None, *,
              parent_id: int = _ROOT_SPAN_ID, args: dict | None = None) -> None:
        """Instant (zero-duration) marker; ignored by attribution."""
        if t is None:
            t = self.tracer.clock.now()
        self.tracer.recorder.append(SpanRecord(
            self.trace_id, self.alloc_id(), parent_id, name, "event",
            float(t), float(t), "i", args))

    def finish(self, t1: float | None = None, *, args: dict | None = None) -> None:
        """Close the trace: emit the root span covering ``[t0, t1)``.
        Idempotent — later calls are dropped, so error paths may finish
        defensively."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
        if t1 is None:
            t1 = self.tracer.clock.now()
        merged = dict(self.attrs or {})
        if args:
            merged.update(args)
        self.tracer.recorder.append(SpanRecord(
            self.trace_id, _ROOT_SPAN_ID, 0, self.name, self.kind,
            float(self.t0), float(max(self.t0, t1)), "X", merged or None))


#: Registry of live tracers so ``export_all`` (load_bench --trace) can merge
#: every platform's recorder without threading handles through call sites.
_REGISTRY_LOCK = threading.Lock()
_TRACERS: list = []  # weakrefs, in registration order
_NEXT_EXPORT_SEQ = 0
_RETAIN = False
_RETAINED: list = []  # strong refs while retention is on


def _register(tracer: "Tracer") -> int:
    import weakref

    global _NEXT_EXPORT_SEQ
    with _REGISTRY_LOCK:
        _NEXT_EXPORT_SEQ += 1
        _TRACERS.append(weakref.ref(tracer))
        if _RETAIN:
            _RETAINED.append(tracer)
        return _NEXT_EXPORT_SEQ


def retain_tracers(on: bool = True) -> None:
    """Pin a strong reference to every live tracer and every one created
    after this call. The registry is weak by default (a test suite churning
    hundreds of platforms must not accumulate their recorders); an
    export-at-exit tool (``load_bench --trace``) turns retention on so
    spans survive the scenario dropping its platform. ``on=False`` releases
    the pins."""
    global _RETAIN
    with _REGISTRY_LOCK:
        _RETAIN = on
        if on:
            _RETAINED.extend(t for ref in _TRACERS
                             if (t := ref()) is not None and t not in _RETAINED)
        else:
            _RETAINED.clear()


def live_tracers() -> list:
    """Live tracers in registration order (export pid order)."""
    with _REGISTRY_LOCK:
        refs = list(_TRACERS)
    out = []
    for ref in refs:
        t = ref()
        if t is not None:
            out.append(t)
    return out


class Tracer:
    """Mints trace/span ids, owns the recorder, and tracks the active
    span context per thread so nested instrumentation (handler enters,
    remote calls, resurrects) parents itself correctly."""

    GUARDED_FIELDS = {"_next_trace": "_lock"}

    def __init__(self, clock=None, *, capacity_per_thread: int = 8192,
                 enabled: bool = True):
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.recorder = FlightRecorder(capacity_per_thread)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._next_trace = CONTROL_TRACE_ID
        self._tls = threading.local()
        #: platform-wide timeline for merge/split/park/scale events
        self.control = SpanContext(self, CONTROL_TRACE_ID,
                                   "control-plane", "control-plane", 0.0)
        self.export_seq = _register(self)

    # ------------------------------------------------------------- mint

    def begin_request(self, name: str, kind: str, *, t0: float | None = None,
                      attrs: dict | None = None) -> SpanContext | None:
        """New trace rooted at ``t0`` (defaults to now). Returns ``None``
        when tracing is disabled — callers guard every touch on that."""
        if not self.enabled:
            return None
        with self._lock:
            self._next_trace += 1
            tid = self._next_trace
        if t0 is None:
            t0 = self.clock.now()
        return SpanContext(self, tid, name, kind, float(t0), attrs)

    # ------------------------------------------- thread-local activation

    def current(self) -> tuple[SpanContext, int] | None:
        """(active context, parent span id) for this thread, or None."""
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return None
        return stack[-1]

    def push(self, ctx: SpanContext, parent_id: int = _ROOT_SPAN_ID) -> None:
        """Non-scoped activation for enter/exit-bracketed call sites (the
        handler); every push MUST be paired with a :meth:`pop`."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        stack.append((ctx, parent_id))

    def pop(self) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack.pop()

    @contextmanager
    def activate(self, ctx: SpanContext | None, parent_id: int = _ROOT_SPAN_ID):
        """Make ``ctx`` the ambient parent for instrumentation on this
        thread. ``None`` is accepted and is a no-op so call sites stay
        unconditional."""
        if ctx is None:
            yield
            return
        self.push(ctx, parent_id)
        try:
            yield
        finally:
            self.pop()

    def activate_snapshot(self, cur: tuple[SpanContext, int] | None):
        """Re-activate a ``current()`` snapshot on another thread (the
        orchestrated backend captures it at submit, restores in the
        worker)."""
        if cur is None:
            return self.activate(None)
        return self.activate(cur[0], cur[1])

    # -------------------------------------------------- control timeline

    def control_span(self, name: str, t0: float, t1: float, *,
                     args: dict | None = None) -> None:
        if self.enabled:
            self.control.emit(name, "control-plane", t0, t1,
                              parent_id=0, args=args)

    def control_event(self, name: str, *, t: float | None = None,
                      args: dict | None = None) -> None:
        if self.enabled:
            if t is None:
                t = self.clock.now()
            self.control.event(name, t, parent_id=0, args=args)
