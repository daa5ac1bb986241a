"""The control plane: instance lifecycle + generation-versioned routing epochs.

Every routing mutation the platform performs — deploy, merge swap, redeploy,
split (fission) — is an *epoch transition*: an atomic publish against the
routing table that, under ONE lock,

  1. flips every affected route to its new instance,
  2. marks the newly-routed instances SERVING,
  3. marks displaced instances that are no longer routed anywhere DRAINING,

then (outside the lock) drains and retires the displaced instances. Because
steps 1–3 share the routing table's lock with ``resolve``, a concurrent
request can never resolve a DRAINING instance: an instance only enters
DRAINING in the same critical section that removes its last route.

A scale-to-zero *park* is an epoch too: it unroutes an instance's
functions (they resolve nowhere until a resurrect publishes them again) and
drains + retires the instance outside the lock. Scale-out and scale-in
epochs grow and shrink a name's replica set.

The instance state machine (:class:`repro_torch.core.function.InstanceState`):

    PROVISIONING -> READY -> SERVING -> DRAINING -> RETIRED

PROVISIONING while the unit is being built/compiled, READY once health-checked
but not yet routed, SERVING while routed, DRAINING after displacement while
in-flight requests finish, RETIRED once drained and its memory freed.

The control plane also owns the *reconciler*: a background thread that
executes queued transitions (deferred merges, fission splits) during observed
traffic troughs — the scheduler's arrival-gap EWMAs say when the platform is
quiet enough that a rebuild stall lands on nobody (ProFaaStinate's
deferral, applied to control-plane work). Every queued transition carries a
``max_defer_s`` deadline so a platform that never troughs still converges.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import TYPE_CHECKING, Callable

from repro_torch.scheduler.clock import SYSTEM_CLOCK

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.function import FunctionInstance

_EVENT_LOG_MAX = 512  # bounded epoch history (stats() reports the tail)
_TICK_S = 0.02  # the reconciler's tick period
# The scheduler's trough test (RequestScheduler.is_trough): quiet this long,
# and this many mean arrival gaps since the last arrival.
_TROUGH_QUIET_S = 0.01
_TROUGH_GAP_MULT = 3.0
_DRAIN_TIMEOUT_S = 0.5  # the bounded drain barrier ahead of a queued transition


@dataclasses.dataclass
class EpochEvent:
    """One routing-epoch transition, as recorded in ``platform.stats()``."""

    epoch: int
    # "deploy" | "merge" | "split" | "redeploy" | "park" | "resurrect"
    # | "scale-out" | "scale-in"
    kind: str
    names: tuple[str, ...]
    reason: str = ""
    retired: tuple[str, ...] = ()  # instance_ids drained + retired by this epoch
    freed_bytes: int = 0
    t_completed: float = 0.0
    deferred_s: float = 0.0  # how long the reconciler held it for a trough


@dataclasses.dataclass
class _QueuedTransition:
    action: Callable[[], None]
    kind: str
    names: tuple[str, ...]
    reason: str
    t_enqueued: float
    deadline: float


class ControlPlane:
    """Owns epoch transitions, instance lifecycle, and the reconciler.

    ``max_defer_s`` is the default deadline after which a queued transition
    runs, trough or not (the platform sets it); the trough test's knobs and
    the tick are the module's constants, at the JAX package's defaults.
    """

    # provlint: _idle_cv is Condition(self._queue_lock) — either name
    # counts as holding the queue lock.
    GUARDED_FIELDS = {
        "events": "_events_lock",
        "_queue": "_queue_lock",
        "_executing": "_queue_lock",
        "_wake_flag": "_wake_cv",
    }

    def __init__(self, platform, registry, *, max_defer_s: float = 1.0, clock=None):
        self.platform = platform
        self.registry = registry
        # Injectable time source: defer deadlines, tick waits, and event
        # timestamps run on it, so reconciler behavior (trough deferral,
        # max_defer expiry) is drivable by a virtual clock in tests.
        self.clock = clock or SYSTEM_CLOCK
        self.max_defer_s = max_defer_s
        self.events: collections.deque[EpochEvent] = collections.deque(maxlen=_EVENT_LOG_MAX)
        self._events_lock = threading.Lock()
        self._queue: collections.deque[_QueuedTransition] = collections.deque()
        self._queue_lock = threading.Lock()
        self._idle_cv = threading.Condition(self._queue_lock)
        self._executing = 0
        # tick wake-up: a condition (not an Event) so the reconciler's
        # tick wait goes through the clock like every other timed wait
        self._wake_cv = threading.Condition()
        self._wake_flag = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._tick_hooks: list[Callable[[], None]] = []

    # --------------------------------------------------------------- epochs

    @property
    def epoch(self) -> int:
        """Current routing generation (bumps only on actual route changes)."""
        return self.registry.version

    def publish(self, routes: dict[str, "FunctionInstance"], *, kind: str,
                reason: str = "", expect: dict[str, "FunctionInstance"] | None = None,
                deferred_s: float = 0.0) -> EpochEvent | None:
        """Atomically publish a new routing epoch.

        ``routes`` maps every affected function name to the instance that will
        serve it from this epoch on. ``expect`` (optional) is a compare-and-swap
        guard: if any named route no longer points at the expected instance —
        another transition raced this one — nothing is published and ``None``
        is returned so the caller can abort its transaction.

        Displaced instances that end up routed nowhere are marked DRAINING
        inside the publish critical section (so a concurrent ``resolve`` can
        never return a DRAINING instance) and then drained + retired outside
        the lock. Returns the recorded :class:`EpochEvent`.
        """
        platform = self.platform
        registry = self.registry
        with registry.mutex:
            if expect is not None:
                for name, inst in expect.items():
                    if registry.get(name) is not inst:
                        return None
            displaced = registry.publish(routes)
            fresh: dict[int, "FunctionInstance"] = {}
            for value in routes.values():
                for inst in (value if isinstance(value, (tuple, list)) else (value,)):
                    fresh[id(inst)] = inst
            for inst in fresh.values():
                inst.mark_serving()
            still_routed = {id(i) for i in registry.live_instances()}
            doomed = [
                inst
                for inst in {
                    id(v): v for tup in displaced.values() for v in tup
                }.values()
                if id(inst) not in still_routed
            ]
            for inst in doomed:
                inst.begin_drain()
            epoch = registry.version
        # Drain + retirement happen OUTSIDE the routing lock. Two barriers
        # compose here: queued scheduler requests re-resolve the NEW routes at
        # dispatch (nothing queued can reach a displaced instance), and each
        # displaced instance's retire() waits out the requests already inside
        # it. A scheduler-wide quiesce would be wrong here — under saturation
        # (exactly when fission publishes) some batch is ALWAYS in flight, and
        # an epoch that waits for a globally empty pipe never lands.
        freed = 0
        for inst in doomed:
            freed += platform.retire_instance(inst)
        event = EpochEvent(
            epoch=epoch, kind=kind, names=tuple(sorted(routes)), reason=reason,
            retired=tuple(i.instance_id for i in doomed), freed_bytes=freed,
            t_completed=self.clock.now(), deferred_s=round(deferred_s, 4),
        )
        return self._record(event)

    def park(self, instance: "FunctionInstance", *, reason: str = "") -> EpochEvent | None:
        """Scale-to-zero epoch: atomically UNROUTE an instance's functions
        (they stop resolving — the platform resurrects them from snapshot on
        the next invoke), then drain + retire it outside the lock.

        Only names still routed to THIS instance are removed — a publish that
        raced the park (redeploy, merge) keeps its routes. Returns the
        recorded event, or None if nothing was routed here anymore."""
        platform = self.platform
        registry = self.registry
        with registry.mutex:
            names = tuple(sorted(
                m for m in instance.members if registry.get(m) is instance
            ))
            if not names:
                return None
            registry.unpublish(names)
            instance.begin_drain()
            epoch = registry.version
        freed = platform.retire_instance(instance)
        event = EpochEvent(
            epoch=epoch, kind="park", names=names, reason=reason,
            retired=(instance.instance_id,), freed_bytes=freed,
            t_completed=self.clock.now(),
        )
        return self._record(event)

    def scale_out(self, instance: "FunctionInstance", names, *,
                  reason: str = "") -> EpochEvent | None:
        """Scale-out epoch: atomically APPEND ``instance`` as a replica of
        every still-routed name in ``names`` and mark it SERVING. Names whose
        route vanished (a racing park or merge won) or that already hold this
        replica are skipped; returns None when nothing changed so the caller
        can retire the unused unit instead of leaking it."""
        registry = self.registry
        with registry.mutex:
            added = registry.add_replicas(names, instance)
            if not added:
                return None
            instance.mark_serving()
            epoch = registry.version
        event = EpochEvent(
            epoch=epoch, kind="scale-out", names=added, reason=reason,
            t_completed=self.clock.now(),
        )
        return self._record(event)

    def scale_in(self, instance: "FunctionInstance", *,
                 reason: str = "") -> EpochEvent | None:
        """Scale-in epoch: atomically REMOVE ``instance`` from every replica
        set that holds it and mark it DRAINING in the same critical section —
        the displacement invariant, so a concurrent resolve can never pick a
        draining replica. Refuses (returns None) if the instance holds no
        route, or if it is ANY name's only replica — scale-in shrinks sets,
        it never unroutes a function (that is :meth:`park`). Drain + retire
        happen outside the lock, so in-flight requests finish before the
        unit's memory is freed."""
        platform = self.platform
        registry = self.registry
        with registry.mutex:
            holding = tuple(sorted(
                m for m in instance.members
                if any(r is instance for r in registry.replicas(m))
            ))
            if not holding:
                return None
            if any(len(registry.replicas(m)) <= 1 for m in holding):
                return None
            removed = registry.remove_replicas(holding, instance)
            instance.begin_drain()
            epoch = registry.version
        freed = platform.retire_instance(instance)
        event = EpochEvent(
            epoch=epoch, kind="scale-in", names=removed, reason=reason,
            retired=(instance.instance_id,), freed_bytes=freed,
            t_completed=self.clock.now(),
        )
        return self._record(event)

    def _record(self, event: EpochEvent) -> EpochEvent:
        """Append to the epoch log and stamp the transition as an instant on
        the control-plane trace timeline — epoch swaps become visible next
        to the request traffic that triggered them."""
        with self._events_lock:
            self.events.append(event)
        self.platform.tracer.control_event(
            f"epoch:{event.kind}", t=event.t_completed,
            args={"epoch": event.epoch, "names": list(event.names),
                  "reason": event.reason})
        return event

    # ----------------------------------------------------------- reconciler

    def enqueue(self, action: Callable[[], None], *, kind: str, names=(),
                reason: str = "", max_defer_s: float | None = None) -> None:
        """Queue a transition for the reconciler: it executes at the next
        observed traffic trough, or unconditionally once ``max_defer_s`` has
        elapsed — control-plane stalls land in quiet gaps when quiet gaps
        exist, and bounded-late otherwise."""
        defer = self.max_defer_s if max_defer_s is None else max_defer_s
        now = self.clock.now()
        item = _QueuedTransition(action, kind, tuple(names), reason, now, now + defer)
        with self._queue_lock:
            self._queue.append(item)
        self._ensure_thread()
        self._kick()

    def add_tick_hook(self, hook: Callable[[], None]) -> None:
        """Run ``hook`` on every reconciler tick (fission evaluation lives
        here — regret detection is control-plane work, never data-path)."""
        self._tick_hooks.append(hook)
        self._ensure_thread()

    def queued_transitions(self) -> int:
        with self._queue_lock:
            return len(self._queue)

    def is_trough(self) -> bool:
        scheduler = getattr(self.platform, "scheduler", None)
        if scheduler is None:
            return True
        return scheduler.is_trough(min_quiet_s=_TROUGH_QUIET_S, gap_mult=_TROUGH_GAP_MULT)

    def run_pending(self, *, force: bool = False) -> int:
        """Execute queued transitions whose moment has come (trough observed
        or deadline passed; ``force=True`` runs everything now). Returns the
        number executed. The reconciler thread calls this each tick; tests
        and synchronous platforms may call it directly."""
        ran = 0
        while True:
            now = self.clock.now()
            with self._queue_lock:
                if not self._queue:
                    return ran
                head = self._queue[0]
                due = force or now >= head.deadline
                if not due:
                    # trough test outside this lock would race other pops;
                    # it is cheap (scheduler snapshot) so keep it inline
                    due = self.is_trough()
                if not due:
                    return ran
                self._queue.popleft()
                self._executing += 1
            try:
                # drain barrier before a deferred transition: wait (bounded)
                # for the affected functions' in-flight batches to clear so
                # the control-plane stall starts on a drained pipe — at a
                # trough this returns immediately, past the deadline it gives
                # up after _DRAIN_TIMEOUT_S rather than stall the transition
                scheduler = getattr(self.platform, "scheduler", None)
                if scheduler is not None and head.names:
                    scheduler.quiesce(
                        head.names, timeout=_DRAIN_TIMEOUT_S, include_queued=False
                    )
                head.action()
            except Exception:  # noqa: BLE001 — a failed transition must not
                pass  # kill the reconciler; the action logs its own outcome
            finally:
                with self._idle_cv:
                    self._executing -= 1
                    self._idle_cv.notify_all()
            ran += 1

    def wait_idle(self, timeout: float = 120.0) -> bool:
        """Block until no transition is queued OR executing (the reconciler
        may have popped one and be mid-build). Returns False on timeout."""
        deadline = self.clock.now() + timeout
        with self._idle_cv:
            while self._queue or self._executing:
                remaining = deadline - self.clock.now()
                if remaining <= 0:
                    return False
                self.clock.wait_on(self._idle_cv, min(remaining, 0.05))
        return True

    def _kick(self) -> None:
        with self._wake_cv:
            self._wake_flag = True
            self._wake_cv.notify_all()

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="lifecycle-reconciler"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._wake_cv:
                if not self._wake_flag:
                    self.clock.wait_on(self._wake_cv, _TICK_S)
                self._wake_flag = False
            if self._stop.is_set():
                return
            for hook in list(self._tick_hooks):
                try:
                    hook()
                except Exception:  # noqa: BLE001
                    pass
            self.run_pending()

    def shutdown(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._kick()
        th = self._thread
        if th is not None and th.is_alive():
            th.join(timeout)

    # -------------------------------------------------------------- metrics

    def stats(self) -> dict:
        with self._events_lock:
            events = list(self.events)[-32:]
        with self.registry.mutex:
            states = {
                inst.instance_id: inst.state.value
                for inst in self.registry.live_instances()
            }
        return {
            "epoch": self.epoch,
            "instance_states": states,
            "queued_transitions": self.queued_transitions(),
            "events": [dataclasses.asdict(e) for e in events],
        }
