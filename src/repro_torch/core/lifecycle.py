"""The control plane: instance lifecycle + generation-versioned routing epochs.

Every routing mutation the platform performs — deploy, merge swap, redeploy —
is an *epoch transition*: an atomic publish against the routing table that,
under ONE lock,

  1. flips every affected route to its new instance,
  2. marks the newly-routed instances SERVING,
  3. marks displaced instances that are no longer routed anywhere DRAINING,

then (outside the lock) drains and retires the displaced instances. Because
steps 1–3 share the routing table's lock with ``resolve``, a concurrent
request can never resolve a DRAINING instance.

A scale-to-zero *park* is an epoch too: it unroutes an instance's
functions (they resolve nowhere until a resurrect publishes them again) and
drains + retires the instance outside the lock.

The instance state machine (:class:`repro_torch.core.function.InstanceState`):

    PROVISIONING -> READY -> SERVING -> DRAINING -> RETIRED

The control plane also owns the *reconciler*: a background thread, started
by the first tick hook, that runs the tick hooks (the idle-park check)
every ``_TICK_S``. The reference's trough-gated transition queue waits for
a caller (replicas, fission).
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


@dataclasses.dataclass
class EpochEvent:
    """One routing-epoch transition, as recorded in ``platform.stats()``."""

    epoch: int
    kind: str  # "deploy" | "merge" | "redeploy" | "park" | "resurrect"
    names: tuple[str, ...]
    reason: str = ""
    retired: tuple[str, ...] = ()  # instance_ids drained + retired by this epoch
    freed_bytes: int = 0
    t_completed: float = 0.0


class ControlPlane:
    """Owns epoch transitions, instance lifecycle, and the reconciler."""

    GUARDED_FIELDS = {
        "events": "_events_lock",
        "_wake_flag": "_wake_cv",
    }

    def __init__(self, platform, registry, *, clock=None):
        self.platform = platform
        self.registry = registry
        # Injectable time source: tick waits and event timestamps run on
        # it, so reconciler behavior is drivable by a virtual clock in tests.
        self.clock = clock or SYSTEM_CLOCK
        self.events: collections.deque[EpochEvent] = collections.deque(maxlen=_EVENT_LOG_MAX)
        self._events_lock = threading.Lock()
        # tick wake-up: a condition (not an Event) so the reconciler's
        # tick wait goes through the clock like every other timed wait
        self._wake_cv = threading.Condition()
        self._wake_flag = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._tick_hooks: list[Callable[[], None]] = []

    @property
    def epoch(self) -> int:
        """Current routing generation (bumps only on actual route changes)."""
        return self.registry.version

    def publish(self, routes: dict[str, "FunctionInstance"], *, kind: str,
                reason: str = "") -> EpochEvent:
        """Atomically publish a new routing epoch.

        ``routes`` maps every affected function name to the instance that will
        serve it from this epoch on. Displaced instances that end up routed
        nowhere are marked DRAINING inside the publish critical section (so a
        concurrent ``resolve`` can never return a DRAINING instance) and then
        drained + retired outside the lock. Returns the recorded event."""
        registry = self.registry
        with registry.mutex:
            displaced = registry.publish(routes)
            for inst in {id(v): v for v in routes.values()}.values():
                inst.mark_serving()
            still_routed = {id(i) for i in registry.live_instances()}
            doomed = [
                inst
                for inst in {id(v): v for tup in displaced.values() for v in tup}.values()
                if id(inst) not in still_routed
            ]
            for inst in doomed:
                inst.begin_drain()
            epoch = registry.version
        freed = sum(self.platform.retire_instance(inst) for inst in doomed)
        event = EpochEvent(
            epoch=epoch, kind=kind, names=tuple(sorted(routes)), reason=reason,
            retired=tuple(i.instance_id for i in doomed), freed_bytes=freed,
            t_completed=self.clock.now(),
        )
        return self._record(event)

    def park(self, instance: "FunctionInstance", *, reason: str = "") -> EpochEvent | None:
        """Scale-to-zero epoch: atomically UNROUTE an instance's functions
        (they stop resolving — the platform resurrects them from snapshot on
        the next invoke), then drain + retire it outside the lock.

        Only names still routed to THIS instance are removed — a publish that
        raced the park (redeploy, merge) keeps its routes. Returns the
        recorded event, or None if nothing was routed here anymore."""
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
        freed = self.platform.retire_instance(instance)
        event = EpochEvent(
            epoch=epoch, kind="park", names=names, reason=reason,
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

    def add_tick_hook(self, hook: Callable[[], None]) -> None:
        """Run ``hook`` on every reconciler tick (the idle-park check lives
        here — control-plane work, never data-path)."""
        self._tick_hooks.append(hook)
        self._ensure_thread()

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
            "events": [dataclasses.asdict(e) for e in events],
        }
