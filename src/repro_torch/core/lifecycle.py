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

The instance state machine (:class:`repro_torch.core.function.InstanceState`):

    PROVISIONING -> READY -> SERVING -> DRAINING -> RETIRED
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import TYPE_CHECKING

from repro_torch.scheduler.clock import SYSTEM_CLOCK

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.function import FunctionInstance

_EVENT_LOG_MAX = 512  # bounded epoch history (stats() reports the tail)


@dataclasses.dataclass
class EpochEvent:
    """One routing-epoch transition, as recorded in ``platform.stats()``."""

    epoch: int
    kind: str  # "deploy" | "merge" | "redeploy"
    names: tuple[str, ...]
    reason: str = ""
    retired: tuple[str, ...] = ()  # instance_ids drained + retired by this epoch
    freed_bytes: int = 0
    t_completed: float = 0.0


class ControlPlane:
    """Owns epoch transitions and instance lifecycle."""

    GUARDED_FIELDS = {"events": "_events_lock"}

    def __init__(self, platform, registry, *, clock=None):
        self.platform = platform
        self.registry = registry
        self.clock = clock or SYSTEM_CLOCK
        self.events: collections.deque[EpochEvent] = collections.deque(maxlen=_EVENT_LOG_MAX)
        self._events_lock = threading.Lock()

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
