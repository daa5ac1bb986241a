"""Injectable time source for every timing-sensitive platform component.

Everything that reads time (handler edge heat, merge costs, lifecycle
event stamps, latency windows) goes through a :class:`SystemClock`-shaped
object, so a later virtual clock can drive it without real sleeps. The
module-level :data:`SYSTEM_CLOCK` singleton is the default everywhere.
"""
from __future__ import annotations

import threading
import time


class SystemClock:
    """Wall-clock time: the production default. Stateless and shared."""

    def now(self) -> float:
        return time.perf_counter()

    def wait_on(self, cond: threading.Condition, timeout: float | None) -> None:
        """``cond.wait`` with the caller holding ``cond``'s lock. May return
        early (notify or spurious wake); callers must loop on their predicate."""
        cond.wait(timeout)


#: Shared default instance — every component's ``clock=None`` resolves here.
SYSTEM_CLOCK = SystemClock()
