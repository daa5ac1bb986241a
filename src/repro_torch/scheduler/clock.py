"""Injectable time source for every timing-sensitive scheduler component.

The scheduler stack (admission queues, window controllers, quiesce barrier,
trough detector, lifecycle reconciler) used to call ``time.perf_counter`` /
``time.sleep`` / ``Condition.wait(timeout)`` directly, which made its tests
pay every window and idle-timeout in wall-clock time — and made sub-ms
timing assertions flaky on loaded CI boxes. Everything now reads time
through a :class:`Clock`:

* :class:`SystemClock` — production: ``perf_counter`` + real waits. The
  module-level :data:`SYSTEM_CLOCK` singleton is the default everywhere, so
  no behavior changes unless a test injects something else.
* :class:`VirtualClock` — deterministic simulation: time only moves when the
  test calls :meth:`~VirtualClock.advance`. Threads that block through
  ``wait_on``/``sleep`` park on real condition variables (no busy spin, no
  real sleeps) and are woken by ``advance``; each wake re-checks its virtual
  deadline. A test can therefore drive hours of scripted traffic through
  real dispatcher threads in milliseconds of wall time, and the
  ``elapsed_real``/:meth:`~VirtualClock.assert_elapsed_real_below` guard
  proves no real sleeping happened.

The contract for blocking code: never call ``cond.wait(timeout)`` directly —
call ``clock.wait_on(cond, timeout)`` while holding ``cond``'s lock, and
treat every return as a possibly-spurious wake (loop and re-check the
predicate against ``clock.now()``). That is exactly the discipline
``Condition.wait`` already requires, so SystemClock adds nothing.
"""
from __future__ import annotations

import threading
import time

#: Real-time safety net for VirtualClock waits: if a test forgets to
#: advance, parked threads still wake occasionally so a failing test's own
#: (real) timeouts can fire instead of the whole process wedging.
_REAL_GUARD_S = 60.0


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


class VirtualClock:
    """Deterministic time for simulation tests.

    ``now()`` returns simulated seconds; only :meth:`advance` moves it.
    Worker threads blocking via :meth:`wait_on` / :meth:`sleep` park on
    their real condition variables and are notified by ``advance`` — they
    re-check their virtual deadlines on every wake, so a window timer
    "expires" the instant the test advances past it, never by real waiting.

    :meth:`wait_for_waiters` is the test-side handshake: it blocks (real
    time, event-driven — no polling sleeps) until at least ``n`` threads are
    parked in a clock wait *and* the parked set has stopped churning, which
    is the moment an ``advance`` is guaranteed to be observed by everyone
    the test cares about.
    """

    virtual = True

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._mu = threading.Lock()
        # cond objects with at least one parked waiter -> waiter count
        self._parked: dict[int, tuple[threading.Condition, int]] = {}
        self._transitions = 0  # total park/unpark events (stabilization)
        self._state_cv = threading.Condition(self._mu)
        self._created_real = time.perf_counter()
        self._sleep_cv = threading.Condition()

    # ------------------------------------------------------------ time API

    def now(self) -> float:
        return self._t  # float read is atomic under the GIL

    def sleep(self, seconds: float) -> None:
        """Park until virtual time reaches ``now + seconds`` (woken only by
        ``advance``). Never blocks on wall-clock time."""
        deadline = self._t + max(0.0, seconds)
        with self._sleep_cv:
            while self._t < deadline:
                self.wait_on(self._sleep_cv, None)

    def wait_on(self, cond: threading.Condition, timeout: float | None) -> None:
        """Virtual-aware ``cond.wait``: returns on a real ``notify``, or as
        soon as ``advance`` moves virtual time past ``now + timeout``.
        Spurious returns are allowed (callers re-check predicates)."""
        if timeout is not None and timeout <= 0:
            return
        key = id(cond)
        with self._mu:
            prev, n = self._parked.get(key, (cond, 0))
            self._parked[key] = (cond, n + 1)
            self._transitions += 1
            self._state_cv.notify_all()
        try:
            # Parked on the caller's own condition: a real notify (producer
            # put, shutdown) wakes it exactly like the system clock; advance()
            # notifies every parked condition so virtual deadlines re-check.
            cond.wait(_REAL_GUARD_S)
        finally:
            with self._mu:
                c, n = self._parked[key]
                if n <= 1:
                    del self._parked[key]
                else:
                    self._parked[key] = (c, n - 1)
                self._transitions += 1
                self._state_cv.notify_all()

    # ----------------------------------------------------------- test API

    def advance(self, seconds: float) -> float:
        """Move virtual time forward and wake every parked waiter so timers
        can re-check their deadlines. Returns the new ``now``."""
        if seconds < 0:
            raise ValueError("virtual time cannot go backwards")
        with self._mu:
            self._t += seconds
            conds = [c for (c, _) in self._parked.values()]
        for cond in conds:
            with cond:
                cond.notify_all()
        return self._t

    def wait_for_waiters(self, n: int = 1, timeout: float = 5.0) -> int:
        """Block (real, bounded) until >= ``n`` threads are parked in a clock
        wait and the parked set is stable. Event-driven — the wait wakes on
        every park/unpark transition, so quiet systems settle immediately.
        Returns the parked-thread count; raises on (real) timeout."""
        deadline = time.perf_counter() + timeout
        with self._mu:
            while True:
                count = sum(n_ for (_, n_) in self._parked.values())
                if count >= n:
                    # stabilization: give in-flight threads one short grace
                    # window to re-park; if nothing transitions, we're settled
                    gen = self._transitions
                    self._state_cv.wait(0.005)
                    if self._transitions == gen:
                        return count
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise TimeoutError(
                        f"only {count}/{n} threads parked on the virtual clock"
                    )
                self._state_cv.wait(min(remaining, 0.25))

    def elapsed_real(self) -> float:
        """Real seconds since construction — the no-real-sleeps guard."""
        return time.perf_counter() - self._created_real

    def assert_elapsed_real_below(self, seconds: float) -> None:
        """Assert the whole simulation ran in under ``seconds`` of wall time
        (i.e. nothing actually slept out a virtual duration)."""
        real = self.elapsed_real()
        if real >= seconds:
            raise AssertionError(
                f"virtual-clock run used {real:.3f}s of real time "
                f"(budget {seconds:.3f}s) — something slept on the wall clock"
            )
