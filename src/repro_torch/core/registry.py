"""Routing table: function name -> ordered replica set, versioned by epoch.

The paper's analogue of the tinyFaaS API-gateway entries / Kubernetes
Service selectors, generalized from one-instance-per-name to an ordered
**replica set** per name. All mutations funnel through :meth:`publish` /
:meth:`add_replicas` / :meth:`remove_replicas` — atomic multi-route updates
under one lock — and ``version`` is the platform's routing *epoch*: it bumps
exactly when some route's ordered replica set actually changes, so epoch
numbers in the control plane's event log are meaningful (an empty or no-op
swap is not a new generation).

Each resolve picks one replica through a pluggable :class:`SpreadPolicy`
(least-outstanding by default, round-robin fallback). The lock is exposed
(``mutex``) so the control plane can make lifecycle state flips atomic WITH
the route flip: an instance is only ever marked DRAINING inside the same
critical section that removed its last route, which is what lets
``resolve_entry`` guarantee it never observes a DRAINING replica through a
live route.
"""
from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Iterable, Sequence

from repro_torch.core.errors import UnknownFunctionError

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.function import FunctionInstance, InstanceState


class SpreadPolicy:
    """Picks which replica of a name serves the next resolve.

    ``select`` is called with a non-empty replica tuple while the routing
    lock is held, so the tuple is a consistent snapshot; implementations keep
    their own cursor state under their own lock (ordered strictly after the
    routing lock — never call back into the table).
    """

    name = "spread"

    def select(self, name: str, replicas: Sequence["FunctionInstance"]) -> "FunctionInstance":
        raise NotImplementedError


class RoundRobinSpread(SpreadPolicy):
    """Cycle through the replica set in publish order, one pick per resolve."""

    name = "round-robin"

    GUARDED_FIELDS = {"_cursor": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._cursor: dict[str, int] = {}

    def select(self, name: str, replicas: Sequence["FunctionInstance"]) -> "FunctionInstance":
        with self._lock:
            i = self._cursor.get(name, 0) % len(replicas)
            self._cursor[name] = i + 1
        return replicas[i]


class LeastOutstandingSpread(SpreadPolicy):
    """Default spread: the replica with the fewest in-flight requests wins;
    ties rotate round-robin so idle replicas still share picks. In-flight
    counts come from ``FunctionInstance.outstanding()`` (begin/end_request
    bracketing), which slightly undercounts queued-but-unstarted pod work on
    the orchestrated backend — acceptable: ties then fall to the rotor."""

    name = "least-outstanding"

    GUARDED_FIELDS = {"_cursor": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._cursor: dict[str, int] = {}

    def select(self, name: str, replicas: Sequence["FunctionInstance"]) -> "FunctionInstance":
        loads = [r.outstanding() for r in replicas]
        low = min(loads)
        tied = [r for r, load in zip(replicas, loads) if load == low]
        if len(tied) == 1:
            return tied[0]
        with self._lock:
            i = self._cursor.get(name, 0) % len(tied)
            self._cursor[name] = i + 1
        return tied[i]


SPREAD_POLICIES = {
    LeastOutstandingSpread.name: LeastOutstandingSpread,
    RoundRobinSpread.name: RoundRobinSpread,
}


def make_spread(spread: "SpreadPolicy | str | None") -> SpreadPolicy:
    """Resolve a spread policy from a name (``least-outstanding`` /
    ``round-robin``), an instance, or None (the default)."""
    if spread is None:
        return LeastOutstandingSpread()
    if isinstance(spread, SpreadPolicy):
        return spread
    try:
        return SPREAD_POLICIES[spread]()
    except KeyError:
        raise ValueError(
            f"unknown spread policy {spread!r}; known: {sorted(SPREAD_POLICIES)}"
        ) from None


class RoutingTable:
    GUARDED_FIELDS = {"_routes": "_lock", "_picks": "_lock", "version": "_lock"}

    def __init__(self, spread: "SpreadPolicy | str | None" = None):
        self._lock = threading.RLock()
        self._routes: dict[str, tuple["FunctionInstance", ...]] = {}
        self._picks: dict[str, dict[str, int]] = {}
        self._spread = make_spread(spread)
        self.version = 0

    @property
    def mutex(self) -> threading.RLock:
        """The routing lock — reentrant so the control plane can compose an
        atomic publish + lifecycle-state transition."""
        return self._lock

    @property
    def spread_name(self) -> str:
        return self._spread.name

    @staticmethod
    def _as_replicas(value) -> tuple["FunctionInstance", ...]:
        if isinstance(value, (tuple, list)):
            return tuple(value)
        return (value,)

    def publish(self, updates) -> dict[str, tuple["FunctionInstance", ...]]:
        """Atomically apply ``updates`` (name -> new instance, or an ordered
        replica sequence); each named route's FULL replica set is replaced
        (an empty sequence unroutes the name). Returns the displaced previous
        replica tuples. ``version`` bumps once iff at least one route's
        ordered replica set actually changed — republishing identical routes
        (or an empty update) is not a new epoch."""
        with self._lock:
            old: dict[str, tuple["FunctionInstance", ...]] = {}
            changed = False
            for name, value in updates.items():
                replicas = self._as_replicas(value)
                prev = self._routes.get(name, ())
                if prev:
                    old[name] = prev
                if not replicas:
                    if prev:
                        del self._routes[name]
                        self._picks.pop(name, None)
                        changed = True
                    continue
                if prev != replicas:
                    self._routes[name] = replicas
                    changed = True
            if changed:
                self.version += 1
            return old

    def register(self, name: str, instance: "FunctionInstance") -> None:
        self.publish({name: instance})

    def unpublish(self, names: Iterable[str]) -> dict[str, tuple["FunctionInstance", ...]]:
        """Atomically remove routes (scale-to-zero park): the names simply
        stop resolving — every replica of each name. Returns the removed
        replica tuples; ``version`` bumps once iff something was actually
        routed."""
        with self._lock:
            removed: dict[str, tuple["FunctionInstance", ...]] = {}
            for name in names:
                replicas = self._routes.pop(name, ())
                if replicas:
                    removed[name] = replicas
                    self._picks.pop(name, None)
            if removed:
                self.version += 1
            return removed

    def add_replicas(self, names: Iterable[str], instance: "FunctionInstance") -> tuple[str, ...]:
        """Scale-out: append ``instance`` to each named route's replica set.
        Names with no live route (a racing park/merge won) or already holding
        this replica are skipped. One ``version`` bump covers the whole
        update. Returns the names whose sets changed."""
        with self._lock:
            changed = []
            for name in names:
                prev = self._routes.get(name)
                if not prev or any(r is instance for r in prev):
                    continue
                self._routes[name] = prev + (instance,)
                changed.append(name)
            if changed:
                self.version += 1
            return tuple(changed)

    def remove_replicas(self, names: Iterable[str], instance: "FunctionInstance",
                        *, keep_last: bool = True) -> tuple[str, ...]:
        """Scale-in: remove ``instance`` from each named route's replica set.
        With ``keep_last`` (the default) a name's only replica is never
        removed — scale-in shrinks a set but never unroutes a function (that
        is :meth:`unpublish`'s job). One ``version`` bump covers the whole
        update. Returns the names whose sets changed."""
        with self._lock:
            changed = []
            for name in names:
                prev = self._routes.get(name, ())
                if not any(r is instance for r in prev):
                    continue
                if keep_last and len(prev) == 1:
                    continue
                self._routes[name] = tuple(r for r in prev if r is not instance)
                changed.append(name)
            if changed:
                self.version += 1
            return tuple(changed)

    def _pick(self, name: str, replicas: tuple["FunctionInstance", ...]) -> "FunctionInstance":
        with self._lock:  # reentrant: resolve paths already hold the lock
            if len(replicas) == 1:
                instance = replicas[0]
            else:
                instance = self._spread.select(name, replicas)
            counts = self._picks.setdefault(name, {})
            counts[instance.instance_id] = counts.get(instance.instance_id, 0) + 1
            return instance

    def resolve(self, name: str) -> "FunctionInstance":
        with self._lock:
            replicas = self._routes.get(name)
            if not replicas:
                raise UnknownFunctionError(name)
            return self._pick(name, replicas)

    def resolve_entry(self, name: str) -> tuple["FunctionInstance", "InstanceState"]:
        """Resolve (spread-selected replica) plus the replica's lifecycle
        state, read atomically with the route under the routing lock. Because
        removal from a replica's last route marks it DRAINING in the same
        critical section, the returned state is never DRAINING or RETIRED."""
        with self._lock:
            replicas = self._routes.get(name)
            if not replicas:
                raise UnknownFunctionError(name)
            instance = self._pick(name, replicas)
            return instance, instance.state

    def get(self, name: str) -> "FunctionInstance | None":
        """The PRIMARY (first-published) replica for ``name``, or None. This
        is the identity the control plane's CAS guards and park/split checks
        compare against — scale-out appends AFTER the primary, so those
        transactions are replica-oblivious."""
        with self._lock:
            replicas = self._routes.get(name)
            return replicas[0] if replicas else None

    def replicas(self, name: str) -> tuple["FunctionInstance", ...]:
        with self._lock:
            return self._routes.get(name, ())

    def replica_count(self, name: str) -> int:
        with self._lock:
            return len(self._routes.get(name, ()))

    def is_routed(self, instance: "FunctionInstance") -> bool:
        with self._lock:
            return any(
                any(r is instance for r in replicas)
                for replicas in self._routes.values()
            )

    def swap(self, names: Iterable[str], instance: "FunctionInstance") -> dict[str, tuple["FunctionInstance", ...]]:
        """Atomically point every name at ``instance`` (collapsing any replica
        set to that single unit); returns the previous replica tuples (for
        draining/retirement)."""
        return self.publish({name: instance for name in names})

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._routes)

    def live_instances(self) -> list["FunctionInstance"]:
        with self._lock:
            seen: dict[int, "FunctionInstance"] = {}
            for replicas in self._routes.values():
                for inst in replicas:
                    seen[id(inst)] = inst
            return list(seen.values())

    def replica_summary(self) -> dict:
        """Per-name replica view for ``platform.stats()["replicas"]``:
        replica ids in publish order, per-replica in-flight counts, and
        cumulative spread pick counts."""
        with self._lock:
            out = {}
            for name, replicas in self._routes.items():
                out[name] = {
                    "replicas": [r.instance_id for r in replicas],
                    "outstanding": {r.instance_id: r.outstanding() for r in replicas},
                    "picks": dict(self._picks.get(name, {})),
                }
            return out
