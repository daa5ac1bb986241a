"""Routing table: function name -> serving instance, versioned by epoch.

The paper's analogue of the tinyFaaS API-gateway entries. All mutations
funnel through :meth:`publish` — atomic multi-route updates under one lock —
and ``version`` is the platform's routing *epoch*: it bumps exactly when some
route actually changes, so epoch numbers in the control plane's event log
are meaningful (an empty or no-op swap is not a new generation).

Routes hold ordered replica tuples so a later replicated data plane keeps
this table's shape; in this slice every tuple has one instance. The lock is
exposed (``mutex``) so the control plane can make lifecycle state flips
atomic WITH the route flip: an instance is only ever marked DRAINING inside
the same critical section that removed its last route.
"""
from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Iterable

from repro_torch.core.errors import UnknownFunctionError

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.function import FunctionInstance


class RoutingTable:
    GUARDED_FIELDS = {"_routes": "_lock", "version": "_lock"}

    def __init__(self):
        self._lock = threading.RLock()
        self._routes: dict[str, tuple["FunctionInstance", ...]] = {}
        self.version = 0

    @property
    def mutex(self) -> threading.RLock:
        """The routing lock — reentrant so the control plane can compose an
        atomic publish + lifecycle-state transition."""
        return self._lock

    def publish(self, updates: dict[str, "FunctionInstance"]) -> dict[str, tuple["FunctionInstance", ...]]:
        """Atomically point each named route at its new instance. Returns the
        displaced previous replica tuples. ``version`` bumps once iff at least
        one route actually changed."""
        with self._lock:
            old: dict[str, tuple["FunctionInstance", ...]] = {}
            changed = False
            for name, instance in updates.items():
                replicas = (instance,)
                prev = self._routes.get(name, ())
                if prev:
                    old[name] = prev
                if prev != replicas:
                    self._routes[name] = replicas
                    changed = True
            if changed:
                self.version += 1
            return old

    def unpublish(self, names: Iterable[str]) -> dict[str, tuple["FunctionInstance", ...]]:
        """Atomically remove routes (scale-to-zero park): the names simply
        stop resolving. Returns the removed replica tuples; ``version`` bumps
        once iff something was actually routed."""
        with self._lock:
            removed: dict[str, tuple["FunctionInstance", ...]] = {}
            for name in names:
                replicas = self._routes.pop(name, ())
                if replicas:
                    removed[name] = replicas
            if removed:
                self.version += 1
            return removed

    def get(self, name: str) -> "FunctionInstance | None":
        """The instance routed for ``name``, or None. This is the identity
        the control plane's park and the platform's scale-to-zero compare
        against."""
        with self._lock:
            replicas = self._routes.get(name)
            return replicas[0] if replicas else None

    def resolve(self, name: str) -> "FunctionInstance":
        with self._lock:
            replicas = self._routes.get(name)
            if not replicas:
                raise UnknownFunctionError(name)
            return replicas[0]

    def live_instances(self) -> list["FunctionInstance"]:
        with self._lock:
            seen: dict[int, "FunctionInstance"] = {}
            for replicas in self._routes.values():
                for inst in replicas:
                    seen[id(inst)] = inst
            return list(seen.values())
