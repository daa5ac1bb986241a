"""FaaS functions and their serving instances.

A :class:`FunctionSpec` is the *bring-your-own-function-code* unit: a
callable ``fn(ctx, params, *args)`` on torch tensors whose only impurity is
calling other functions through the platform context (``ctx.call`` /
``ctx.call_async``). It must not write its arguments in place.

A :class:`FunctionInstance` is the running analogue of a FaaS container: it
hosts one or more functions' code + weights. Entries that are
*self-contained* (leaf functions; fused groups whose calls all resolve to
co-located members) run as ONE unit: a single host call with every
co-located member inlined, followed by one device synchronize. Whether an
entry is self-contained is decided once per argument structure by a
shape-only run on meta tensors. Entries with a synchronous boundary call run
as *interpreter glue* (EagerContext): each outbound call is a real blocking
dispatch through the platform — the blocking-socket analogue the Function
Handler observes. Capturing a unit as a CUDA graph is later work.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.core.errors import InvocationError


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    name: str
    fn: Callable  # fn(ctx, params, *args) -> tree of tensors
    params: Any = None
    trust_domain: str = "default"
    description: str = ""


# Per-instance runtime footprint (container language runtime + loaded libs).
# A FaaS instance is a container; Python containers idle at ~30-60 MiB RSS,
# and the paper's RAM savings come precisely from retiring these duplicated
# runtimes. In-process instances share one interpreter, so the RAM metric
# models this per-container constant explicitly.
INSTANCE_RUNTIME_OVERHEAD_BYTES = 32 * 2**20


def tree_bytes(t) -> int:
    """Bytes of the tensor leaves (numel x element size)."""
    return sum(x.numel() * x.element_size() for x in tree.leaves(t) if isinstance(x, torch.Tensor))


def _leaf_key(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    return (type(x).__name__, repr(x))


def _struct_key(t) -> tuple:
    """Tree structure + (shape, dtype, device) of every leaf."""
    leaves, structure = tree.flatten(t)
    return (structure, tuple(_leaf_key(x) for x in leaves))


def _structs_of(t):
    """The same tree with every tensor replaced by a meta tensor of its shape
    and dtype (the port's ``jax.ShapeDtypeStruct``)."""
    return tree.map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta") if isinstance(x, torch.Tensor) else x,
        t,
    )


def block_until_ready(out) -> None:
    """Synchronize every CUDA device the output lives on (the counterpart of
    ``jax.block_until_ready``); a CPU result is ready already."""
    devices = {x.device for x in tree.leaves(out) if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class InstanceState(enum.Enum):
    """Control-plane lifecycle: PROVISIONING -> READY (health-checked, not
    yet routed) -> SERVING (routed) -> DRAINING (displaced, in-flight
    requests finishing) -> RETIRED (drained, memory freed)."""

    PROVISIONING = "provisioning"
    READY = "ready"
    SERVING = "serving"
    DRAINING = "draining"
    RETIRED = "retired"


@dataclasses.dataclass
class CompiledEntry:
    """A self-contained entry: ``run(params_by_member, *args)`` returns
    ``(output, queued async calls)``."""

    run: Callable
    compile_s: float


class FunctionInstance:
    """One running execution unit hosting >= 1 functions ("members")."""

    _counter = 0
    _counter_lock = threading.Lock()

    GUARDED_FIELDS = {"_compiled": "_lock", "_eager_entries": "_lock", "_active": "_lock"}

    def __init__(self, specs: dict[str, FunctionSpec], platform):
        with FunctionInstance._counter_lock:
            FunctionInstance._counter += 1
            seq = FunctionInstance._counter
        self.members: dict[str, FunctionSpec] = dict(specs)
        self.instance_id = f"inst{seq}[{'+'.join(sorted(specs))}]"
        self.platform = platform
        self.params: dict[str, Any] = {n: s.params for n, s in specs.items()}
        self.state = InstanceState.PROVISIONING
        self._compiled: dict[tuple, CompiledEntry] = {}
        self._eager_entries: set[tuple] = set()
        self._lock = threading.Lock()
        self._active = 0
        self._idle_event = threading.Event()
        self._idle_event.set()

    # ----------------------------------------------------------- lifecycle

    def mark_ready(self):
        self.state = InstanceState.READY

    def mark_serving(self):
        """Routed by an epoch publish (called under the routing lock)."""
        if self.state != InstanceState.RETIRED:
            self.state = InstanceState.SERVING

    def begin_drain(self):
        with self._lock:
            if self.state != InstanceState.RETIRED:
                self.state = InstanceState.DRAINING

    def begin_request(self):
        with self._lock:
            if self.state == InstanceState.RETIRED:
                raise InvocationError(f"{self.instance_id} is {self.state.value}")
            self._active += 1
            self._idle_event.clear()

    def end_request(self):
        with self._lock:
            self._active -= 1
            if self._active == 0:
                self._idle_event.set()

    def retire(self, timeout: float = 30.0) -> int:
        """Drain in-flight requests, terminate, free weights. Returns bytes
        freed (the RAM the fusion reclaims). The RETIRED flip and the
        in-flight check share the instance lock, so a request cannot begin
        after the params are freed."""
        self.begin_drain()
        if self.state == InstanceState.RETIRED:
            return 0
        deadline = time.perf_counter() + timeout
        while True:
            with self._lock:
                if self._active == 0 or time.perf_counter() >= deadline:
                    self.state = InstanceState.RETIRED
                    params = self.params
                    self.params = {}
                    self._compiled = {}
                    break
            self._idle_event.wait(max(0.0, deadline - time.perf_counter()))
        return INSTANCE_RUNTIME_OVERHEAD_BYTES + tree_bytes(params)

    # ----------------------------------------------------------- compile

    def _entry_callable(self, entry: str):
        from repro_torch.core.context import TraceContext

        spec = self.members[entry]

        def run(params_by_member, *args):
            pending: list = []
            ctx = TraceContext(self.platform, self, params_by_member, entry, pending)
            return spec.fn(ctx, params_by_member[entry], *args), pending

        return run

    def get_compiled(self, entry: str, args: tuple) -> CompiledEntry | None:
        """The entry as one unit, or None when it crosses an instance boundary
        synchronously (-> interpreter-glue execution). Decided once per
        argument structure by a shape-only run on meta tensors; that run reads
        no values, so an entry that calls ``.item()`` cannot be a unit."""
        key = (entry, _struct_key(args))
        with self._lock:
            if key in self._eager_entries:
                return None
            got = self._compiled.get(key)
        if got is not None:
            return got
        from repro_torch.core.context import BoundaryCall, TraceContext

        t0 = time.perf_counter()
        spec = self.members[entry]
        meta_params = _structs_of(self.params)
        try:
            with torch.no_grad():
                ctx = TraceContext(self.platform, self, meta_params, entry, pending=None)
                spec.fn(ctx, meta_params[entry], *_structs_of(args))
        except BoundaryCall:
            with self._lock:
                self._eager_entries.add(key)
            return None
        entry_obj = CompiledEntry(self._entry_callable(entry), time.perf_counter() - t0)
        with self._lock:
            self._compiled[key] = entry_obj
        return entry_obj

    # ----------------------------------------------------------- execute

    def execute(self, entry: str, args: tuple):
        """Run one request to completion (synchronous, device-synced)."""
        ce = self.get_compiled(entry, args)
        pending: list = []
        with torch.no_grad():
            if ce is None:  # interpreter glue: host-dispatched outbound calls
                from repro_torch.core.context import EagerContext

                spec = self.members[entry]
                ctx = EagerContext(self.platform, self, self.params, entry)
                out = spec.fn(ctx, self.params[entry], *args)
            else:
                out, pending = ce.run(self.params, *args)
        block_until_ready(out)
        for caller, callee, call_args in pending:
            self.platform.async_call(self, caller, callee, call_args)
        return out

    # ----------------------------------------------------------- metrics

    def resident_bytes(self) -> int:
        """Live footprint of this execution unit: the container runtime
        constant + weights (numel x element size). Workspace that a run
        allocates (activations, caches it returns) is not counted."""
        if self.state == InstanceState.RETIRED:
            return 0
        with self._lock:
            params = self.params
        return INSTANCE_RUNTIME_OVERHEAD_BYTES + tree_bytes(params)

    def __repr__(self):
        return f"<{self.instance_id} {self.state.value} members={sorted(self.members)}>"
