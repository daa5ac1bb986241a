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
    ``(output, queued async calls)``.

    ``output_bytes`` and ``workspace_bytes`` are recorded at the entry's first
    run (``measured``), the counterpart of the reference's memory analysis of
    a compiled program: the bytes of the returned tree, and on a CUDA device
    the run's peak allocation above what is still allocated when it returns
    (its outputs, and what a library keeps once allocated, such as a cuBLAS
    workspace): the memory the run needs beside its inputs and outputs. The
    CPU has no allocator statistic, so there the workspace is 0."""

    run: Callable
    compile_s: float
    output_bytes: int = 0
    workspace_bytes: int = 0
    measured: bool = False


def _footprint_bytes(params, compiled: dict) -> int:
    """One instance's live footprint: the runtime constant + weights + the
    largest recorded workspace + output bytes of its compiled entries. Shared
    by ``resident_bytes`` and ``retire``'s freed bytes, so that the RAM
    reported freed is the RAM that was counted.

    The reference adds every entry's bytes. Here one caching allocator serves
    all of an instance's entries, which run one at a time and hand their
    outputs to the caller, so an instance holds one entry's workspace and
    outputs at a time: the largest. (A sum would count the whole cache tree
    once more for every canary a merge replayed through the fused unit.)"""
    return INSTANCE_RUNTIME_OVERHEAD_BYTES + tree_bytes(params) + max(
        (ce.workspace_bytes + ce.output_bytes for ce in compiled.values()), default=0)


class _RunningThreads:
    """The threads inside an instance's run (a glue entry's nested calls run
    on its own thread), so that a first run's device-wide memory peak is
    recorded only when no other thread ran beside it: a merge replays its
    canaries on a thread of its own while requests go on."""

    GUARDED_FIELDS = {"_depth": "_lock", "_arrivals": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._depth: dict[int, int] = {}
        self._arrivals = 0  # threads that began a run, ever

    def enter(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            if tid not in self._depth:
                self._depth[tid] = 0
                self._arrivals += 1
            self._depth[tid] += 1

    def exit(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            self._depth[tid] -= 1
            if self._depth[tid] == 0:
                del self._depth[tid]

    def others(self) -> tuple[bool, int]:
        """(another thread is in a run now, threads that began one so far)."""
        tid = threading.get_ident()
        with self._lock:
            return any(t != tid for t in self._depth), self._arrivals


_RUNNING = _RunningThreads()


def _cuda_device(*trees):
    """The first CUDA device a tensor leaf of ``trees`` lives on, or None."""
    for t in trees:
        for x in tree.leaves(t):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                return x.device
    return None


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
                    params, compiled = self.params, self._compiled
                    self.params = {}
                    self._compiled = {}
                    break
            self._idle_event.wait(max(0.0, deadline - time.perf_counter()))
        return _footprint_bytes(params, compiled)

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
        _RUNNING.enter()
        try:
            with torch.no_grad():
                if ce is None:  # interpreter glue: host-dispatched outbound calls
                    from repro_torch.core.context import EagerContext

                    spec = self.members[entry]
                    ctx = EagerContext(self.platform, self, self.params, entry)
                    out = spec.fn(ctx, self.params[entry], *args)
                elif ce.measured:
                    out, pending = ce.run(self.params, *args)
                else:
                    out, pending = self._first_run(ce, args)
            block_until_ready(out)
        finally:
            _RUNNING.exit()
        for caller, callee, call_args in pending:
            self.platform.async_call(self, caller, callee, call_args)
        return out

    def _first_run(self, ce: CompiledEntry, args: tuple):
        """Run a compiled entry whose bytes are not recorded yet, and record
        its output and workspace bytes on it. The peak is the device's, so a
        run that another thread's run overlapped records nothing: a later
        run of the entry records it."""
        dev = _cuda_device(self.params, args)
        if dev is None:
            out, pending = ce.run(self.params, *args)
            workspace = 0
        else:
            busy, arrivals = _RUNNING.others()
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out, pending = ce.run(self.params, *args)
            torch.cuda.synchronize(dev)
            workspace = torch.cuda.max_memory_allocated(dev) - torch.cuda.memory_allocated(dev)
            if busy or _RUNNING.others() != (False, arrivals):
                return out, pending
        with self._lock:
            ce.output_bytes = tree_bytes(out)
            ce.workspace_bytes = workspace
            ce.measured = True
        return out, pending

    # ----------------------------------------------------------- metrics

    def resident_bytes(self) -> int:
        """Live footprint of this execution unit: the container runtime
        constant + weights (numel x element size) + the largest recorded
        workspace + output bytes of its compiled entries (:func:`_footprint_bytes`).
        Entries that cross an instance boundary (interpreter glue) record
        nothing, as in the reference."""
        if self.state == InstanceState.RETIRED:
            return 0
        with self._lock:
            return _footprint_bytes(self.params, self._compiled)

    def entry_bytes(self) -> list[tuple[int, int]]:
        """(workspace_bytes, output_bytes) of each compiled entry that has
        run: what :meth:`resident_bytes` takes its largest from."""
        with self._lock:
            return [(ce.workspace_bytes, ce.output_bytes) for ce in self._compiled.values() if ce.measured]

    def __repr__(self):
        return f"<{self.instance_id} {self.state.value} members={sorted(self.members)}>"
