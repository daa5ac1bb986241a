"""FaaS functions and their serving instances.

A :class:`FunctionSpec` is the *bring-your-own-function-code* unit: a
callable ``fn(ctx, params, *args)`` on torch tensors whose only impurity is
calling other functions through the platform context (``ctx.call`` /
``ctx.call_async``). It must not write its arguments in place.

A :class:`FunctionInstance` is the running analogue of a FaaS container: it
hosts one or more functions' code + weights. Entries that are
*self-contained* (leaf functions; fused groups whose calls all resolve to
co-located members) run as ONE unit. Whether an entry is self-contained is
decided once per argument structure by a shape-only run on meta tensors (the
port's ``jax.jit(...).trace``). Entries with a synchronous boundary call run
as *interpreter glue* (EagerContext): each outbound call is a real blocking
dispatch through the platform — the blocking-socket analogue the Function
Handler observes.

On the card a unit is one program, as a ``jax.jit`` executable is: its first
run is eager (it measures the run's workspace and warms up what a capture
needs), its second run is captured as a CUDA graph, and every later run of
the same argument structure replays that graph (:class:`CapturedGraph`).
A replay copies the arguments into the graph's static inputs and copies the
returned tree out, so the caller owns what it gets. An instance's graphs
share one memory pool, as a process's XLA executables share one allocator:
the pool holds the largest graph's temporaries once, not every graph's, and
the instance replays one graph at a time. An entry whose run queues
``call_async`` is never captured (its arguments would live in the graph's
pool); on the CPU nothing is captured.

``execute_batch`` runs k compatible requests as one program per
power-of-two bucket: the requests stack on a new leading axis and the entry
runs under ``torch.func.vmap`` (the kernels fold that axis into their own
batch axis). A bucket's program is a compiled entry like any other,
captured at its second run.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
import weakref
from typing import Any, Callable

import torch

from repro_torch import donate, tree
from repro_torch.analysis.dispatch import TRACER
from repro_torch.core.errors import InvocationError
from repro_torch.kernels import build
from repro_torch.scheduler.batching import next_batch_bucket, split_results, stack_requests


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


class CapturedGraph:
    """A compiled entry captured as a CUDA graph, replayed from then on.

    ``static`` holds the graph's input leaves: a copy owned by the graph for
    every tensor the caller passes, except the ``bound`` ones, which the
    graph reads (and writes) at their own address: the inputs the entry
    writes in place, and the inputs it hands on unchanged that the caller
    passed as the same object at the entry's first run and at its capture
    (a paged KV arena, which a copy per step would move whole). A replay
    with another tensor there is refused (:meth:`replay` returns None).
    ``passthrough`` maps an output leaf that IS an input the graph did not
    write (a cache tree a stage hands on) to that input, so the caller gets
    its own tensor back, as an eager run returns it. ``launches`` are the kernel launches
    recorded while capturing, added once per replay. ``lock`` is the
    instance's graph lock: it serializes copy-in, replay and copy-out of all
    the instance's graphs, which share one pool (a replay overwrites the
    temporaries of every other graph there). ``pool_bytes``: what the
    instance's pool grew by at this graph's capture.

    With ``lanes`` (a batched program), the static inputs are the requests
    stacked on a new leading axis, and a replay takes k requests' leaves."""

    def __init__(self, graph, device, static: list, bound: frozenset, out_leaves: list, out_structure,
                 passthrough: dict, launches: dict, static_bytes: int, pool_bytes: int, lock: threading.Lock):
        self.graph = graph
        self.device = device
        self.static = static
        self.bound = bound
        self.owned = [i for i, x in enumerate(static) if isinstance(x, torch.Tensor) and i not in bound]
        self.out_leaves = out_leaves
        self.out_structure = out_structure
        self.passthrough = passthrough
        self.launches = launches
        self.static_bytes = static_bytes
        self.pool_bytes = pool_bytes
        self.lock = lock
        self.replays = 0

    def _same(self, i: int, x) -> bool:
        s = self.static[i]
        return (isinstance(x, torch.Tensor) and x.data_ptr() == s.data_ptr() and x.shape == s.shape
                and x.stride() == s.stride() and x.dtype == s.dtype)

    def replay(self, leaves: list, lanes: int | None = None):
        """The output tree of one request (``leaves``), or the k output trees
        of ``lanes`` requests (``leaves``: one leaf list per request); None
        when a bound input is not the tensor the graph was captured on."""
        if lanes is None and not all(self._same(i, leaves[i]) for i in self.bound):
            return None
        with self.lock:
            for i in self.owned:
                if lanes is None:
                    self.static[i].copy_(leaves[i])
                else:
                    torch.stack([req[i] for req in leaves], out=self.static[i])
            self.graph.replay()
            outs = []
            for j, o in enumerate(self.out_leaves):
                i = self.passthrough.get(j)
                if lanes is None:
                    outs.append(leaves[i] if i is not None else o.clone())
                elif i is not None:
                    outs.append([req[i] for req in leaves])
                else:
                    c = o.clone()
                    outs.append([c[r] for r in range(lanes)])
            _synchronize(self.device)
            self.replays += 1
        build.LAUNCHES.add_replayed(self.launches)
        if lanes is None:
            return tree.unflatten(self.out_structure, outs)
        return [tree.unflatten(self.out_structure, [o[r] for o in outs]) for r in range(lanes)]


@dataclasses.dataclass
class CompiledEntry:
    """A self-contained entry: ``run(params_by_member, *args)`` returns
    ``(output, queued async calls)``.

    The shape-only run records whether the entry queues async calls
    (``effectful``), which argument leaves it writes in place (``mutated``:
    their version counters moved) and which it returns as they are
    (``handed_on``). The first run keeps a weak reference to each tensor
    argument (``first_args``): a handed-on leaf that is the same object at
    the capture is bound by address, unless a replay was once refused for
    it (``unbindable``: the entry is captured again with a copy there). ``output_bytes`` and
    ``workspace_bytes`` are recorded at the entry's first run (``measured``),
    the counterpart of the reference's memory analysis of a compiled
    program: the bytes of the returned tree, and on a CUDA device the run's
    peak allocation above what is still allocated when it returns (its
    outputs, and what a library keeps once allocated, such as a cuBLAS
    workspace): the memory the run needs beside its inputs and outputs. The
    CPU has no allocator statistic, so there the workspace is 0. On the card
    the entry's second run captures it (``graph``); from then on its bytes
    are the graph's static inputs and memory pool. A batched entry's ``run``
    takes the stacked arguments of its bucket's requests."""

    run: Callable
    compile_s: float
    effectful: bool = False
    mutated: frozenset = frozenset()
    handed_on: frozenset = frozenset()
    unbindable: frozenset = frozenset()
    output_bytes: int = 0
    workspace_bytes: int = 0
    measured: bool = False
    runs: int = 0
    first_args: list | None = None
    graph: CapturedGraph | None = None
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False)


def _footprint_bytes(params, compiled: dict, pool_bytes: int) -> int:
    """One instance's live footprint: the runtime constant + weights + every
    captured entry's static inputs + the segments of the graphs' shared pool
    (``pool_bytes``) + the largest eager entry's workspace + output bytes.
    Shared by ``resident_bytes`` and ``retire``'s freed bytes, so that the
    RAM reported freed is the RAM that was counted.

    Each graph holds its static inputs for as long as it lives, beside every
    other graph, so they add; the pool, shared by the instance's graphs, is
    counted once, whole. The reference adds every entry's bytes; for the
    eager entries the port takes the largest, because one caching allocator
    serves them all, and they run one at a time and hand their outputs to
    the caller: an instance holds one eager entry's workspace and outputs at
    a time. (A sum would count the whole cache tree once more for every
    canary a merge replayed through the fused unit.) Both sides of a fusion
    are counted so: an unfused chain's leaf (its head, which takes the
    caches and returns them) is captured as the fused unit is."""
    statics = sum(ce.graph.static_bytes for ce in compiled.values() if ce.graph is not None)
    eager = max((ce.workspace_bytes + ce.output_bytes for ce in compiled.values() if ce.graph is None),
                default=0)
    return INSTANCE_RUNTIME_OVERHEAD_BYTES + tree_bytes(params) + statics + pool_bytes + eager


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


def _capture_device(*trees):
    """The device a run on ``trees`` is captured on: its CUDA device; None
    (nothing is captured) on the CPU."""
    return _cuda_device(*trees)


_CAPTURE_LOCK = threading.Lock()  # one capture at a time, process-wide
_CAPTURE_STREAMS: dict = {}  # device -> the stream captures run on (guarded by _CAPTURE_LOCK)


def _capture_graph(warmup: Callable, fn: Callable, dev, pool):
    """Run ``warmup()`` eagerly, then capture ``fn()`` as a CUDA graph into
    the memory pool ``pool`` (a new one when None), both on the device's
    capture stream (a capture needs a stream of its own, and a warm-up on it
    first). Returns (warm-up result, graph, ``fn``'s output as captured, the
    pool, bytes of the pool's segments). A pool lives as long as a graph
    captured into it: the allocators refuse a capture into a pool whose
    graphs are all gone (``FunctionInstance._drop_graph``)."""
    with _CAPTURE_LOCK:
        stream = _CAPTURE_STREAMS.get(dev)
        if stream is None:
            stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            result = warmup()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        # the segments the caching allocator holds for the pool
        pool = tuple(graph.pool())
        pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                         if tuple(seg.get("segment_pool_id") or ()) == pool)
    return result, graph, out, pool, pool_bytes


def _synchronize(dev) -> None:
    torch.cuda.current_stream(dev).synchronize()


class FunctionInstance:
    """One running execution unit hosting >= 1 functions ("members")."""

    _counter = 0
    _counter_lock = threading.Lock()

    GUARDED_FIELDS = {"_compiled": "_lock", "_eager_entries": "_lock", "_active": "_lock",
                      "_batched": "_lock", "_batch_unsupported": "_lock", "_batch_fallbacks": "_lock",
                      "_pool_bytes": "_lock", "_graph_pool": "_graph_lock"}

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
        # batched programs: (entry, argument structure, bucket) -> entry
        self._batched: dict[tuple, CompiledEntry] = {}
        self._batch_unsupported: dict[tuple, str] = {}  # key -> why it runs per request
        self._batch_fallbacks: dict[str, int] = {}  # entry -> requests run per request
        self._lock = threading.Lock()
        # the graphs' shared memory pool (made at the first capture) and its
        # bytes; _graph_lock serializes the graphs' captures and replays
        self._graph_lock = threading.Lock()
        self._graph_pool = None
        self._pool_bytes = 0
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
        """Drain in-flight requests, terminate, free weights and captured
        graphs. Returns bytes freed (the RAM the fusion reclaims). The
        RETIRED flip and the in-flight check share the instance lock, so a
        request cannot begin after the params are freed."""
        self.begin_drain()
        if self.state == InstanceState.RETIRED:
            return 0
        deadline = time.perf_counter() + timeout
        while True:
            with self._lock:
                if self._active == 0 or time.perf_counter() >= deadline:
                    self.state = InstanceState.RETIRED
                    params, compiled = self.params, {**self._compiled, **self._batched}
                    pool_bytes = self._pool_bytes
                    self.params = {}
                    self._compiled = {}
                    self._batched = {}
                    break
            self._idle_event.wait(max(0.0, deadline - time.perf_counter()))
        return _footprint_bytes(params, compiled, pool_bytes)

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
        no values, so an entry that calls ``.item()`` cannot be a unit. It
        also records the entry's effects (queued async calls) and the
        arguments it writes in place."""
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
        meta_args = _structs_of(args)
        leaves = tree.leaves(meta_args)
        versions = [x._version if isinstance(x, torch.Tensor) else None for x in leaves]
        effects: list = []
        try:
            with torch.no_grad():
                ctx = TraceContext(self.platform, self, meta_params, entry, effects, shape_only=True)
                out = spec.fn(ctx, meta_params[entry], *meta_args)
        except BoundaryCall:
            with self._lock:
                self._eager_entries.add(key)
            return None
        mutated = frozenset(i for i, (x, v) in enumerate(zip(leaves, versions))
                            if v is not None and x._version != v)
        index = {id(x): i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)}
        handed_on = frozenset(index[id(o)] for o in tree.leaves(out) if id(o) in index)
        entry_obj = CompiledEntry(self._entry_callable(entry), time.perf_counter() - t0,
                                  effectful=bool(effects), mutated=mutated, handed_on=handed_on)
        with self._lock:
            self._compiled[key] = entry_obj
        TRACER.note_compile("entries")
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
                else:
                    out, pending = self._run_compiled(ce, args)
            block_until_ready(out)
        finally:
            _RUNNING.exit()
        for caller, callee, call_args in pending:
            self.platform.async_call(self, caller, callee, call_args)
        return out

    def _run_compiled(self, ce: CompiledEntry, args: tuple):
        """(output, queued async calls) of one run of a compiled entry: the
        first run eager and measured, the second captured (on the card, when
        the entry has no effects), later ones replayed. For a batched entry
        ``args`` are the stacked requests."""
        if ce.graph is None and ce.runs and not ce.effectful and _capture_device(self.params, args) is not None:
            with ce.lock:
                if ce.graph is None:
                    return self._capture(ce, args)
        graph = ce.graph
        if graph is not None:
            leaves = tree.leaves(args)
            out = graph.replay(leaves)
            if out is not None:
                return out, []
            # a leaf bound because it was the same object twice is another
            # one now: capture again with a copy there at the next run
            moved = frozenset(i for i in graph.bound - ce.mutated if not graph._same(i, leaves[i]))
            if moved:
                self._drop_graph(ce, graph, moved)
        if ce.measured:
            out, pending = ce.run(self.params, *args)
        else:
            out, pending = self._first_run(ce, args)
        with ce.lock:
            if ce.first_args is None:
                ce.first_args = [weakref.ref(x) if isinstance(x, torch.Tensor) else None
                                 for x in tree.leaves(args)]
            ce.runs += 1
        return out, pending

    def _drop_graph(self, ce: CompiledEntry, graph: CapturedGraph, moved: frozenset) -> None:
        """Drop ``graph`` (a replay refused it: its bound inputs ``moved``);
        the entry is captured again at its next run, with copies there. When
        the instance then holds no graph, its pool is forgotten and the next
        capture makes a new one: a pool dies with the last graph captured
        into it, and a capture into it afterwards fails (the device and host
        caching allocators assert its use count)."""
        with ce.lock:
            ce.unbindable |= moved
            if ce.graph is graph:
                ce.graph = None
        with self._graph_lock, self._lock:
            if not any(e.graph is not None for e in (*self._compiled.values(), *self._batched.values())):
                self._graph_pool = None
                self._pool_bytes = 0

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

    def _capture(self, ce: CompiledEntry, args: tuple):
        """Capture the entry as a CUDA graph (the caller holds ``ce.lock``).
        This call's result comes from an eager run on the capture stream,
        which is also the warm-up capture needs; the graph is then captured
        on static inputs that the platform owns, so the run may write its
        new caches into them (:mod:`repro_torch.donate`), and into the pool
        the instance's graphs share (under the graph lock: no graph of the
        instance replays meanwhile). Other threads go on launching work
        (``thread_local`` capture mode)."""
        dev = _capture_device(self.params, args)
        leaves, structure = tree.flatten(args)
        first = ce.first_args or [None] * len(leaves)
        bound = ce.mutated | {i for i in ce.handed_on - ce.unbindable
                              if first[i] is not None and first[i]() is leaves[i]}
        # the caller keeps its arguments (and this call's outputs may be
        # them): the graph gets copies, but for the bound inputs
        static = [x.clone() if isinstance(x, torch.Tensor) and i not in bound else x
                  for i, x in enumerate(leaves)]
        versions = [x._version if isinstance(x, torch.Tensor) else None for x in static]

        def captured():
            with build.LAUNCHES.recording() as rec, donate.donating():
                out = ce.run(self.params, *tree.unflatten(structure, static))[0]
            return out, rec

        with self._graph_lock:
            (out, pending), graph, (static_out, launches), pool, pool_bytes = _capture_graph(
                lambda: ce.run(self.params, *args), captured, dev, self._graph_pool)
            self._graph_pool = pool
            with self._lock:
                grown, self._pool_bytes = pool_bytes - self._pool_bytes, pool_bytes
        out_leaves, out_structure = tree.flatten(static_out)
        index = {id(x): i for i, x in enumerate(static) if isinstance(x, torch.Tensor)}
        passthrough = {}
        for j, o in enumerate(out_leaves):
            i = index.get(id(o))
            if i is not None and (i in bound or static[i]._version == versions[i]):
                passthrough[j] = i
        static_bytes = sum(static[i].numel() * static[i].element_size() for i in set(index.values()) - bound)
        ce.graph = CapturedGraph(graph, dev, static, frozenset(bound), out_leaves, out_structure, passthrough,
                                 launches, static_bytes, grown, self._graph_lock)
        ce.runs += 1
        TRACER.note_compile("captures")
        return out, pending

    # ----------------------------------------------------------- batched execute

    def _get_batched(self, entry: str, args: tuple, bucket: int) -> CompiledEntry | None:
        """The program serving ``bucket`` requests of this entry at once, or
        None when the entry cannot be one batched program: it crosses an
        instance boundary, queues async calls (each lane would fire them,
        and bucket padding would replay the last request's), writes its
        arguments in place (the lanes' stacked copies would take the
        writes), or ``torch.func.vmap`` rejects it on a shape-only run."""
        skey = _struct_key(args)
        key = (entry, skey, bucket)
        with self._lock:
            if key in self._batch_unsupported:
                return None
            got = self._batched.get(key)
        if got is not None:
            return got
        t0 = time.perf_counter()
        single = self.get_compiled(entry, args)
        reason = None
        if single is None:
            reason = "crosses an instance boundary"
        elif single.effectful:
            reason = "queues async calls"
        elif single.mutated:
            reason = "writes its arguments in place"
        else:
            run = self._entry_callable(entry)
            in_dims = (None,) + tuple(
                tree.map(lambda x: 0 if isinstance(x, torch.Tensor) else None, a) for a in args)

            def batched_run(params, *stacked):
                out = torch.func.vmap(lambda p, *a: run(p, *a)[0], in_dims=in_dims)(params, *stacked)
                return out, []

            try:  # the port's trace: vmap over meta tensors runs no kernel
                with torch.no_grad():
                    batched_run(_structs_of(self.params), *_structs_of(stack_requests([args] * bucket)))
            except Exception as exc:  # noqa: BLE001 — batching is an optimization:
                # anything vmap rejects runs per request, never fails a request
                reason = f"vmap: {type(exc).__name__}: {exc}"
        if reason is not None:
            with self._lock:
                self._batch_unsupported[key] = reason
            return None
        entry_obj = CompiledEntry(batched_run, time.perf_counter() - t0)
        with self._lock:
            self._batched[key] = entry_obj
        TRACER.note_compile("buckets")
        return entry_obj

    def execute_batch(self, entry: str, args_list: list[tuple], max_bucket: int | None = None) -> list:
        """Run k compatible requests as ONE execution where possible.

        Requests stack along a new leading axis, padded up to a power-of-two
        bucket (capped at ``max_bucket``, normally the scheduler's max_batch,
        so a full batch never pads past its configured size) — at most
        O(log max_batch) batched programs ever exist. The batch axis is
        carried by vmap, so each request sees its original shapes. Entries
        that cannot run as one program run per request (counted in
        :meth:`batch_stats`)."""
        k = len(args_list)
        if k == 1:
            return [self.execute(entry, args_list[0])]
        skey = _struct_key(args_list[0])
        with self._lock:
            # Prefer an existing bucket that fits (padding is nearly free; a
            # new program mid-traffic costs a first run and a capture).
            fitting = [key[2] for key in self._batched if key[0] == entry and key[1] == skey and key[2] >= k]
        bucket = min(fitting) if fitting else next_batch_bucket(k, max_bucket)
        if bucket < k:
            # Non-power-of-two max_bucket clamps below k (e.g. 6 requests,
            # cap 6 -> bucket 4): run power-of-two chunks instead of minting
            # a never-reused bucket-6 program.
            out: list = []
            for i in range(0, k, bucket):
                out.extend(self.execute_batch(entry, args_list[i : i + bucket], max_bucket))
            return out
        ce = self._get_batched(entry, args_list[0], bucket)
        if ce is None:
            with self._lock:
                self._batch_fallbacks[entry] = self._batch_fallbacks.get(entry, 0) + k
            return [self.execute(entry, a) for a in args_list]
        padded = args_list + [args_list[-1]] * (bucket - k)
        _RUNNING.enter()
        try:
            with torch.no_grad():
                graph = ce.graph
                if graph is not None:  # the requests go straight into the static inputs
                    outs = graph.replay([tree.leaves(a) for a in padded], lanes=bucket)
                else:
                    outs = split_results(self._run_compiled(ce, tuple(stack_requests(padded)))[0], bucket)
            block_until_ready(outs)
        finally:
            _RUNNING.exit()
        return outs[:k]

    # ----------------------------------------------------------- metrics

    def resident_bytes(self) -> int:
        """Live footprint of this execution unit: the container runtime
        constant + weights + its captured graphs' static inputs and shared
        pool + the largest eager entry's recorded bytes
        (:func:`_footprint_bytes`). Entries that cross an instance
        boundary (interpreter glue) record nothing, as in the reference."""
        if self.state == InstanceState.RETIRED:
            return 0
        with self._lock:
            return _footprint_bytes(self.params, {**self._compiled, **self._batched}, self._pool_bytes)

    def entry_bytes(self) -> list[tuple[int, int]]:
        """(workspace_bytes, output_bytes) of each compiled entry that has
        run eagerly and been measured and is not captured (a captured
        entry's bytes are its graph's)."""
        with self._lock:
            return [(ce.workspace_bytes, ce.output_bytes) for ce in self._compiled.values()
                    if ce.measured and ce.graph is None]

    def graph_pool_bytes(self) -> int:
        """Bytes of the segments of the pool the instance's graphs share."""
        with self._lock:
            return self._pool_bytes

    def graph_stats(self) -> list[dict]:
        """Each compiled entry (single and batched): the shape of its first
        argument leaf, its eager runs (the capture included), whether it is
        captured and how often its graph replayed, its graph's static bytes
        and what the shared pool grew by at its capture, the launches one
        replay makes."""
        with self._lock:
            entries = [(key[0], key[1], None, ce) for key, ce in self._compiled.items()]
            entries += [(key[0], key[1], key[2], ce) for key, ce in self._batched.items()]
        out = []
        for entry, skey, bucket, ce in entries:
            g = ce.graph
            out.append({"entry": entry, "bucket": bucket, "arg_shape": list(skey[1][0][0]) if skey[1] else [],
                        "runs": ce.runs, "captured": g is not None, "replays": g.replays if g else 0,
                        "effectful": ce.effectful,
                        "static_bytes": g.static_bytes if g else 0, "pool_bytes": g.pool_bytes if g else 0,
                        "launches_per_replay": dict(g.launches) if g else {}})
        return out

    def batch_stats(self) -> dict:
        """Requests that ran per request because their entry cannot batch,
        by entry, and why each such program was refused."""
        with self._lock:
            return {"fallback_requests": dict(self._batch_fallbacks),
                    "unsupported": {f"{key[0]}@{key[2]}": why for key, why in self._batch_unsupported.items()}}

    def __repr__(self):
        return f"<{self.instance_id} {self.state.value} members={sorted(self.members)}>"
