"""Static cost analysis of one program run: FLOPs, HBM bytes, peak memory.

The counterpart of the JAX package's ``repro/launch/hlo_analysis.py``. That
module parses the optimized HLO text of a compiled program; an eager
PyTorch program has no HLO to parse, so this one runs the program once —
on meta tensors for a shape-only dry run (nothing is allocated and no
kernel launches), or on the card — under a ``TorchDispatchMode`` that sees
every aten op, and collects what the hand-written kernels report through
``repro_torch.kernels.cost``:

  * FLOPs   — aten ops by ``torch.utils.flop_counter``'s formulas (the
              registry ``FlopCounterMode`` counts with: matrix products,
              convolutions), and each kernel and gradient by its formula in
              ``kernels/cost.py``;
  * bytes   — the reference's fusion-optimal traffic model: the operands
              and results of matrix products, gathers, scatters and index
              ops (a scatter moves its updates twice, in place), ``cat``,
              ``sort`` and ``topk``, plus each kernel's own bytes;
              elementwise ops count as fused and add nothing;
  * peak    — the live storage bytes at their highest: each storage counted
              once across its views and released when its last reference
              goes, the program's inputs live from the start, and each
              kernel's transient workspace added at its call on meta (on
              the card it is allocated and seen);
  * loops   — ``kernels.cost.trips(n)``: on meta tensors a loop whose
              iterations cost alike runs once and counts n times, as the
              reference scales a ``while`` body by its trip count (the
              train step's microbatches); on a device it runs whole.

  * collectives — on a mesh (a rank's program, ``sharding/spmd.py``),
              every ``torch.ops._c10d_functional`` collective by kind (the
              reference's ``COLLECTIVES``) with the reference's ring-model
              bytes per device (``hlo_analysis.py``'s
              ``_collective_moved``): an all-gather moves (g-1)/g of its
              result, an all-reduce twice (g-1)/g of its operand, a
              reduce-scatter and an all-to-all (g-1)/g of it, for a group
              of g ranks. One card moves none: ``collective_bytes`` is 0.

The analysis sees its own thread and the threads the autograd engine runs
its backward on, and no other. An op on ``DTensor``s is left to the
``DTensor`` (the mode declines it), which runs it as local ops and
collectives that the mode then sees, as ``CommDebugMode`` does.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost
from repro_torch.sharding import spmd

aten = torch.ops.aten

# ops whose operands and results must touch HBM even when everything
# elementwise is fused (hlo_analysis.py's _TRAFFIC_OPS)
_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.addbmm, aten._scaled_mm, aten.convolution,
             aten._convolution, aten.convolution_backward}
_GATHERS = {aten.gather, aten.index_select, aten.embedding, aten.index, aten.take, aten.cat, aten.sort,
            aten.topk, aten.embedding_dense_backward}
# in-place updates: the updates read and the updated rows written, not the
# whole target (hlo_analysis.py: scatter / dynamic-update-slice)
_SCATTERS = {aten.scatter, aten.scatter_, aten.scatter_add, aten.scatter_add_, aten.scatter_reduce,
             aten.scatter_reduce_, aten.index_put, aten.index_put_, aten._index_put_impl_, aten.index_add,
             aten.index_add_, aten.index_copy, aten.index_copy_}


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_C10D = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


def _group_size(func, args) -> int:
    """The ranks of a functional collective's group: its ``group_size``
    argument, or its group's size from the name."""
    name = func._overloadpacket.__name__
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


def _collective_moved(kind: str, g: int, operand_bytes: int, result_bytes: int) -> float:
    """Bytes one device moves, the ring model of the reference's
    ``hlo_analysis._collective_moved``."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-gather":
        return result_bytes * frac
    if kind == "all-reduce":
        return 2.0 * operand_bytes * frac
    if kind in ("reduce-scatter", "all-to-all"):
        return operand_bytes * frac
    return float(operand_bytes)  # collective-permute


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return issubclass(t, DTensor)


def _local(t):
    """A ``DTensor``'s local shard (its storage is what this rank holds)."""
    with torch.no_grad():
        return spmd.local_of(t)


def _tensor_bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x) if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class CostSummary:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    loop_trips: dict = dataclasses.field(default_factory=dict)
    top_traffic: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    input_bytes: int = 0
    aten_flops: float = 0.0
    aten_bytes: float = 0.0
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    kernel_calls: dict = dataclasses.field(default_factory=dict)  # by build.KERNELS name
    workspace_bytes: int = 0  # the largest kernel workspace
    # per COLLECTIVES kind: {"count", "bytes"} (bytes per device, ring model)
    collective_detail: dict = dataclasses.field(
        default_factory=lambda: {op: {"count": 0, "bytes": 0.0} for op in COLLECTIVES})
    top_collectives: list = dataclasses.field(default_factory=list)


class CostAnalysis(TorchDispatchMode, kcost.Sink):
    """A dispatch mode that counts one run (see the module docstring).
    ``inputs``: the trees whose storages are live before the run (the
    weights, optimizer state, caches and batch)."""

    def __init__(self, *inputs):
        super().__init__()
        self.scale = 1
        self._s = CostSummary()
        self._traffic: dict[str, list] = {}
        self._lock = threading.RLock()  # a storage freed while one is tracked
        self._live: dict[int, int] = {}
        self._refs: dict[int, weakref.ref] = {}
        self._cur = 0
        self._kernel_sink = None
        self._collectives: dict[tuple, list] = {}
        for t in tree_leaves(inputs):
            if isinstance(t, torch.Tensor):
                self._track(_local(t))
        self._s.input_bytes = self._cur
        self._s.peak_bytes = self._cur

    # -------------------------------------------------------------- peak

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._live:
                return
            n = st.nbytes()
            self._live[key] = n
            self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))
            self._cur += n
            self._s.peak_bytes = max(self._s.peak_bytes, self._cur)

    def _free(self, key: int) -> None:
        with self._lock:
            n = self._live.pop(key, None)
            self._refs.pop(key, None)
            if n is not None:
                self._cur -= n

    @property
    def live_bytes(self) -> int:
        return self._cur

    # ------------------------------------------------------------ counts

    def _traffic_add(self, op: str, nbytes: float) -> None:
        row = self._traffic.setdefault(op, [0.0, 0])
        row[0] += nbytes
        row[1] += self.scale

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented  # the DTensor runs it as local ops, which come back here
        if func.namespace == "aten":
            out = func(*args, **kwargs)
        else:  # a kernel's op: its wrapper reports to this thread's sinks, where this mode is popped
            with kcost.sink(self):
                out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional" and packet.__name__ in _C10D:
            self._collective(_C10D[packet.__name__], func, args, out)
        formula = flop_registry.get(packet)
        if formula is not None:
            f = formula(*args, **kwargs, out_val=out) * self.scale
            self._s.aten_flops += f
        if packet in _PRODUCTS or packet in _GATHERS:
            nbytes = (_tensor_bytes(args) + _tensor_bytes(kwargs) + _tensor_bytes(out)) * self.scale
        elif packet in _SCATTERS:
            nbytes = 2 * (_tensor_bytes(args[1:]) + _tensor_bytes(kwargs)) * self.scale
        else:
            nbytes = 0
        if nbytes:
            self._s.aten_bytes += nbytes
            self._traffic_add(f"aten.{packet.__name__}", nbytes)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def kernel(self, name: str, c: kcost.KernelCost, launches: tuple, meta: bool) -> None:
        """A kernel call reported by its wrapper (``kernels.cost.record``)."""
        with self._lock:
            s = self._s
            s.kernel_flops += c.flops * self.scale
            s.kernel_bytes += c.bytes * self.scale
            for k in launches:
                s.kernel_calls[k] = s.kernel_calls.get(k, 0) + self.scale
            s.workspace_bytes = max(s.workspace_bytes, c.workspace_bytes)
            if meta:  # the card allocates it inside the call; on meta it is counted here
                s.peak_bytes = max(s.peak_bytes, self._cur + c.workspace_bytes)
            self._traffic_add(name, c.bytes * self.scale)

    def _collective(self, kind: str, func, args, out) -> None:
        g = _group_size(func, args)
        operand, result = _tensor_bytes(args[0]), _tensor_bytes(out)
        moved = _collective_moved(kind, g, operand, result) * self.scale
        with self._lock:
            row = self._s.collective_detail[kind]
            row["count"] += self.scale
            row["bytes"] += moved
            self._s.collective_bytes += moved
            key = (kind, g, tuple(args[0].shape), str(args[0].dtype))
            agg = self._collectives.setdefault(key, [0.0, 0])
            agg[0] += moved
            agg[1] += self.scale

    def trips(self, name: str, n: int) -> None:
        self._s.loop_trips[name] = n

    # ------------------------------------------------------------ scope

    def __enter__(self):
        self._kernel_sink = kcost.sink(self)
        self._kernel_sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._kernel_sink.__exit__(*exc)

    def summary(self) -> CostSummary:
        s = dataclasses.replace(self._s)
        s.flops = s.aten_flops + s.kernel_flops
        s.bytes = s.aten_bytes + s.kernel_bytes
        s.top_traffic = sorted(({"op": op, "total_bytes": b, "calls": n} for op, (b, n) in self._traffic.items()),
                               key=lambda r: -r["total_bytes"])[:20]
        s.kernel_calls = dict(sorted(s.kernel_calls.items()))
        s.collective_detail = {k: dict(v) for k, v in s.collective_detail.items()}
        s.top_collectives = sorted(({"op": kind, "group": g, "operand": list(shape), "dtype": dt,
                                     "total_bytes": b, "calls": n}
                                    for (kind, g, shape, dt), (b, n) in self._collectives.items()),
                                   key=lambda r: -r["total_bytes"])[:20]
        s.loop_trips = dict(s.loop_trips)
        return s


def analyze(fn, *args, **kwargs) -> CostSummary:
    """Run ``fn(*args, **kwargs)`` once under a :class:`CostAnalysis` whose
    inputs are ``args`` and ``kwargs`` and return its summary."""
    mode = CostAnalysis(args, kwargs)
    with mode:
        out = fn(*args, **kwargs)
    del out
    return mode.summary()
