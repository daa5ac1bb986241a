"""Rank-local programs on a ``DeviceMesh``: layouts and explicit
collectives.

Under a mesh the JAX package writes one global program and lets XLA's SPMD
partitioner cut it into per-device programs, moving data where its
``shard_as`` constraints and ``shard_map`` regions say. The port writes the
per-device program itself: each rank runs the model on its local shards
(``DTensor.to_local()`` of the strict placements), and every movement of
data is one of the collectives below, at the reference's ``shard_as``
sites. Each collective is a ``torch.autograd.Function`` whose backward is
the collective that the reference's partitioner pairs with it:

  ``gather``    all-gather; backward a reduce-scatter (``bwd="sum"``: the
                ranks used the gathered value for different work) or the
                rank's own slice (``bwd="slice"``: they all did the same);
  ``scatter``   reduce-scatter of partial sums; backward an all-gather;
  ``reduce``    all-reduce of partial sums; backward the identity;
  ``sum_grad``  the identity; backward an all-reduce (a replicated value
                that the ranks used for different work);
  ``chunk``     the rank's slice of a replicated value; backward an
                all-gather.

A collective over several mesh axes (a dim split over ('pod', 'data')) runs
over each axis in turn, so the rank's block is major to minor as XLA's.
They call ``torch.ops._c10d_functional`` directly, the ops that a dispatch
mode sees (``launch/cost_analysis.py`` counts them) and that take the fake
process group's meta tensors. An axis of size 1 moves nothing and is
skipped.
"""
from __future__ import annotations

import dataclasses
import math
import torch

from repro_torch import tree

c10d = torch.ops._c10d_functional


# ------------------------------------------------------------------ layouts


def strict_placements(shape, logical, rules, mesh) -> tuple:
    from repro_torch.sharding.specs import to_placements, to_pspec

    return to_placements(to_pspec(shape, logical, rules, strict=True), mesh)


def local_shape(shape, placements, mesh) -> tuple[int, ...]:
    """This rank's shard shape of a tensor of ``shape`` with
    ``placements``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return tuple(compute_local_shape_and_global_offset(tuple(shape), mesh, list(placements))[0])


def as_dtensor(local: torch.Tensor, mesh, placements, shape):
    """``local`` as this rank's shard of a ``DTensor`` of global ``shape``
    (autograd flows through)."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False, shape=shape, stride=stride)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_of(x):
    """A ``DTensor``'s shard on this rank (autograd flows back to it); any
    other value as it is."""
    return x.to_local() if is_dtensor(x) else x


def distribute(full: torch.Tensor, mesh, placements):
    """``full`` as a ``DTensor`` with ``placements``, each rank taking its
    shard of the global value it holds (every rank holds the same: a seeded
    draw, a host batch, a checkpoint's array), so nothing is sent."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(tuple(full.shape), mesh, list(placements))
    local = full
    for d, (n, o) in enumerate(zip(shape, offset)):
        local = local.narrow(d, o, n)
    return as_dtensor(local.contiguous(), mesh, placements, full.shape)


class Spec:
    """Per dim of a tensor, the mesh axes that shard it, in mesh order. A
    leaf of the ``tree`` module (not a tuple), so a tree of specs maps
    leafwise."""

    __slots__ = ("dims",)

    def __init__(self, dims):
        self.dims = tuple(tuple(a) for a in dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __len__(self) -> int:
        return len(self.dims)

    def __iter__(self):
        return iter(self.dims)

    def __eq__(self, other) -> bool:
        return isinstance(other, Spec) and self.dims == other.dims

    def __hash__(self) -> int:
        return hash(self.dims)

    def __repr__(self) -> str:
        return f"Spec{self.dims}"

    def axes(self) -> set:
        return {a for d in self.dims for a in d}

    def tail(self) -> "Spec":
        """The spec of one slice along an unsharded leading (stacking) dim."""
        if self.dims and self.dims[0]:
            raise ValueError(f"the stacking dim of {self} is sharded")
        return Spec(self.dims[1:])


def spec_of(t) -> Spec:
    """The :class:`Spec` of a ``DTensor`` (no axes for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return Spec(((),) * t.dim())
    names = t.device_mesh.mesh_dim_names
    out = [[] for _ in range(t.dim())]
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            out[p.dim].append(name)
    return Spec(out)


def spec_from_rules(shape, logical, rules, *, strict: bool = False) -> Spec:
    """The :class:`Spec` of ``to_pspec`` (lenient unless ``strict``)."""
    from repro_torch.sharding.specs import spec_axes, to_pspec

    return Spec(spec_axes(e) for e in to_pspec(shape, logical, rules, strict=strict))


def split(t):
    """(the tree's local tensors, its specs): each ``DTensor`` leaf's
    ``to_local()`` (autograd flows back to the ``DTensor``) and
    :func:`spec_of`."""
    return tree.map(local_of, t), tree.map(spec_of, t)


def placements_of(spec: Spec, mesh) -> tuple:
    """The placements of a per-dim spec of mesh axes (:func:`spec_of`)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for d, axes in enumerate(spec):
        for ax in axes:
            out[names.index(ax)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Act:
    """How a (B, T, ...) activation is split on this rank: the mesh axes
    over its batch and over its sequence (the residual stream's sequence
    parallelism, ('model',), or ())."""

    batch: tuple = ()
    seq: tuple = ()

    @property
    def axes(self) -> tuple:
        return self.batch + self.seq

    @staticmethod
    def of(spec) -> "Act":
        return Act(tuple(spec[0]), tuple(spec[1]))

    @staticmethod
    def from_rules(rules, b: int, t: int) -> "Act":
        """The lenient layout of ('batch', 'seq', None) at (B, T)."""
        from repro_torch.sharding.specs import spec_axes, to_pspec

        spec = to_pspec((b, t, 1), ("batch", "seq", None), rules)
        act = Act(spec_axes(spec[0]), spec_axes(spec[1]))
        if act.seq not in ((), ("model",)):
            raise NotImplementedError(f"sequence split over {act.seq}: the residual stream splits over 'model'")
        return act


# ------------------------------------------------------------------ collectives


def _group(mesh, axis: str):
    g = mesh.get_group(axis)
    return g.size(), g.group_name


def _all_gather(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    n, name = _group(mesh, axis)
    y = c10d.wait_tensor(c10d.all_gather_into_tensor(x.movedim(dim, 0).contiguous(), n, name))
    return y.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    n, name = _group(mesh, axis)
    y = c10d.wait_tensor(c10d.reduce_scatter_tensor(x.movedim(dim, 0).contiguous(), "sum", n, name))
    return y.movedim(0, dim).contiguous()


def _all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    _, name = _group(mesh, axis)
    return c10d.wait_tensor(c10d.all_reduce(x.contiguous(), op, name))


def _chunk(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    step = x.shape[dim] // n
    return x.narrow(dim, i * step, step)


class Ctx:
    """A mesh seen from this rank: axis sizes, coordinates and the
    collectives over named axes. ``Ctx(None)`` is one device with no mesh:
    every axis has size 1, so every collective is the identity."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = () if mesh is None else tuple(mesh.mesh_dim_names)
        self.sizes = {} if mesh is None else dict(zip(self.names, mesh.shape))
        self.coord = {} if mesh is None else dict(zip(self.names, mesh.get_coordinate()))

    def live(self, axes) -> tuple[str, ...]:
        if not self.sizes:  # one device: the hot path of every unsharded block
            return ()
        return tuple(a for a in axes if self.sizes.get(a, 1) > 1)

    def count(self, axes) -> int:
        return math.prod(self.sizes.get(a, 1) for a in axes)

    def index(self, axes) -> int:
        """This rank's block index over ``axes`` (major to minor)."""
        i = 0
        for a in axes:
            i = i * self.sizes.get(a, 1) + self.coord.get(a, 0)
        return i

    # raw collectives over several axes (no autograd)
    def all_gather(self, x, dim, axes):
        for a in reversed(self.live(axes)):  # minor first: the major axis concatenates whole blocks
            x = _all_gather(x, dim, self.mesh, a)
        return x

    def reduce_scatter(self, x, dim, axes):
        for a in self.live(axes):
            x = _reduce_scatter(x, dim, self.mesh, a)
        return x

    def all_reduce(self, x, axes, op: str = "sum"):
        for a in self.live(axes):
            x = _all_reduce(x, self.mesh, a, op)
        return x

    def take(self, x, dim, axes):
        axes = self.live(axes)
        return _chunk(x, dim, self.count(axes), self.index(axes)) if axes else x

    # autograd forms
    def gather(self, x, dim: int, axes, bwd: str = "sum"):
        return x if not self.live(axes) else _Gather.apply(x, self, dim, tuple(axes), bwd)

    def scatter(self, x, dim: int, axes):
        return x if not self.live(axes) else _Scatter.apply(x, self, dim, tuple(axes))

    def reduce(self, x, axes):
        return x if not self.live(axes) else _Reduce.apply(x, self, tuple(axes))

    def sum_grad(self, x, axes):
        return x if not self.live(axes) else _SumGrad.apply(x, self, tuple(axes))

    def chunk(self, x, dim: int, axes):
        return x if not self.live(axes) else _Chunk.apply(x, self, dim, tuple(axes))

    def param(self, p: torch.Tensor, spec: Spec, data_axes=()):
        """A parameter shard ready for this rank's use: every dim sharded
        over data-parallel axes (FSDP) gathered, the 'model' axis kept (TP);
        ``data_axes``: the axes over which the ranks use it on different
        data, whose gradient contributions are summed (by the gather's
        reduce-scatter on a sharded dim, by ``sum_grad`` on a replicated
        one)."""
        sharding = set()
        for d, axes in enumerate(spec):
            sharding.update(axes)
            for a in reversed([a for a in axes if a != "model"]):  # minor first, as all_gather
                p = self.gather(p, d, (a,), "sum" if a in data_axes else "slice")
        return self.sum_grad(p, tuple(a for a in data_axes if a not in sharding))

    def params(self, p: dict, s, data_axes=()) -> dict:
        """:meth:`param` of each leaf of the flat dict ``p`` with specs
        ``s`` (``p`` itself with no mesh)."""
        if not self.names:
            return p
        return {k: self.param(p[k], s[k], data_axes) for k in p}


class _NoSpec:
    """The spec tree of a program on one device: every subtree is this, and
    every dim of every leaf is split over no axis (``NO_SPEC[i] == ()``)."""

    __slots__ = ()

    def __getitem__(self, key):
        return () if isinstance(key, int) else self

    def __iter__(self):
        return iter(())

    def tail(self) -> "_NoSpec":
        return self

    def axes(self) -> set:
        return set()

    def __repr__(self) -> str:
        return "NO_SPEC"


NO_SPEC = _NoSpec()


@dataclasses.dataclass(frozen=True)
class Rank:
    """How this rank runs a block family's program: its view of the mesh,
    the rules, the residual stream's layout and the stream's global
    (B, T, d) (None: the stream's own shape, one device). :data:`SINGLE`
    runs the program on one device, where every collective is the
    identity."""

    ctx: Ctx
    rules: object = None
    act: Act = Act()
    shape: tuple | None = None

    def stream_shape(self, x: torch.Tensor) -> tuple:
        return tuple(x.shape) if self.shape is None else self.shape


SINGLE = Rank(Ctx(None))


def ctx_for(mesh) -> Ctx:
    """``mesh`` seen from this rank, or a clear error for rules made
    without one."""
    if mesh is None:
        raise ValueError("these rules were made from axis sizes alone: a program on a mesh needs rules made "
                         "from a DeviceMesh")
    return Ctx(mesh)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, dim, axes, bwd):
        fctx.args = (ctx, dim, axes, bwd)
        return ctx.all_gather(x, dim, axes)

    @staticmethod
    def backward(fctx, g):
        ctx, dim, axes, bwd = fctx.args
        g = ctx.reduce_scatter(g, dim, axes) if bwd == "sum" else ctx.take(g, dim, axes)
        return g, None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, dim, axes):
        fctx.args = (ctx, dim, axes)
        return ctx.reduce_scatter(x, dim, axes)

    @staticmethod
    def backward(fctx, g):
        ctx, dim, axes = fctx.args
        return ctx.all_gather(g, dim, axes), None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        return ctx.all_reduce(x, axes)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.args = (ctx, axes)
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        ctx, axes = fctx.args
        return ctx.all_reduce(g, axes), None, None


class _Chunk(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, dim, axes):
        fctx.args = (ctx, dim, axes)
        return ctx.take(x, dim, axes).contiguous()

    @staticmethod
    def backward(fctx, g):
        ctx, dim, axes = fctx.args
        return ctx.all_gather(g.contiguous(), dim, axes), None, None, None
