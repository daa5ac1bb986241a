"""Parameter definition trees.

A model is described by a tree (nested dicts) of :class:`ParamDef` leaves,
in the JAX package's layout and shapes (``wq`` is ``(d, H, hd)``, layers
stacked on a leading axis), so a chain stage takes its slice of the weights
and a JAX parameter tree maps onto the port's leaf for leaf. ``init_params``
materializes the tree from a seeded ``torch.Generator`` with the JAX
package's init rule (``repro/models/params.py``); the random numbers differ
from JAX's, so tests that compare the two bridge JAX's parameters instead.
``param_structs`` gives the same tree as empty meta tensors (the JAX
package's ``jax.ShapeDtypeStruct`` tree): the dry run's zero-allocation
weights; on a mesh, meta ``DTensor``s with the strict placements of each
leaf's logical axes, so each rank's local shape is the reference's shard
shape. ``param_pspecs`` gives those strict specs.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...] | None = None  # per-dim logical axis names (None: all unnamed)
    init: str = "normal"          # normal | zeros | ones | embed
    scale_axis: int | None = None  # fan-in axis for 'normal' (default: -2)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.logical is None:
            object.__setattr__(self, "logical", (None,) * len(self.shape))
        if len(self.shape) != len(self.logical):
            raise ValueError(f"ParamDef rank mismatch: {self.shape} vs {self.logical}")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _fan_in(d: ParamDef) -> int:
    if not d.shape:
        return 1
    ax = d.scale_axis
    if ax is None:
        ax = -2 if len(d.shape) >= 2 else 0
    return max(1, d.shape[ax])


# float32 values drawn at once: a leaf is drawn in runs of leading-axis
# slices of at most this many values (at least one slice), each written into
# the final-dtype leaf, so the float32 temporary is one layer's slice at
# most, never the whole stacked leaf.
DRAW_VALUES = 1 << 26


def _init_leaf(d: ParamDef, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    scale = 1.0 if d.init == "embed" else 1.0 / math.sqrt(_fan_in(d))
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    rows = max(1, DRAW_VALUES // max(1, math.prod(d.shape[1:])))
    for part in out.view(-1, *d.shape[1:]).split(rows):
        x = torch.randn(part.shape, generator=gen, dtype=torch.float32, device=device)
        part.copy_(x.mul_(scale))
    return out


def init_params(defs, seed: int = 0, *, device=None):
    """Materialize ``defs`` on ``device`` (default: the card) from a
    ``torch.Generator`` seeded with ``seed``; leaves draw in sorted-key order,
    each in its def's dtype."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree.map(lambda d: _init_leaf(d, gen, dev), defs)


def param_pspecs(defs, rules):
    """Each leaf's strict spec (``sharding.specs.to_pspec``, strict=True) as
    a ``sharding.spmd.Spec``: a tree leaf, which ``CheckpointManager.restore``
    takes as ``shardings``."""
    from repro_torch.sharding import spmd

    return tree.map(lambda d: spmd.spec_from_rules(d.shape, d.logical, rules, strict=True), defs)


def param_structs(defs, mesh=None, rules=None):
    """``defs`` as empty meta tensors of their shapes and dtypes: no
    storage is allocated, so a 42B-parameter train state stays symbolic.
    With ``mesh`` and ``rules``, each leaf is a meta ``DTensor`` with the
    strict placements of its logical axes (uneven dims drop their axis)."""
    if mesh is None or rules is None:
        return tree.map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)
    from repro_torch.sharding import spmd

    def one(d: ParamDef):
        placements = spmd.strict_placements(d.shape, d.logical, rules, mesh)
        local = spmd.local_shape(d.shape, placements, mesh)
        return spmd.as_dtensor(torch.empty(local, dtype=d.dtype, device="meta"), mesh, placements, d.shape)

    return tree.map(one, defs)


def param_count(defs) -> int:
    return sum(math.prod(d.shape) for d in tree.leaves(defs))


def param_bytes(defs) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in tree.leaves(defs))


def map_defs(fn, defs):
    return tree.map(fn, defs)


def stack_defs(defs, n: int, logical: str = "layers"):
    """Prepend a stacking axis (layers stacked on a leading axis)."""
    return map_defs(
        lambda d: dataclasses.replace(
            d,
            shape=(n, *d.shape),
            logical=(logical, *d.logical),
            scale_axis=None if d.scale_axis is None else (d.scale_axis if d.scale_axis < 0 else d.scale_axis + 1),
        ),
        defs,
    )
