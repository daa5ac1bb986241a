"""Parameter definition trees.

A model is described by a tree (nested dicts) of :class:`ParamDef` leaves,
in the JAX package's layout and shapes (``wq`` is ``(d, H, hd)``, layers
stacked on a leading axis), so a chain stage takes its slice of the weights
and a JAX parameter tree maps onto the port's leaf for leaf. ``init_params``
materializes the tree from a seeded ``torch.Generator`` with the JAX
package's init rule (``repro/models/params.py``); the random numbers differ
from JAX's, so tests that compare the two bridge JAX's parameters instead.
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
    init: str = "normal"          # normal | zeros | ones | embed
    scale_axis: int | None = None  # fan-in axis for 'normal' (default: -2)
    dtype: torch.dtype = torch.bfloat16


def _fan_in(d: ParamDef) -> int:
    if not d.shape:
        return 1
    ax = d.scale_axis
    if ax is None:
        ax = -2 if len(d.shape) >= 2 else 0
    return max(1, d.shape[ax])


def _init_leaf(d: ParamDef, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
    if d.init != "embed":
        x.mul_(1.0 / math.sqrt(_fan_in(d)))
    return x.to(d.dtype)


def init_params(defs, seed: int = 0, *, device=None):
    """Materialize ``defs`` on ``device`` (default: the card) from a
    ``torch.Generator`` seeded with ``seed``; leaves draw in sorted-key order."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    leaves, _ = tree.flatten(defs)
    values = iter([_init_leaf(d, gen, dev) for d in leaves])
    return tree.map(lambda _: next(values), defs)


def param_bytes(defs) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in tree.leaves(defs))


def stack_defs(defs, n: int):
    """Prepend a stacking axis (layers stacked on a leading axis)."""
    return tree.map(
        lambda d: dataclasses.replace(
            d,
            shape=(n, *d.shape),
            scale_axis=None if d.scale_axis is None else (d.scale_axis if d.scale_axis < 0 else d.scale_axis + 1),
        ),
        defs,
    )
