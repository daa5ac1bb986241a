"""Minimal pytree helpers over dicts, lists and tuples of tensors.

The counterpart of ``jax.tree`` for the shapes of trees this package uses:
parameter trees are nested dicts (keys visited in sorted order, as JAX
does), arguments are tuples. ``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree) -> tuple[list, Any]:
    """(leaves, structure); the structure is a hashable description."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _walk(node, leaves: list):
    # module-level, not a closure: a nested function that recurses through
    # its own cell is a reference cycle, which would keep the leaves (whole
    # cache trees) alive until the cyclic garbage collector runs
    if node is None:
        return None
    if isinstance(node, dict):
        return ("dict", tuple((k, _walk(node[k], leaves)) for k in sorted(node)))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, tuple(_walk(x, leaves) for x in node))
    leaves.append(node)
    return "*"


def leaves(tree) -> list:
    return flatten(tree)[0]


def map(fn: Callable, tree, *rest):  # noqa: A001 - mirrors jax.tree.map
    """Apply ``fn`` leafwise over ``tree`` and same-structured ``rest``,
    visiting leaves in :func:`flatten` order (dict keys sorted)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def unflatten(structure, leaves) -> Any:
    """The tree :func:`flatten` described by ``structure``, with ``leaves``
    (in flatten order) in its leaf slots."""
    return _build(structure, iter(leaves))


def _build(node, it):
    if node is None:
        return None
    if node == "*":
        return next(it)
    kind, children = node
    if kind == "dict":
        return {k: _build(sub, it) for k, sub in children}
    out = [_build(sub, it) for sub in children]
    return tuple(out) if kind == "tuple" else out
