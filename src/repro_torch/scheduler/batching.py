"""Request-batching primitives: shape keys, stacking, bucketing.

Two concurrent requests are *compatible* (co-batchable) when they target the
same function with the same argument structure — same tree structure, same
leaf shapes, dtypes and devices (and equal non-tensor leaves). Compatible
requests stack along a NEW leading batch axis and run as one vmapped
execution (``FunctionInstance.execute_batch``); the batch axis is invisible
to the function's own code, so shape-polymorphic routes (prefill vs decode)
keep their per-request meaning.
"""
from __future__ import annotations

import torch

from repro_torch import tree


def _leaf_sig(leaf) -> tuple:
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype), str(leaf.device))
    return (type(leaf).__name__, repr(leaf))


def request_key(name: str, args: tuple, slo_name: str | None = None) -> tuple:
    """Admission-queue key: (function, argument-structure[, SLO class]). A
    non-tensor leaf is keyed by its value: it is a constant of the program
    (as in ``FunctionInstance.get_compiled``), so requests that differ there
    never share a batch. ``slo_name`` partitions admission per class so batches can never mix
    latency targets (a strict request must not ride in — or wait behind — a
    best-effort convoy)."""
    leaves, structure = tree.flatten(args)
    key = (name, structure, tuple(_leaf_sig(l) for l in leaves))
    return key if slo_name is None else key + (slo_name,)


def stack_requests(args_list: list[tuple]):
    """Stack k compatible requests' args along a new leading axis
    (non-tensor leaves, equal across compatible requests, are kept)."""
    return tree.map(lambda *xs: torch.stack(xs) if isinstance(xs[0], torch.Tensor) else xs[0], *args_list)


def split_results(out, k: int) -> list:
    """Scatter a batched output tree back into k per-request trees."""
    return [tree.map(lambda x: x[i], out) for i in range(k)]


def largest_pow2_le(n: int) -> int:
    """Largest power of two <= n (n floored at 1). The shared clamp behind
    the bucket invariant: the scheduler's max_batch and the bucket cap must
    agree, or admitted batches outgrow the compiled bucket set."""
    return 1 << (max(1, int(n)).bit_length() - 1)


def next_batch_bucket(k: int, max_batch: int | None = None) -> int:
    """Round a batch size up to the next power-of-two bucket (optionally
    capped at max_batch) so an instance builds O(log max_batch) batched
    programs instead of one per observed size; short batches pad up.

    The cap itself clamps to the largest power-of-two <= max_batch: a
    non-power-of-two cap (e.g. 6) must not mint a one-off bucket-6 program
    that no other batch size reuses. Batches larger than the clamped cap run
    as bucket-sized chunks (see FunctionInstance.execute_batch)."""
    b = 1 if k <= 1 else 1 << (k - 1).bit_length()
    if max_batch is not None:
        b = min(b, largest_pow2_le(max_batch))
    return b
