"""Request-batching primitives. The port has only the power-of-two clamp
behind the continuous batcher's capacity so far; request stacking and
splitting come with the scheduler."""
from __future__ import annotations


def largest_pow2_le(n: int) -> int:
    """Largest power of two <= n (n floored at 1). The shared clamp behind
    the bucket invariant: the scheduler's max_batch and the bucket cap must
    agree, or admitted batches outgrow the compiled bucket set."""
    return 1 << (max(1, int(n)).bit_length() - 1)
