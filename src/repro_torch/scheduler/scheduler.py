"""The request scheduler's public error type. The scheduler itself
(admission queues, coalescer, ``invoke_async``) is not ported yet; the
continuous batcher's ``ShedError`` already subclasses this, so one
``except`` clause implements a client's back-off for both admission paths."""
from __future__ import annotations


class OverloadShedError(RuntimeError):
    """Best-effort request rejected at admission: the function's predicted
    offered load is at/over its batched capacity (rho >= 1) and the
    best-effort backlog already holds its bound — queueing more background
    traffic would only push strict classes toward misses. Fail fast so the
    client can back off."""
