"""Shared latency metrics: bounded sliding window + percentile reporting.

The BillingMeter's latency sink (all external traffic); the request
scheduler, once ported, shares it.
"""
from __future__ import annotations

import collections
import math
import threading
import time


def percentiles_ms(samples_s, points=(50, 95, 99)) -> dict:
    """p50/p95/p99 (milliseconds) via the textbook nearest-rank definition:
    rank = ceil(p/100 * n), 1-indexed. Explicit ceil — Python's round() is
    half-even, which lands one rank low whenever p/100 * n hits an exact
    half (e.g. p50 of 5 samples picked the 2nd instead of the 3rd)."""
    out = {f"p{p}_ms": 0.0 for p in points}
    n = len(samples_s)
    if not n:
        return out
    ordered = sorted(samples_s)
    for p in points:
        rank = min(n, max(1, math.ceil(p / 100.0 * n)))
        out[f"p{p}_ms"] = ordered[rank - 1] * 1e3
    return out


class LatencyWindow:
    """Thread-safe bounded window of request latencies. Tracks the earliest
    request start and latest completion so `snapshot()` can report sustained
    throughput alongside tail percentiles. ``clock`` supplies the default
    completion timestamp when a caller doesn't pass one (virtual-clock
    tests drive latencies entirely in simulated time)."""

    def __init__(self, maxlen: int = 200_000, clock=None):
        self._lock = threading.Lock()
        self._clock = clock
        self._samples: collections.deque = collections.deque(maxlen=maxlen)
        self._count = 0
        self._t_first: float | None = None
        self._t_last = 0.0

    def observe(self, seconds: float, t_done: float | None = None) -> None:
        if t_done is None:
            t_done = self._clock.now() if self._clock is not None else time.perf_counter()
        with self._lock:
            self._samples.append(seconds)
            self._count += 1
            t_start = t_done - seconds
            if self._t_first is None or t_start < self._t_first:
                self._t_first = t_start
            if t_done > self._t_last:
                self._t_last = t_done

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._count = 0
            self._t_first = None
            self._t_last = 0.0

    def snapshot(self) -> dict:
        with self._lock:
            samples = list(self._samples)
            count = self._count
            span = (self._t_last - self._t_first) if self._t_first is not None else 0.0
        out = {"requests": count, "throughput_rps": count / span if span > 0 else 0.0}
        out.update(percentiles_ms(samples))
        return out
