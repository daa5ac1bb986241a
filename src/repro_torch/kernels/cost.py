"""The cost of each hand-written kernel and gradient, from its call's shapes.

One formula per kernel: ``(flops, bytes, workspace_bytes)``. ``flops`` are
the products the kernel does (2 per multiply-add); ``bytes`` are what it
must move at the least, each input read once and each output written once;
``workspace_bytes`` is the transient device memory its call allocates
beside its outputs (K3's and K6's gradients: accumulators, recomputed
states, partials). These are the terms of ``chip_smoke.py``'s bounds and of
the dry run's roofline (``launch/cost_analysis.py``).

Where the work depends on the data (K4's and K1's valid rows, K2's start,
K5's kept rows and active experts), a formula takes that count as an
argument and, without it, counts what the shapes allow at the most; the
shape-only dry run knows nothing else, and so a card run and a meta run of
the same step count alike.

Every wrapper reports each call to :func:`record` where it launches its
kernel on the card, and where a meta tensor takes the card's branch without
a launch; an active cost analysis (a sink, :func:`sink`) collects them.
:func:`trips` is the counterpart of a ``while`` loop's trip count in the
JAX package's HLO analysis: on meta tensors a loop whose iterations cost
alike runs once and counts ``n`` times.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple

#: Streaming multiprocessors of the H100 SXM: the split counts of a meta
#: run (a card run asks its device).
H100_SMS = 132

SSD_CHUNK = 64  # K6's chunk (csrc/ssd_scan.cu: kQ) and its gradient's (GRAD_CHUNK)


class KernelCost(NamedTuple):
    flops: float
    bytes: float
    workspace_bytes: int = 0


def flash_attention(b, t, s, h, kv, hd, causal: bool = True, with_lse: bool = False) -> KernelCost:
    """K3's forward: QK^T and PV, 4 B H T S hd (half of it causal); q, k, v
    read once, the bf16 output written once; under autograd also the rows'
    logsumexp (B, H, T) and the fp32 output."""
    flops = 4 * b * h * t * s * hd / (2 if causal else 1)
    q = b * t * h * hd
    nbytes = 2 * (q + 2 * b * s * kv * hd + q)
    if with_lse:
        nbytes += 4 * (b * h * t + q)
    return KernelCost(flops, nbytes)


def flash_attention_grad(b, t, s, h, kv, hd, causal: bool = True, sms: int = H100_SMS) -> KernelCost:
    """K3's gradient (prep, the sweep, post): five products of the forward's
    size, 10 B H T S hd (half of it causal); q, k, v, dout, the fp32 output
    and the logsumexp read once, dq, dk, dv written once. Workspace: D and
    lse * log2(e) (B, H, T padded to query tiles) fp32, the dQ counters, the
    fp32 dQ accumulator, and a head split's fp32 partial dK and dV."""
    from repro_torch.kernels import flash_attention as fa

    q = b * t * h * hd
    k = b * s * kv * hd
    flops = 5 * 2 * b * h * t * s * hd * (0.5 if causal else 1.0)
    nbytes = 2 * (2 * q + 2 * k + 2 * k + q) + 4 * (q + b * h * t)
    nq = -(-t // fa.GRAD_QUERY_ROWS[hd])
    splits = fa.grad_splits(b, s, kv, h // kv, sms)
    work = 4 * (2 * b * h * nq * fa.GRAD_QUERY_ROWS[hd] + b * h * nq + b * h * nq * fa.GRAD_DQ_TILE
                + fa.grad_workspace_numel(b, s, kv, hd, splits))
    return KernelCost(flops, nbytes, work if t else 0)


def decode_attention(b, s, h, kv, hd, rows: int | None = None, with_lse: bool = False) -> KernelCost:
    """K4: ``rows`` valid cache rows in all (default B S, every row);
    4 H hd per row; the rows' K and V read once, q read and the output
    written once; with ``with_lse`` also the heads' logsumexp (B, H) fp32."""
    rows = b * s if rows is None else rows
    return KernelCost(4 * h * hd * rows, 2 * (2 * rows * kv * hd + 2 * b * h * hd) + (4 * b * h if with_lse else 0))


def paged_decode_attention(b, n, page, h, kv, hd, rows: int | None = None) -> KernelCost:
    """K1: K4's terms over ``rows`` valid rows (default every row the block
    table reaches), plus the block table and the lengths."""
    rows = b * n * page if rows is None else rows
    return KernelCost(4 * h * hd * rows, 2 * (2 * rows * kv * hd + 2 * b * h * hd) + 4 * (b * n + b))


def paged_chunk_attention(b, c, n, page, h, kv, hd, start: int | None = None) -> KernelCost:
    """K2: each sequence's C rows against their visible columns, the chunk
    starting at ``start`` (default: the table's last C rows); the visible
    K/V rows read once, q, the output, the table and ``start`` once."""
    start = n * page - c if start is None else start
    pairs = c * start + c * (c + 1) // 2  # (row, visible column) pairs: all C rows are computed
    nbytes = 2 * (2 * b * c * h * hd + 2 * b * min(start + c, n * page) * kv * hd) + 4 * (b * n + b)
    return KernelCost(4 * h * hd * b * pairs, nbytes)


def moe_gmm(e, c, d, f, rows: int | None = None, active: int | None = None) -> KernelCost:
    """K5: ``rows`` kept rows in all (default E C) over ``active`` experts
    (default E); the kept rows of xe and the active experts' weights read
    once, the whole (E, C, f) output written once."""
    rows = e * c if rows is None else rows
    active = e if active is None else active
    return KernelCost(2 * rows * d * f, 2 * (rows * d + active * d * f + e * c * f))


def moe_gmm_grad(e, c, d, f, rows: int | None = None, active: int | None = None) -> KernelCost:
    """K5's gradient: dxe = dy w^T and dw = xe^T dy over the kept rows;
    the kept rows of xe and dy, the active experts' w read once, dxe and dw
    written whole."""
    rows = e * c if rows is None else rows
    active = e if active is None else active
    return KernelCost(2 * 2 * rows * d * f, 2 * (rows * d + rows * f + active * d * f + e * c * d + e * d * f))


def _chunks(t: int) -> list[int]:
    return [min(SSD_CHUNK, t - c) for c in range(0, t, SSD_CHUNK)]


def ssd_scan(b, t, h, g, p, n) -> KernelCost:
    """K6: per (b, h) the dual form's products over chunks of SSD_CHUNK
    rows, 2Q^2 N + 2Q^2 P + 4QNP each; x, B, C, dt, A_log, D read once, y
    and the final state (B, H, P, N) fp32 written once."""
    flops = b * h * sum(2 * q * q * n + 2 * q * q * p + 4 * q * n * p for q in _chunks(t))
    nbytes = 2 * (2 * b * t * h * p + 2 * b * t * g * n) + 4 * (b * t * h + 2 * h) + 4 * b * h * p * n
    return KernelCost(flops, nbytes)


def ssd_scan_grad(b, t, h, g, p, n, with_state: bool = False, sms: int = H100_SMS) -> KernelCost:
    """K6's gradient (the walks, then the chunks): per (b, h) and chunk
    2Q^2 N (C B^T) + 4Q^2 P (dy x^T, the transposed weights times dy) + 4Q^2
    N (dC, dB) + 6QNP (the states' terms) + 4QNP (the two walks); x, dy, B,
    C, dt, A_log, D (and the final state's cotangent when given) read once,
    dx, dB, dC, ddt, dA_log, dD written once. Workspace: the chunk-boundary
    states and their cotangents, 2 B H ceil(T / 64) P N bf16, each head
    split's fp32 dB and dC partials, the chunks' fp32 dA partials and the
    tickets."""
    from repro_torch.kernels import ssd_scan as sd

    flops = b * h * sum(2 * q * q * n + 4 * q * q * p + 4 * q * q * n + 10 * q * n * p for q in _chunks(t))
    nbytes = 2 * (3 * b * t * h * p + 4 * b * t * g * n) + 4 * (2 * b * t * h + 4 * h)
    if with_state:
        nbytes += 4 * b * h * p * n
    nc = -(-t // SSD_CHUNK)
    splits = sd.grad_splits(b, nc, g, h // g, sms)
    work = (2 * 2 * b * h * nc * p * n + 4 * splits * b * g * nc * 2 * SSD_CHUNK * n + 4 * b * nc * h * 2
            + 4 * (1 + nc * b * g))
    return KernelCost(flops, nbytes, work if t else 0)


#: name -> (formula, the kernels the call launches: build.KERNELS' names)
FORMULAS: dict[str, tuple[Callable[..., KernelCost], tuple[str, ...]]] = {
    "flash_attention": (flash_attention, ("flash_attention",)),
    "flash_attention_grad": (flash_attention_grad,
                             ("flash_attention_bwd_prep", "flash_attention_bwd", "flash_attention_bwd_post")),
    "decode_attention": (decode_attention, ("decode_attention",)),
    "paged_decode_attention": (paged_decode_attention, ("paged_decode_attention",)),
    "paged_chunk_attention": (paged_chunk_attention, ("paged_chunk_attention",)),
    "moe_gmm": (moe_gmm, ("moe_gmm",)),
    "moe_gmm_grad": (moe_gmm_grad, ("moe_gmm_bwd_dx", "moe_gmm_bwd_dw")),
    "ssd_scan": (ssd_scan, ("ssd_scan",)),
    "ssd_scan_grad": (ssd_scan_grad, ("ssd_scan_bwd_walk", "ssd_scan_bwd_chunk")),
}

# -------------------------------------------------------------- sinks

_lock = threading.Lock()
_open = 0  # sinks open in any thread: record() returns at once while 0
_local = threading.local()  # .stack: the sinks entered on this thread


class Sink:
    """What :func:`record` and :func:`trips` report to: a cost analysis.
    ``kernel(name, cost, launches, meta)`` takes each kernel call,
    ``trips(name, n)`` each scaled loop, and ``scale`` (an int) is
    multiplied by a scaled loop's n while its one iteration runs."""

    scale = 1

    def kernel(self, name: str, cost: KernelCost, launches: tuple, meta: bool) -> None:
        raise NotImplementedError

    def trips(self, name: str, n: int) -> None:
        raise NotImplementedError


@contextlib.contextmanager
def sink(obj: Sink):
    """While inside, ``obj`` is active on this thread. A sink that is also
    a ``TorchDispatchMode`` is active too wherever the mode is: the autograd
    engine carries the mode stack to the threads that run a card's
    backward, and no other thread sees it."""
    global _open
    stack = _local.__dict__.setdefault("stack", [])
    with _lock:
        _open += 1
    stack.append(obj)
    try:
        yield obj
    finally:
        stack.pop()
        with _lock:
            _open -= 1


def _active() -> list:
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    out = []
    for s in (*getattr(_local, "stack", ()), *_get_current_dispatch_mode_stack()):
        if isinstance(s, Sink) and s not in out:  # a sink entered twice reports once
            out.append(s)
    return out


def record(name: str, meta: bool, **dims) -> None:
    """Report one call of kernel ``name`` (a key of FORMULAS) with its
    shapes to the sinks active on this thread; ``meta``: the call launched
    nothing (a meta tensor took the card's branch). Free when no analysis
    is open."""
    if not _open:
        return
    active = _active()
    if not active:
        return
    formula, launches = FORMULAS[name]
    cost = formula(**dims)
    for s in active:
        s.kernel(name, cost, launches, meta)


def trips(n: int, name: str, like):
    """``range(n)``, or one iteration whose costs count ``n`` times when
    the loop runs on meta tensors (``like``, one of its tensors, is meta)
    under an active sink: a shape-only run computes nothing, so its
    iterations cost alike and one stands for all. On any other device the
    loop runs whole, analysed or not. The sinks note the loop's ``name``
    and ``n``."""
    scaling = _active() if _open and like.is_meta and n > 1 else []
    if not scaling:
        yield from range(n)
        return
    for s in scaling:
        s.trips(name, n)
        s.scale *= n
    try:
        yield 0
    finally:
        for s in scaling:
            s.scale //= n
