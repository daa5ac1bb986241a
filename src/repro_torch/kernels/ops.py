"""Kernel entry points the models call.

Dispatch is by the tensor's device, inside each kernel wrapper: ``cuda``
launches the hand-written kernel (or raises — there is no fallback),
``cpu`` runs the plain version, ``meta`` returns an empty output of the
right shape for the shape-only run of a fused unit. There is no switch that
forces the plain version on the card. Each entry notes itself to the
dispatch tracer when it runs eagerly (informational, as in the reference).
"""
from __future__ import annotations

from repro_torch.analysis.dispatch import TRACER
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


def attention(q, k, v, *, causal: bool = True):
    """q: (B,T,H,hd); k, v: (B,S,KV,hd) -> (B,T,H,hd)."""
    TRACER.note_kernel_call("attention", q)
    return _flash.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k, v, cur_len, return_lse: bool = False):
    """q: (B,H,hd); k, v: (B,S,KV,hd); cur_len: (B,) -> (B,H,hd) (and with
    ``return_lse`` the heads' logsumexp (B,H) fp32)."""
    TRACER.note_kernel_call("decode_attention", q)
    return _decode.decode_attention(q, k, v, cur_len, return_lse)


def paged_decode_attention(q, k_pages, v_pages, block_table, cur_len):
    """q: (B,H,hd); pages: (P,page,KV,hd); block_table: (B,n); cur_len: (B,) -> (B,H,hd)."""
    TRACER.note_kernel_call("paged_decode_attention", q)
    return _paged.paged_decode_attention(q, k_pages, v_pages, block_table, cur_len)


def paged_chunk_attention(q, k_pages, v_pages, block_table, start):
    """q: (B,C,H,hd); pages: (P,page,KV,hd); block_table: (B,n); start: (B,) -> (B,C,H,hd)."""
    TRACER.note_kernel_call("paged_chunk_attention", q)
    return _paged.paged_chunk_attention(q, k_pages, v_pages, block_table, start)


def gmm(xe, w, rows=None, active=None):
    """xe: (E,C,d); w: (E,d,f) -> (E,C,f); rows (E,): kept rows per expert
    (None: all); active: a bound on the experts with rows > 0."""
    TRACER.note_kernel_call("gmm", xe)
    return _gmm.moe_gmm(xe, w, rows, active)


def ssd(x, bm, cm, dt, a_log, d_skip, return_state: bool = False):
    """x: (B,T,H,P); bm/cm: (B,T,G,N); dt: (B,T,H) fp32; a_log/d_skip: (H,) -> y (B,T,H,P);
    with ``return_state``, (y, the final state (B,H,P,N) fp32)."""
    TRACER.note_kernel_call("ssd", x)
    return _ssd.ssd_scan(x, bm, cm, dt, a_log, d_skip, return_state)


def counts() -> dict:
    """Kernel launches (eager and replayed from captured graphs) and
    plain-version calls since the last reset."""
    return {**build.LAUNCHES.total(), **ref.CALLS}


def reset_counts() -> None:
    build.LAUNCHES.reset()
    for name in ref.CALLS:
        ref.CALLS[name] = 0
