"""Kernel entry points the models call.

Dispatch is by the tensor's device, inside each kernel wrapper: ``cuda``
launches the hand-written kernel (or raises — there is no fallback),
``cpu`` runs the plain version, ``meta`` returns an empty output of the
right shape for the shape-only run of a fused unit. There is no switch that
forces the plain version on the card.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref


def attention(q, k, v, *, causal: bool = True):
    """q: (B,T,H,hd); k, v: (B,S,KV,hd) -> (B,T,H,hd)."""
    return _flash.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k, v, cur_len):
    """q: (B,H,hd); k, v: (B,S,KV,hd); cur_len: (B,) -> (B,H,hd)."""
    return _decode.decode_attention(q, k, v, cur_len)


def counts() -> dict:
    """Kernel launches and plain-version calls since the last reset."""
    return {
        "flash_attention": _flash.launches,
        "decode_attention": _decode.launches,
        "mha_ref": ref.CALLS["mha_ref"],
        "decode_attn_ref": ref.CALLS["decode_attn_ref"],
    }


def reset_counts() -> None:
    _flash.launches = 0
    _decode.launches = 0
    for name in ref.CALLS:
        ref.CALLS[name] = 0
