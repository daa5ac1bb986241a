"""K4: one-token GQA decode attention over a contiguous KV cache.

The hand-written Hopper kernel is ``csrc/decode_attention.cu`` (one block
per (sequence, kv head), so each K/V row is read once for its G query
heads; only rows below ``cur_len`` are read); its plain PyTorch version is
:func:`repro_torch.kernels.ref.decode_attn_ref`, re-exported here as
:data:`plain`. It replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py: decode_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_attn_ref as plain

HEAD_DIMS = (64, 128)
MAX_GROUP_WIDTH = 1024  # G * hd outputs per block (8 per thread x 128 threads)

#: Kernel launches; the wrapper adds one where it launches, nowhere else.
launches = 0


def _check(q, k, v, cur_len) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,H,hd), k/v (B,S,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head dim {HEAD_DIMS}, got {hd}")
    if (h // k.shape[2]) * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention kernel takes G*hd <= {MAX_GROUP_WIDTH}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention kernel takes bfloat16, {name} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if cur_len.shape != (b,) or cur_len.dtype != torch.int32 or cur_len.device != q.device:
        raise ValueError(f"cur_len must be int32 of shape ({b},) on {q.device}")
    if not cur_len.is_contiguous():
        raise ValueError("cur_len must be contiguous")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cur_len: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k, v: (B, S, KV, hd); cur_len: (B,) int32 -> (B, H, hd).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version; a meta tensor returns an empty output of the right shape."""
    if q.device.type == "cpu":
        return plain(q, k, v, cur_len)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check(q, k, v, cur_len)
    b, h, hd = q.shape
    out = torch.empty_like(q)
    lib = build.load()
    err = lib.repro_decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cur_len.data_ptr(), out.data_ptr(),
        b, k.shape[1], h, k.shape[2], hd,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "decode_attention launch")
    global launches
    launches += 1
    return out
