"""K3: causal / non-causal GQA flash attention (forward).

The hand-written Hopper kernel is ``csrc/flash_attention.cu`` (mma.sync
bf16 tiles, online softmax in fp32 registers, any T and S, head dim 64 or
128); its plain PyTorch version is :func:`repro_torch.kernels.ref.mha_ref`,
re-exported here as :data:`plain`. It replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py: flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mha_ref as plain

HEAD_DIMS = (64, 128)

#: Kernel launches; the wrapper adds one where it launches, nowhere else.
launches = 0


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,T,H,hd), k/v (B,S,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim {HEAD_DIMS}, got {hd}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bfloat16, {name} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, T, H, hd); k, v: (B, S, KV, hd) -> (B, T, H, hd).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version; a meta tensor returns an empty output of the right shape
    (the shape-only run of a fused unit)."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    b, t, h, hd = q.shape
    out = torch.empty_like(q)
    if t == 0:
        return out
    lib = build.load()
    err = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, t, k.shape[1], h, k.shape[2], hd, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention launch")
    global launches
    launches += 1
    return out
