"""K5: the per-expert grouped GEMM of the MoE layer, out[e] = xe[e] @ w[e].

The hand-written Hopper kernel is ``csrc/moe_gmm.cu`` (one block per
(expert, C tile, f tile), a cp.async ring of bf16 tiles, mma.sync with fp32
accumulators, any C and any d, f that are multiples of 8); its plain PyTorch
version is :func:`repro_torch.kernels.ref.gmm_ref`, re-exported here as
:data:`plain`. It replaces the Pallas TPU kernel
``repro/kernels/moe_gmm.py: moe_gmm``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gmm_ref as plain

#: Kernel launches; the wrapper adds one where it launches, nowhere else.
launches = 0


def _check(xe, w) -> None:
    if xe.dim() != 3 or w.dim() != 3 or w.shape[0] != xe.shape[0] or w.shape[1] != xe.shape[2]:
        raise ValueError(f"expected xe (E,C,d), w (E,d,f); got {tuple(xe.shape)}, {tuple(w.shape)}")
    e, _, d = xe.shape
    f = w.shape[2]
    if d % 8 or f % 8:
        raise ValueError(f"moe_gmm kernel takes d and f that are multiples of 8, got d={d}, f={f}")
    if e > 65535:
        raise ValueError(f"moe_gmm kernel takes at most 65535 experts, got {e}")
    if w.device != xe.device:
        raise ValueError(f"w is on {w.device}, xe on {xe.device}")
    for name, x in (("xe", xe), ("w", w)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"moe_gmm kernel takes bfloat16, {name} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def moe_gmm(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, d); w: (E, d, f) -> (E, C, f) in the dtype of ``xe``.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version; a meta tensor returns an empty output of the right shape."""
    if xe.device.type == "cpu":
        return plain(xe, w)
    if xe.device.type == "meta":
        return torch.empty(xe.shape[0], xe.shape[1], w.shape[2], dtype=xe.dtype, device="meta")
    if xe.device.type != "cuda":
        raise ValueError(f"moe_gmm: unsupported device {xe.device}")
    _check(xe, w)
    e, c, d = xe.shape
    out = torch.empty(e, c, w.shape[2], dtype=xe.dtype, device=xe.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    err = lib.repro_moe_gmm_fwd(
        xe.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, w.shape[2],
        torch.cuda.current_stream(xe.device).cuda_stream,
    )
    build.check(err, "moe_gmm launch")
    global launches
    launches += 1
    return out
