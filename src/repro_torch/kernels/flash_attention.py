"""K3: causal / non-causal GQA flash attention, and its gradient.

The hand-written Hopper kernel is ``csrc/flash_attention.cu`` (its sweep,
``csrc/flash_sweep.cuh``, is shared with K2): one block of two warpgroups
per 64 query rows of a head, the heaviest causal tiles issued
first; K/V tiles come through a 2-stage cp.async ring, the two warpgroups
split each tile's columns with online-softmax states of their own (merged at
the end), QK^T and PV are mma.sync bf16 tiles fed by ldmatrix (V by
ldmatrix.trans, no transposed copy), and every sum runs in one fixed order,
so two launches give equal bits. Any T and S, head dim 64, 112 or 128. Its
plain PyTorch version is :func:`repro_torch.kernels.ref.mha_ref`, re-exported
here as :data:`plain`. It replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py: flash_attention``.

Under autograd (grad mode on, an input that requires grad) a CUDA call runs
:class:`_FlashAttention`: the same forward kernel, which then also writes
each row's logsumexp, and as its backward the two kernels of
``csrc/flash_attention_bwd.cu`` (dq with D = rowsum(dO * o), then dk and
dv), each counted by its own name. Their plain version is
:func:`repro_torch.kernels.ref.mha_ref_bwd` (:data:`plain_bwd`). On the CPU
autograd runs through the plain forward.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build
from repro_torch.kernels.ref import mha_ref as plain
from repro_torch.kernels.ref import mha_ref_bwd as plain_bwd  # noqa: F401 - re-exported beside plain

HEAD_DIMS = (64, 112, 128)


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


def _forward(q, k, v, causal: bool, lse: torch.Tensor | None = None) -> torch.Tensor:
    """The forward kernel on checked CUDA inputs; with ``lse`` ((B, H, T)
    fp32) it also writes each row's logsumexp."""
    b, t, h, hd = q.shape
    out = torch.empty_like(q)
    if t == 0:
        return out
    lib = build.load()
    err = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
        b, t, k.shape[1], h, k.shape[2], hd, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention launch")
    build.count_launch("flash_attention")
    return out


def backward(q, k, v, out, lse, dout, causal: bool):
    """K3's gradient on the card: (dq, dk, dv) in bf16 from the forward's
    inputs, its output ``out`` and row logsumexp ``lse``, and the output
    gradient ``dout``. Two launches: dq (which also writes D = rowsum(dout *
    out)), then dk and dv."""
    _check(q, k, v)
    b, t, h, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape or torch.bfloat16 != out.dtype or dout.dtype != out.dtype:
        raise ValueError(f"flash_attention backward: out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must be bf16 of q's shape {tuple(q.shape)}")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention backward: lse must be contiguous fp32 {(b, h, t)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dout = dout.contiguous()
    if t == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dsum = backward_dq(q, k, v, out, lse, dout, causal)
    return (dq, *backward_dkdv(q, k, v, dout, lse, dsum, causal))


def backward_dq(q, k, v, out, lse, dout, causal: bool):
    """The first backward kernel on checked inputs: (dq, D)."""
    b, t, h, hd = q.shape
    dq = torch.empty_like(q)
    dsum = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    err = build.load().repro_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dsum.data_ptr(), b, t, k.shape[1], h, k.shape[2], hd, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention backward (dq) launch")
    build.count_launch("flash_attention_bwd_dq")
    return dq, dsum


def backward_dkdv(q, k, v, dout, lse, dsum, causal: bool):
    """The second backward kernel on checked inputs and backward_dq's D:
    (dk, dv)."""
    b, t, h, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = build.load().repro_flash_attention_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, t, k.shape[1], h, k.shape[2], hd, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention backward (dk, dv) launch")
    build.count_launch("flash_attention_bwd_dkdv")
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """K3 under autograd on the card: the forward kernel with the rows'
    logsumexp, saved with its inputs and output for the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        _check(q, k, v)
        b, t, h, _ = q.shape
        lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, causal, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, out, lse, dout, ctx.causal)
        return dq, dk, dv, None


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    return _forward(q, k, v, causal)


@_op.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


@_op.register_vmap
def _(info, in_dims, q, k, v, causal):
    """The mapped axis folds into B: one launch for every lane."""
    q, k, v = build.fold_lanes(info, in_dims[:3], q, k, v)
    return build.unfold_lanes(info, _op(q, k, v, causal)), 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, T, H, hd); k, v: (B, S, KV, hd) -> (B, T, H, hd).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version; a meta tensor returns an empty output of the right shape
    (the shape-only run of a fused unit). Under ``torch.func.vmap`` the
    lanes fold into B. Under autograd (grad mode, an input that requires
    grad) a CUDA call's gradient is K3's backward kernels and a CPU call's
    is autograd through the plain version."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if q.device.type == "cuda":
            return _FlashAttention.apply(q, k, v, causal)
        if q.device.type == "cpu":
            return plain(q, k, v, causal=causal)
    return _op(q, k, v, causal)
