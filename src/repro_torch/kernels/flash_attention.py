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
each row's logsumexp and its output in fp32, and as its backward the three
kernels of ``csrc/flash_attention_bwd.cu`` (prep: D = rowsum(dO * o) from
the fp32 output; the sweep: one
pass over kv tiles on wgmma fed by TMA, dQ summed across kv tiles in one
fixed order, a wide group's query heads split over blocks; post: dq, and a
split's dk and dv), each counted by its own name. Their plain version is
:func:`repro_torch.kernels.ref.mha_ref_bwd` (:data:`plain_bwd`). On the CPU
autograd runs through the plain forward.
"""
from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build, cost
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


def _forward(q, k, v, causal: bool, lse: torch.Tensor | None = None,
             out32: torch.Tensor | None = None) -> torch.Tensor:
    """The forward kernel on checked CUDA inputs; with ``lse`` ((B, H, T)
    fp32) it also writes each row's logsumexp, with ``out32`` ((B, T, H, hd)
    fp32, contiguous) the output before its rounding to bf16 (the bf16
    output's arithmetic is the same either way)."""
    b, t, h, hd = q.shape
    out = torch.empty_like(q)
    if t == 0:
        return out
    cost.record("flash_attention", q.is_meta, b=b, t=t, s=k.shape[1], h=h, kv=k.shape[2], hd=hd, causal=causal,
                with_lse=lse is not None)
    if q.is_meta:  # a shape-only run: the card's allocations, no launch
        return out
    lib = build.load()
    err = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
        0 if out32 is None else out32.data_ptr(), b, t, k.shape[1], h, k.shape[2], hd, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention launch")
    build.count_launch("flash_attention")
    return out


#: Query rows of one step of the gradient's sweep at each head dim (the
#: kernel's ``query_rows<D>()``, ``csrc/flash_attention_bwd.cu``); its kv
#: tile is GRAD_KV_ROWS rows.
GRAD_QUERY_ROWS = {64: 128, 112: 64, 128: 64}
GRAD_KV_ROWS = 128
GRAD_DQ_TILE = 2 * 64 * 64  # fp32 of one query tile's dQ accumulator


def grad_splits(b: int, s: int, kv: int, group: int, sms: int) -> int:
    """Blocks over which the sweep splits a group's query heads: 1 when the
    B * KV * ceil(S / 128) blocks of kv tiles already fill the ``sms``
    streaming multiprocessors (one block each), else as many as fill them,
    at most ``group``, with the heads shared out evenly (ceil(group / n)
    each, no split empty)."""
    blocks = b * kv * -(-s // GRAD_KV_ROWS)
    if blocks >= sms or group == 1:
        return 1
    per_split = -(-group // min(group, -(-sms // blocks)))
    return -(-group // per_split)


def grad_workspace_numel(b: int, s: int, kv: int, hd: int, splits: int) -> int:
    """fp32 elements of the split's partial dK and dV (none without a split):
    2 x (splits, B, KV, S rounded up to the kv tile, head dim in 64-column
    tiles)."""
    if splits == 1:
        return 0
    return 2 * splits * b * kv * (-(-s // GRAD_KV_ROWS) * GRAD_KV_ROWS) * (64 if hd <= 64 else 128)


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def backward(q, k, v, out32, lse, dout, causal: bool):
    """K3's gradient on the card: (dq, dk, dv) in bf16 from the forward's
    inputs, its fp32 output ``out32`` (before the rounding to bf16) and row
    logsumexp ``lse``, and the output gradient ``dout``. Three launches:
    prep (D = rowsum(dout * out32)), the sweep, post (dq, and dk / dv from a
    head split's partials). D is taken from the fp32 output: dS = P (dP - D)
    cancels where the rows of V share a large common component, and D from
    the bf16 output would carry its rounding into dq and dk."""
    _check(q, k, v)
    b, t, h, _ = q.shape
    if lse.shape != (b, h, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention backward: lse must be contiguous fp32 {(b, h, t)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention backward: the kernels run on the card, q is on {q.device} "
                         "(the plain version is mha_ref_bwd)")
    if out32.shape != q.shape or out32.dtype != torch.float32 or dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: out32 {tuple(out32.shape)} {out32.dtype} must be fp32 and "
                         f"dout {tuple(dout.shape)} {dout.dtype} bf16, both of q's shape {tuple(q.shape)}")
    if not out32.is_contiguous() or out32.data_ptr() % 16:
        raise ValueError("flash_attention backward: out32 must be contiguous and 16-byte aligned")
    dout = dout.contiguous()
    if t == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if q.is_meta:  # a shape-only run: the outputs; the workspace is the cost's
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        cost.record("flash_attention_grad", True, b=b, t=t, s=k.shape[1], h=h, kv=k.shape[2], hd=q.shape[3],
                    causal=causal)
        return grads
    cost.record("flash_attention_grad", False, b=b, t=t, s=k.shape[1], h=h, kv=k.shape[2], hd=q.shape[3],
                causal=causal, sms=_sms(q.device))
    dsum, lse2, sem = backward_prep(out32, dout, lse)
    dq_acc, dk, dv, ws, splits = backward_sweep(q, k, v, dout, lse2, dsum, sem, causal)
    return backward_post(dq_acc, ws, splits, q, dk, dv), dk, dv


def backward_prep(out32, dout, lse):
    """The first kernel on checked inputs: D = rowsum(dout * out32) (the
    forward's fp32 output) and lse * log2(e), (B, H, T padded to whole query
    tiles) fp32 each, and the sweep's dQ counters (B, H, query tiles) int32,
    zeroed."""
    b, t, h, hd = out32.shape
    nq = -(-t // GRAD_QUERY_ROWS[hd])
    dsum = torch.empty(b, h, nq * GRAD_QUERY_ROWS[hd], dtype=torch.float32, device=out32.device)
    lse2 = torch.empty_like(dsum)
    sem = torch.empty(b, h, nq, dtype=torch.int32, device=out32.device)
    err = build.load().repro_flash_attention_bwd_prep(
        out32.data_ptr(), dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), lse2.data_ptr(), sem.data_ptr(),
        b, t, h, hd, torch.cuda.current_stream(out32.device).cuda_stream)
    build.check(err, "flash_attention backward (prep) launch")
    build.count_launch("flash_attention_bwd_prep")
    return dsum, lse2, sem


def backward_sweep(q, k, v, dout, lse2, dsum, sem, causal: bool):
    """The sweep on checked inputs and prep's outputs (its counters are
    spent: a second sweep needs a new prep): (the fp32 dq accumulator, dk,
    dv, the split's workspace or None, the split count). Without a split dk
    and dv are final; with one post writes them."""
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    nq = -(-t // GRAD_QUERY_ROWS[hd])
    splits = grad_splits(b, s, kv, h // kv, _sms(q.device))
    dq_acc = torch.empty(b * h * nq * GRAD_DQ_TILE, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    n_ws = grad_workspace_numel(b, s, kv, hd, splits)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    err = build.load().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse2.data_ptr(), dsum.data_ptr(),
        dq_acc.data_ptr(), sem.data_ptr(), dk.data_ptr(), dv.data_ptr(), 0 if ws is None else ws.data_ptr(),
        b, t, s, h, kv, hd, int(causal), splits, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention backward (sweep) launch")
    build.count_launch("flash_attention_bwd")
    return dq_acc, dk, dv, ws, splits


def backward_post(dq_acc, ws, splits: int, q, dk, dv):
    """The last kernel: dq (bf16, q's shape) from the accumulator; with a
    split also dk and dv (written in place) from the workspace."""
    b, t, h, hd = q.shape
    dq = torch.empty_like(q)
    err = build.load().repro_flash_attention_bwd_post(
        dq_acc.data_ptr(), dq.data_ptr(), 0 if ws is None else ws.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, dk.shape[1], h, dk.shape[2], hd, splits, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention backward (post) launch")
    build.count_launch("flash_attention_bwd_post")
    return dq


class _FlashAttention(torch.autograd.Function):
    """K3 under autograd on the card: the forward kernel with the rows'
    logsumexp and its fp32 output, saved with its inputs for the backward
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        _check(q, k, v)
        b, t, h, _ = q.shape
        lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
        out32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, causal, lse, out32)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out32, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, out32, lse, dout, ctx.causal)
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
    b, t, h, hd = q.shape
    if q.is_meta and t:  # the card's branch of a shape-only run
        cost.record("flash_attention", True, b=b, t=t, s=k.shape[1], h=h, kv=k.shape[2], hd=hd, causal=causal)
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
    plain version; a meta tensor takes the card's branch without a launch:
    empty outputs of the right shapes, what the card allocates, the call
    reported to an active cost analysis (``kernels/cost.py``) — the
    shape-only run of a fused unit or of a dry run. Under
    ``torch.func.vmap`` the lanes fold into B. Under autograd (grad mode, an
    input that requires grad) a CUDA or meta call's gradient is K3's
    backward kernels and a CPU call's is autograd through the plain
    version."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if q.device.type in ("cuda", "meta"):
            return _FlashAttention.apply(q, k, v, causal)
        if q.device.type == "cpu":
            return plain(q, k, v, causal=causal)
    return _op(q, k, v, causal)
