"""K6: the Mamba-2 SSD chunked scan (forward): y and the final state.

The hand-written Hopper kernel is ``csrc/ssd_scan.cu``: chunks of 64 rows,
up to 8 ranks per sequence each computing a contiguous run of chunks in
parallel (a rank re-walks the state recurrence over the chunks before its
run), one head and a 64- or 32-wide slice of its head dim per block, the
products on the tensor cores with the fp32 state in registers, and the last
rank writing the final state; any T, state dim 64 or 128, head dim a
multiple of 32, B and C grouped by ``h // (H / G)``. Its plain PyTorch
version is :func:`repro_torch.kernels.ref.ssd_ref`, re-exported here as
:data:`plain`. It replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py:
ssd_scan`` (which returns y only).

Under autograd its gradient is ``csrc/ssd_scan_bwd.cu`` on the card (two
kernels: the chunk-boundary states recomputed into a bf16 workspace, then
the chunks' terms, a group's heads split over :func:`grad_splits` blocks;
the final state's cotangent taken when it is given) and
:func:`repro_torch.kernels.ref.ssd_ref_bwd` (:data:`plain_bwd`) on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.ref import ssd_ref as plain
from repro_torch.kernels.ref import ssd_ref_bwd as plain_bwd

STATE_DIMS = (64, 128)  # csrc/ssd_scan.cu instantiates N = 64 and 128
HEAD_DIM_MULTIPLE = 32  # a block takes a 64-wide slice of the head dim where P is a multiple of 64, else 32
GRAD_HEAD_DIM = 64  # csrc/ssd_scan_bwd.cu's chunk kernel takes P = 64
GRAD_CHUNK = 64  # ... and chunks of 64 rows
GRAD_BLOCKS_PER_SM = 2  # its chunk kernel's blocks that share an SM (shared memory and registers)


def grad_splits(b: int, nc: int, g: int, heads_per_group: int, sms: int) -> int:
    """The number of blocks over which K6's gradient splits a group's heads:
    each (chunk, sequence, group) gets that many blocks, each a contiguous
    run of ceil(heads / splits) heads, every run non-empty. A block's time
    is about its heads plus one head's worth of set-up (B, C, C B^T, the
    partials' sum), and the card runs GRAD_BLOCKS_PER_SM blocks on each of
    ``sms`` SMs at once, so the split that takes the fewest (waves of blocks)
    x (heads + 1) is chosen, the fewer splits on a tie."""
    tiles, slots = nc * b * g, GRAD_BLOCKS_PER_SM * sms

    def cost(n: int) -> int:
        per = -(-heads_per_group // n)
        return -(-tiles * (-(-heads_per_group // per)) // slots) * (per + 1)

    best = min(range(1, heads_per_group + 1), key=lambda n: (cost(n), n))
    return -(-heads_per_group // -(-heads_per_group // best))


def _check(x, bm, cm, dt, a_log, d_skip) -> None:
    if x.dim() != 4 or bm.dim() != 4 or cm.shape != bm.shape:
        raise ValueError(f"expected x (B,T,H,P), bm/cm (B,T,G,N); got {tuple(x.shape)}, "
                         f"{tuple(bm.shape)}, {tuple(cm.shape)}")
    b, t, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    if bm.shape[:2] != (b, t) or h % g:
        raise ValueError(f"incompatible x {tuple(x.shape)} and bm/cm {tuple(bm.shape)}")
    if dt.shape != (b, t, h) or a_log.shape != (h,) or d_skip.shape != (h,):
        raise ValueError(f"expected dt ({b},{t},{h}) and a_log, d_skip ({h},); got {tuple(dt.shape)}, "
                         f"{tuple(a_log.shape)}, {tuple(d_skip.shape)}")
    if n not in STATE_DIMS:
        raise ValueError(f"ssd_scan kernel takes state dim {STATE_DIMS}, got {n}")
    if p % HEAD_DIM_MULTIPLE:
        raise ValueError(f"ssd_scan kernel takes a head dim that is a multiple of {HEAD_DIM_MULTIPLE}, got {p}")
    for name, v, dtype in (("x", x, torch.bfloat16), ("bm", bm, torch.bfloat16), ("cm", cm, torch.bfloat16),
                           ("dt", dt, torch.float32), ("a_log", a_log, torch.float32),
                           ("d_skip", d_skip, torch.float32)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if v.dtype != dtype:
            raise TypeError(f"ssd_scan kernel takes {name} in {dtype}, got {v.dtype}")
        if not v.is_contiguous() or v.data_ptr() % (16 if dtype == torch.bfloat16 else 4):
            raise ValueError(f"{name} must be contiguous and aligned")


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _op(x: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        d_skip: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        y, state = plain(x, bm, cm, dt, a_log, d_skip)
        return y.to(x.dtype), state
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    _check(x, bm, cm, dt, a_log, d_skip)
    b, t, h, p = x.shape
    n = bm.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    if not y.numel():
        state.zero_()  # no token: the zero state
        return y, state
    cost.record("ssd_scan", False, b=b, t=t, h=h, g=bm.shape[2], p=p, n=n)
    err = build.load().repro_ssd_scan_fwd(
        x.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
        d_skip.data_ptr(), y.data_ptr(), state.data_ptr(), b, t, h, p, bm.shape[2], n,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "ssd_scan launch")
    build.count_launch("ssd_scan")
    return y, state


@_op.register_fake
def _(x, bm, cm, dt, a_log, d_skip):
    b, t, h, p = x.shape
    if x.is_meta and x.numel():  # the card's branch of a shape-only run
        cost.record("ssd_scan", True, b=b, t=t, h=h, g=bm.shape[2], p=p, n=bm.shape[-1])
    return torch.empty_like(x), x.new_empty(b, h, p, bm.shape[-1], dtype=torch.float32)


@_op.register_vmap
def _(info, in_dims, x, bm, cm, dt, a_log, d_skip):
    """The mapped axis folds into B (one launch) when the per-head
    parameters are shared by the lanes; else one launch per lane."""
    if in_dims[4] is not None or in_dims[5] is not None:
        return build.per_lane(info, in_dims, _op, x, bm, cm, dt, a_log, d_skip)
    x, bm, cm, dt = build.fold_lanes(info, in_dims[:4], x, bm, cm, dt)
    y, state = _op(x, bm, cm, dt, a_log, d_skip)
    return (build.unfold_lanes(info, y), build.unfold_lanes(info, state)), (0, 0)


def backward(x, bm, cm, dt, a_log, d_skip, dy, dstate=None):
    """(dx, dbm, dcm, ddt, da_log, dd_skip) of ``ssd_scan`` for the
    cotangents ``dy`` of y and ``dstate`` of the final state (None: zero):
    K6's backward kernels for CUDA tensors (or a raise), the plain backward
    for CPU tensors. On the card the chunk-boundary states and their
    cotangents are recomputed into a transient workspace of 2 B H
    ceil(T / 64) P N bf16 values, and each split of a group's heads
    (:func:`grad_splits`) sums its dB and dC into an fp32 partial. Meta
    tensors get the card's outputs with no launch (the workspace counted by
    ``kernels/cost.py``), the call reported to an active cost analysis."""
    if x.device.type == "cpu":
        return plain_bwd(x, bm, cm, dt, a_log, d_skip, dy, dstate)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan backward: unsupported device {x.device}")
    _check(x, bm, cm, dt, a_log, d_skip)
    b, t, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    if p != GRAD_HEAD_DIM:
        raise ValueError(f"ssd_scan backward kernel takes a head dim of {GRAD_HEAD_DIM}, got {p}")
    dy = dy.to(x.dtype).contiguous()
    if dy.shape != x.shape or dy.device != x.device or dy.data_ptr() % 16:
        raise ValueError(f"ssd_scan backward: dy must be {tuple(x.shape)} on {x.device}, got {tuple(dy.shape)}")
    if dstate is not None:
        dstate = dstate.float().contiguous()
        if dstate.shape != (b, h, p, n) or dstate.device != x.device:
            raise ValueError(f"ssd_scan backward: dstate must be ({b}, {h}, {p}, {n}), got {tuple(dstate.shape)}")
    dx, dbm, dcm = torch.empty_like(x), torch.empty_like(bm), torch.empty_like(cm)
    ddt = torch.empty_like(dt)
    da_log, dd_skip = torch.empty_like(a_log), torch.empty_like(d_skip)
    if not x.numel():
        return dx, dbm, dcm, ddt, da_log.zero_(), dd_skip.zero_()
    if x.is_meta:
        cost.record("ssd_scan_grad", True, b=b, t=t, h=h, g=g, p=p, n=n, with_state=dstate is not None)
        return dx, dbm, dcm, ddt, da_log, dd_skip
    nc = -(-t // GRAD_CHUNK)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    cost.record("ssd_scan_grad", False, b=b, t=t, h=h, g=g, p=p, n=n, with_state=dstate is not None, sms=sms)
    splits = grad_splits(b, nc, g, h // g, sms)
    ws_s = torch.empty(b, h, nc, p, n, dtype=torch.bfloat16, device=x.device)
    ws_z = torch.empty_like(ws_s)
    part_bc = torch.empty(splits, b, g, nc, 2, GRAD_CHUNK, n, dtype=torch.float32, device=x.device)
    part = torch.empty(b, nc, h, 2, dtype=torch.float32, device=x.device)
    ticket = torch.zeros(1 + nc * b * g, dtype=torch.int32, device=x.device)
    err = build.load().repro_ssd_scan_bwd(
        x.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(), a_log.data_ptr(), d_skip.data_ptr(),
        dy.data_ptr(), None if dstate is None else dstate.data_ptr(), ws_s.data_ptr(), ws_z.data_ptr(),
        part_bc.data_ptr(), part.data_ptr(), ticket.data_ptr(), dx.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
        ddt.data_ptr(), da_log.data_ptr(), dd_skip.data_ptr(), b, t, h, p, g, n, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd_scan backward launch")
    build.count_launch("ssd_scan_bwd_walk")
    build.count_launch("ssd_scan_bwd_chunk")
    return dx, dbm, dcm, ddt, da_log, dd_skip


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy, dstate):
    saved = ctx.saved_tensors  # once: under torch.utils.checkpoint a second unpack raises
    if dy is None:
        dy = torch.zeros_like(saved[0])
    return backward(*saved, dy, dstate)


_op.register_autograd(_backward, setup_context=_setup_context)


def ssd_scan(x: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor, dt: torch.Tensor,
             a_log: torch.Tensor, d_skip: torch.Tensor, return_state: bool = False):
    """x: (B,T,H,P); bm/cm: (B,T,G,N); dt: (B,T,H) fp32; a_log, d_skip: (H,)
    fp32 -> y (B,T,H,P) in the dtype of ``x`` (fp32 accumulated); with
    ``return_state``, (y, the final state (B,H,P,N) fp32).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version; a meta tensor returns empty outputs of the right shapes
    and reports the call to an active cost analysis (the shape-only run of a
    fused unit or of a dry run). Under autograd the gradient is
    :func:`backward`."""
    y, state = _op(x, bm, cm, dt, a_log, d_skip)
    return (y, state) if return_state else y
