"""K5: the per-expert grouped GEMM of the MoE layer, out[e] = xe[e] @ w[e],
over the routed experts only.

The hand-written Hopper kernel is ``csrc/moe_gmm.cu``: it reads the weights
of the experts that received a token (``rows[e] > 0``) and no others, streams
them with the Tensor Memory Accelerator through one mbarrier ring per block
(the blocks that fit on the card at once, each walking its (expert, f tile)
items),
multiplies the kept rows on the tensor cores (mma.sync, fp32 accumulators)
and writes exact zeros for every row at or past ``rows[e]``; any C, any d
and f that are multiples of 8, at most 256 experts. Its plain PyTorch version is
:func:`repro_torch.kernels.ref.gmm_ref`, re-exported here as :data:`plain`.
It replaces the Pallas TPU kernel ``repro/kernels/moe_gmm.py: moe_gmm``.

Under autograd its gradient is ``csrc/moe_gmm_bwd.cu`` on the card (dxe =
dy w^T and dw = xe^T dy over the kept rows: two persistent kernels, one
block per SM, on wgmma fed by TMA, their tile lists built on the card from
``rows``, so the wrapper never reads ``rows`` on the host; no atomics) and
:func:`repro_torch.kernels.ref.gmm_ref_bwd` (:data:`plain_bwd`) on the CPU;
``rows`` and ``active`` carry no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.ref import gmm_ref as plain
from repro_torch.kernels.ref import gmm_ref_bwd as plain_bwd

MAX_EXPERTS = 256  # the kernel keeps its list of active experts in shared memory


def _check(xe, w, rows=None, active: int = 1) -> None:
    if xe.dim() != 3 or w.dim() != 3 or w.shape[0] != xe.shape[0] or w.shape[1] != xe.shape[2]:
        raise ValueError(f"expected xe (E,C,d), w (E,d,f); got {tuple(xe.shape)}, {tuple(w.shape)}")
    e, _, d = xe.shape
    f = w.shape[2]
    if d % 8 or f % 8:
        raise ValueError(f"moe_gmm kernel takes d and f that are multiples of 8, got d={d}, f={f}")
    if e > MAX_EXPERTS:
        raise ValueError(f"moe_gmm kernel takes at most {MAX_EXPERTS} experts, got {e}")
    if active < 1:
        raise ValueError(f"moe_gmm: the bound on active experts must be at least 1, got {active}")
    if w.device != xe.device:
        raise ValueError(f"w is on {w.device}, xe on {xe.device}")
    for name, x in (("xe", xe), ("w", w)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"moe_gmm kernel takes bfloat16, {name} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if rows is not None:
        if rows.shape != (e,) or rows.dtype != torch.int32 or rows.device != xe.device or not rows.is_contiguous():
            raise ValueError(f"rows must be contiguous int32 of shape ({e},) on {xe.device}")


@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=())
def _op(xe: torch.Tensor, w: torch.Tensor, rows: torch.Tensor | None, active: int) -> torch.Tensor:
    if xe.device.type == "cpu":
        return plain(xe, w, rows)
    if xe.device.type != "cuda":
        raise ValueError(f"moe_gmm: unsupported device {xe.device}")
    e, c, d = xe.shape
    _check(xe, w, rows, active)
    f = w.shape[2]
    out = torch.empty(e, c, f, dtype=xe.dtype, device=xe.device)
    if out.numel() == 0:
        return out
    cost.record("moe_gmm", False, e=e, c=c, d=d, f=f, active=active)
    lib = build.load()
    err = lib.repro_moe_gmm_fwd(
        xe.data_ptr(), w.data_ptr(), None if rows is None else rows.data_ptr(), out.data_ptr(),
        e, c, d, f, active, torch.cuda.current_stream(xe.device).cuda_stream,
    )
    build.check(err, "moe_gmm launch")
    build.count_launch("moe_gmm")
    return out


@_op.register_fake
def _(xe, w, rows, active):
    e, c, d = xe.shape
    if xe.is_meta and e * c * w.shape[2]:  # the card's branch of a shape-only run
        cost.record("moe_gmm", True, e=e, c=c, d=d, f=w.shape[2], active=active)
    return xe.new_empty(e, c, w.shape[2])


@_op.register_vmap
def _(info, in_dims, xe, w, rows, active):
    """One launch per lane: each lane routes its own rows to the experts."""
    return build.per_lane(info, in_dims, _op, xe, w, rows, active)


def backward(xe: torch.Tensor, w: torch.Tensor, rows: torch.Tensor | None, dy: torch.Tensor):
    """(dxe, dw) of ``moe_gmm(xe, w, rows)`` for the output gradient ``dy``
    (E, C, f): K5's backward kernels for CUDA tensors (or a raise), the plain
    backward for CPU tensors, and for meta tensors the card's outputs with
    no launch, the call reported to an active cost analysis."""
    if xe.device.type == "cpu":
        return plain_bwd(xe, w, rows, dy)
    if xe.device.type not in ("cuda", "meta"):
        raise ValueError(f"moe_gmm backward: unsupported device {xe.device}")
    _check(xe, w, rows)
    dy = dy.contiguous()
    e, c, d = xe.shape
    f = w.shape[2]
    if dy.shape != (e, c, f) or dy.dtype != xe.dtype or dy.device != xe.device or dy.data_ptr() % 16:
        raise ValueError(f"moe_gmm backward: dy must be ({e}, {c}, {f}) {xe.dtype} on {xe.device}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    dxe, dw = torch.empty_like(xe), torch.empty_like(w)
    if xe.numel() == 0 or dy.numel() == 0:
        return dxe.zero_(), dw.zero_()
    cost.record("moe_gmm_grad", xe.is_meta, e=e, c=c, d=d, f=f)
    if xe.is_meta:
        return dxe, dw
    err = build.load().repro_moe_gmm_bwd(
        xe.data_ptr(), w.data_ptr(), None if rows is None else rows.data_ptr(), dy.data_ptr(), dxe.data_ptr(),
        dw.data_ptr(), e, c, d, f, torch.cuda.current_stream(xe.device).cuda_stream)
    build.check(err, "moe_gmm backward launch")
    build.count_launch("moe_gmm_bwd_dx")
    build.count_launch("moe_gmm_bwd_dw")
    return dxe, dw


def _setup_context(ctx, inputs, output):
    xe, w, rows, _ = inputs
    ctx.save_for_backward(xe, w, rows)


def _backward(ctx, dy):
    xe, w, rows = ctx.saved_tensors
    dxe, dw = backward(xe, w, rows, dy)
    return dxe, dw, None, None


_op.register_autograd(_backward, setup_context=_setup_context)


def moe_gmm(xe: torch.Tensor, w: torch.Tensor, rows: torch.Tensor | None = None,
            active: int | None = None) -> torch.Tensor:
    """xe: (E, C, d); w: (E, d, f) -> (E, C, f) in the dtype of ``xe``.

    ``rows`` (E,) int32: the kept rows of each expert. Rows of ``xe[e]`` at or
    past ``rows[e]`` are taken as zero and their outputs are exact zeros; an
    expert with ``rows[e] == 0`` reads no weight. None keeps every row.
    ``active``: an upper bound on the experts with ``rows[e] > 0``, known
    from shapes (the MoE layer's ``min(E, N * k)``); it sizes the grid. Any
    value is correct, a tight one is fast; None means E.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version; a meta tensor returns an empty output of the right shape
    and reports the call to an active cost analysis. Under autograd the
    gradient of ``xe`` and ``w`` is :func:`backward`."""
    e = xe.shape[0]
    active = e if active is None else max(1, min(active, e))
    return _op(xe, w, rows, active)
