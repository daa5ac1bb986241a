"""K1 and K2: GQA attention through a block table over the paged KV arena.

K1 ``paged_decode_attention`` (one query token per sequence, every batched
decode step of the continuous batcher) and K2 ``paged_chunk_attention`` (C
prefill rows from absolute position ``start``, every chunked-prefill chunk)
are hand-written Hopper kernels in ``csrc/paged_attention.cu`` (K1 is the
split-K sweep of ``csrc/decode_split.cuh``, shared with K4; K2 is the
query-tile sweep of ``csrc/flash_sweep.cuh``, shared with K3; both read
each row through the block table; any group of query heads); their plain
PyTorch versions are :func:`repro_torch.kernels.ref.paged_decode_attn_ref`
and :func:`repro_torch.kernels.ref.paged_chunk_attn_ref`, re-exported here
as :data:`plain_decode` and :data:`plain_chunk`. They replace the Pallas TPU
kernels ``repro/kernels/paged_attention.py: paged_decode_attention`` and
``paged_chunk_attention``. Any page size is taken (the JAX dispatch's
``% 128`` gate is a TPU lane rule).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.ref import paged_chunk_attn_ref as plain_chunk
from repro_torch.kernels.ref import paged_decode_attn_ref as plain_decode

HEAD_DIMS = (64, 128)


def _check_pages(q, k_pages, v_pages, block_table, lengths, name: str, len_name: str) -> None:
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected k/v pages (P,page,KV,hd); got {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    kv = k_pages.shape[2]
    if k_pages.shape[3] != hd or h % kv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and pages {tuple(k_pages.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head dim {HEAD_DIMS}, got {hd}")
    for arg, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.device != q.device:
            raise ValueError(f"{arg} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bfloat16, {arg} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{arg} must be contiguous and 16-byte aligned")
    if block_table.dim() != 2 or block_table.shape[0] != b or block_table.shape[1] < 1:
        raise ValueError(f"block_table must be (B={b}, n>=1), got {tuple(block_table.shape)}")
    for arg, x in (("block_table", block_table), (len_name, lengths)):
        if x.dtype != torch.int32 or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{arg} must be contiguous int32 on {q.device}")
    if lengths.shape != (b,):
        raise ValueError(f"{len_name} must have shape ({b},), got {tuple(lengths.shape)}")


@torch.library.custom_op("repro_torch::paged_decode_attention", mutates_args=())
def _decode_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
               block_table: torch.Tensor, cur_len: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return plain_decode(q, k_pages, v_pages, block_table, cur_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    if q.dim() != 3:
        raise ValueError(f"expected q (B,H,hd), got {tuple(q.shape)}")
    _check_pages(q, k_pages, v_pages, block_table, cur_len, "paged_decode_attention", "cur_len")
    b, h, hd = q.shape
    p, page, kv, _ = k_pages.shape
    out = torch.empty_like(q)
    cost.record("paged_decode_attention", False, b=b, n=block_table.shape[1], page=page, h=h, kv=kv, hd=hd)
    err = build.load().repro_paged_decode_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
        cur_len.data_ptr(), out.data_ptr(), b, p, page, block_table.shape[1], h, kv, hd,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "paged_decode_attention launch")
    build.count_launch("paged_decode_attention")
    return out


@_decode_op.register_fake
def _(q, k_pages, v_pages, block_table, cur_len):
    if q.is_meta:  # the card's branch of a shape-only run
        cost.record("paged_decode_attention", True, b=q.shape[0], n=block_table.shape[1], page=k_pages.shape[1],
                    h=q.shape[1], kv=k_pages.shape[2], hd=q.shape[2])
    return torch.empty_like(q)


@_decode_op.register_vmap
def _(info, in_dims, q, k_pages, v_pages, block_table, cur_len):
    """Lanes over one shared arena fold into B (one launch); lanes with
    arenas of their own launch once each."""
    if in_dims[1] is not None or in_dims[2] is not None:
        return build.per_lane(info, in_dims, _decode_op, q, k_pages, v_pages, block_table, cur_len)
    q, block_table, cur_len = build.fold_lanes(info, (in_dims[0], in_dims[3], in_dims[4]),
                                               q, block_table, cur_len)
    return build.unfold_lanes(info, _decode_op(q, k_pages, v_pages, block_table, cur_len)), 0


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_table: torch.Tensor, cur_len: torch.Tensor) -> torch.Tensor:
    """K1. q: (B, H, hd); pages: (P, page, KV, hd); block_table: (B, n)
    int32; cur_len: (B,) int32 -> (B, H, hd). Columns >= cur_len are masked;
    cur_len == 0 gives exact zeros.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version; a meta tensor returns an empty output of the right shape
    and reports the call to an active cost analysis."""
    if q.device.type == "cuda":
        build.refuse_grad("paged_decode_attention", q, k_pages, v_pages)
    return _decode_op(q, k_pages, v_pages, block_table, cur_len)


@torch.library.custom_op("repro_torch::paged_chunk_attention", mutates_args=())
def _chunk_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              block_table: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return plain_chunk(q, k_pages, v_pages, block_table, start)
    if q.device.type != "cuda":
        raise ValueError(f"paged_chunk_attention: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"expected q (B,C,H,hd), got {tuple(q.shape)}")
    _check_pages(q, k_pages, v_pages, block_table, start, "paged_chunk_attention", "start")
    b, c, h, hd = q.shape
    p, page, kv, _ = k_pages.shape
    out = torch.empty_like(q)
    if c == 0:
        return out
    cost.record("paged_chunk_attention", False, b=b, c=c, n=block_table.shape[1], page=page, h=h, kv=kv, hd=hd)
    err = build.load().repro_paged_chunk_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
        start.data_ptr(), out.data_ptr(), b, c, p, page, block_table.shape[1], h, kv, hd,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "paged_chunk_attention launch")
    build.count_launch("paged_chunk_attention")
    return out


@_chunk_op.register_fake
def _(q, k_pages, v_pages, block_table, start):
    b, c, h, hd = q.shape
    if q.is_meta and c:  # the card's branch of a shape-only run
        cost.record("paged_chunk_attention", True, b=b, c=c, n=block_table.shape[1], page=k_pages.shape[1], h=h,
                    kv=k_pages.shape[2], hd=hd)
    return torch.empty_like(q)


@_chunk_op.register_vmap
def _(info, in_dims, q, k_pages, v_pages, block_table, start):
    """As K1's rule: lanes over one shared arena fold into B."""
    if in_dims[1] is not None or in_dims[2] is not None:
        return build.per_lane(info, in_dims, _chunk_op, q, k_pages, v_pages, block_table, start)
    q, block_table, start = build.fold_lanes(info, (in_dims[0], in_dims[3], in_dims[4]),
                                             q, block_table, start)
    return build.unfold_lanes(info, _chunk_op(q, k_pages, v_pages, block_table, start)), 0


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          block_table: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """K2. q: (B, C, H, hd) — C prefill rows whose absolute positions begin
    at ``start`` (B,) int32; pages: (P, page, KV, hd); block_table: (B, n)
    int32 -> (B, C, H, hd). Row i attends the columns <= start + i.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version; a meta tensor returns an empty output of the right shape
    and reports the call to an active cost analysis."""
    if q.device.type == "cuda":
        build.refuse_grad("paged_chunk_attention", q, k_pages, v_pages)
    return _chunk_op(q, k_pages, v_pages, block_table, start)
