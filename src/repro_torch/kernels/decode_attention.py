"""K4: one-token GQA decode attention over a contiguous KV cache.

The hand-written Hopper kernel is ``csrc/decode_attention.cu``, an
instantiation of the split-K sweep of ``csrc/decode_split.cuh`` (shared with
K1): split-K in one launch. A thread-block cluster of ``min(8, ceil(S/64))``
blocks serves each (sequence, kv head), every block a contiguous run of
64-row tiles of the cache (so each K/V row is read once for its G query
heads, any G, and only rows below ``cur_len`` are read, on the device); rank
0 combines the blocks' partial softmax states through distributed shared
memory in rank order. The split depends on S only, and nothing is summed
with atomics, so two launches give equal bits. With ``return_lse`` rank 0
also writes each head's logsumexp of its scaled scores from the combine's
own running max and sum: the weight of the output when a cache whose
sequence is split over a mesh is attended rank by rank and the partial
outputs are combined (``models/sharded.py``). Its plain PyTorch version is
:func:`repro_torch.kernels.ref.decode_attn_ref` (and
:func:`~repro_torch.kernels.ref.decode_attn_lse_ref`), re-exported here as
:data:`plain` (and :data:`plain_lse`). It replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py: decode_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.ref import decode_attn_lse_ref as plain_lse
from repro_torch.kernels.ref import decode_attn_ref as plain

HEAD_DIMS = (64, 112, 128)


def _check(q, k, v, cur_len) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,H,hd), k/v (B,S,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head dim {HEAD_DIMS}, got {hd}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention kernel takes bfloat16, {name} is {x.dtype}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    rows = _batch_rows(k)
    if rows is None or rows != _batch_rows(v):
        raise ValueError(f"each sequence of k and v must be contiguous, the sequences whole rows apart, at least "
                         f"S rows and equally in both; got strides {k.stride()}, {v.stride()}")
    if cur_len.shape != (b,) or cur_len.dtype != torch.int32 or cur_len.device != q.device:
        raise ValueError(f"cur_len must be int32 of shape ({b},) on {q.device}")
    if not cur_len.is_contiguous():
        raise ValueError("cur_len must be contiguous")


def _batch_rows(k) -> int | None:
    """Rows of KV * hd between one sequence of ``k`` and the next, or None
    for a layout the kernel cannot read. Each sequence's (S, KV, hd) must be
    contiguous; the sequences may lie further apart than S rows (one layer
    of k requests' stacked caches, read in place)."""
    b, s, kv, hd = k.shape
    if any(n > 1 and st != want for n, st, want in zip(k.shape[1:], k.stride()[1:], (kv * hd, hd, 1))):
        return None
    if b == 1:
        return s
    if k.stride(0) % (kv * hd) or k.stride(0) < s * kv * hd:
        return None
    return k.stride(0) // (kv * hd)


def _launch(q, k, v, cur_len, lse):
    """One launch of the kernel on CUDA tensors; ``lse``: a (B, H) fp32
    output for the heads' logsumexp, or None."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check(q, k, v, cur_len)
    b, h, hd = q.shape
    out = torch.empty_like(q)
    cost.record("decode_attention", False, b=b, s=k.shape[1], h=h, kv=k.shape[2], hd=hd, with_lse=lse is not None)
    lib = build.load()
    err = lib.repro_decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cur_len.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, k.shape[1], _batch_rows(k), h, k.shape[2], hd,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "decode_attention launch")
    build.count_launch("decode_attention")
    return out


def _fake(q, k, lse: bool):
    if q.is_meta:  # the card's branch of a shape-only run
        b, h, hd = q.shape
        cost.record("decode_attention", True, b=b, s=k.shape[1], h=h, kv=k.shape[2], hd=hd, with_lse=lse)
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cur_len: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return plain(q, k, v, cur_len)
    return _launch(q, k, v, cur_len, None)


@_op.register_fake
def _(q, k, v, cur_len):
    return _fake(q, k, False)


@torch.library.custom_op("repro_torch::decode_attention_lse", mutates_args=())
def _op_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cur_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return plain_lse(q, k, v, cur_len)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return _launch(q, k, v, cur_len, lse), lse


@_op_lse.register_fake
def _(q, k, v, cur_len):
    return _fake(q, k, True), q.new_empty(q.shape[:2], dtype=torch.float32)


@_op.register_vmap
def _(info, in_dims, q, k, v, cur_len):
    """The mapped axis folds into B: one launch for every lane (the split
    depends on S only, so each lane gets the bits of its own launch). K and
    V fold as views where they can: one layer of the lanes' stacked caches
    is read in place, not copied."""
    q, cur_len = build.fold_lanes(info, (in_dims[0], in_dims[3]), q, cur_len)
    k, v = build.fold_lanes(info, in_dims[1:3], k, v, contiguous=False)
    if _batch_rows(k) is None or _batch_rows(k) != _batch_rows(v):  # e.g. K/V shared by the lanes
        k, v = k.contiguous(), v.contiguous()
    return build.unfold_lanes(info, _op(q, k, v, cur_len)), 0


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cur_len: torch.Tensor, return_lse: bool = False):
    """q: (B, H, hd); k, v: (B, S, KV, hd); cur_len: (B,) int32 -> (B, H, hd),
    and with ``return_lse`` each head's logsumexp of its scaled scores
    (B, H) fp32 (-inf where cur_len == 0).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version; a meta tensor returns an empty output of the right shape
    and reports the call to an active cost analysis. Under
    ``torch.func.vmap`` the lanes fold into B (without ``return_lse``)."""
    if q.device.type == "cuda":
        build.refuse_grad("decode_attention", q, k, v)
    return _op_lse(q, k, v, cur_len) if return_lse else _op(q, k, v, cur_len)
