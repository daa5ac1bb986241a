"""Plain PyTorch versions of the kernels (the correctness references).

Each is the mathematically transparent dense formulation of what its kernel
computes — slow and memory-hungry by design. The kernel wrappers run these
for CPU tensors; the tests and ``chip_smoke.py`` hold the kernels against
them. Every call adds one to ``CALLS`` (under a lock: the scheduler's
dispatchers and the merger's canary thread run them concurrently) so a run
can show which path it took.
"""
from __future__ import annotations

import math
import threading

import torch

CALLS = {"mha_ref": 0, "mha_ref_bwd": 0, "decode_attn_ref": 0, "paged_decode_attn_ref": 0,
         "paged_chunk_attn_ref": 0, "gmm_ref": 0, "ssd_ref": 0}
_CALLS_LOCK = threading.Lock()


def _called(name: str) -> None:
    with _CALLS_LOCK:
        CALLS[name] += 1


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of fp32 ``scores`` where ``mask`` holds. A
    row with no valid entry gives exact zeros (the kernels' ``l == 0 -> 1``
    contract) instead of NaN."""
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.where(l == 0, torch.ones_like(l), l)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
            q_offset: int = 0) -> torch.Tensor:
    """q: (B, T, H, hd); k, v: (B, S, KV, hd) with H % KV == 0 -> (B, T, H, hd).
    Query head h reads kv head h // (H // KV). Scores in fp32; P is cast to
    the V dtype before PV."""
    _called("mha_ref")
    return _mha(q, k, v, causal, q_offset)


def _mha(q, k, v, causal: bool, q_offset: int = 0):
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, t, kv, h // kv, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * (1.0 / math.sqrt(hd))
    mask = torch.ones(t, s, dtype=torch.bool, device=q.device)
    if causal:
        qi = torch.arange(t, device=q.device) + q_offset
        mask = torch.arange(s, device=q.device)[None, :] <= qi[:, None]
    probs = _masked_softmax(scores, mask)
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype), v)
    return out.reshape(b, t, h, hd)


def mha_ref_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
                causal: bool = True):
    """The gradient of :func:`mha_ref` (K3's gradient, the plain version):
    (dq, dk, dv) of ``mha_ref(q, k, v)`` against the output gradient ``do``
    (B, T, H, hd), by ``torch.autograd.grad`` through the same formula in
    fp32 (the inputs widened first), returned in fp32. A kv head's dk and dv
    sum over its group of query heads."""
    _called("mha_ref_bwd")
    with torch.enable_grad():
        qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
        out = _mha(qf, kf, vf, causal)
        return torch.autograd.grad(out, (qf, kf, vf), do.float())


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cur_len: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k, v: (B, S, KV, hd); cur_len: (B,) -> (B, H, hd).
    Columns >= cur_len are masked; cur_len == 0 gives exact zeros."""
    _called("decode_attn_ref")
    return _decode_attn(q, k, v, cur_len)


def _decode_attn(q, k, v, cur_len):
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float()) * (1.0 / math.sqrt(hd))
    mask = torch.arange(s, device=q.device)[None, :] < cur_len[:, None].to(q.device)  # (B, S)
    probs = _masked_softmax(scores, mask[:, None, None, :])
    out = torch.einsum("bkgs,bskh->bkgh", probs.to(v.dtype), v)
    return out.reshape(b, h, hd)


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """pages: (P, page, KV, hd); block_table: (B, n) -> (B, n*page, KV, hd).

    Rebuilds each sequence's logical cache from its pages with one gather
    (garbage past the sequence's length: callers mask)."""
    b, n = block_table.shape
    _, page, kv, hd = pages.shape
    return pages[block_table.long()].reshape(b, n * page, kv, hd)


def paged_decode_attn_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          block_table: torch.Tensor, cur_len: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); pages: (P, page, KV, hd); block_table: (B, n) int32;
    cur_len: (B,) -> (B, H, hd). The gather, then :func:`decode_attn_ref`:
    columns >= cur_len are masked, cur_len == 0 gives exact zeros."""
    _called("paged_decode_attn_ref")
    k = gather_pages(k_pages, block_table)
    v = gather_pages(v_pages, block_table)
    return _decode_attn(q, k, v, cur_len)


def paged_chunk_attn_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                         block_table: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """q: (B, C, H, hd) — C prefill rows whose absolute positions begin at
    ``start`` (B,); pages: (P, page, KV, hd); block_table: (B, n) int32 ->
    (B, C, H, hd). The gather, then causal attention with a per-sequence
    query offset: row i sees the columns <= start + i, as
    ``full_attention(..., q_offset=start)`` computes it in the JAX package.
    ``start`` is read as a tensor, never on the host."""
    _called("paged_chunk_attn_ref")
    b, c, h, hd = q.shape
    k = gather_pages(k_pages, block_table)
    v = gather_pages(v_pages, block_table)
    s, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, c, kv, h // kv, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * (1.0 / math.sqrt(hd))
    rows = start.to(q.device).long()[:, None] + torch.arange(c, device=q.device)[None, :]  # (B, C)
    mask = torch.arange(s, device=q.device)[None, None, :] <= rows[:, :, None]  # (B, C, S)
    probs = _masked_softmax(scores, mask[:, None, None])
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype), v)
    return out.reshape(b, c, h, hd)


def gmm_ref(xe: torch.Tensor, w: torch.Tensor, rows: torch.Tensor | None = None) -> torch.Tensor:
    """Per-expert GEMM. xe: (E, C, d); w: (E, d, f) -> (E, C, f), accumulated
    in float32 and cast to the dtype of ``xe``. ``rows`` (E,): the kept rows
    of each expert; rows of ``xe[e]`` at or past ``rows[e]`` are masked to
    zero first (None keeps every row). Where those rows are zero already, the
    result equals the unmasked product bit for bit: each skipped product is
    0 * w."""
    _called("gmm_ref")
    if rows is not None:
        keep = torch.arange(xe.shape[1], device=xe.device)[None, :] < rows.to(xe.device)[:, None]
        xe = xe.masked_fill(~keep[:, :, None], 0)
    return torch.einsum("ecd,edf->ecf", xe.float(), w.float()).to(xe.dtype)


def ssd_ref(x: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor, dt: torch.Tensor,
            a_log: torch.Tensor, d_skip: torch.Tensor):
    """Naive O(T^2) SSD (the exact dual form, no chunking).

    x: (B,T,H,P); bm/cm: (B,T,G,N); dt: (B,T,H) fp32; a_log, d_skip: (H,)
    -> y (B,T,H,P) fp32 and the final state (B,H,P,N) fp32. Head h reads
    group h // (H // G). Decay factors are computed only where i >= j."""
    _called("ssd_ref")
    b, t, h, p = x.shape
    hpg = h // bm.shape[2]
    a = -torch.exp(a_log.float())
    dtf = dt.float()
    cum = torch.cumsum(dtf * a, dim=1)  # (B,T,H)
    # decay[i, j] = exp(cum_i - cum_j) for i >= j (the difference is positive
    # above the diagonal, where exp may overflow: masked before exp)
    li = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Ti, Tj, H)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    decay = torch.exp(torch.where(causal, li, torch.full_like(li, float("-inf"))))
    lmat = decay * dtf[:, None, :, :]  # (B,Ti,Tj,H)
    scores = torch.einsum("bign,bjgn->bijg", cm.float(), bm.float())
    scores = torch.repeat_interleave(scores, hpg, dim=3) * lmat
    xf = x.float()
    y = torch.einsum("bijh,bjhp->bihp", scores, xf)
    y = y + xf * d_skip.float()[None, None, :, None]
    w_j = torch.exp(cum[:, -1:, :] - cum) * dtf  # (B,T,H)
    bh = torch.repeat_interleave(bm, hpg, dim=2).float()  # (B,T,H,N)
    state = torch.einsum("bthp,bthn->bhpn", xf * w_j[..., None], bh)
    return y, state
