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
         "paged_chunk_attn_ref": 0, "gmm_ref": 0, "gmm_ref_bwd": 0, "ssd_ref": 0, "ssd_ref_bwd": 0}
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


def decode_attn_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cur_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_attn_ref` and each head's logsumexp of its scaled
    scores over the valid columns, (B, H) fp32 (-inf where cur_len == 0)."""
    _called("decode_attn_ref")
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    scores = torch.einsum("bkgh,bskh->bkgs", q.reshape(b, kv, h // kv, hd).float(), k.float()) * (1.0 / math.sqrt(hd))
    mask = torch.arange(s, device=q.device)[None, :] < cur_len[:, None].to(q.device)
    lse = torch.logsumexp(scores.masked_fill(~mask[:, None, None, :], float("-inf")), dim=-1)
    return _decode_attn(q, k, v, cur_len), lse.reshape(b, h)


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


def _kept(xe: torch.Tensor, rows: torch.Tensor | None) -> torch.Tensor | None:
    """(E, C, 1) bool: the rows of each expert below ``rows[e]`` (None: all)."""
    if rows is None:
        return None
    return (torch.arange(xe.shape[1], device=xe.device)[None, :] < rows.to(xe.device)[:, None])[:, :, None]


def gmm_ref_bwd(xe: torch.Tensor, w: torch.Tensor, rows: torch.Tensor | None, dy: torch.Tensor):
    """The gradient of :func:`gmm_ref` (K5's gradient, the plain version),
    written out: for ``dy`` (E, C, f),

        dxe[e] = dy[e] w[e]^T on the rows below rows[e], exact zeros past them
        dw[e]  = xe[e]^T dy[e] over the rows below rows[e]

    in fp32, returned in the dtypes of ``xe`` and ``w``. An expert with
    ``rows[e] == 0`` gets exact zeros in both."""
    _called("gmm_ref_bwd")
    keep = _kept(xe, rows)
    dyf = dy.float()
    if keep is not None:
        dyf = dyf.masked_fill(~keep, 0)
    xf = xe.float() if keep is None else xe.float().masked_fill(~keep, 0)
    dxe = torch.einsum("ecf,edf->ecd", dyf, w.float())
    dw = torch.einsum("ecd,ecf->edf", xf, dyf)
    return dxe.to(xe.dtype), dw.to(w.dtype)


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


def ssd_ref_bwd(x: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                d_skip: torch.Tensor, dy: torch.Tensor, dstate: torch.Tensor | None = None):
    """The gradient of :func:`ssd_ref` (K6's gradient, the plain version),
    written out in the same dense O(T^2) form: for the cotangents ``dy`` of y
    (B,T,H,P) and ``dstate`` of the final state (B,H,P,N) fp32 (None: zero),
    (dx, dbm, dcm, ddt, da_log, dd_skip) in the dtypes of the inputs.

    With cum_t = sum_{s<=t} a dt_s, E[i,j] = exp(cum_i - cum_j) for j <= i,
    L = E dt_j, CB = C_i.B_j, M = dy_i.x_j, A = L CB M, the state weights
    u_j = exp(cum_T - cum_j) (T the last row) and q_j = x_j.(dS B_j):

        dx_j  = D dy_j + sum_i L_ij CB_ij dy_i + u_j dt_j dS B_j
        dC_i  = sum_heads sum_j L_ij M_ij B_j
        dB_j  = sum_heads (sum_i L_ij M_ij C_i + u_j dt_j dS^T x_j)
        dcum_t = sum_j A_tj - sum_i A_it - u_t dt_t q_t + [t = T] sum_j u_j dt_j q_j
        ddt_s = sum_i E_is CB_is M_is + u_s q_s + a sum_{t>=s} dcum_t
        dA_log = a sum_{b,s} dt_s sum_{t>=s} dcum_t,   dD = sum_{b,t} dy.x

    (a head's dB and dC add up over the heads of its group)."""
    _called("ssd_ref_bwd")
    b, t, h, p = x.shape
    g = bm.shape[2]
    hpg = h // g
    a = -torch.exp(a_log.float())
    dtf = dt.float()
    xf, dyf = x.float(), dy.float()
    bh = torch.repeat_interleave(bm.float(), hpg, dim=2)  # (B,T,H,N)
    ch = torch.repeat_interleave(cm.float(), hpg, dim=2)
    cum = torch.cumsum(dtf * a, dim=1)  # (B,T,H)
    li = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Ti,Tj,H)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    e = torch.exp(torch.where(causal, li, torch.full_like(li, float("-inf"))))
    lm = e * dtf[:, None, :, :]
    cb = torch.einsum("bihn,bjhn->bijh", ch, bh)
    m = torch.einsum("bihp,bjhp->bijh", dyf, xf)
    lcb, lmm = lm * cb, lm * m
    u = torch.exp(cum[:, -1:, :] - cum)  # (B,T,H)
    ds = torch.zeros(b, h, p, bh.shape[-1], dtype=torch.float32, device=x.device) if dstate is None \
        else dstate.float()
    dsb = torch.einsum("bhpn,bthn->bthp", ds, bh)  # dS B_j
    dx = dyf * d_skip.float()[None, None, :, None] + torch.einsum("bijh,bihp->bjhp", lcb, dyf) \
        + (u * dtf)[..., None] * dsb
    dch = torch.einsum("bijh,bjhn->bihn", lmm, bh)
    dbh = torch.einsum("bijh,bihn->bjhn", lmm, ch) + (u * dtf)[..., None] * torch.einsum("bhpn,bthp->bthn", ds, xf)
    q = (xf * dsb).sum(-1)  # (B,T,H)
    am = lmm * cb
    dcum = am.sum(2) - am.sum(1) - u * dtf * q
    dcum[:, -1] += (u * dtf * q).sum(1)
    rcum = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])  # sum_{t>=s}
    ddt = (e * cb * m).sum(1) + u * q + a * rcum
    da_log = a * (dtf * rcum).sum((0, 1))
    dd = (dyf * xf).sum((0, 1, 3))
    dbm = dbh.reshape(b, t, g, hpg, -1).sum(3)
    dcm = dch.reshape(b, t, g, hpg, -1).sum(3)
    return (dx.to(x.dtype), dbm.to(bm.dtype), dcm.to(cm.dtype), ddt.to(dt.dtype), da_log.to(a_log.dtype),
            dd.to(d_skip.dtype))
