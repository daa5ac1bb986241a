"""Plain PyTorch versions of the kernels (the correctness references).

Each is the mathematically transparent dense formulation of what its kernel
computes — slow and memory-hungry by design. The kernel wrappers run these
for CPU tensors; the tests and ``chip_smoke.py`` hold the kernels against
them. Every call adds one to ``CALLS`` so a run can show which path it took.
"""
from __future__ import annotations

import math

import torch

CALLS = {"mha_ref": 0, "decode_attn_ref": 0}


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
    CALLS["mha_ref"] += 1
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


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cur_len: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k, v: (B, S, KV, hd); cur_len: (B,) -> (B, H, hd).
    Columns >= cur_len are masked; cur_len == 0 gives exact zeros."""
    CALLS["decode_attn_ref"] += 1
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float()) * (1.0 / math.sqrt(hd))
    mask = torch.arange(s, device=q.device)[None, :] < cur_len[:, None].to(q.device)  # (B, S)
    probs = _masked_softmax(scores, mask[:, None, None, :])
    out = torch.einsum("bkgs,bskh->bkgh", probs.to(v.dtype), v)
    return out.reshape(b, h, hd)
