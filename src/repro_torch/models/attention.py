"""GQA/MQA attention: prefill over the whole prompt and one-token decode
against a dense KV cache; one-token decode and chunked prefill against the
paged KV arena.

The attention itself goes through ``repro_torch.kernels.ops``: the
hand-written kernels for CUDA tensors, their plain versions for CPU
tensors, empty outputs for the meta tensors of a shape-only run.

The dense cache is never written in place (every update returns new
tensors). The paged arena IS written in place: JAX returns new page pools
from every step, but in eager torch an out-of-place scatter would copy the
whole pool per layer per step. The paged updates below therefore
``index_put_`` the new rows into the pool they are given, and read no
tensor value on the host, so a fused paged chain stays one unit.
"""
from __future__ import annotations

import torch

from repro_torch import donate
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rms_norm_1d
from repro_torch.models.params import ParamDef


def attn_defs(cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("embed_fsdp", "heads", "head_dim")),
        "wk": ParamDef((d, kv, hd), ("embed_fsdp", "kv_heads", "head_dim")),
        "wv": ParamDef((d, kv, hd), ("embed_fsdp", "kv_heads", "head_dim")),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed_fsdp")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
        defs["k_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
    return defs


def qkv_project(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor | None):
    """x: (B, T, d) -> q (B,T,H,hd), k/v (B,T,KV,hd); applies QK-norm + RoPE."""
    q = torch.einsum("btd,dhk->bthk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", x, params["wk"])
    v = torch.einsum("btd,dhk->bthk", x, params["wv"])
    if "q_norm" in params:
        q = rms_norm_1d(params["q_norm"], q)
        k = rms_norm_1d(params["k_norm"], k)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """Prompt attention from position 0. q: (B,T,H,hd); k,v: (B,S,KV,hd) -> (B,T,H,hd)."""
    return kops.attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: torch.Tensor) -> torch.Tensor:
    """One-token attention over a dense KV cache.

    q: (B,1,H,hd); caches: (B,S,KV,hd); cur_len: (B,) valid lengths
    (positions < cur_len attend)."""
    if k_cache.dtype != q.dtype:
        # quantized (e.g. fp8) KV cache: widen to the compute dtype
        k_cache = k_cache.to(q.dtype)
        v_cache = v_cache.to(q.dtype)
    out = kops.decode_attention(q[:, 0].contiguous(), k_cache.contiguous(), v_cache.contiguous(), cur_len)
    return out[:, None]


def attn_output(params, attn: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bthk,hkd->btd", attn, params["wo"])


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, positions: torch.Tensor):
    """Scatter new K/V rows (B, T_new, KV, hd) into caches at ``positions``
    (B, T_new). Returns NEW cache tensors and leaves the inputs untouched,
    as the JAX version does: a canary replay of the same request must see
    the cache it saw the first time. When the inputs are donated (a captured
    graph's own static inputs, :mod:`repro_torch.donate`), the rows go into
    the given caches in place and those are returned."""
    b, t_new, kv, hd = k_new.shape
    if donate.donated():  # index_put_ has a vmap rule (scatter_ would loop over the lanes)
        rows = (torch.arange(b, device=k_new.device)[:, None].expand(b, t_new), positions.long())
        return (k_cache.index_put_(rows, k_new.to(k_cache.dtype)),
                v_cache.index_put_(rows, v_new.to(v_cache.dtype)))
    idx = positions.long()[:, :, None, None].expand(b, t_new, kv, hd)
    k_cache = k_cache.scatter(1, idx, k_new.to(k_cache.dtype))
    v_cache = v_cache.scatter(1, idx, v_new.to(v_cache.dtype))
    return k_cache, v_cache


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_table: torch.Tensor, cur_len: torch.Tensor) -> torch.Tensor:
    """One-token attention over a paged KV arena.

    q: (B,1,H,hd); pages: (P, page, KV, hd); block_table: (B, n) int32 rows
    of physical page ids (padded entries point at the arena's scratch page);
    cur_len: (B,) valid lengths -> (B,1,H,hd)."""
    if k_pages.dtype != q.dtype:
        k_pages = k_pages.to(q.dtype)  # quantized KV: widen (off the bf16 main path)
        v_pages = v_pages.to(q.dtype)
    out = kops.paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages, block_table, cur_len)
    return out[:, None]


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          block_table: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Causal attention for one chunked-prefill block over a paged arena.

    q: (1, C, H, hd) — C chunk rows whose absolute positions begin at
    ``start`` (shape (1,) int32); pages: (P, page, KV, hd); block_table:
    (1, n). Each chunk row attends to every position <= its own absolute
    position, exactly like the matching rows of a dense causal prefill."""
    if k_pages.dtype != q.dtype:
        k_pages = k_pages.to(q.dtype)
        v_pages = v_pages.to(q.dtype)
    return kops.paged_chunk_attention(q.contiguous(), k_pages, v_pages, block_table, start)


def update_paged_kv(k_pages: torch.Tensor, v_pages: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, block_table: torch.Tensor, cur_len: torch.Tensor):
    """Write one new K/V token (B, 1, KV, hd) IN PLACE into the page arena at
    each sequence's write position: physical page ``bt[b, cur//page]``, row
    ``cur % page``. Masked slots carry an all-scratch block-table row with
    ``cur_len == 0``, so their write lands in the reserved scratch page
    (several slots may write it at once; no live row reads it). Returns the
    same two tensors."""
    page, n = k_pages.shape[1], block_table.shape[1]
    cur = cur_len.long()
    logical = (cur // page).clamp(0, n - 1)  # a gather clamps, as in JAX
    phys = torch.gather(block_table, 1, logical[:, None])[:, 0].long()  # (B,)
    slot = cur % page
    k_pages.index_put_((phys, slot), k_new[:, 0].to(k_pages.dtype))
    v_pages.index_put_((phys, slot), v_new[:, 0].to(v_pages.dtype))
    return k_pages, v_pages


def update_paged_kv_chunk(k_pages: torch.Tensor, v_pages: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, block_table: torch.Tensor, start: torch.Tensor,
                          valid: torch.Tensor):
    """Write one prefill chunk's K/V rows (1, C, KV, hd) IN PLACE into the
    page arena: chunk row i lands at logical position ``start + i`` ->
    physical page ``bt[0, (start+i)//page]``, slot ``(start+i) % page``. Rows
    at ``i >= valid`` are padding (the chunk is padded to a power of two):
    their writes go to the reserved scratch page, the same contract as a
    masked decode slot. ``start`` and ``valid`` are (1,) tensors, read as
    tensors. Returns the same two tensors."""
    page, n = k_pages.shape[1], block_table.shape[1]
    c = k_new.shape[1]
    idx = torch.arange(c, device=k_new.device)
    pos = start.long()[0] + idx
    logical = (pos // page).clamp(0, n - 1)
    phys = torch.where(idx < valid.long()[0], block_table[0].long()[logical], 0)  # (C,)
    slot = pos % page
    k_pages.index_put_((phys, slot), k_new[0].to(k_pages.dtype))
    v_pages.index_put_((phys, slot), v_new[0].to(v_pages.dtype))
    return k_pages, v_pages
