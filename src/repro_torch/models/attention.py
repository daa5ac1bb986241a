"""GQA/MQA attention: prefill over the whole prompt and one-token decode
against a dense KV cache.

The attention itself goes through ``repro_torch.kernels.ops``: the
hand-written kernels for CUDA tensors, their plain versions for CPU
tensors, empty outputs for the meta tensors of a shape-only run.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rms_norm_1d
from repro_torch.models.params import ParamDef


def attn_defs(cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h, hd)),
        "wk": ParamDef((d, kv, hd)),
        "wv": ParamDef((d, kv, hd)),
        "wo": ParamDef((h, hd, d)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), init="ones")
        defs["k_norm"] = ParamDef((hd,), init="ones")
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
    the cache it saw the first time."""
    b, t_new, kv, hd = k_new.shape
    idx = positions.long()[:, :, None, None].expand(b, t_new, kv, hd)
    k_cache = k_cache.scatter(1, idx, k_new.to(k_cache.dtype))
    v_cache = v_cache.scatter(1, idx, v_new.to(v_cache.dtype))
    return k_cache, v_cache
