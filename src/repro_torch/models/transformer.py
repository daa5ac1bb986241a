"""Pre-LN dense transformer blocks and layer stacks.

Layers are stacked on a leading 'layers' axis, as in the JAX package; where
JAX scans over that axis, the port runs a Python loop over layers.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_defs, norm_defs
from repro_torch.models.params import stack_defs


def block_defs(cfg: ModelConfig):
    return {
        "ln1": norm_defs(cfg),
        "attn": attn_mod.attn_defs(cfg),
        "ln2": norm_defs(cfg),
        "mlp": mlp_defs(cfg),
    }


def stack_block_defs(cfg: ModelConfig, n_layers: int):
    return stack_defs(block_defs(cfg), n_layers)


def _cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.kv_cache_dtype)


def apply_block_full(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                     causal: bool = True, collect_cache: bool = False):
    """Full-sequence block. Returns (x, (k, v) in the cache dtype, or None)."""
    h = apply_norm(params["ln1"], x, cfg)
    q, k, v = attn_mod.qkv_project(params["attn"], h, cfg, positions)
    out = attn_mod.full_attention(q, k, v, causal=causal)
    x = x + attn_mod.attn_output(params["attn"], out)
    entry = None
    if collect_cache:
        entry = (k.to(_cache_dtype(cfg)), v.to(_cache_dtype(cfg)))
    h = apply_norm(params["ln2"], x, cfg)
    x = x + apply_mlp(params["mlp"], h, cfg)
    return x, entry


def apply_block_decode(params, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                       cur_len: torch.Tensor):
    """Single-token block step. cache: {'k','v'} of shape (B, S, KV, hd).
    Returns (x, new cache) — new tensors, the input cache is not written."""
    positions = cur_len[:, None]  # (B, 1)
    h = apply_norm(params["ln1"], x, cfg)
    q, k_new, v_new = attn_mod.qkv_project(params["attn"], h, cfg, positions)
    k_cache, v_cache = attn_mod.update_kv_cache(cache["k"], cache["v"], k_new, v_new, positions)
    out = attn_mod.decode_attention(q, k_cache, v_cache, cur_len + 1)
    x = x + attn_mod.attn_output(params["attn"], out)
    h = apply_norm(params["ln2"], x, cfg)
    x = x + apply_mlp(params["mlp"], h, cfg)
    return x, {"k": k_cache, "v": v_cache}


def _layer(stacked_params, i: int):
    return tree.map(lambda a: a[i], stacked_params)


def _num_layers(stacked_params) -> int:
    return tree.leaves(stacked_params)[0].shape[0]


def apply_stack_full(stacked_params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                     causal: bool = True, collect_cache: bool = False):
    """Full-sequence pass through the stack. Returns (x, {'k','v'} stacked
    on a leading 'layers' axis, or None)."""
    ks, vs = [], []
    for i in range(_num_layers(stacked_params)):
        x, entry = apply_block_full(_layer(stacked_params, i), x, cfg, positions, causal, collect_cache)
        if collect_cache:
            ks.append(entry[0])
            vs.append(entry[1])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if collect_cache else None
    return x, cache


def apply_stack_decode(stacked_params, x: torch.Tensor, caches: dict, cfg: ModelConfig,
                       cur_len: torch.Tensor):
    """One decode step through the stack; caches have a leading 'layers' dim.
    Returns (x, new caches)."""
    ks, vs = [], []
    for i in range(_num_layers(stacked_params)):
        cache_i = {"k": caches["k"][i], "v": caches["v"][i]}
        x, new_cache = apply_block_decode(_layer(stacked_params, i), x, cache_i, cfg, cur_len)
        ks.append(new_cache["k"])
        vs.append(new_cache["v"])
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}
