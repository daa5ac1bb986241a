"""build_model(cfg) — the Model API for the block families (dense, MoE, VLM).

A Model exposes the serving programs (plain functions of parameter trees —
exactly what the Provuse platform deploys as FaaS functions):

  prefill_fn(params, batch)         -> (last_logits, cache)
  decode_fn(params, batch, cache)   -> (logits, new_cache)

plus ``cache_defs`` (the dense KV cache's ParamDef tree for a shape) and
``init`` (seeded parameters on a device).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, embed_tokens, embedding_defs, norm_defs, unembed
from repro_torch.models.params import ParamDef, init_params


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    param_defs: Any
    init: Callable[..., Any]
    prefill_fn: Callable
    decode_fn: Callable
    cache_defs: Callable[[ShapeConfig], Any]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"the port serves the dense, moe and vlm families, not {cfg.family!r}")
    L = cfg.num_layers
    kind = tfm.layer_kind(cfg)
    defs: dict = {
        "embed": embedding_defs(cfg),
        "ln_f": norm_defs(cfg),
        "blocks": tfm.stack_block_defs(cfg, kind, L),
    }

    def prefill_fn(params, batch):
        if "embeds" in batch:  # vlm: precomputed frontend embeddings
            x = batch["embeds"]
        else:
            x = embed_tokens(params["embed"], batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        h, cache = tfm.apply_stack_full(params["blocks"], x, cfg, kind, positions, causal=True,
                                        collect_cache=True)
        h = apply_norm(params["ln_f"], h[:, -1:], cfg)
        return unembed(params["embed"], h)[:, 0], cache  # last position only

    def decode_fn(params, batch, cache):
        x = embed_tokens(params["embed"], batch["tokens"])  # (B, 1, d)
        h, new_cache = tfm.apply_stack_decode(params["blocks"], x, cache, cfg, kind, batch["cur_len"])
        h = apply_norm(params["ln_f"], h, cfg)
        return unembed(params["embed"], h)[:, 0], new_cache

    def cache_defs(shape: ShapeConfig):
        sh = (L, shape.global_batch, shape.seq_len, cfg.num_kv_heads, cfg.head_dim)
        dt = getattr(torch, cfg.kv_cache_dtype)
        return {"k": ParamDef(sh, init="zeros", dtype=dt), "v": ParamDef(sh, init="zeros", dtype=dt)}

    return Model(
        cfg=cfg,
        param_defs=defs,
        init=lambda seed=0, *, device=None: init_params(defs, seed, device=device),
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        cache_defs=cache_defs,
    )
