"""Encoder-decoder transformer (SeamlessM4T-style backbone).

The modality frontend is a STUB, as in the JAX package: the prompt is
precomputed frame embeddings (B, S_src, d), which the encoder consumes
directly. Decoder = causal self-attention + cross-attention over encoder
states.

On the Provuse platform the encoder and decoder are deployed as two separate
functions — the decoder's blocking wait on encoder output is the canonical
synchronous edge the Function Handler detects.

The JAX package runs each stack with ``jax.lax.scan``; the port loops over
layers, as ``models/transformer.py`` does. Attention goes through the
kernel wrappers: the encoder's self-attention is K3 non-causal, the
decoder's cross-attention K4 at a decode step (over the source rows, with
``valid_src_len``) and K3 non-causal over a whole target (training).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, norm_defs
from repro_torch.models.params import ParamDef, stack_defs


def cross_attn_defs(cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamDef((d, h, hd), ("embed_fsdp", "heads", "head_dim")),
        "wk": ParamDef((d, kv, hd), ("embed_fsdp", "kv_heads", "head_dim")),
        "wv": ParamDef((d, kv, hd), ("embed_fsdp", "kv_heads", "head_dim")),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed_fsdp")),
    }


def decoder_block_defs(cfg: ModelConfig):
    defs = tfm.block_defs(cfg, "dense")
    defs["ln_cross"] = norm_defs(cfg)
    defs["cross"] = cross_attn_defs(cfg)
    return defs


def encdec_defs(cfg: ModelConfig):
    return {
        "encoder": stack_defs(tfm.block_defs(cfg, "dense"), cfg.num_layers),
        "decoder": stack_defs(decoder_block_defs(cfg), cfg.num_decoder_layers),
    }


def _apply_cross(params, x: torch.Tensor, enc_kv, cfg: ModelConfig, valid_src_len=None) -> torch.Tensor:
    """x: (B,T,d); enc_kv = (k, v): (B,S,KV,hd). One query row with
    ``valid_src_len`` (B,) attends through K4, anything else through K3
    non-causal."""
    h = apply_norm(params["ln_cross"], x, cfg)
    q = torch.einsum("btd,dhk->bthk", h, params["cross"]["wq"])
    if x.shape[1] == 1 and valid_src_len is not None:
        out = attn_mod.decode_attention(q, enc_kv[0], enc_kv[1], valid_src_len)
    else:
        out = attn_mod.full_attention(q, enc_kv[0], enc_kv[1], causal=False)
    return x + torch.einsum("bthk,hkd->btd", out, params["cross"]["wo"])


def _cross_kv(layer_params, enc: torch.Tensor):
    k = torch.einsum("bsd,dhk->bshk", enc, layer_params["cross"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc, layer_params["cross"]["wv"])
    return k, v


def encode(params, src: torch.Tensor, cfg: ModelConfig):
    """src: (B, S, d) frame embeddings -> encoder states (B, S, d), in the
    weights' dtype (the frames are cast to it, as the vlm's embeds are)."""
    src = src.to(params["encoder"]["attn"]["wq"].dtype)
    positions = torch.arange(src.shape[1], device=src.device)[None, :]
    x, _, _ = tfm.apply_stack_full(params["encoder"], src, cfg, "dense", positions, causal=False)
    return x


def cross_kv_from_enc(params, enc: torch.Tensor):
    """Project encoder states into per-decoder-layer cross K/V.
    Returns {'k','v'}: (L_dec, B, S, KV, hd) — the decode-time cross cache,
    in the encoder's dtype and at the source length."""
    ks, vs = zip(*(_cross_kv(lp, enc) for lp in tfm._layers(params["decoder"])))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _decoder_block_train(layer_params, h: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig,
                         positions: torch.Tensor) -> torch.Tensor:
    h, _, _ = tfm.apply_block_full(layer_params, h, cfg, "dense", positions, causal=True)
    return _apply_cross(layer_params, h, _cross_kv(layer_params, enc), cfg)


def decode_train(params, tgt_emb: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder over the full target. tgt_emb: (B, T, d).
    Under autograd with ``cfg.remat`` each layer (self-attention, MLP, the
    cross K/V projection and cross-attention) runs under
    ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of its
    scan body does."""
    positions = torch.arange(tgt_emb.shape[1], device=tgt_emb.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled() and (
        tgt_emb.requires_grad or enc.requires_grad
        or any(p.requires_grad for p in tree.leaves(params["decoder"])))
    x = tgt_emb
    for lp in tfm._layers(params["decoder"]):
        if remat:
            x = checkpoint(_decoder_block_train, lp, x, enc, cfg, positions, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _decoder_block_train(lp, x, enc, cfg, positions)
    return x


def decoder_step(params, x: torch.Tensor, self_cache: dict, cross_cache: dict, cfg: ModelConfig,
                 cur_len: torch.Tensor, src_len: torch.Tensor):
    """One decode token. self_cache k/v: (L,B,S_tgt,KV,hd); cross_cache k/v:
    (L,B,S_src,KV,hd); cur_len and src_len: (B,) int32. Returns (x, the new
    self cache); the cross cache is read only."""

    def cross(lp, i, h):
        return _apply_cross(lp, h, (cross_cache["k"][i], cross_cache["v"][i]), cfg, valid_src_len=src_len)

    return tfm.apply_stack_decode(params["decoder"], x, self_cache, cfg, "dense", cur_len, post=cross)
