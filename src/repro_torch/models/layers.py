"""Shared neural-net layers: norms, rotary embedding, MLPs, embeddings.

Pure-functional style: ``*_defs(cfg)`` returns a ParamDef tree, ``fn(params,
x, ...)`` applies it. Compute is bf16 with fp32 inside norms and RoPE, as in
the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamDef

# ---------------------------------------------------------------- norms


def norm_defs(cfg: ModelConfig, d: int | None = None):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": ParamDef((d,), init="ones")}
    return {"scale": ParamDef((d,), init="ones"), "bias": ParamDef((d,), init="zeros")}


def apply_norm(params, x: torch.Tensor, cfg: ModelConfig, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if "bias" in params:  # LayerNorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:  # RMSNorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


def rms_norm_1d(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Headwise RMSNorm (QK-norm): normalizes the trailing dim."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------- rotary


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- mlp


def mlp_defs(cfg: ModelConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":  # SwiGLU: gate + up + down
        return {
            "wi_gate": ParamDef((d, f)),
            "wi_up": ParamDef((d, f)),
            "wo": ParamDef((f, d)),
        }
    return {"wi": ParamDef((d, f)), "wo": ParamDef((f, d))}


def apply_mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "wi_gate" in params:
        g = x @ params["wi_gate"]
        u = x @ params["wi_up"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu((x @ params["wi"]).float(), approximate="tanh").to(x.dtype)
    return h @ params["wo"]


# ---------------------------------------------------------------- embeddings


def embedding_defs(cfg: ModelConfig):
    defs = {"table": ParamDef((cfg.vocab_size, cfg.d_model), init="embed")}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size))
    return defs


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["table"])


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Returns fp32 logits."""
    if "head" in params:
        return (x @ params["head"]).float()
    return (x @ params["table"].t()).float()
