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
        return {"scale": ParamDef((d,), ("embed",), init="ones")}
    return {"scale": ParamDef((d,), ("embed",), init="ones"), "bias": ParamDef((d,), ("embed",), init="zeros")}


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
            "wi_gate": ParamDef((d, f), ("embed_fsdp", "ff")),
            "wi_up": ParamDef((d, f), ("embed_fsdp", "ff")),
            "wo": ParamDef((f, d), ("ff", "embed_fsdp")),
        }
    return {"wi": ParamDef((d, f), ("embed_fsdp", "ff")), "wo": ParamDef((f, d), ("ff", "embed_fsdp"))}


# float32 values of the tanh GELU's temporaries at once: the activation runs
# over runs of rows of at most this many values (at least one row)
GELU_VALUES = 1 << 21


def apply_mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "wi_gate" in params:
        # the gate's fp32 activation in place, each (T, d_ff) temporary freed
        # as soon as the next is made: the same products, a third of the peak
        h = F.silu((x @ params["wi_gate"]).float(), inplace=True).to(x.dtype)
        h = h * (x @ params["wi_up"])
    else:
        h = x @ params["wi"]
        if torch.is_grad_enabled() and h.requires_grad:
            # under autograd the same values out of place: a product written
            # in place has no backward
            h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        else:
            # the tanh GELU in fp32, a run of rows at a time, written back
            # into the product: the same values without (T, d_ff) fp32
            # temporaries
            rows = h.view(-1, h.shape[-1])
            for part in rows.split(max(1, GELU_VALUES // h.shape[-1])):
                part.copy_(F.gelu(part.float(), approximate="tanh"))
    return h @ params["wo"]


# ---------------------------------------------------------------- embeddings


def embedding_defs(cfg: ModelConfig):
    defs = {"table": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed_fsdp"), init="embed")}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size), ("embed_fsdp", "vocab"))
    return defs


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["table"])


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Returns fp32 logits."""
    if "head" in params:
        return (x @ params["head"]).float()
    return (x @ params["table"].t()).float()
