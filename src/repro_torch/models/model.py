"""build_model(cfg) — the Model API for the block families (dense, MoE, VLM,
SSM), the hybrid family and the enc-dec (audio) family.

A Model exposes the programs (plain functions of parameter trees — exactly
what the Provuse platform deploys as FaaS functions):

  loss_fn(params, batch)            -> (loss, metrics)          [train]
  prefill_fn(params, batch)         -> (last_logits, cache)     [serve]
  decode_fn(params, batch, cache)   -> (logits, new_cache)      [serve]

``loss_fn`` trains every family the port serves (``tokens``, ``embeds``,
or ``src_embeds`` and ``tgt_tokens``): K3, K5 and K6 have gradients on the
card, and the MoE family's loss adds ``router_aux_weight`` times the MoE
layers' aux loss, as the reference's does.

plus ``cache_defs`` (the decode cache's ParamDef tree for a shape: the
dense KV cache, the SSM states, the hybrid's mix of both, or the enc-dec's
decoder self cache and cross K/V), ``input_defs`` / ``make_inputs`` (a
shape's request or batch, as ParamDefs and drawn from a seed) and ``init``
(seeded parameters on a device).

The audio family's frontend is a stub: a prompt is ``src_embeds`` (B, S, d)
frame embeddings and a BOS ``tokens`` (B, 1); the prefill encodes the
source, builds the decoder's cross K/V at the source length and decodes
the BOS into a ``ENCDEC_TGT_CACHE``-row self cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as ed
from repro_torch.models import hybrid as hy
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, embed_tokens, embedding_defs, norm_defs, unembed
from repro_torch.models.params import ParamDef, init_params

ENCDEC_TGT_CACHE = 4096  # decoder self-cache length for enc-dec decode cells
CE_CHUNK = 512
# the families build_model serves and loss_fn trains (all of them since K5's
# and K6's gradients)
TRAINED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    param_defs: Any
    init: Callable[..., Any]
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    cache_defs: Callable[[ShapeConfig], Any]
    input_defs: Callable[[ShapeConfig], Any]
    make_inputs: Callable[..., Any]


# ------------------------------------------------------------------ loss


def _ce_chunk(emb_params, h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one chunk: fp32 logits (B, c, V), their
    logsumexp less the target's logit."""
    logits = unembed(emb_params, h)
    lz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return torch.sum(lz - ll)


def chunked_ce(emb_params, hidden: torch.Tensor, targets: torch.Tensor, cfg: ModelConfig,
               chunk: int = CE_CHUNK) -> torch.Tensor:
    """Mean cross-entropy over sequence chunks: a (B, chunk, V) logits
    buffer replaces the (B, T, V) one, the largest buffer of a train step
    otherwise. Chunks are summed in order, as the reference's scan sums
    them; under autograd with ``cfg.remat`` each chunk's logits are
    recomputed in the backward."""
    b, t, _ = hidden.shape
    c = min(chunk, t)
    if t % c:
        c = t
    remat = cfg.remat and torch.is_grad_enabled() and hidden.requires_grad
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for h, y in zip(hidden.split(c, dim=1), targets.split(c, dim=1)):
        if remat:
            part = checkpoint(_ce_chunk, emb_params, h, y, use_reentrant=False, preserve_rng_state=False)
        else:
            part = _ce_chunk(emb_params, h, y)
        tot = tot + part
    return tot / (b * t)


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam not in TRAINED_FAMILIES:
        raise NotImplementedError(f"the port serves and trains the {', '.join(TRAINED_FAMILIES)} families, not {fam!r}")
    L = cfg.num_layers
    kind = tfm.layer_kind(cfg)
    defs: dict = {"embed": embedding_defs(cfg), "ln_f": norm_defs(cfg)}
    if fam == "hybrid":
        defs["hybrid"] = hy.hybrid_defs(cfg)
    elif fam == "audio":
        defs["encdec"] = ed.encdec_defs(cfg)
    else:
        defs["blocks"] = tfm.stack_block_defs(cfg, kind, L)

    def loss_fn(params, batch):
        """(loss, metrics): the mean next-token cross-entropy of ``batch``
        (``tokens`` or ``embeds``, or the enc-dec's ``src_embeds`` and
        ``tgt_tokens``, and ``targets``) plus ``router_aux_weight`` times
        the MoE aux loss; ``metrics`` holds ``ce``, ``loss`` and the MoE
        metrics summed over the layers (``moe_aux``, ``moe_dropped``; zeros
        without MoE layers), as the reference's."""
        if fam == "audio":
            enc = ed.encode(params["encdec"], batch["src_embeds"], cfg)
            tgt = embed_tokens(params["embed"], batch["tgt_tokens"])
            h = ed.decode_train(params["encdec"], tgt, enc, cfg)
            metrics = None
        else:
            if "embeds" in batch:  # vlm: stub frontend embeddings, in the weights' dtype
                x = batch["embeds"].to(params["embed"]["table"].dtype)
            else:
                x = embed_tokens(params["embed"], batch["tokens"])
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
            if fam == "hybrid":
                h, _ = hy.apply_hybrid_full(params["hybrid"], x, cfg, positions)
                metrics = None
            else:
                h, _, metrics = tfm.apply_stack_full(params["blocks"], x, cfg, kind, positions, causal=True)
        h = apply_norm(params["ln_f"], h, cfg)
        ce = chunked_ce(params["embed"], h, batch["targets"], cfg)
        if metrics is None:  # no MoE layer: the reference's zeros
            metrics = tfm.zero_metrics(h)
        loss = ce + cfg.router_aux_weight * metrics["moe_aux"]
        out = dict(metrics)
        out.update(ce=ce, loss=loss)
        return loss, out

    def prefill_fn(params, batch):
        if fam == "audio":  # encode, the cross K/V at the source length, then the BOS at position 0
            enc = ed.encode(params["encdec"], batch["src_embeds"], cfg)
            cross = ed.cross_kv_from_enc(params["encdec"], enc)
            b = enc.shape[0]
            shape = (cfg.num_decoder_layers, b, ENCDEC_TGT_CACHE, cfg.num_kv_heads, cfg.head_dim)
            # bf16 whatever the weights' dtype, as the reference's prefill_fn
            self_cache = {kv: torch.zeros(shape, dtype=torch.bfloat16, device=enc.device) for kv in ("k", "v")}
            cur = torch.zeros((b,), dtype=torch.int32, device=enc.device)
            src_len = torch.full((b,), enc.shape[1], dtype=torch.int32, device=enc.device)
            x = embed_tokens(params["embed"], batch["tokens"])  # (B, 1, d)
            h, new_self = ed.decoder_step(params["encdec"], x, self_cache, cross, cfg, cur, src_len)
            h = apply_norm(params["ln_f"], h, cfg)
            return unembed(params["embed"], h)[:, 0], {"self": new_self, "cross": cross}
        if "embeds" in batch:  # vlm: precomputed frontend embeddings
            x = batch["embeds"]
        else:
            x = embed_tokens(params["embed"], batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        if fam == "hybrid":
            h, cache = hy.apply_hybrid_full(params["hybrid"], x, cfg, positions, collect_cache=True)
        else:
            h, cache, _ = tfm.apply_stack_full(params["blocks"], x, cfg, kind, positions, causal=True,
                                               collect_cache=True)
        h = apply_norm(params["ln_f"], h[:, -1:], cfg)
        return unembed(params["embed"], h)[:, 0], cache  # last position only

    def decode_fn(params, batch, cache):
        x = embed_tokens(params["embed"], batch["tokens"])  # (B, 1, d)
        if fam == "hybrid":
            h, new_cache = hy.apply_hybrid_decode(params["hybrid"], x, cache, cfg, batch["cur_len"])
        elif fam == "audio":
            cross = cache["cross"]
            src_len = torch.full((x.shape[0],), cross["k"].shape[2], dtype=torch.int32, device=x.device)
            h, new_self = ed.decoder_step(params["encdec"], x, cache["self"], cross, cfg, batch["cur_len"],
                                          src_len)
            new_cache = {"self": new_self, "cross": cross}
        else:
            h, new_cache = tfm.apply_stack_decode(params["blocks"], x, cache, cfg, kind, batch["cur_len"])
        h = apply_norm(params["ln_f"], h, cfg)
        return unembed(params["embed"], h)[:, 0], new_cache

    def _attn_cache_defs(lead: tuple, batch: int, seq: int):
        sh = (*lead, batch, seq, cfg.num_kv_heads, cfg.head_dim)
        dt = getattr(torch, cfg.kv_cache_dtype)
        return {"k": ParamDef(sh, init="zeros", dtype=dt), "v": ParamDef(sh, init="zeros", dtype=dt)}

    def _ssm_cache_defs(lead: tuple, batch: int):
        return {name: ParamDef((*lead, *sh), init="zeros", dtype=dt)
                for name, (sh, dt) in ssm_mod.ssm_cache_shapes(cfg, batch).items()}

    def cache_defs(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        if fam == "ssm":
            return _ssm_cache_defs((L,), b)
        if fam == "hybrid":
            n_groups, every, tail = hy.split_layers(cfg)
            out = {"groups": _ssm_cache_defs((n_groups, every), b), "attn": _attn_cache_defs((n_groups,), b, s)}
            if tail:
                out["tail"] = _ssm_cache_defs((tail,), b)
            return out
        if fam == "audio":
            # the reference declares cross at s rows; a prefill builds it at
            # the source length (ServingEngine.prefill takes only "self")
            ld = cfg.num_decoder_layers
            return {"self": _attn_cache_defs((ld,), b, min(ENCDEC_TGT_CACHE, s)),
                    "cross": _attn_cache_defs((ld,), b, s)}
        return _attn_cache_defs((L,), b, s)

    def input_defs(shape: ShapeConfig):
        """The inputs of a ``train`` batch, a ``prefill`` request or a
        ``decode`` step at ``shape``, as ParamDefs (the reference's
        ``input_defs``)."""
        b, s = shape.global_batch, shape.seq_len
        tok = lambda t: ParamDef((b, t), init="zeros", dtype=torch.int32)  # noqa: E731
        emb = lambda t: ParamDef((b, t, cfg.d_model), init="normal", dtype=torch.bfloat16)  # noqa: E731
        if shape.kind == "train":
            if fam == "audio":
                return {"src_embeds": emb(s), "tgt_tokens": tok(s), "targets": tok(s)}
            if fam == "vlm":
                return {"embeds": emb(s), "targets": tok(s)}
            return {"tokens": tok(s), "targets": tok(s)}
        if shape.kind == "prefill":
            if fam == "audio":
                return {"src_embeds": emb(s), "tokens": tok(1)}
            if fam == "vlm":
                return {"embeds": emb(s)}
            return {"tokens": tok(s)}
        return {"tokens": tok(1), "cur_len": ParamDef((b,), init="zeros", dtype=torch.int32)}

    def make_inputs(shape: ShapeConfig, seed: int = 0, *, device=None):
        """``input_defs(shape)`` drawn from ``seed`` on ``device`` (default:
        the card): token ids uniform over the vocabulary, ``cur_len`` at
        ``seq_len - 2``, embeddings normal with std 0.02, as the reference
        draws them (with its own generator, so not its values)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out = {}
        for name, d in sorted(input_defs(shape).items()):
            if d.dtype == torch.int32 and name == "cur_len":
                out[name] = torch.full(d.shape, max(0, shape.seq_len - 2), dtype=torch.int32, device=dev)
            elif d.dtype == torch.int32:
                hi = max(2, cfg.vocab_size or 2)
                out[name] = torch.randint(0, hi, d.shape, generator=gen, dtype=torch.int32, device=dev)
            else:
                x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=dev)
                out[name] = (x * 0.02).to(d.dtype)
        return out

    return Model(
        cfg=cfg,
        param_defs=defs,
        init=lambda seed=0, *, device=None: init_params(defs, seed, device=device),
        loss_fn=loss_fn,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        cache_defs=cache_defs,
        input_defs=input_defs,
        make_inputs=make_inputs,
    )
