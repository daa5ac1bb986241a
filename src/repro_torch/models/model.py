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

from repro_torch import donate
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as ed
from repro_torch.models import hybrid as hy
from repro_torch.models import sharded
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, embed_tokens, embedding_defs, norm_defs, unembed
from repro_torch.models.params import ParamDef, init_params
from repro_torch.sharding import spmd

ENCDEC_TGT_CACHE = 4096  # decoder self-cache length for enc-dec decode cells
# the logical axes of an SSM layer's cache leaves (the reference's model.py)
SSM_CACHE_LOGICAL = {
    "ssd": ("batch", "ssm_heads", None, None),
    "conv_x": ("batch", "conv_k", "ssm_inner"),
    "conv_B": ("batch", "conv_k", None, "ssm_state"),
    "conv_C": ("batch", "conv_k", None, "ssm_state"),
}
CE_CHUNK = 512
# the families build_model serves and loss_fn trains (all of them since K5's
# and K6's gradients)
TRAINED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
# the families whose programs run on a mesh (build_model(cfg, rules))
MESH_FAMILIES = ("dense", "moe", "vlm")


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


def _ce_chunk(emb_params, h: torch.Tensor, y: torch.Tensor, specs=spmd.NO_SPEC,
              rank: spmd.Rank = spmd.SINGLE) -> torch.Tensor:
    """Summed cross-entropy of one chunk: fp32 logits (B, c, V), their
    logsumexp less the target's logit (over the rank's vocab slice on a
    mesh that splits it)."""
    logits, split = sharded.logits_local(rank.ctx, emb_params, specs, h, rank.act.batch)
    if split:
        return sharded.split_vocab_ce(rank.ctx, logits, y)
    lz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return torch.sum(lz - ll)


def chunked_ce(emb_params, hidden: torch.Tensor, targets: torch.Tensor, cfg: ModelConfig,
               chunk: int = CE_CHUNK, specs=spmd.NO_SPEC, rank: spmd.Rank = spmd.SINGLE) -> torch.Tensor:
    """Mean cross-entropy over sequence chunks: a (B, chunk, V) logits
    buffer replaces the (B, T, V) one, the largest buffer of a train step
    otherwise. Chunks are summed in order, as the reference's scan sums
    them; under autograd with ``cfg.remat`` each chunk's logits are
    recomputed in the backward. On a mesh (``rank``), the rank's
    (B_l, T_l, d) ``hidden``: its sequence is gathered and each chunk's
    logits taken over the rank's vocab slice, and the mean is over the
    whole batch."""
    ctx, act = rank.ctx, rank.act
    b, t = rank.stream_shape(hidden)[:2]
    hidden = sharded.enter(ctx, hidden, act, sharded.vocab_split(emb_params, specs))
    targets = ctx.all_gather(targets, 1, act.seq)
    c = min(chunk, t)
    if t % c:
        c = t
    remat = cfg.remat and torch.is_grad_enabled() and hidden.requires_grad
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for h, y in zip(hidden.split(c, dim=1), targets.split(c, dim=1)):
        if remat:
            part = checkpoint(_ce_chunk, emb_params, h, y, specs, rank, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            part = _ce_chunk(emb_params, h, y, specs, rank)
        tot = tot + part
    return ctx.reduce(tot, act.batch) / (b * t)


def build_model(cfg: ModelConfig, rules=None) -> Model:
    """The model of ``cfg``; with ``rules`` (``sharding.specs``, made on a
    ``DeviceMesh``) its programs run on the mesh, each rank on its shards
    (``models/sharded.py``): the dense, vlm and MoE families."""
    fam = cfg.family
    if fam not in TRAINED_FAMILIES:
        raise NotImplementedError(f"the port serves and trains the {', '.join(TRAINED_FAMILIES)} families, not {fam!r}")
    if rules is not None and fam not in MESH_FAMILIES:
        raise NotImplementedError(f"the {fam} family on a mesh is ROADMAP Queue 1 item 16; the port runs "
                                  f"{', '.join(MESH_FAMILIES)} on one")
    L = cfg.num_layers
    kind = tfm.layer_kind(cfg)
    defs: dict = {"embed": embedding_defs(cfg), "ln_f": norm_defs(cfg)}
    if fam == "hybrid":
        defs["hybrid"] = hy.hybrid_defs(cfg)
    elif fam == "audio":
        defs["encdec"] = ed.encdec_defs(cfg)
    else:
        defs["blocks"] = tfm.stack_block_defs(cfg, kind, L)

    def on_rank(trees: tuple, batch_at: int, name: str, b: int, t: int):
        """(the trees' tensors, their specs, the ``spmd.Rank``) this rank
        runs the program with: each ``DTensor``'s shard on a mesh, the trees
        as given on one device."""
        if rules is None:
            return trees, (spmd.NO_SPEC,) * len(trees), spmd.SINGLE
        return sharded.on_rank(rules, trees, batch_at, name, b, t, cfg.d_model)

    def embed(params, batch, specs, rank):
        return sharded.embed(rank.ctx, params["embed"], specs["embed"], batch["tokens"], rank.act)

    def norm_f(params, specs, h, rank):
        return apply_norm(rank.ctx.params(params["ln_f"], specs["ln_f"], rank.act.axes), h, cfg)

    def logits_of(params, specs, h, rank):
        """(B, V) fp32 logits of the (B, 1, d) ``h`` (the rank's (B_l, V_l) on a mesh)."""
        return sharded.logits_local(rank.ctx, params["embed"], specs["embed"], h, rank.act.batch)[0][:, 0]

    def logits_out(logits, specs, rank):
        if rules is None:
            return logits
        return sharded.logits_out(logits, specs["embed"], rank, cfg.vocab_size)

    def loss_fn(params, batch):
        """(loss, metrics): the mean next-token cross-entropy of ``batch``
        (``tokens`` or ``embeds``, or the enc-dec's ``src_embeds`` and
        ``tgt_tokens``, and ``targets``) plus ``router_aux_weight`` times
        the MoE aux loss; ``metrics`` holds ``ce``, ``loss`` and the MoE
        metrics summed over the layers (``moe_aux``, ``moe_dropped``; zeros
        without MoE layers), as the reference's. On a mesh the loss and the
        metrics are the same plain 0-d tensors on every rank."""
        specs, rank = spmd.NO_SPEC, spmd.SINGLE
        if fam == "audio":
            enc = ed.encode(params["encdec"], batch["src_embeds"], cfg)
            tgt = embed_tokens(params["embed"], batch["tgt_tokens"])
            h = ed.decode_train(params["encdec"], tgt, enc, cfg)
            metrics = None
        else:
            b, t = batch["targets"].shape
            (params, batch), (specs, _), rank = on_rank((params, batch), 1, "targets", b, t)
            if "embeds" in batch:  # vlm: stub frontend embeddings, in the weights' dtype
                x = batch["embeds"].to(params["embed"]["table"].dtype)
            else:
                x = embed(params, batch, specs, rank)
            positions = torch.arange(t, device=x.device)[None, :]
            if fam == "hybrid":
                h, _ = hy.apply_hybrid_full(params["hybrid"], x, cfg, positions)
                metrics = None
            else:
                h, _, metrics = tfm.apply_stack_full(params["blocks"], x, cfg, kind, positions, causal=True,
                                                     specs=specs["blocks"], rank=rank)
        h = norm_f(params, specs, h, rank)
        ce = chunked_ce(params["embed"], h, batch["targets"], cfg, specs=specs["embed"], rank=rank)
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
        name = "embeds" if "embeds" in batch else "tokens"
        b, t = batch[name].shape[:2]
        (params, batch), (specs, _), rank = on_rank((params, batch), 1, name, b, t)
        if "embeds" in batch:  # vlm: precomputed frontend embeddings
            x = batch["embeds"]
        else:
            x = embed(params, batch, specs, rank)
        positions = torch.arange(t, device=x.device)[None, :]
        if fam == "hybrid":
            h, cache = hy.apply_hybrid_full(params["hybrid"], x, cfg, positions, collect_cache=True)
        else:
            h, cache, _ = tfm.apply_stack_full(params["blocks"], x, cfg, kind, positions, causal=True,
                                               collect_cache=True, specs=specs["blocks"], rank=rank)
        # the last position only: the last 'model' rank's last row when the sequence is split
        h = rank.ctx.all_gather(h[:, -1:], 1, rank.act.seq)[:, -1:]
        logits = logits_of(params, specs, norm_f(params, specs, h, rank), rank)
        if rules is not None:
            cspec = spmd.Spec(((), *sharded.cache_spec(rules, b, t, cfg)))
            cshape = (cfg.num_layers, b, t, cfg.num_kv_heads, cfg.head_dim)
            cache = {k: sharded.wrap(v, cspec, rules.mesh, cshape) for k, v in cache.items()}
        return logits_out(logits, specs, rank), cache

    def decode_fn(params, batch, cache):
        b = batch["tokens"].shape[0]
        (params, batch, local_cache), (specs, _, cache_specs), rank = on_rank((params, batch, cache), 1,
                                                                              "tokens", b, 1)
        x = embed(params, batch, specs, rank)  # (B, 1, d)
        if fam == "hybrid":
            h, new_cache = hy.apply_hybrid_decode(params["hybrid"], x, cache, cfg, batch["cur_len"])
        elif fam == "audio":
            cross = cache["cross"]
            src_len = torch.full((x.shape[0],), cross["k"].shape[2], dtype=torch.int32, device=x.device)
            h, new_self = ed.decoder_step(params["encdec"], x, cache["self"], cross, cfg, batch["cur_len"],
                                          src_len)
            new_cache = {"self": new_self, "cross": cross}
        else:
            h, new_cache = tfm.apply_stack_decode(params["blocks"], x, local_cache, cfg, kind, batch["cur_len"],
                                                  specs=specs["blocks"], cache_specs=cache_specs, rank=rank)
            if rules is not None:  # donated: the caches were written in place
                new_cache = cache if donate.donated() else {
                    k: sharded.wrap(v, cache_specs[k], rules.mesh, cache[k].shape) for k, v in new_cache.items()}
        logits = logits_of(params, specs, norm_f(params, specs, h, rank), rank)
        return logits_out(logits, specs, rank), new_cache

    def _attn_cache_defs(lead: tuple, lead_logical: tuple, batch: int, seq: int):
        sh = (*lead, batch, seq, cfg.num_kv_heads, cfg.head_dim)
        lg = (*lead_logical, "batch", "cache_seq", "cache_kv_heads", "head_dim")
        dt = getattr(torch, cfg.kv_cache_dtype)
        return {"k": ParamDef(sh, lg, init="zeros", dtype=dt), "v": ParamDef(sh, lg, init="zeros", dtype=dt)}

    def _ssm_cache_defs(lead: tuple, lead_logical: tuple, batch: int):
        return {name: ParamDef((*lead, *sh), (*lead_logical, *SSM_CACHE_LOGICAL[name]), init="zeros", dtype=dt)
                for name, (sh, dt) in ssm_mod.ssm_cache_shapes(cfg, batch).items()}

    def cache_defs(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        if fam == "ssm":
            return _ssm_cache_defs((L,), ("layers",), b)
        if fam == "hybrid":
            n_groups, every, tail = hy.split_layers(cfg)
            out = {"groups": _ssm_cache_defs((n_groups, every), ("groups", "inner"), b),
                   "attn": _attn_cache_defs((n_groups,), ("groups",), b, s)}
            if tail:
                out["tail"] = _ssm_cache_defs((tail,), ("inner",), b)
            return out
        if fam == "audio":
            # the reference declares cross at s rows; a prefill builds it at
            # the source length (ServingEngine.prefill takes only "self")
            ld = cfg.num_decoder_layers
            return {"self": _attn_cache_defs((ld,), ("layers",), b, min(ENCDEC_TGT_CACHE, s)),
                    "cross": _attn_cache_defs((ld,), ("layers",), b, s)}
        return _attn_cache_defs((L,), ("layers",), b, s)

    def input_defs(shape: ShapeConfig):
        """The inputs of a ``train`` batch, a ``prefill`` request or a
        ``decode`` step at ``shape``, as ParamDefs (the reference's
        ``input_defs``)."""
        b, s = shape.global_batch, shape.seq_len
        tok = lambda t: ParamDef((b, t), ("batch", "seq"), init="zeros", dtype=torch.int32)  # noqa: E731
        tok1 = ParamDef((b, 1), ("batch", None), init="zeros", dtype=torch.int32)
        emb = lambda t: ParamDef((b, t, cfg.d_model), ("batch", "seq", None), init="normal",  # noqa: E731
                                 dtype=torch.bfloat16)
        if shape.kind == "train":
            if fam == "audio":
                return {"src_embeds": emb(s), "tgt_tokens": tok(s), "targets": tok(s)}
            if fam == "vlm":
                return {"embeds": emb(s), "targets": tok(s)}
            return {"tokens": tok(s), "targets": tok(s)}
        if shape.kind == "prefill":
            if fam == "audio":
                return {"src_embeds": emb(s), "tokens": tok1}
            if fam == "vlm":
                return {"embeds": emb(s)}
            return {"tokens": tok(s)}
        return {"tokens": tok1, "cur_len": ParamDef((b,), ("batch",), init="zeros", dtype=torch.int32)}

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
