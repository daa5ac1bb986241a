"""Pre-LN transformer blocks (dense, MoE or Mamba-2 SSM) and layer stacks.

Layers are stacked on a leading 'layers' axis, as in the JAX package; where
JAX scans over that axis, the port runs a Python loop over layers. The
paged steps write each layer's slice of the arena in place (where JAX
carries the pool through its scan and updates it there), so the pool stays
one buffer through the stack.

A block's ``kind`` is "dense" (SwiGLU MLP), "moe" (the MoE layer in the
MLP's place) or "ssm" (a pre-norm Mamba-2 mixer, no attention and no MLP),
as in the JAX package. An attention block's cache entry is (k, v); an SSM
block's is its state dict (``models/ssm.py: ssm_cache_shapes``), which has
no pages. A full-sequence pass returns the MoE layers' metrics (aux loss,
drop share) summed over the layers, as the reference's stack does (None for
a stack without an MoE layer, where the reference's are zeros); the serve
paths discard them, as the JAX serving engine does.

Under autograd (training), a full-sequence pass takes each layer's slice of
the stacked parameters once (one ``unbind`` per leaf, whose backward builds
the stacked gradient with one stack), and with ``cfg.remat`` runs each
block under ``torch.utils.checkpoint``: the block's activations are dropped
after the forward and recomputed in the backward, as the reference's
``jax.checkpoint`` of its scan body does.

The attention blocks, their stacks and the decode step are also each rank's
program on a mesh: given the parameters' ``specs`` and an ``spmd.Rank``
they run on the rank's shards and move data at the reference's ``shard_as``
sites through ``models/sharded.py``; with the defaults (``spmd.NO_SPEC``,
``spmd.SINGLE``) each of those moves is the identity.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import donate, tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharded
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_defs, norm_defs
from repro_torch.models.params import stack_defs
from repro_torch.sharding import spmd
from repro_torch.sharding.specs import shard_as_bf16_grad


def block_defs(cfg: ModelConfig, kind: str):
    """kind: dense | moe | ssm"""
    if kind == "ssm":
        return {"ln1": norm_defs(cfg), "ssm": ssm_mod.ssm_defs(cfg)}
    defs = {
        "ln1": norm_defs(cfg),
        "attn": attn_mod.attn_defs(cfg),
        "ln2": norm_defs(cfg),
    }
    if kind == "moe":
        defs["moe"] = moe_mod.moe_defs(cfg)
    else:
        defs["mlp"] = mlp_defs(cfg)
    return defs


def layer_kind(cfg: ModelConfig) -> str:
    if cfg.family == "ssm":
        return "ssm"
    return "moe" if cfg.family == "moe" else "dense"


def stack_block_defs(cfg: ModelConfig, kind: str, n_layers: int):
    return stack_defs(block_defs(cfg, kind), n_layers)


def _norm(params, specs, x: torch.Tensor, cfg: ModelConfig, rank: spmd.Rank) -> torch.Tensor:
    return apply_norm(rank.ctx.params(params, specs, rank.act.axes), x, cfg)


def _ffn(params, h: torch.Tensor, cfg: ModelConfig, kind: str, specs=spmd.NO_SPEC,
         rank: spmd.Rank = spmd.SINGLE):
    """The block's second half: (the MoE layer's or the dense MLP's output,
    the MoE layer's metrics or None)."""
    if kind == "moe":
        return moe_mod.apply_moe_local(params["moe"], specs["moe"], h, cfg, rank)
    ctx, act = rank.ctx, rank.act
    split = sharded.split_over_model(specs["mlp"]["wo"], 0)
    w = ctx.params(params["mlp"], specs["mlp"], act.batch)
    return sharded.leave(ctx, apply_mlp(w, sharded.enter(ctx, h, act, split), cfg), act, split), None


def zero_metrics(x: torch.Tensor) -> dict:
    """The MoE metrics of a block without an MoE layer: fp32 zeros."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return {"moe_aux": zero, "moe_dropped": zero}


def add_metrics(total: dict | None, m: dict | None) -> dict | None:
    """The MoE metrics summed so far plus a block's (None: no MoE layer)."""
    if m is None or total is None:
        return total if m is None else dict(m)
    return {k: total[k] + m[k] for k in total}


def remat_active(cfg: ModelConfig, x: torch.Tensor, params, collect_cache: bool) -> bool:
    """Whether a full-sequence pass runs its blocks under
    ``torch.utils.checkpoint``: ``cfg.remat``, under autograd, with no cache
    collected, and something to differentiate (``x`` or a parameter)."""
    return cfg.remat and not collect_cache and torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in tree.leaves(params)))


def _cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.kv_cache_dtype)


def apply_block_full(params, x: torch.Tensor, cfg: ModelConfig, kind: str, positions: torch.Tensor,
                     causal: bool = True, collect_cache: bool = False, specs=spmd.NO_SPEC,
                     rank: spmd.Rank = spmd.SINGLE):
    """Full-sequence block. Returns (x, cache entry or None, the MoE layer's
    metrics or None): (k, v) in the cache dtype for attention kinds, the
    state dict for 'ssm'. On a mesh (``rank``, ``models/sharded.py``):
    the rank's (B_l, T_l, d) block of the stream, its parameter shards with
    ``specs``, ``positions`` over the whole sequence, and the cache entry in
    the cache's layout."""
    if kind == "ssm":
        h = apply_norm(params["ln1"], x, cfg)
        if collect_cache:
            out, cache = ssm_mod.apply_ssm(params["ssm"], h, cfg, return_cache=True)
        else:
            out, cache = ssm_mod.apply_ssm(params["ssm"], h, cfg), None
        return x + out, cache, None
    ctx, act, rules = rank.ctx, rank.act, rank.rules
    asp = specs["attn"]
    heads_split = sharded.split_over_model(asp["wq"], 1)
    w = sharded.attn_weights(ctx, params["attn"], asp, act.batch)
    h = sharded.enter(ctx, _norm(params["ln1"], specs["ln1"], x, cfg, rank), act, heads_split)
    q, k, v = attn_mod.qkv_project(w, h, cfg, positions)
    out = attn_mod.full_attention(q, *sharded.kv_for_heads(ctx, k, v, cfg, asp), causal=causal)
    o = sharded.leave(ctx, attn_mod.attn_output(w, out), act, heads_split)
    x = shard_as_bf16_grad(x + o, ("batch", "seq", None), rules)
    entry = None
    if collect_cache:
        # k/v hold the whole sequence and (when 'model' splits the cache's
        # heads) the rank's heads: cut the sequence where the cache splits it
        b, t = rank.stream_shape(x)[:2]
        seq = sharded.cache_spec(rules, b, t, cfg)[1]
        entry = tuple(ctx.take(z, 1, seq).to(_cache_dtype(cfg)) for z in (k, v))
    h = _norm(params["ln2"], specs["ln2"], x, cfg, rank)
    y, metrics = _ffn(params, h, cfg, kind, specs, rank)
    return shard_as_bf16_grad(x + y, ("batch", "seq", None), rules), entry, metrics


def apply_block_decode(params, x: torch.Tensor, cache: dict, cfg: ModelConfig, kind: str,
                       cur_len: torch.Tensor, specs=spmd.NO_SPEC, cache_spec=spmd.NO_SPEC,
                       rank: spmd.Rank = spmd.SINGLE):
    """Single-token block step. cache: {'k','v'} of shape (B, S, KV, hd), or
    the SSM state dict for 'ssm'. Returns (x, new cache) — new tensors, the
    input cache is not written. On a mesh: the rank's (B_l, 1, d) stream
    and cache rows (B_l, S_l, KV_l, hd), ``cache_spec`` the cache's spec
    (batch, sequence, heads, head dim)."""
    if kind == "ssm":
        h = apply_norm(params["ln1"], x, cfg)
        out, new_cache = ssm_mod.ssm_decode_step(params["ssm"], h, cache, cfg)
        return x + out, new_cache
    ctx, act = rank.ctx, rank.act
    asp = specs["attn"]
    heads_split = sharded.split_over_model(asp["wq"], 1)
    seq_axes = ctx.live(cache_spec[1])
    positions = cur_len[:, None]  # (B, 1)
    w = sharded.attn_weights(ctx, params["attn"], asp, act.batch)
    h = sharded.enter(ctx, _norm(params["ln1"], specs["ln1"], x, cfg, rank), act, heads_split)
    q, k_new, v_new = attn_mod.qkv_project(w, h, cfg, positions)
    if seq_axes:
        k_cache, v_cache = sharded.write_rows(ctx, cache["k"], cache["v"], k_new, v_new, cur_len, seq_axes)
    else:
        k_cache, v_cache = attn_mod.update_kv_cache(cache["k"], cache["v"], k_new, v_new, positions)
    gathered = heads_split and "model" in seq_axes  # every head attends over the rank's rows
    if gathered:
        q = ctx.all_gather(q, 2, sharded.MODEL)
        kc, vc = k_cache, v_cache
    else:
        kc, vc = sharded.kv_for_heads(ctx, k_cache, v_cache, cfg, asp)
    if seq_axes:
        kc, vc = (kc, vc) if kc.dtype == q.dtype else (kc.to(q.dtype), vc.to(q.dtype))
        out = sharded.split_decode_attention(ctx, q, kc, vc, cur_len, seq_axes)
    else:
        out = attn_mod.decode_attention(q, kc, vc, cur_len + 1)
    if gathered:
        out = ctx.take(out, 2, sharded.MODEL)
    x = x + sharded.leave(ctx, attn_mod.attn_output(w, out), act, heads_split)
    h = _norm(params["ln2"], specs["ln2"], x, cfg, rank)
    x = x + _ffn(params, h, cfg, kind, specs, rank)[0]
    return x, {"k": k_cache, "v": v_cache}


def apply_block_decode_paged(params, x: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                             block_table: torch.Tensor, cfg: ModelConfig, kind: str,
                             cur_len: torch.Tensor, write_kv: bool = True):
    """Single-token block step against one layer's page arena slice.

    Same math as :func:`apply_block_decode` but the KV cache is
    ``(num_pages, page, KV, hd)`` shared across requests, addressed through
    the batch's block table: write the new token's K/V into its page (in
    place), then attend through the table.

    ``write_kv=False`` runs a FROZEN step: the new token's K/V is assumed
    already resident at position ``cur_len`` (a shared-prefix-cache hit)
    and nothing is written — the engine uses this to recover first-token
    logits for a whole-prompt hit without touching shared pages. Returns
    (x, k_pages, v_pages). Attention kinds only: an SSM state is recurrent,
    not length-indexed, so it has no pages."""
    if kind == "ssm":
        raise ValueError("paged decode applies to attention caches only")
    positions = cur_len[:, None]  # (B, 1)
    h = apply_norm(params["ln1"], x, cfg)
    q, k_new, v_new = attn_mod.qkv_project(params["attn"], h, cfg, positions)
    if write_kv:
        attn_mod.update_paged_kv(k_pages, v_pages, k_new, v_new, block_table, cur_len)
    out = attn_mod.paged_decode_attention(q, k_pages, v_pages, block_table, cur_len + 1)
    x = x + attn_mod.attn_output(params["attn"], out)
    h = apply_norm(params["ln2"], x, cfg)
    x = x + _ffn(params, h, cfg, kind)[0]
    return x, k_pages, v_pages


def apply_block_prefill_chunk_paged(params, x: torch.Tensor, k_pages: torch.Tensor,
                                    v_pages: torch.Tensor, block_table: torch.Tensor,
                                    cfg: ModelConfig, kind: str, start: torch.Tensor,
                                    valid: torch.Tensor):
    """One prefill CHUNK's block step against a layer's page arena slice.

    ``x``: (1, C, d) — C chunk rows whose absolute positions begin at
    ``start`` (shape (1,)); ``valid`` (shape (1,)) counts the real rows
    (the rest are padding whose K/V writes route to the scratch page). The
    chunk's K/V is written BEFORE attention so chunk tokens attend to
    themselves and each other, exactly like the matching rows of a dense
    causal prefill. Returns (x, k_pages, v_pages). Attention kinds only."""
    if kind == "ssm":
        raise ValueError("paged prefill applies to attention caches only")
    c = x.shape[1]
    positions = start[:, None] + torch.arange(c, device=x.device)[None, :]  # (1, C)
    h = apply_norm(params["ln1"], x, cfg)
    q, k_new, v_new = attn_mod.qkv_project(params["attn"], h, cfg, positions)
    attn_mod.update_paged_kv_chunk(k_pages, v_pages, k_new, v_new, block_table, start, valid)
    out = attn_mod.paged_chunk_attention(q, k_pages, v_pages, block_table, start)
    x = x + attn_mod.attn_output(params["attn"], out)
    h = apply_norm(params["ln2"], x, cfg)
    x = x + _ffn(params, h, cfg, kind)[0]
    return x, k_pages, v_pages


def _layer(stacked_params, i: int):
    return tree.map(lambda a: a[i], stacked_params)


def _num_layers(stacked_params) -> int:
    return tree.leaves(stacked_params)[0].shape[0]


def _layers(stacked_params) -> list:
    """Every layer's slice of the stacked parameters, taken at once: one
    ``unbind`` per leaf. Under autograd each ``a[i]`` would zero-fill a
    full-size stacked gradient in its backward (one per layer); the slices
    of one ``unbind`` share one backward, a single stack."""
    leaves, struct = tree.flatten(stacked_params)
    per_leaf = [x.unbind(0) for x in leaves]
    return [tree.unflatten(struct, [u[i] for u in per_leaf]) for i in range(_num_layers(stacked_params))]


def stack_into(stacked, i: int, n: int, entry, like=None) -> dict:
    """Copy layer ``i``'s cache entry (a (k, v) tuple, or a dict of tensors
    nested to any depth) into slot ``i`` of ``stacked``, the n layers' caches
    on a new leading axis as a dict, made at the first entry (in the dtypes of
    ``like``'s leaves when given); returns it. The caller drops each entry
    once it is copied, so the layers are never held twice over, as a stack of
    the whole list would hold them. The new buffer is made ``empty_like`` an
    entry (not ``new_empty``), so that under ``torch.func.vmap`` it carries
    the entry's mapped axis and the batched copies land in it."""
    if isinstance(entry, tuple):
        entry = {"k": entry[0], "v": entry[1]}
    if stacked is None:
        stacked = tree.map(lambda x, d: torch.empty_like(x.expand(n, *x.shape), dtype=d.dtype), entry,
                           entry if like is None else like)
    tree.map(lambda o, x: o[i].copy_(x), stacked, entry)
    return stacked


def apply_stack_full(stacked_params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                     positions: torch.Tensor, causal: bool = True, collect_cache: bool = False,
                     into=None, specs=spmd.NO_SPEC, rank: spmd.Rank = spmd.SINGLE):
    """Full-sequence pass through the stack. Returns (x, the cache stacked on
    a leading 'layers' axis — {'k','v'} for attention kinds, the SSM state
    dict for 'ssm' — or None, the MoE metrics summed over the layers or
    None). ``into``: a stacked cache of the right shapes (e.g. a view of a
    larger one) that the layers' caches are copied into, in place of a new
    one. Under autograd with ``cfg.remat`` (:func:`remat_active`), each
    block runs under ``torch.utils.checkpoint`` (recomputed in the backward;
    its metrics are those of the forward). On a mesh, ``specs`` are the
    stacked parameters' and ``rank`` this rank's (:func:`apply_block_full`)."""
    n = _num_layers(stacked_params)
    layers = _layers(stacked_params)
    layer_specs = tree.map(lambda sp: sp.tail(), specs)
    remat = remat_active(cfg, x, stacked_params, collect_cache)
    cache, metrics = into, None
    for i, lp in enumerate(layers):
        args = (lp, x, cfg, kind, positions, causal, collect_cache, layer_specs, rank)
        if remat:
            x, entry, m = checkpoint(apply_block_full, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            x, entry, m = apply_block_full(*args)
        metrics = add_metrics(metrics, m)
        if collect_cache:
            cache = stack_into(cache, i, n, entry)
    return x, cache, metrics


def apply_stack_decode(stacked_params, x: torch.Tensor, caches: dict, cfg: ModelConfig, kind: str,
                       cur_len: torch.Tensor, post=None, specs=spmd.NO_SPEC, cache_specs=spmd.NO_SPEC,
                       rank: spmd.Rank = spmd.SINGLE):
    """One decode step through the stack; caches have a leading 'layers' dim.
    Returns (x, new caches), each in the dtype of the cache it replaces (as
    the JAX package's carry keeps it). ``post(layer_params, i, x)``, when
    given, runs after each block on its output (the enc-dec decoder's
    cross-attention). When the inputs are donated
    (:func:`repro_torch.donate.donated`), each layer's new cache is written
    into its slot of ``caches`` and ``caches`` is returned: a layer that
    wrote its slot in place (an attention layer's new rows, an SSM layer's
    state) returns it as it is, and the rest (an SSM layer's new conv
    histories) is copied in after the layer read the old values. On a mesh,
    ``specs`` and ``cache_specs`` are the stacked parameters' and caches'
    and ``rank`` this rank's (:func:`apply_block_decode`)."""
    n = _num_layers(stacked_params)
    layer_specs = tree.map(lambda sp: sp.tail(), specs)
    cache_spec = cache_specs["k"].tail()
    donated = donate.donated()
    stacked = caches if donated else None
    for i in range(n):
        old = _layer(caches, i)
        lp = _layer(stacked_params, i)
        x, new_cache = apply_block_decode(lp, x, old, cfg, kind, cur_len, layer_specs, cache_spec, rank)
        if post is not None:
            x = post(lp, i, x)
        if donated:
            tree.map(lambda slot, prev, new: prev is new or slot[i].copy_(new), caches, old, new_cache)
        else:
            stacked = stack_into(stacked, i, n, new_cache, like=caches)
    return x, stacked


def apply_stack_decode_paged(stacked_params, x: torch.Tensor, arena: dict, block_table: torch.Tensor,
                             cfg: ModelConfig, kind: str, cur_len: torch.Tensor,
                             write_kv: bool = True):
    """One decode step through the stack against a paged arena.

    ``arena``: ``{'k','v'}`` of shape (L, num_pages, page, KV, hd) — the
    stage's slice of the shared pool, written in place layer by layer
    (nothing is written when ``write_kv=False``, the frozen step). Returns
    (x, arena) with the same tensors."""
    for i in range(_num_layers(stacked_params)):
        x, _, _ = apply_block_decode_paged(_layer(stacked_params, i), x, arena["k"][i], arena["v"][i],
                                           block_table, cfg, kind, cur_len, write_kv)
    return x, arena


def apply_stack_prefill_chunk_paged(stacked_params, x: torch.Tensor, arena: dict,
                                    block_table: torch.Tensor, cfg: ModelConfig, kind: str,
                                    start: torch.Tensor, valid: torch.Tensor):
    """One prefill chunk through the stack against a paged arena, written in
    place layer by layer as :func:`apply_stack_decode_paged`. Returns
    (x, arena) with the same tensors."""
    for i in range(_num_layers(stacked_params)):
        x, _, _ = apply_block_prefill_chunk_paged(_layer(stacked_params, i), x, arena["k"][i],
                                                  arena["v"][i], block_table, cfg, kind, start,
                                                  valid)
    return x, arena
