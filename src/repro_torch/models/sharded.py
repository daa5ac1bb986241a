"""The mesh's branches of the block families' programs.

The dense, vlm and MoE programs (``models/transformer.py``,
``models/model.py``, ``models/moe.py``) are one program each, run by every
rank on its local shards (``sharding/spmd.py``) and on one device with
``spmd.SINGLE``, where every collective below is the identity. On a mesh
the parameters carry the strict placements of ``train_rules`` /
``infer_rules`` / ``decode_rules`` (FSDP over the data axes, gathered at
each use by ``Ctx.param``; TP over 'model'), and the residual stream
(B, T, d) is split as ('batch', 'seq', None): batch over the data axes,
sequence over 'model' where the rules split it (Megatron-style sequence
parallelism). At each of the reference's ``shard_as`` sites the data moves
with one explicit collective:

  * into an attention or MLP region whose weights are split over 'model'
    (heads, ff): an all-gather of the sequence (its backward a
    reduce-scatter); out of it, a reduce-scatter of the partial sums (an
    all-reduce when the sequence is not split): :func:`enter`,
    :func:`leave`. A region whose weights are not split (heads or ff that
    'model' does not divide) runs whole on every rank;
  * GQA under TP: K/V whose heads 'model' does not divide are computed
    whole, repeated to the query heads and cut to the rank's heads (the
    reference's repeat, ``transformer.py:90-100``): :func:`kv_for_heads`;
  * the vocab split over 'model': the embedding looks up the rank's rows
    (the others give zeros) and reduces; the loss takes the logsumexp and
    the target's logit over the rank's vocab slice, then reduces:
    :func:`embed`, :func:`split_vocab_ce`;
  * decode with the KV cache's sequence split (flash-decoding): each rank
    writes the new row if it holds that position, attends over its rows,
    and the partial softmaxes are combined by an all-reduce of their
    maxima, weighted outputs and sums: :func:`write_rows`,
    :func:`split_decode_attention`.

The kernels run on local shards: K3 and K4 see the rank's heads (and K4 its
cache rows), K5 the rank's experts. Their device rule is unchanged: a CUDA
tensor launches, a CPU tensor runs the plain version, a meta tensor gives
an empty output and a cost record.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import donate
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import unembed
from repro_torch.sharding import spmd

MODEL = ("model",)


def split_over_model(spec, dim: int) -> bool:
    return "model" in spec[dim]


def enter(ctx, h, act: spmd.Act, split: bool):
    """Into a region on the whole sequence: split regions use it for
    different work on each 'model' rank (their gradients sum)."""
    if act.seq:
        return ctx.gather(h, 1, act.seq, "sum" if split else "slice")
    return ctx.sum_grad(h, MODEL) if split else h


def leave(ctx, o, act: spmd.Act, split: bool):
    """Out of it, back to the residual stream's layout: a split region's
    partial sums reduced, a whole one's sequence cut to the rank's block."""
    if split:
        return ctx.scatter(o, 1, act.seq) if act.seq else ctx.reduce(o, MODEL)
    return ctx.chunk(o, 1, act.seq) if act.seq else o


def attn_weights(ctx, ap, asp, batch_axes) -> dict:
    """The attention weights ready for this rank's use. Where 'model'
    splits the query heads, every K/V weight's use is a partial sum over
    'model' (the rank's heads' share), so a K/V weight (and a QK-norm
    scale) that 'model' does not split sums its gradient over it."""
    if not ctx.names:
        return ap
    kv_axes = batch_axes + (MODEL if split_over_model(asp["wq"], 1) else ())
    return {k: ctx.param(ap[k], asp[k], batch_axes if k in ("wq", "wo") else kv_axes) for k in ap}


def kv_for_heads(ctx, k, v, cfg: ModelConfig, asp):
    """K/V for the rank's query heads. K/V whose heads 'model' does not
    split are computed whole on every rank, but each rank's heads use only
    their share of them: the rank's slice is a plain narrow (zero gradient
    elsewhere), so the gradients stay partial sums like the queries'. A
    single K/V head (MQA) serves every query head as it is."""
    if (not ctx.live(MODEL) or not split_over_model(asp["wq"], 1) or split_over_model(asp["wk"], 1)
            or k.shape[2] == 1):
        return k, v
    rep = cfg.num_heads // cfg.num_kv_heads
    return (ctx.take(k.repeat_interleave(rep, dim=2), 2, MODEL),
            ctx.take(v.repeat_interleave(rep, dim=2), 2, MODEL))


def cache_spec(rules, b: int, s: int, cfg: ModelConfig) -> spmd.Spec:
    """The spec of one layer's KV cache at (B, S) (unsharded without
    rules)."""
    if rules is None:
        return spmd.NO_SPEC
    return spmd.spec_from_rules((b, s, cfg.num_kv_heads, cfg.head_dim),
                                ("batch", "cache_seq", "cache_kv_heads", "head_dim"), rules, strict=True)


# ------------------------------------------------------------------ embed / loss


def _vocab(ep, es):
    """(the unembedding's key, whether 'model' splits its vocab)."""
    key = "head" if "head" in ep else "table"
    return key, split_over_model(es[key], 1 if key == "head" else 0)


def embed(ctx, ep, es, tokens, act: spmd.Act):
    """The rank's (B_l, T_l, d) block of the token embeddings."""
    spec = es["table"]
    if not split_over_model(spec, 0):
        return F.embedding(tokens, ctx.param(ep["table"], spec, act.axes))
    table = ctx.param(ep["table"], spec, act.batch)  # the rank's vocab rows
    toks = ctx.all_gather(tokens, 1, act.seq).long() - ctx.index(MODEL) * table.shape[0]
    ok = (toks >= 0) & (toks < table.shape[0])
    x = F.embedding(torch.where(ok, toks, 0), table)
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return ctx.scatter(x, 1, act.seq) if act.seq else ctx.reduce(x, MODEL)


def logits_local(ctx, ep, es, h, batch_axes):
    """(fp32 logits of ``h`` over the rank's vocab slice, whether the vocab
    is split)."""
    key, split = _vocab(ep, es)
    return unembed({key: ctx.param(ep[key], es[key], batch_axes)}, h), split


def vocab_split(ep, es) -> bool:
    return _vocab(ep, es)[1]


def split_vocab_ce(ctx, logits, y):
    """Summed cross-entropy of logits over the rank's vocab slice: the
    logsumexp and the target's logit from each slice, reduced over
    'model'."""
    gmax = ctx.all_reduce(logits.detach().amax(dim=-1), MODEL, "max")
    lz = torch.log(ctx.reduce(torch.exp(logits - gmax[..., None]).sum(dim=-1), MODEL)) + gmax
    rel = y.long() - ctx.index(MODEL) * logits.shape[-1]
    ok = (rel >= 0) & (rel < logits.shape[-1])
    ll = torch.gather(logits, -1, torch.where(ok, rel, 0)[..., None])[..., 0]
    ll = ctx.reduce(torch.where(ok, ll, torch.zeros((), dtype=ll.dtype, device=ll.device)), MODEL)
    return torch.sum(lz - ll)


# ------------------------------------------------------------------ decode


def write_rows(ctx, k_cache, v_cache, k_new, v_new, cur_len, seq_axes):
    """Row ``cur_len[b]`` of each batch row's cache rows on this rank set to
    the new K/V where this rank holds that position (the cache's sequence
    split over ``seq_axes``); in place when donated."""
    s_l = k_cache.shape[1]
    pos = cur_len.long() - ctx.index(seq_axes) * s_l
    own = (pos >= 0) & (pos < s_l)
    b = k_cache.shape[0]
    pos = torch.where(own, pos, 0)
    rows = torch.arange(b, device=k_cache.device)

    def put(cache, new):
        new = torch.where(own[:, None, None], new[:, 0].to(cache.dtype), cache[rows, pos])
        return cache.index_put_((rows, pos), new) if donate.donated() else cache.index_put((rows, pos), new)

    return put(k_cache, k_new), put(v_cache, v_new)


def split_decode_attention(ctx, q, k_cache, v_cache, cur_len, seq_axes):
    """K4 on the rank's cache rows, the cache's sequence split over
    ``seq_axes``: the partial softmaxes combined (flash-decoding), each
    weighted by the logsumexp K4 returns beside its output. q:
    (B, 1, H, hd) -> (B, 1, H, hd)."""
    q = q[:, 0].contiguous()
    s_l = k_cache.shape[1]
    n_valid = torch.clamp(cur_len + 1 - ctx.index(seq_axes) * s_l, 0, s_l).to(cur_len.dtype)
    out, lse = kops.decode_attention(q, k_cache.contiguous(), v_cache.contiguous(), n_valid, return_lse=True)
    gmax = ctx.all_reduce(lse, seq_axes, "max")
    wgt = torch.exp(lse - gmax)  # 0 on a rank without a valid row
    num = ctx.all_reduce(torch.where(n_valid[:, None, None] > 0, out.float(), 0.0) * wgt[..., None], seq_axes)
    return (num / ctx.all_reduce(wgt, seq_axes)[..., None]).to(q.dtype)[:, None]


# ------------------------------------------------------------------ programs' inputs and outputs


def on_rank(rules, trees: tuple, batch_specs, name: str, b: int, t: int, d: int):
    """(the trees' local tensors, their specs, this rank's ``spmd.Rank``) of
    ``DTensor`` trees on ``rules.mesh``; the batch leaf ``name`` must be
    laid out as the rules lay out ('batch', 'seq') at (B, T)."""
    ctx = spmd.ctx_for(rules.mesh)
    locs, specs = spmd.split(trees)
    act = spmd.Act.from_rules(rules, b, t)
    got = specs[batch_specs][name]
    if tuple(got[:2]) != (act.batch, act.seq):
        raise ValueError(f"batch leaf {name!r} is laid out {got}, the rules give {act}")
    return locs, specs, spmd.Rank(ctx, rules, act, (b, t, d))


def wrap(local, spec, mesh, shape):
    """This rank's ``local`` as its shard of a ``DTensor`` with ``spec``."""
    return spmd.as_dtensor(local, mesh, spmd.placements_of(spec, mesh), shape)


def logits_out(logits, es, rank: spmd.Rank, vocab: int):
    """The (B_l, V_l) logits as a ``DTensor`` of (B, V)."""
    vaxes = es["head"][1] if "head" in es else es["table"][0]
    return wrap(logits, spmd.Spec((rank.act.batch, vaxes)), rank.rules.mesh, (rank.shape[0], vocab))
