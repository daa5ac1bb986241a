"""Zamba2-style hybrid: Mamba-2 backbone + ONE shared transformer block
applied every `shared_attn_every` layers. [arXiv:2411.15242]

81 layers = 13 groups of 6 + a tail of 3 (config-derived). Where the JAX
package scans over the groups and, inside each, over the group's Mamba
layers, the port loops over both in Python. The shared block's *weights*
are reused at every application, but each application has its own KV cache
(``n_groups`` leading dim).

Deviation kept from the JAX package: the real Zamba2 feeds concat(hidden,
embedding) through per-application LoRA on the shared block; here the
shared block is applied to the hidden state directly — the same compute
shape, simpler plumbing.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import donate, tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.params import stack_defs


def split_layers(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, group_size, tail)."""
    every = cfg.shared_attn_every
    n_groups, tail = divmod(cfg.num_layers, every)
    return n_groups, every, tail


def hybrid_defs(cfg: ModelConfig):
    n_groups, every, tail = split_layers(cfg)
    defs = {
        "groups": stack_defs(stack_defs(tfm.block_defs(cfg, "ssm"), every, "inner"), n_groups, "groups"),
        "shared": tfm.block_defs(cfg, "dense"),
    }
    if tail:
        defs["tail"] = stack_defs(tfm.block_defs(cfg, "ssm"), tail, "inner")
    return defs


def apply_hybrid_full(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                      collect_cache: bool = False, attn_into: dict | None = None):
    """Returns (x, caches); no block of the hybrid has MoE metrics. Under
    autograd the shared block's gradient adds up over its applications, as
    the reference's ``lax.scan`` over the groups accumulates it; with remat
    (``tfm.remat_active``) each application runs under
    ``torch.utils.checkpoint``, as each SSM block does (the reference
    checkpoints the group body that holds both).

    caches (collect_cache=True) = {'groups': SSM
    states (n_groups, every, ...), 'attn': {'k','v'} (n_groups, B, S, KV,
    hd), 'tail': SSM states (tail, ...)}; else None. ``attn_into``: {'k',
    'v'} (n_groups, B, S_max, KV, hd) tensors that each application's K/V
    is written into, in its leading S slots (cast to their dtype), in place
    of a new stacked cache; it is returned as 'attn'. Each group's states go
    straight into their slots of 'groups' from the second group on, so no
    group's copy is held beside them."""
    n_groups, _, tail = split_layers(cfg)
    groups = attn = None
    remat = tfm.remat_active(cfg, x, params["shared"], collect_cache)
    for gi in range(n_groups):
        group = tree.map(lambda a: a[gi], params["groups"])
        into = None if groups is None else tree.map(lambda a: a[gi], groups)
        x, ssm_cache, _ = tfm.apply_stack_full(group, x, cfg, "ssm", positions, collect_cache=collect_cache,
                                               into=into)
        if collect_cache and groups is None:
            groups = tfm.stack_into(groups, gi, n_groups, ssm_cache)
        ssm_cache = None
        args = (params["shared"], x, cfg, "dense", positions, True, collect_cache)
        if remat:  # the reference checkpoints the whole group body, the shared block in it
            x, kv, _ = checkpoint(tfm.apply_block_full, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            x, kv, _ = tfm.apply_block_full(*args)
        if collect_cache and attn_into is not None:
            for name, part in zip("kv", kv):
                attn_into[name][gi, :, : part.shape[1]] = part.to(attn_into[name].dtype)
        elif collect_cache:
            attn = tfm.stack_into(attn, gi, n_groups, kv)
    tail_cache = None
    if tail:
        x, tail_cache, _ = tfm.apply_stack_full(params["tail"], x, cfg, "ssm", positions,
                                                collect_cache=collect_cache)
    if not collect_cache:
        return x, None
    caches = {"groups": groups, "attn": attn if attn_into is None else attn_into}
    if tail:
        caches["tail"] = tail_cache
    return x, caches


def apply_hybrid_decode(params, x: torch.Tensor, caches: dict, cfg: ModelConfig, cur_len: torch.Tensor):
    """caches: {'groups': SSM states stacked (n_groups, every, ...), 'attn':
    {'k','v'} (n_groups, B, S, KV, hd), 'tail': (tail, ...)}. Returns (x, new
    caches) — new tensors, the input caches are not written, unless they are
    donated (:func:`repro_torch.donate.donated`): then every new cache goes
    into its slot of ``caches`` (through ``apply_stack_decode`` and
    ``update_kv_cache``) and ``caches`` is returned."""
    n_groups, _, tail = split_layers(cfg)
    donated = donate.donated()
    new_groups, new_attn = (caches["groups"], caches["attn"]) if donated else (None, None)
    for gi in range(n_groups):
        group = tree.map(lambda a: a[gi], params["groups"])
        x, new_ssm = tfm.apply_stack_decode(group, x, tree.map(lambda a: a[gi], caches["groups"]), cfg,
                                            "ssm", cur_len)
        x, attn = tfm.apply_block_decode(params["shared"], x, tree.map(lambda a: a[gi], caches["attn"]),
                                         cfg, "dense", cur_len)
        if not donated:
            new_groups = tfm.stack_into(new_groups, gi, n_groups, new_ssm)
            new_attn = tfm.stack_into(new_attn, gi, n_groups, attn)
    new_caches = {"groups": new_groups, "attn": new_attn}
    if tail:
        x, new_caches["tail"] = tfm.apply_stack_decode(params["tail"], x, caches["tail"], cfg, "ssm", cur_len)
    return x, new_caches
