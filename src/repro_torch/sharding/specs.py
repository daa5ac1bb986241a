"""Logical-axis -> mesh-axis sharding rules (the JAX package's
``repro/sharding/specs.py``, copied).

Every tensor in the framework is annotated with *logical* axis names
(e.g. ``('batch', 'seq', 'embed')``); a :class:`LogicalRules` table maps each
logical name to zero or more mesh axes. This is the single place where the
parallelism strategy (DP / FSDP / TP / EP / SP, multi-pod DP) is decided.

Axis conventions:
  'pod'   — cross-pod data parallelism (multi-pod mesh only)
  'data'  — in-pod data parallelism + FSDP param sharding
  'model' — tensor parallelism (heads / ff / vocab), expert parallelism,
            and sequence parallelism for the residual stream & long KV

A spec is a plain tuple with the entries of the reference's
``PartitionSpec``: per tensor dim, None, a mesh axis name or a tuple of
them. :func:`to_placements` turns it into a ``DTensor``'s placements on a
``torch.distributed.device_mesh.DeviceMesh`` whose dims are named after the
mesh axes. A dim over several axes (``('pod', 'data')``) is split major to
minor, as XLA splits it; DTensor splits a dim over its mesh dims in mesh
order, so the axes of an entry must come in the mesh's order (they do in
every rule below).

Uneven shards: XLA pads a lenient ``heads`` or ``vocab`` shard to equal
sizes, while DTensor splits as ``torch.chunk`` does (the last shards
shorter). The values are the same either way; only the lenient
(``shard_as``) path meets it, since strict specs divide exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

# Logical names where uneven (padded) sharding is accepted rather than
# dropping the mesh axis: q-heads (starcoder2 has 24 heads on a 16-way TP
# axis) and vocab (tokenizer sizes are rarely multiples of 16).
ALLOW_UNEVEN = frozenset({"heads", "vocab"})


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    """Mapping of logical axis name -> mesh axis (or tuple of mesh axes).
    ``mesh``: the ``DeviceMesh`` the rules were made for, or None when they
    were made from axis sizes alone (spec reckoning, no process group)."""

    rules: Mapping[str, tuple[str, ...] | str | None]
    mesh_axis_sizes: Mapping[str, int]
    mesh: Any = None

    def dp_axes(self) -> tuple[str, ...]:
        return tuple(ax for ax in ("pod", "data") if self.mesh_axis_sizes.get(ax, 1) > 1)

    def mesh_axes_for(self, logical: str) -> tuple[str, ...]:
        got = self.rules.get(logical)
        if got is None:
            return ()
        if isinstance(got, str):
            return (got,)
        return tuple(got)

    def spec_entry(self, logical: str | None, dim: int, *, strict: bool = False) -> tuple[str, ...] | str | None:
        """Resolve one logical axis to a spec entry, honouring divisibility.
        ``strict=True`` (array/struct shardings — must divide exactly) always
        drops non-dividing axes; the lenient path keeps ALLOW_UNEVEN names."""
        if logical is None:
            return None
        axes = self.mesh_axes_for(logical)
        if not axes:
            return None
        if not strict and logical in ALLOW_UNEVEN:
            return axes if len(axes) > 1 else axes[0]
        keep: list[str] = []
        remaining = dim
        for ax in axes:
            size = self.mesh_axis_sizes.get(ax, 1)
            if size > 1 and remaining % size == 0:
                keep.append(ax)
                remaining //= size
            elif size == 1:
                # axis of extent 1 — harmless, keep it out for clean specs
                continue
        if not keep:
            return None
        return tuple(keep) if len(keep) > 1 else keep[0]


def _mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, or of a mapping of axis sizes
    (rules reckoned without devices)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _as_mesh(mesh):
    return None if isinstance(mesh, Mapping) else mesh


def train_rules(mesh) -> LogicalRules:
    """Sharding rules for train / prefill programs.

    Params: FSDP over ('pod','data') on the embed dim + TP over 'model'.
    Activations: batch over ('pod','data'), residual-stream seq over 'model'
    (Megatron-style sequence parallelism: an all-gather before the
    attention/MLP TP regions and a reduce-scatter after).
    """
    sizes = _mesh_sizes(mesh)
    has_pod = "pod" in sizes
    dp: tuple[str, ...] = ("pod", "data") if has_pod else ("data",)
    rules = {
        # --- activations ---
        "batch": dp,
        "seq": "model",          # sequence-parallel residual stream
        "seq_full": None,        # inside attention (post all-gather)
        "embed": None,
        "act_heads": "model",
        "act_kv_heads": None,    # GQA KV usually replicated across TP
        "act_ff": "model",
        "head_dim": None,
        "vocab_out": "model",    # logits vocab dim
        # --- params: FSDP axis + TP axis ---
        "embed_fsdp": dp,        # every big param's embed dim
        "heads": "model",
        "kv_heads": "model",     # dropped automatically when not divisible
        "ff": "model",
        "experts": "model",      # EP: expert dim over 'model'
        "expert_ff": None,       # per-expert ff dim (model axis is taken by EP)
        "vocab": "model",
        # --- SSM ---
        "ssm_inner": "model",    # d_inner sharded over TP
        "ssm_heads": "model",
        "ssm_state": None,
        "conv_k": None,
        # --- misc ---
        "layers": None,
        "groups": None,
        "inner": None,
        "cache_seq": None,
        "cache_kv_heads": None,
        "expert_cap": None,
    }
    return LogicalRules(rules, sizes, _as_mesh(mesh))


def _cache_rules(sizes: Mapping[str, int], kv_heads: int | None) -> dict:
    model_size = sizes.get("model", 1)
    shard_kv = kv_heads is not None and kv_heads % model_size == 0 and kv_heads >= model_size
    return {
        "cache_seq": None if shard_kv else "model",
        "cache_kv_heads": "model" if shard_kv else None,
    }


def infer_rules(mesh, *, kv_heads: int | None = None) -> LogicalRules:
    """PREFILL rules: params stay FSDP-sharded (ZeRO-inference) — the
    per-layer weight all-gather amortizes over the whole prompt batch. The
    prefill-built KV cache is sharded like the decode cache (heads over
    'model' when divisible, else sequence)."""
    base = train_rules(mesh)
    rules = dict(base.rules)
    rules.update(_cache_rules(base.mesh_axis_sizes, kv_heads))
    return LogicalRules(rules, base.mesh_axis_sizes, base.mesh)


def decode_rules(mesh, *, kv_heads: int | None = None, batch: int | None = None) -> LogicalRules:
    """Sharding rules for decode programs (single-token step, big KV cache).

    Params: TP-only. The KV cache is the dominant tensor: if the arch has
    enough KV heads to split over the TP axis we shard heads; otherwise
    (MQA / small-GQA) we shard the cache *sequence* dim over 'model' —
    flash-decoding style, the partial softmaxes combined by an all-reduce.
    """
    base = infer_rules(mesh, kv_heads=kv_heads)
    sizes = base.mesh_axis_sizes
    # DECODE params: TP-only (vLLM layout): FSDP'd decode weights would be
    # all-gathered every token
    rules_patch = {"embed_fsdp": None}
    model_size = sizes.get("model", 1)
    dp_size = sizes.get("pod", 1) * sizes.get("data", 1)
    shard_kv_heads = kv_heads is not None and kv_heads % model_size == 0 and kv_heads >= model_size
    # single-stream long-context decode (batch < data axis): the data axis
    # would sit idle — use it for the cache sequence dim instead
    seq_over_data = batch is not None and batch < dp_size
    rules = dict(base.rules)
    if seq_over_data:
        cache_seq: tuple[str, ...] | str | None = ("pod", "data") if "pod" in sizes else ("data",)
        if not shard_kv_heads:
            cache_seq = (*cache_seq, "model")
        rules["cache_seq"] = cache_seq
        rules["batch"] = None
    rules.update(rules_patch)
    rules.update(
        {
            "seq": None,          # q_len == 1: nothing to shard
            "act_kv_heads": "model" if shard_kv_heads else None,
        }
    )
    return LogicalRules(rules, sizes, base.mesh)


def to_pspec(shape: Sequence[int], logical: Sequence[str | None], rules: LogicalRules, *,
             strict: bool = False) -> tuple:
    if len(shape) != len(logical):
        raise ValueError(f"rank mismatch: shape {shape} vs logical {logical}")
    entries = [rules.spec_entry(lg, d, strict=strict) for lg, d in zip(logical, shape)]
    # a spec must not name one mesh axis twice; keep first occurrence
    seen: set[str] = set()
    cleaned: list = []
    for e in entries:
        if e is None:
            cleaned.append(None)
            continue
        group = (e,) if isinstance(e, str) else e
        kept = tuple(ax for ax in group if ax not in seen)
        seen.update(kept)
        if not kept:
            cleaned.append(None)
        elif len(kept) == 1:
            cleaned.append(kept[0])
        else:
            cleaned.append(kept)
    return tuple(cleaned)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Sequence, mesh) -> tuple:
    """A ``DTensor``'s placements for ``spec`` on ``mesh``, one per mesh
    dim: ``Shard(d)`` on every mesh axis that spec entry d names,
    ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        pos = [names.index(ax) for ax in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} splits dim {d} against the mesh's order {names}")
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


def to_named_sharding(mesh, shape: Sequence[int], logical: Sequence[str | None], rules: LogicalRules) -> tuple:
    """The strict placements of a tensor of ``shape`` (the reference's
    ``NamedSharding`` of the strict spec)."""
    return to_placements(to_pspec(shape, logical, rules, strict=True), mesh)


def shard_as(x, logical: Sequence[str | None], rules: LogicalRules | None):
    """Redistribute a ``DTensor`` to the lenient placements of its logical
    axes (the reference's ``with_sharding_constraint``); the identity when
    ``rules`` is None or ``x`` is a rank's local tensor (the rank-local
    programs of ``sharding/spmd.py`` move their data with explicit
    collectives)."""
    from torch.distributed.tensor import DTensor

    if rules is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(to_pspec(x.shape, logical, rules), x.device_mesh))


class _Bf16Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, logical, rules):
        ctx.logical, ctx.rules = logical, rules
        return shard_as(x, logical, rules)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.bfloat16).to(g.dtype)
        return shard_as(g, ctx.logical, ctx.rules), None, None


def shard_as_bf16_grad(x, logical: Sequence[str | None], rules: LogicalRules | None):
    """shard_as whose BACKWARD casts the cotangent to bf16 first (and back
    to its dtype): the residual stream's boundary reductions in the
    backward then carry bf16 values, as the reference's do. The identity,
    backward too, when ``rules`` is None."""
    if rules is None:
        return x
    return _Bf16Grad.apply(x, tuple(logical), rules)
