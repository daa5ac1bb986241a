"""Top-k token-choice Mixture-of-Experts with capacity buffers.

The Switch-Transformer capacity formulation of the JAX package
(``repro/models/moe.py``), token for token:

  1. route: fp32 router logits -> softmax -> top-k experts per token and
     their weights, renormalised (floor 1e-9)
  2. position: each (token, choice)'s slot in its (group's) expert's
     buffer, from a stable sort by expert and a running maximum of the run
     starts; slots at or past the capacity C are dropped
  3. dispatch: scatter the token vectors into (G, E, C, d) buffers
  4. compute: the per-expert products gate/up and down through K5
     (``kernels.ops.gmm``), SiLU in fp32
  5. combine: gather each token's k expert outputs, weighted sum

Nothing here reads a tensor value on the host and no shape depends on the
data (no ``nonzero``, no boolean indexing), so a fused chain that holds MoE
layers stays one unit under the platform's shape-only run on meta tensors.

One program, :func:`apply_moe_local`, runs on one device (one group, every
collective the identity) and on a mesh (``rules``), where the tokens go in
G groups, one per data-parallel shard (:func:`num_groups`), and each rank
runs its group's dispatch and combine locally, as the reference's
``shard_map`` over the data-parallel axes does. With
``moe_impl="dropping_ep"`` and a 'model' axis of more than one rank, the
expert-parallel schedule: each 'model' rank gathers its group's tokens,
builds only its E/m experts' buffer (slot E/m drops), runs K5 on it, and the
partial token outputs are reduced with a reduce-scatter over 'model' (an
all-reduce when the tokens are not split over it), as the reference's
``psum_scatter`` / ``psum``. Without it (``dropping``) the group's buffer of
all experts is built on every 'model' rank, each runs K5 on its slice of
experts and an all-gather brings the outputs back for the combine. Groups
that do not line up with the data-parallel shards (a decode batch smaller
than G) are computed on every rank from the gathered tokens.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.params import ParamDef
from repro_torch.sharding import spmd


def moe_defs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {
        "router": ParamDef((d, e), ("embed_fsdp", None), dtype=torch.float32),
        "wi_gate": ParamDef((e, d, f), ("experts", "embed_fsdp", "expert_ff")),
        "wi_up": ParamDef((e, d, f), ("experts", "embed_fsdp", "expert_ff")),
        "wo": ParamDef((e, f, d), ("experts", "expert_ff", "embed_fsdp")),
    }


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.num_experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(8, _round_up(c, 8))


def num_groups(n_tokens: int, batch: int, cfg: ModelConfig, rules=None) -> int:
    """Groups = data-parallel shard count when per-group token counts stay
    healthy (>= ~4 slots/expert); halved otherwise (tiny decode batches).
    One without a mesh."""
    target = cfg.moe_min_group_tokens or 4 * cfg.num_experts
    if rules is None:
        g = 1
    else:
        g = rules.mesh_axis_sizes.get("pod", 1) * rules.mesh_axis_sizes.get("data", 1)
    while g > 1 and ((n_tokens // g) < target or n_tokens % g or (g > batch and g % batch)):
        g //= 2
    return max(1, g)


def choose_experts(router: torch.Tensor, x: torch.Tensor, k: int):
    """(probs (B, T, E) fp32, the top-k experts (B, T, k) and their weights
    (B, T, k) fp32, renormalised) of x: (B, T, d)."""
    probs = torch.softmax(torch.einsum("btd,de->bte", x.float(), router), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)  # sorted, as jax.lax.top_k
    return probs, idx, w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)


def route(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, T, d) -> (probs (B, T, E) fp32, idx (N*k,) int64, weights
    (N, k) fp32, pos (N*k,) int64): each (token, choice)'s expert and its
    slot in that expert's buffer, in token-major order."""
    k = cfg.num_experts_per_tok
    probs, idx, w = choose_experts(params["router"], x, k)
    e_flat = idx.reshape(-1)
    return probs, e_flat, w.reshape(-1, k), slot_positions(e_flat)


def slot_positions(e_flat: torch.Tensor) -> torch.Tensor:
    """pos[i] = #{j < i : e[j] == e[i]}: each (token, choice)'s slot in its
    expert's buffer. A stable sort groups each expert's choices in token
    order; a slot is its distance from its run's start."""
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    pos_in_row = torch.arange(e_flat.shape[0], device=e_flat.device)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    run_start = torch.cummax(torch.where(is_start, pos_in_row, 0), dim=0).values
    return torch.zeros_like(order).scatter(0, order, pos_in_row - run_start)


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig, rules=None):
    """x: (B, T, d) -> (y (B, T, d), metrics {'moe_aux', 'moe_dropped'} as
    fp32 tensors): :func:`apply_moe_local` on one device. Under ``rules``
    (a mesh), ``params`` and ``x`` are ``DTensor``s (``x`` laid out as
    ('batch', 'seq', None)); ``y`` comes back as one in ``x``'s layout and
    the metrics as every rank's same values."""
    if rules is None:
        return apply_moe_local(params, spmd.NO_SPEC, x, cfg, spmd.SINGLE)
    (p_l, x_l), (specs, x_spec) = spmd.split((params, x))
    rank = spmd.Rank(spmd.ctx_for(rules.mesh), rules, spmd.Act.of(x_spec), tuple(x.shape))
    y, metrics = apply_moe_local(p_l, specs, x_l, cfg, rank)
    return spmd.as_dtensor(y, rules.mesh, x.placements, x.shape), metrics


def apply_moe_local(params, specs, x: torch.Tensor, cfg: ModelConfig, rank: spmd.Rank):
    """This rank's program of the MoE layer. ``params``: its shards with
    per-dim ``specs`` (``spmd.spec_of``; ``spmd.NO_SPEC`` on one device);
    ``x``: the rank's (B_l, T_l, d) block of the stream ``rank.shape``,
    split as ``rank.act``. Returns (y in ``x``'s layout, metrics the same on
    every rank). On one device (``spmd.SINGLE``) every collective is the
    identity and the program is the one group's dispatch, K5 and combine."""
    ctx, act, rules = rank.ctx, rank.act, rank.rules
    b, t, d = rank.stream_shape(x)
    n = b * t
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    g = num_groups(n, b, cfg, rules)
    nl = n // g
    cap = capacity(nl, cfg)
    dp = rules.dp_axes() if rules is not None else ()
    msize = ctx.sizes.get("model", 1)
    local_groups = g == ctx.count(dp) and act.batch == dp  # one group per dp rank, the rank's rows
    experts_split = "model" in specs["wi_gate"][0]
    ep = cfg.moe_impl == "dropping_ep" and local_groups and msize > 1 and experts_split

    # route on this rank's tokens (the reference routes the (B, T, d) stream
    # before grouping)
    probs, idx, w = choose_experts(ctx.param(params["router"], specs["router"], act.axes), x, k)

    # the tokens of this rank's group(s): its rows over the whole sequence,
    # or every token when the groups do not follow the dp shards. Under EP
    # each 'model' rank uses its own experts' share of them (the gather's
    # backward sums); otherwise every rank does the same work on them.
    bwd = "sum" if ep else "slice"
    gather_axes = ((), act.seq) if local_groups else (act.batch, act.seq)

    def tokens(z, grad=True):
        for dim, axes in enumerate(gather_axes):
            z = ctx.gather(z, dim, axes, bwd) if grad else ctx.all_gather(z, dim, axes)
        return z

    xg, wg, ig = tokens(x), tokens(w), tokens(idx, grad=False)
    bg, tg = xg.shape[:2]
    n_loc = bg * tg  # tokens this rank dispatches: one group's, or all g groups'
    groups = n_loc // nl
    e_flat = ig.reshape(-1)
    # a slot per (group, expert) run; one group: the expert's own run
    ge = e_flat if groups == 1 else torch.arange(n_loc * k, device=x.device) // (nl * k) * e + e_flat
    pos = slot_positions(ge)
    kept = pos < cap
    # out-of-place scatters into new zero buffers, so that under
    # torch.func.vmap the buffers take each lane's mapped axis
    xr = xg.reshape(n_loc, d).repeat_interleave(k, dim=0)
    # the experts see different tokens on each dp rank only when each holds its own group
    wi_gate, wi_up, wo = (ctx.param(params[n_], specs[n_], act.batch if local_groups else ())
                          for n_ in ("wi_gate", "wi_up", "wo"))
    e_loc = wi_gate.shape[0]  # this rank's experts: E / m when split over 'model'

    if ep:
        rel = e_flat - ctx.index(("model",)) * e_loc
        ok = kept & (rel >= 0) & (rel < e_loc)
        slot = torch.where(ok, rel * cap + pos, e_loc * cap)  # the rank's (E/m, C) buffer, spare row last
        buf = xg.new_zeros(e_loc * cap + 1, d).index_put((slot,), xr)
        rows = torch.zeros(e_loc, dtype=torch.int32, device=x.device).index_add(
            0, torch.where(ok, rel, 0), ok.int())
        ye = _experts(buf[: e_loc * cap].view(1, e_loc, cap, d), wi_gate, wi_up, wo, rows[None],
                      min(e_loc, nl * k))
        yk = ye.reshape(e_loc * cap, d).index_select(0, torch.where(ok, slot, 0))
        yk = torch.where(ok[:, None], yk, torch.zeros((), dtype=yk.dtype, device=yk.device))
        y = (yk.reshape(n_loc, k, d) * wg.reshape(n_loc, k, 1).to(ye.dtype)).sum(dim=1).reshape(bg, tg, d)
        y = ctx.scatter(y, 1, ("model",)) if act.seq else ctx.reduce(y, ("model",))
    else:
        # row of the flat (G*E*C + 1, d) buffer: a kept choice's slot; a
        # dropped one writes the spare last row, which is cut off (the
        # reference's scatter with mode="drop" and gather with mode="fill")
        slot = ge * cap + torch.where(kept, pos, 0)
        spare = groups * e * cap
        buf = xg.new_zeros(spare + 1, d).index_put((torch.where(kept, slot, spare),), xr)
        xe = buf[:spare].view(groups, e, cap, d)
        # each expert's kept rows, min(count, cap), on the device: K5 reads
        # only the experts with rows > 0 (at most min(E, N k) of them) and
        # only their kept rows; h = silu(gate) * up is 0 on every skipped
        # row, so the same rows hold for wo
        rows = torch.zeros(groups * e, dtype=torch.int32, device=x.device).index_add(
            0, ge, kept.int()).view(groups, e)
        if experts_split:  # each 'model' rank its experts' slice; the outputs gathered back
            xe = ctx.chunk(xe, 1, ("model",))
            rows = ctx.take(rows, 1, ("model",))
        ye = _experts(xe, wi_gate, wi_up, wo, rows, min(e_loc, nl * k))
        if experts_split:
            ye = ctx.gather(ye, 1, ("model",), "slice")
        yk = ye.reshape(spare, d).index_select(0, slot)
        yk = torch.where(kept[:, None], yk, torch.zeros((), dtype=yk.dtype, device=yk.device))
        y = (yk.reshape(n_loc, k, d) * wg.reshape(n_loc, k, 1).to(ye.dtype)).sum(dim=1).reshape(bg, tg, d)
        for dim, axes in enumerate(gather_axes):  # back to this rank's block
            y = ctx.chunk(y, dim, axes)

    # Switch load-balance aux over all G groups: E * sum_e f_e * P_e
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).index_add(
        0, e_flat, torch.ones(n_loc * k, dtype=torch.float32, device=x.device))
    n_kept = kept.float().sum()
    if local_groups:  # the other groups' counts are on the other dp ranks
        counts, n_kept = ctx.all_reduce(counts, dp), ctx.all_reduce(n_kept, dp)
    p_e = ctx.reduce(probs.sum(dim=(0, 1)), act.axes) / n
    aux = e * torch.sum(counts / n / k * p_e)
    dropped = 1.0 - n_kept / (n * k)
    return y, {"moe_aux": aux, "moe_dropped": dropped}


def _experts(xe: torch.Tensor, wi_gate, wi_up, wo, rows: torch.Tensor, active: int) -> torch.Tensor:
    """The expert FFN on (G, E, C, d) buffers through K5, one group at a
    time (G is 1 on a rank that holds its own group)."""
    out = []
    for xe_g, rows_g in zip(xe.unbind(0), rows.unbind(0)):
        gate = kops.gmm(xe_g, wi_gate, rows_g, active)
        up = kops.gmm(xe_g, wi_up, rows_g, active)
        h = F.silu(gate.float()).to(xe_g.dtype) * up
        out.append(kops.gmm(h, wo, rows_g, active))
    return out[0][None] if len(out) == 1 else torch.stack(out)
