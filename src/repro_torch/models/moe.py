"""Top-k token-choice Mixture-of-Experts with capacity buffers.

The Switch-Transformer capacity formulation of the JAX package
(``repro/models/moe.py``), token for token, on one device (one group):

  1. route: fp32 router logits -> softmax -> top-k experts per token and
     their weights, renormalised (floor 1e-9)
  2. position: each (token, choice)'s slot in its expert's buffer, from a
     stable sort by expert and a running maximum of the run starts; slots at
     or past the capacity C are dropped
  3. dispatch: scatter the token vectors into an (E, C, d) buffer
  4. compute: the per-expert products gate/up and down through K5
     (``kernels.ops.gmm``), SiLU in fp32
  5. combine: gather each token's k expert outputs, weighted sum

Nothing here reads a tensor value on the host and no shape depends on the
data (no ``nonzero``, no boolean indexing), so a fused chain that holds MoE
layers stays one unit under the platform's shape-only run on meta tensors.
The JAX package's sharded schedules (``shard_map`` dispatch and the
expert-parallel combine) need a device mesh and are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.params import ParamDef


def moe_defs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {
        "router": ParamDef((d, e), dtype=torch.float32),
        "wi_gate": ParamDef((e, d, f)),
        "wi_up": ParamDef((e, d, f)),
        "wo": ParamDef((e, f, d)),
    }


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.num_experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(8, _round_up(c, 8))


def num_groups(n_tokens: int, batch: int, cfg: ModelConfig, rules=None) -> int:
    """Token groups of the dispatch. The JAX package takes one per
    data-parallel shard of its mesh; without a mesh (``rules is None``, the
    only case the port runs) there is one."""
    if rules is not None:
        raise NotImplementedError("the port runs the MoE layer without a device mesh")
    return 1


def route(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, T, d) -> (probs (B, T, E) fp32, idx (N*k,) int64, weights
    (N, k) fp32, pos (N*k,) int64): each (token, choice)'s expert and its
    slot in that expert's buffer, in token-major order."""
    k = cfg.num_experts_per_tok
    logits = torch.einsum("btd,de->bte", x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)  # sorted, as jax.lax.top_k
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
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
    fp32 tensors)."""
    b, t, d = x.shape
    n = b * t
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    num_groups(n, b, cfg, rules)  # one group: there is no mesh to shard over
    cap = capacity(n, cfg)

    probs, e_flat, w, pos = route(params, x, cfg)
    kept = pos < cap
    # row of the flat (E*C + 1, d) buffer: a kept choice's slot; a dropped
    # one writes the spare last row, which is cut off (the reference's
    # scatter with mode="drop" and gather with mode="fill")
    slot = e_flat * cap + torch.where(kept, pos, 0)
    # out-of-place scatters into new zero buffers, so that under
    # torch.func.vmap the buffers take each lane's mapped axis
    buf = x.new_zeros(e * cap + 1, d).index_put(
        (torch.where(kept, slot, e * cap),), x.reshape(n, d).repeat_interleave(k, dim=0))
    xe = buf[: e * cap].view(e, cap, d)
    # each expert's kept rows, min(count, cap), on the device: K5 reads only
    # the experts with rows > 0 (at most min(E, N k) of them) and only their
    # kept rows; h = silu(gate) * up is 0 on every skipped row, so the same
    # rows hold for wo
    rows = torch.zeros(e, dtype=torch.int32, device=x.device).index_add(0, e_flat, kept.int())
    active = min(e, n * k)

    gate = kops.gmm(xe, params["wi_gate"], rows, active)
    up = kops.gmm(xe, params["wi_up"], rows, active)
    h = F.silu(gate.float()).to(xe.dtype) * up
    ye = kops.gmm(h, params["wo"], rows, active)  # wo: (E, f, d)

    yk = ye.reshape(e * cap, d).index_select(0, slot)
    yk = torch.where(kept[:, None], yk, torch.zeros((), dtype=yk.dtype, device=yk.device))
    y = (yk.reshape(n, k, d) * w[:, :, None].to(ye.dtype)).sum(dim=1).reshape(b, t, d)

    # Switch load-balance aux: E * sum_e f_e * P_e
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).index_add(
        0, e_flat, torch.ones(n * k, dtype=torch.float32, device=x.device))
    aux = e * torch.sum(counts / n / k * probs.mean(dim=(0, 1)))
    dropped = 1.0 - kept.float().mean()
    return y, {"moe_aux": aux, "moe_dropped": dropped}
