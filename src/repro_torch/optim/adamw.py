"""AdamW with fp32 first and second moments (the JAX package's
``optim/adamw.py``).

:func:`adamw_update` is functional, as the reference: it returns new
parameter and moment tensors and leaves its inputs as they were, so a
caller that keeps the old state (a training loop's initial state, a
checkpoint being written) still holds it. :func:`adamw_update_` computes
the same bits in place, for a caller that hands its state over: the
reference jits its step and XLA reuses the donated buffers, while eager
PyTorch would hold the old and the new state at once. It walks each leaf's
storage in pieces of at most ``piece`` elements (a stacked leaf is cut
along its leading axes), so its fp32 temporaries are one piece's and not a
128-expert leaf's. Either update is clipped by the global norm of the
gradients and runs in float32 in the reference's order of operations; each
new parameter is cast back to its own dtype. On the card every quantity
stays a tensor (the step, the learning rate, the norm): an update never
reads a device value on the host.

On a mesh the train step runs either update on each rank's local shards
(the same operations on the same elements) and hands it the global norm
(:func:`sharded_global_norm`): each leaf's local sum of squares, summed
over the mesh axes that shard the leaf (a replicated leaf counted once).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.models.params import ParamDef


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_state_defs(param_defs):
    """The optimizer state's ParamDef tree: the step (int32) and m / v with
    the params' shapes in fp32, zero-initialized."""
    as_fp32 = lambda d: dataclasses.replace(d, dtype=torch.float32, init="zeros")  # noqa: E731
    return {
        "step": ParamDef((), (), init="zeros", dtype=torch.int32),
        "m": tree.map(as_fp32, param_defs),
        "v": tree.map(as_fp32, param_defs),
    }


def adamw_init(params):
    """Step 0 and zero moments, on the params' device."""
    leaf = tree.leaves(params)[0]
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
        "m": tree.map(zeros32, params),
        "v": tree.map(zeros32, params),
    }


def global_norm(t) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32."""
    return torch.sqrt(torch.sum(torch.stack([torch.sum(torch.square(x.float())) for x in tree.leaves(t)])))


def sharded_global_norm(grads, specs, ctx) -> torch.Tensor:
    """:func:`global_norm` of the global gradients from a rank's local
    shards: the leaves grouped by the mesh axes that shard them, each
    group's local sum of squares all-reduced over those axes."""
    groups: dict[tuple, list] = {}
    for g, spec in zip(tree.leaves(grads), tree.leaves(specs)):
        axes = tuple(a for a in ctx.names if a in spec.axes())
        groups.setdefault(axes, []).append(torch.sum(torch.square(g.float())))
    total = [ctx.all_reduce(torch.sum(torch.stack(parts)), axes) for axes, parts in groups.items()]
    return torch.sqrt(torch.sum(torch.stack(total)))


def _step_terms(step: torch.Tensor, grads, cfg: AdamWConfig, lr_schedule, gnorm=None):
    """(lr, the gradients' global norm, the clip's scale, the two bias
    corrections) of the update that makes ``step``; ``gnorm``: the norm
    when the caller has it (a mesh's, from the ranks' shards)."""
    stepf = step.float()
    lr = lr_schedule(step) if lr_schedule is not None else torch.tensor(cfg.lr, dtype=torch.float32,
                                                                        device=step.device)
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    return lr, gnorm, scale, 1 - cfg.b1 ** stepf, 1 - cfg.b2 ** stepf


def adamw_update(params, grads, opt_state, cfg: AdamWConfig,
                 lr_schedule: Callable[[torch.Tensor], torch.Tensor] | None = None, *, gnorm=None):
    """Returns (new_params, new_opt_state, metrics): ``metrics`` holds the
    gradients' global norm before clipping (``grad_norm``) and the step's
    learning rate (``lr``), both 0-d fp32 tensors."""
    step = opt_state["step"] + 1
    lr, gnorm, scale, bc1, bc2 = _step_terms(step, grads, cfg, lr_schedule, gnorm)

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new, v_new

    flat_p, struct = tree.flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, tree.leaves(grads), tree.leaves(opt_state["m"]),
                                                 tree.leaves(opt_state["v"]))]
    new_params = tree.unflatten(struct, [o[0] for o in out])
    new_state = {"step": step,
                 "m": tree.unflatten(struct, [o[1] for o in out]),
                 "v": tree.unflatten(struct, [o[2] for o in out])}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


UPDATE_PIECE = 1 << 24  # elements of a leaf updated at once in place: 64 MB per fp32 temporary


def _pieces(leaves):
    """The leaves (a param and its gradient and moments) as tuples of
    views of consecutive pieces of their storage, at most UPDATE_PIECE
    elements each; the whole leaves where one is not contiguous."""
    if not all(x.is_contiguous() for x in leaves):
        return [leaves]
    n, piece = leaves[0].numel(), UPDATE_PIECE
    return [tuple(x.view(-1)[i:i + piece] for x in leaves) for i in range(0, n, piece)] or [leaves]


@torch.no_grad()
def adamw_update_(params, grads, opt_state, cfg: AdamWConfig,
                  lr_schedule: Callable[[torch.Tensor], torch.Tensor] | None = None, *, gnorm=None):
    """:func:`adamw_update` in place: the params, m, v and the step of
    ``opt_state`` become the new state, equal bit for bit to the functional
    update's (the same operations on the same elements: a piece is a view,
    and no ``alpha=`` form fuses two of them). Returns the metrics."""
    step = opt_state["step"]
    step.add_(1)
    lr, gnorm, scale, bc1, bc2 = _step_terms(step, grads, cfg, lr_schedule, gnorm)
    for leaves in zip(tree.leaves(params), tree.leaves(grads), tree.leaves(opt_state["m"]),
                      tree.leaves(opt_state["v"])):
        for p, g, m, v in _pieces(leaves):
            g32 = g.float() * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
            del g32
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
    return {"grad_norm": gnorm, "lr": lr}
