"""train_step: loss -> grads -> clipped AdamW update, with optional
gradient-accumulation microbatching (the JAX package's
``training/train_step.py``).

``torch.autograd.grad`` takes the place of ``jax.value_and_grad``: the
params' leaves are detached views that require grad, so a step never
accumulates into ``.grad``. The microbatches run one after the other (the
reference scans over them) and their gradients accumulate in the grad dtype
(bf16 for bf16 params), then divide by their number, as the reference does:
into one accumulator, in place, each microbatch's tree freed once it is
added. A shape-only run (meta tensors) under a cost analysis runs the
microbatch loop once and counts it ``microbatches`` times
(``kernels.cost.trips``); on a device the loop always runs whole.

A step leaves its input state as it was, unless the caller hands the state
over (inside :func:`repro_torch.donate.donating`, the counterpart of the
reference's donated jit argument): then the update is
:func:`~repro_torch.optim.adamw.adamw_update_`, in place, equal bit for bit
to the functional one, and the returned state is the input's tensors.
"""
from __future__ import annotations

import torch

from repro_torch import donate, tree
from repro_torch.kernels import cost as kcost
from repro_torch.models.model import Model
from repro_torch.sharding import spmd
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_state_defs, adamw_update, adamw_update_,
                                     sharded_global_norm)


def _microbatches(batch, n: int) -> list:
    """The ``n`` microbatches of ``batch``: consecutive slices of its rows;
    on a mesh, of each rank's rows (a ``DTensor`` of the slice's global
    shape)."""
    def split(x):
        if not spmd.is_dtensor(x):
            return x.reshape(n, x.shape[0] // n, *x.shape[1:]).unbind(0)
        local = x.to_local()
        shape = (x.shape[0] // n, *x.shape[1:])
        return [spmd.as_dtensor(part, x.device_mesh, x.placements, shape)
                for part in local.reshape(n, local.shape[0] // n, *local.shape[1:]).unbind(0)]

    leaves, struct = tree.flatten(batch)
    parts = [split(x) for x in leaves]
    return [tree.unflatten(struct, [p[i] for p in parts]) for i in range(n)]


def make_train_state_defs(model: Model):
    return {"params": model.param_defs, "opt": adamw_state_defs(model.param_defs)}


def init_train_state(model: Model, seed: int = 0, *, device=None):
    """Params from ``seed`` (``model.init``) on ``device`` (default: the
    card) and a fresh AdamW state beside them."""
    params = model.init(seed, device=device)
    return {"params": params, "opt": adamw_init(params)}


def value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads) of ``model.loss_fn`` at ``params``, detached:
    the counterpart of ``jax.value_and_grad(loss_fn, has_aux=True)``. The
    gradients are of the params' tree and dtypes; a leaf the loss does not
    read (the token table under ``embeds``) has a zero gradient, as in JAX."""
    leaves, struct = tree.flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = model.loss_fn(tree.unflatten(struct, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree.unflatten(struct, grads)


def make_train_step(model: Model, opt_cfg: AdamWConfig | None = None, lr_schedule=None):
    """``train_step(state, batch) -> (new_state, metrics)``: the loss's
    metrics (``loss``, ``ce``, ...) averaged over the microbatches, plus
    ``grad_norm`` and ``lr``, all 0-d fp32 tensors on the state's device.
    Called inside ``donate.donating()``, it updates ``state`` in place and
    returns it."""
    opt_cfg = opt_cfg or AdamWConfig()
    n_micro = max(1, model.cfg.microbatches)

    def train_step(state, batch):
        in_place = donate.donated()
        params = state["params"]
        mesh = next((x.device_mesh for x in tree.leaves(params) if spmd.is_dtensor(x)), None)
        if n_micro == 1:
            loss, metrics, grads = value_and_grad(model, params, batch)
            grads = tree.map(spmd.local_of, grads)
        else:
            micro = _microbatches(batch, n_micro)
            grads = None
            loss = metrics = None
            for i in kcost.trips(n_micro, "microbatches", like=spmd.local_of(tree.leaves(micro[0])[0])):
                l, m, g = value_and_grad(model, params, micro[i])
                g = tree.map(spmd.local_of, g)
                if grads is None:  # the accumulator: in the grad dtype, on each rank's shard
                    grads = tree.map(torch.zeros_like, g)
                for a, b in zip(tree.leaves(grads), tree.leaves(g)):
                    a.add_(b.to(a.dtype))
                del g  # this microbatch's gradients, before the next one's
                loss = l if loss is None else loss + l
                metrics = m if metrics is None else tree.map(lambda a, b: a + b, metrics, m)
            for a in tree.leaves(grads):
                a.div_(n_micro)
            loss = loss / n_micro
            metrics = tree.map(lambda m: m / n_micro, metrics)

        gnorm = None
        opt = state["opt"]
        if mesh is not None:  # the update on each rank's shards, with the global norm
            with torch.no_grad():
                (params, opt), (specs, _) = spmd.split((params, opt))
            gnorm = sharded_global_norm(grads, specs, spmd.ctx_for(mesh))
        if in_place:
            opt_metrics = adamw_update_(params, grads, opt, opt_cfg, lr_schedule, gnorm=gnorm)
            new_state = state
        else:
            new_params, new_opt, opt_metrics = adamw_update(params, grads, opt, opt_cfg, lr_schedule, gnorm=gnorm)
            new_state = {"params": new_params, "opt": new_opt}
            if mesh is not None:
                new_state = tree.map(lambda new, old: spmd.as_dtensor(new, old.device_mesh, old.placements,
                                                                      old.shape), new_state, state)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return new_state, metrics

    return train_step
