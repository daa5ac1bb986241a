"""Carry the JAX package's parameters into the port.

``params_from_numpy`` takes a parameter tree whose leaves are numpy
**float32** arrays — the caller converts with ``np.asarray(x.astype(
jnp.float32))``, because ``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``
— and the port's ``ParamDef`` tree of the same model, and returns the port's
tree: same keys, same shapes, each leaf in the dtype its def gives it (the
MoE router stays float32 beside bf16 weights), widened to ``dtype`` where
that is wider, on ``device``. Both packages then compute the same function
on the same weights. ``train_state_from_numpy`` does the same for a whole
train state, so both packages take the same step from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device


def params_from_numpy(params, defs, *, dtype: torch.dtype = torch.bfloat16, device=None):
    """``dtype=torch.bfloat16`` gives every leaf its def's dtype;
    ``dtype=torch.float32`` gives every leaf float32 (a float32 reference)."""
    dev = resolve_device(device)

    def convert(x, d):
        a = np.asarray(x)
        if a.dtype != np.float32:
            raise TypeError(f"params_from_numpy takes float32 leaves, got {a.dtype}")
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"leaf of shape {a.shape} for a def of shape {d.shape}")
        return torch.from_numpy(np.array(a, copy=True)).to(
            device=dev, dtype=torch.promote_types(d.dtype, dtype))

    return tree.map(convert, params, defs)


def train_state_from_numpy(state, param_defs, *, dtype: torch.dtype = torch.bfloat16, device=None):
    """The JAX package's train state ``{"params", "opt": {"step", "m",
    "v"}}`` (float32 numpy leaves; the step an integer array or int) as the
    port's: the params by :func:`params_from_numpy`, the moments float32
    tensors of the params' shapes, the step a 0-d int32 tensor, all on
    ``device``."""
    dev = resolve_device(device)
    params = params_from_numpy(state["params"], param_defs, dtype=dtype, device=dev)

    def moment(x, p):
        a = np.asarray(x)
        if a.dtype != np.float32 or tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"a moment must be float32 of its param's shape {tuple(p.shape)}, got "
                             f"{a.dtype} {a.shape}")
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    opt = state["opt"]
    return {
        "params": params,
        "opt": {
            "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32, device=dev),
            "m": tree.map(moment, opt["m"], params),
            "v": tree.map(moment, opt["v"], params),
        },
    }
