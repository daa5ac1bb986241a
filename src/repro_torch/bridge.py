"""Carry the JAX package's parameters into the port.

``params_from_numpy`` takes a parameter tree whose leaves are numpy
**float32** arrays — the caller converts with ``np.asarray(x.astype(
jnp.float32))``, because ``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``
— and returns the port's tree: same keys, same shapes, cast to ``dtype`` on
``device``. Both packages then compute the same function on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device


def params_from_numpy(params, *, dtype: torch.dtype = torch.bfloat16, device=None):
    dev = resolve_device(device)

    def convert(x):
        a = np.asarray(x)
        if a.dtype != np.float32:
            raise TypeError(f"params_from_numpy takes float32 leaves, got {a.dtype}")
        return torch.from_numpy(np.array(a, copy=True)).to(device=dev, dtype=dtype)

    return tree.map(convert, params)
