"""Input donation: the counterpart of ``jax.jit(..., donate_argnums=...)``.

A function must not write its arguments in place: the caller, a recorded
canary or another client may still hold them. The one exception is a run
whose arguments the platform owns — the static inputs of a captured CUDA
graph (``core/function.py``), which the platform refills before every
replay. Inside such a run :func:`donated` is true, and a step that rebuilds
a stacked cache may write the new one into its input's storage instead of a
new buffer, as XLA reuses a donated input buffer for an output. The graph
then holds one copy of the cache, not an input copy and an output copy.

A training step is the other: a caller that hands its state to
``train_step`` inside :func:`donating` gets the state back updated in place
(``training/train_step.py``), so the card holds one training state and not
an old and a new one. ``TrainLoop`` donates every state it owns (each step's
output) and the caller's initial state only when the caller donates it.
"""
from __future__ import annotations

import contextlib
import threading

_tls = threading.local()


def donated() -> bool:
    """True inside a run whose inputs the platform owns."""
    return getattr(_tls, "on", False)


@contextlib.contextmanager
def donating(on: bool = True):
    """Inside: :func:`donated` is ``on``."""
    prev = donated()
    _tls.on = on
    try:
        yield
    finally:
        _tls.on = prev
