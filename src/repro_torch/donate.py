"""Input donation: the counterpart of ``jax.jit(..., donate_argnums=...)``.

A function must not write its arguments in place: the caller, a recorded
canary or another client may still hold them. The one exception is a run
whose arguments the platform owns — the static inputs of a captured CUDA
graph (``core/function.py``), which the platform refills before every
replay. Inside such a run :func:`donated` is true, and a step that rebuilds
a stacked cache may write the new one into its input's storage instead of a
new buffer, as XLA reuses a donated input buffer for an output. The graph
then holds one copy of the cache, not an input copy and an output copy.
"""
from __future__ import annotations

import contextlib
import threading

_tls = threading.local()


def donated() -> bool:
    """True inside a run whose inputs the platform owns."""
    return getattr(_tls, "on", False)


@contextlib.contextmanager
def donating():
    prev = donated()
    _tls.on = True
    try:
        yield
    finally:
        _tls.on = prev
