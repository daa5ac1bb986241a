"""Dispatch-hygiene tracer: steady-state new programs and host syncs.

Two hazards a serving loop must not have in steady state:

* **New programs.** The port makes a program where the reference compiles
  one: a new compiled entry (its shape-only run on meta tensors is the
  port's ``jax.jit(...).trace``), the CUDA-graph capture of an entry, and a
  new batched bucket (``core/function.py`` reports each through
  :meth:`DispatchTracer.note_compile`). A decode loop whose shapes are not
  padded to a closed set makes new ones mid-stream, so
  ``delta(snapshot).compiles == 0`` is the "no new programs" assertion.

* **Per-token host syncs.** A device→host fetch inside the token loop
  serializes every step on a transfer. While armed the tracer patches
  ``Tensor.item``, ``Tensor.tolist``, ``Tensor.numpy`` (which
  ``numpy.asarray(tensor)`` reaches through ``Tensor.__array__``) and
  ``Tensor.cpu``, and counts each fetch once: ``.cpu()`` counts only on a
  CUDA tensor (elsewhere it moves nothing), and the host tensor it returns
  is marked so that ``.cpu().numpy()`` counts once. A fetch made inside
  another counted fetch is not counted again. On the card the armed window
  also turns on ``torch.cuda.set_sync_debug_mode("warn")`` and counts its
  warnings (``cuda_syncs``): every synchronizing CUDA call, the fetches and
  the device syncs that end an execution alike, so none escapes. The smoke
  gate allows one batched fetch per decode step plus O(1) per request
  (seating/finishing) and fails on anything per-token-per-lane.

The tracer is a process-wide singleton (``TRACER``), disarmed by default
(zero overhead: arming is what installs the patches; the last disarm
restores the originals). ``kernels/ops.py`` reports eager kernel entries
informationally (eager dispatch is legitimate on the unfused glue path).
"""
from __future__ import annotations

import dataclasses
import threading
import warnings

from repro_torch.analysis.guards import guarded_by

_FETCHES = ("item", "tolist", "numpy", "cpu")
_SYNC_WARNING = "called a synchronizing CUDA operation"
_PROGRAM_KINDS = ("entries", "captures", "buckets")


@dataclasses.dataclass(frozen=True)
class DispatchSnapshot:
    compiles: int
    host_syncs: int
    decode_steps: int
    kernel_calls: int
    # the compiles by kind, and the card's synchronizing calls
    entries: int = 0
    captures: int = 0
    buckets: int = 0
    cuda_syncs: int = 0


class DispatchTracer:
    """Armable new-program + host-sync counter. See module docstring.

    Thread-safe and re-entrant: ``arm``/``disarm`` are ref-counted under
    ``_mu``, so overlapping measurement windows never double-install the
    patches, and never capture an installed wrapper as the "original" to
    restore, which would leak the patch forever."""

    GUARDED_FIELDS = {
        "_arm_count": "_mu",
        "_unpatch": "_mu",
        "programs": "_mu",
        "host_syncs": "_mu",
        "decode_steps": "_mu",
        "kernel_calls": "_mu",
        "cuda_syncs": "_mu",
    }

    def __init__(self):
        self._mu = threading.Lock()
        # lock-free fast-path flag the hot hooks read; written ONLY under
        # _mu. A stale read at an arm/disarm boundary misses/adds at most
        # one in-flight event — never a leak or a crash — so the hooks
        # stay O(1) with no lock acquisition while disarmed.
        self._armed = False
        self._arm_count = 0
        self._unpatch = None  # installed patches' restore thunk, or None
        self._tls = threading.local()  # depth of counted fetches on this thread
        self.programs = dict.fromkeys(_PROGRAM_KINDS, 0)
        self.host_syncs = 0
        self.decode_steps = 0
        self.kernel_calls: dict[str, int] = {}
        self.cuda_syncs = 0

    @property
    def armed(self) -> bool:
        return self._armed

    # -- wiring ------------------------------------------------------------

    def _count_sync(self) -> None:
        with self._mu:
            if self._arm_count > 0:
                self.host_syncs += 1

    def _fetch_wrapper(self, name: str, orig):
        tracer = self

        def fetch(t, *args, **kw):
            tls = tracer._tls
            depth = getattr(tls, "depth", 0)
            if not tracer._armed or depth:
                return orig(t, *args, **kw)
            counted = (t.is_cuda if name == "cpu"
                       else t.device.type != "meta" and not getattr(t, "_dispatch_fetched", False))
            if counted:
                tracer._count_sync()
            tls.depth = depth + 1
            try:
                out = orig(t, *args, **kw)
            finally:
                tls.depth = depth
            if counted and name == "cpu":
                out._dispatch_fetched = True  # its .numpy() moves nothing more
            return out

        return fetch

    @guarded_by("_mu")
    def _patch(self) -> None:
        """Install the fetch-counting wrappers (and, on the card, the
        sync-debug mode). Only called on the 0 -> 1 arm transition with the
        previous patches restored, so the captured originals are always the
        real methods."""
        if self._unpatch is not None:
            return
        import torch

        own = {name: torch.Tensor.__dict__.get(name) for name in _FETCHES}
        for name in _FETCHES:
            setattr(torch.Tensor, name, self._fetch_wrapper(name, getattr(torch.Tensor, name)))
        restore_sync = self._watch_cuda_syncs(torch)

        def unpatch():
            for name, fn in own.items():
                if fn is None:
                    delattr(torch.Tensor, name)  # the inherited method shows again
                else:
                    setattr(torch.Tensor, name, fn)
            restore_sync()

        self._unpatch = unpatch

    def _watch_cuda_syncs(self, torch):
        """On the card: warn on every synchronizing CUDA call and count the
        warnings; returns the restore thunk."""
        if not torch.cuda.is_available():
            return lambda: None
        prev_mode = torch.cuda.get_sync_debug_mode()
        prev_show = warnings.showwarning
        tracer = self

        def showwarning(message, category, filename, lineno, file=None, line=None):
            if _SYNC_WARNING in str(message):
                with tracer._mu:
                    if tracer._arm_count > 0:
                        tracer.cuda_syncs += 1
                return
            prev_show(message, category, filename, lineno, file, line)

        # every occurrence, not once per call site (the default filter)
        warnings.filterwarnings("always", message=_SYNC_WARNING, category=UserWarning)
        sync_filter = warnings.filters[0]
        warnings.showwarning = showwarning
        torch.cuda.set_sync_debug_mode("warn")

        def restore():
            torch.cuda.set_sync_debug_mode(prev_mode)
            warnings.showwarning = prev_show
            if sync_filter in warnings.filters:
                warnings.filters.remove(sync_filter)

        return restore

    # -- public API --------------------------------------------------------

    def arm(self) -> None:
        """Begin (or join) a measurement window. Every ``arm`` needs a
        matching ``disarm``; patches install on the first and are removed
        by the last, so mid-flight re-arms neither double-count nor leak."""
        with self._mu:
            self._arm_count += 1
            if self._arm_count == 1:
                self._patch()
                self._armed = True

    def disarm(self) -> None:
        with self._mu:
            if self._arm_count == 0:
                return  # idempotent: stray disarms don't underflow
            self._arm_count -= 1
            if self._arm_count == 0:
                self._armed = False
                if self._unpatch is not None:
                    self._unpatch()
                    self._unpatch = None

    def note_compile(self, kind: str) -> None:
        """A new program: ``"entries"`` (a compiled entry), ``"captures"``
        (a CUDA-graph capture) or ``"buckets"`` (a batched bucket)."""
        if self._armed:
            with self._mu:
                if self._arm_count > 0:
                    self.programs[kind] += 1

    def note_decode_step(self) -> None:
        if self._armed:
            with self._mu:
                self.decode_steps += 1

    def note_kernel_call(self, name: str, probe=None) -> None:
        """Informational: an op entry executed eagerly on a real tensor.

        Legitimate on the unfused glue path; recorded so smoke reports show
        the eager/captured split, never asserted on. A shape-only run (meta
        tensors) and a run being captured note nothing: a captured graph's
        replays run no Python."""
        if not self._armed:
            return
        if probe is not None:
            if probe.device.type == "meta":
                return
            if probe.is_cuda:
                import torch

                if torch.cuda.is_current_stream_capturing():
                    return
        with self._mu:
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    def snapshot(self) -> DispatchSnapshot:
        with self._mu:
            return DispatchSnapshot(
                compiles=sum(self.programs.values()),
                host_syncs=self.host_syncs,
                decode_steps=self.decode_steps,
                kernel_calls=sum(self.kernel_calls.values()),
                cuda_syncs=self.cuda_syncs,
                **self.programs,
            )

    def delta(self, since: DispatchSnapshot) -> DispatchSnapshot:
        now = self.snapshot()
        return DispatchSnapshot(**{f.name: getattr(now, f.name) - getattr(since, f.name)
                                   for f in dataclasses.fields(DispatchSnapshot)})


#: Process-wide tracer instance the instrumentation hooks report into.
TRACER = DispatchTracer()
