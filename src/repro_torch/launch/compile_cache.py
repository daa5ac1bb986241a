"""Warm provisioning level 1: the in-process executable index.

The counterpart of the JAX package's ``launch/compile_cache.py``. Every
``FunctionInstance`` rebuild (a merge, a resurrect) creates fresh closures,
so a cache keyed by function identity would redo, for a unit it was serving
seconds earlier, what the unit's first call does: the shape-only run on meta
tensors that decides whether an entry is one unit, and what it writes and
hands on. The index keys by *behavior* instead: a digest of every member
spec's bytecode, closure values and defaults, the parameter and argument
tree structure, the bucket, and the environment (torch version, device
kind, kernel sources).

What an index value is here: in JAX it is a compiled program that takes its
params as arguments, so instances share it. A port ``CompiledEntry`` is
neither shareable nor params-free: its ``run`` closes over its instance and
platform, and a captured CUDA graph binds the addresses of that instance's
params. So the index holds only a platform-free record of what the
shape-only run and the first run found (:class:`EntryRecord`); a hit builds
the instance's own ``run`` from it and skips the meta run. A graph is never
shared: every instance captures its own at an entry's second run.

The persistent, cross-process level is the kernel build directory, keyed by
``kernels.build.source_hash()``; the JAX package's ``jax`` compilation cache
has no other counterpart.

Safety invariants:

- Only the structure and dtypes of the params enter the key, so two
  instances with different weights share a record.
- Effectful entries (``ctx.call_async``) are never inserted.
- Closure cells are digested by VALUE (a tensor by its dtype, shape and
  bytes); an ``nn.Module`` by its type and identity, never by its ``repr``,
  which carries no address.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import threading
import types
import weakref
from typing import Any, Mapping

import numpy as np
import torch

_MAX_ARRAY_BYTES = 1 << 20  # full-hash cap; larger arrays are sample-hashed
_SAMPLES = 1024
_MAX_DEPTH = 8
_VIEW_AS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8, torch.float8_e5m2: torch.uint8}


@dataclasses.dataclass(frozen=True)
class EntryRecord:
    """What an instance learns about an entry and another instance may
    reuse: the shape-only run's findings (``effectful`` — always False, an
    effectful entry is never inserted — and ``mutated``, ``handed_on``:
    indices of argument leaves) and, once ``measured``, the first run's
    output and workspace bytes. ``compile_s``: the seconds the shape-only
    run took."""

    compile_s: float
    effectful: bool = False
    mutated: frozenset = frozenset()
    handed_on: frozenset = frozenset()
    output_bytes: int = 0
    workspace_bytes: int = 0
    measured: bool = False


@functools.cache
def environment_key() -> tuple:
    """Everything outside the spec that changes what an entry runs: the torch
    version, the device kind (a CUDA card's compute capability) and the
    kernel sources."""
    from repro_torch.kernels import build

    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability()
        device = f"cuda:sm_{major}{minor}"
    else:
        device = "cpu"
    return (torch.__version__, device, build.source_hash())


def _digest_code(h, code: types.CodeType) -> None:
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    h.update(repr(code.co_varnames).encode())
    h.update(repr(code.co_freevars).encode())
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _digest_code(h, const)  # nested lambdas / comprehensions
        else:
            h.update(repr(const).encode())


def _digest_tensor(h, t: torch.Tensor) -> None:
    """A tensor by value: dtype, shape and every byte up to 1 MiB; above
    that, 1024 evenly spaced elements, gathered on the tensor's own device
    and then fetched."""
    t = t.detach()
    h.update(f"tensor:{t.dtype}:{tuple(t.shape)}".encode())
    if t.device.type == "meta":
        h.update(b"<meta>")
        return
    flat = t.reshape(-1)
    if flat.numel() * flat.element_size() > _MAX_ARRAY_BYTES:
        idx = torch.linspace(0, flat.numel() - 1, _SAMPLES, device=flat.device).long()
        flat = flat[idx]
    flat = flat.contiguous().cpu()
    if flat.dtype in _VIEW_AS:  # dtypes numpy lacks: hash their bit patterns
        flat = flat.view(_VIEW_AS[flat.dtype])
    h.update(memoryview(flat.numpy()))


def _digest_update(h, obj: Any, seen: set[int], depth: int = 0) -> None:
    if depth > _MAX_DEPTH:
        h.update(b"<deep>")
        return
    if obj is None or isinstance(obj, (bool, int, float, complex, str, bytes)):
        h.update(repr(obj).encode())
        return
    oid = id(obj)
    if oid in seen:
        h.update(b"<cycle>")
        return
    seen.add(oid)
    code = getattr(obj, "__code__", None)
    if code is not None:
        _digest_code(h, code)
        for cell in getattr(obj, "__closure__", None) or ():
            try:
                val = cell.cell_contents
            except ValueError:
                val = "<empty-cell>"
            _digest_update(h, val, seen, depth + 1)
        _digest_update(h, getattr(obj, "__defaults__", None), seen, depth + 1)
        kwdefaults = getattr(obj, "__kwdefaults__", None)
        for k in sorted(kwdefaults or ()):
            h.update(k.encode())
            _digest_update(h, kwdefaults[k], seen, depth + 1)
        return
    if isinstance(obj, torch.nn.Module):
        # its repr names the layers but not the weights: two modules with
        # different weights must not collide
        h.update(f"module:{type(obj).__module__}.{type(obj).__qualname__}:{id(obj)}".encode())
        return
    if isinstance(obj, torch.Tensor):
        _digest_tensor(h, obj)
        return
    shape = getattr(obj, "shape", None)
    dtype = getattr(obj, "dtype", None)
    if shape is not None and dtype is not None:
        h.update(f"arr:{dtype}:{shape}".encode())
        try:
            arr = np.asarray(obj)
        except Exception:
            h.update(b"<opaque-array>")
            return
        if arr.nbytes <= _MAX_ARRAY_BYTES:
            h.update(np.ascontiguousarray(arr).tobytes())
        else:
            flat = arr.reshape(-1)
            idx = np.linspace(0, flat.shape[0] - 1, num=_SAMPLES).astype(np.int64)
            h.update(np.ascontiguousarray(flat[idx]).tobytes())
        return
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _digest_update(h, getattr(obj, f.name), seen, depth + 1)
        return
    if isinstance(obj, dict):
        h.update(b"dict")
        try:
            keys = sorted(obj)
        except TypeError:
            keys = list(obj)
        for k in keys:
            h.update(repr(k).encode())
            _digest_update(h, obj[k], seen, depth + 1)
        return
    if isinstance(obj, (list, tuple)):
        h.update(type(obj).__name__.encode())
        for item in obj:
            _digest_update(h, item, seen, depth + 1)
        return
    if isinstance(obj, (set, frozenset)):
        h.update(type(obj).__name__.encode())
        for item in sorted(obj, key=repr):
            _digest_update(h, item, seen, depth + 1)
        return
    if isinstance(obj, types.ModuleType):
        h.update(f"mod:{obj.__name__}".encode())
        return
    # Fallback: repr. Default reprs embed the object address, so two
    # *distinct* unknown objects never collide (conservatively unequal);
    # value-repr'd objects (dtypes, devices, enums, paths) compare by content.
    h.update(repr(obj).encode())


# spec digests are memoized by object identity — FunctionSpec is frozen, and
# the weakref finalizer evicts the id when the spec is collected so a reused
# address can't alias a dead spec's digest. The lock is reentrant: a garbage
# collection while a thread holds it may run that finalizer on the same
# thread (the JAX package's plain Lock can deadlock so).
_SPEC_DIGESTS: dict[int, str] = {}
_SPEC_LOCK = threading.RLock()


def _evict_spec(key: int) -> None:
    with _SPEC_LOCK:
        _SPEC_DIGESTS.pop(key, None)


def spec_digest(spec) -> str:
    """Content digest of a FunctionSpec's *behavior*: name, trust domain,
    and the full fn closure tree. Params are excluded — only their structure
    enters the executable key, separately."""
    key = id(spec)
    with _SPEC_LOCK:
        got = _SPEC_DIGESTS.get(key)
    if got is not None:
        return got
    h = hashlib.blake2b(digest_size=16)
    h.update(spec.name.encode())
    h.update(spec.trust_domain.encode())
    _digest_update(h, spec.fn, set())
    digest = h.hexdigest()
    with _SPEC_LOCK:
        _SPEC_DIGESTS[key] = digest
    weakref.finalize(spec, _evict_spec, key)
    return digest


def members_digest(specs: Mapping[str, Any]) -> str:
    """Digest of a whole execution unit. ``TraceContext.call`` inlines
    co-located members into one unit, so the key must cover EVERY member's
    spec, not just the entry's."""
    h = hashlib.blake2b(digest_size=16)
    for name in sorted(specs):
        h.update(name.encode())
        h.update(spec_digest(specs[name]).encode())
    return h.hexdigest()


class ExecutableIndex:
    """Process-wide LRU of entry records keyed by executable key.

    Values are held opaquely — only ``compile_s`` is read, for the
    saved-seconds counter. Only effect-free entries are ever inserted, so a
    hit is safe to reuse on any instance and platform."""

    GUARDED_FIELDS = {
        "_entries": "_lock",
        "_hits": "_lock",
        "_misses": "_lock",
        "_inserts": "_lock",
        "_evictions": "_lock",
        "_saved_s": "_lock",
    }

    def __init__(self, max_entries: int = 512):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._hits = 0
        self._misses = 0
        self._inserts = 0
        self._evictions = 0
        self._saved_s = 0.0

    def lookup(self, key) -> Any | None:
        if key is None:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            self._saved_s += float(getattr(entry, "compile_s", 0.0))
            return entry

    def insert(self, key, entry) -> None:
        if key is None:
            return
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._entries[key] = entry
                return
            self._entries[key] = entry
            self._inserts += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self._evictions += 1

    def clear(self) -> None:
        """Drop entries AND counters (a measurement of a cold first cycle
        starts from an empty index)."""
        with self._lock:
            self._entries.clear()
            self._hits = 0
            self._misses = 0
            self._inserts = 0
            self._evictions = 0
            self._saved_s = 0.0

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self._hits,
                "misses": self._misses,
                "inserts": self._inserts,
                "evictions": self._evictions,
                "saved_s": round(self._saved_s, 4),
            }


EXECUTABLE_INDEX = ExecutableIndex()
