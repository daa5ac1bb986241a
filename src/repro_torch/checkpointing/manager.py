"""Content-addressed instance snapshots: the snapshot half of the JAX
package's ``checkpointing/manager.py`` (``CheckpointManager`` waits for
training).

A snapshot stores *logical* content: every tensor leaf of a parameter tree,
keyed by its tree path, as a ``.npy`` file, plus a ``meta.json`` with each
leaf's dtype and shape. numpy has no bfloat16 or float8, so such a leaf is
stored as a same-width integer view and its true dtype is recorded by name.
The digest hashes each leaf's path, dtype name, shape and raw bytes, so a
round trip is bit-exact by construction.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.scheduler.clock import SYSTEM_CLOCK

# dtypes numpy cannot hold, stored as same-width integer views
_VIEW_AS = {
    torch.bfloat16: torch.int16,
    torch.float8_e4m3fn: torch.uint8,
    torch.float8_e5m2: torch.uint8,
}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _flatten_with_paths(t) -> dict:
    """{"a/b/0": leaf}: dict keys and sequence indices joined by "/", as the
    JAX package joins its key paths."""
    out: dict = {}
    _paths(t, (), out)
    return out


def _paths(node, prefix: tuple, out: dict) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _paths(node[k], (*prefix, str(k)), out)
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            _paths(x, (*prefix, str(i)), out)
    else:
        out["/".join(prefix)] = node


def _host_leaf(x) -> tuple[str, tuple, np.ndarray]:
    """(dtype name, shape, host array of the raw bytes): one device-to-host
    copy of a tensor leaf, viewed as an integer array where numpy lacks the
    dtype."""
    t = torch.as_tensor(x).detach()
    name, shape = _dtype_name(t.dtype), tuple(t.shape)
    t = t.contiguous().cpu()
    if t.dtype in _VIEW_AS:
        t = t.view(_VIEW_AS[t.dtype])
    return name, shape, t.numpy()


def _update(h, key: str, name: str, shape: tuple, data) -> None:
    h.update(key.encode())
    h.update(name.encode())
    h.update(repr(shape).encode())
    h.update(memoryview(np.ascontiguousarray(data)))


def snapshot_digest(t) -> str:
    """Content address of a parameter tree: its structure plus every leaf's
    path, dtype, shape, and full bytes. Two trees share a digest iff they
    restore identically."""
    return _digest_host(t, {k: _host_leaf(x) for k, x in _flatten_with_paths(t).items()})


def _digest_host(t, host: dict) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(str(tree.flatten(t)[1]).encode())
    for key in sorted(host):
        _update(h, key, *host[key])
    return h.hexdigest()


class SnapshotIntegrityError(RuntimeError):
    """Restored bytes do not re-hash to the requested digest (on-disk
    corruption / truncation)."""


class SnapshotStore:
    """Content-addressed instance snapshots — warm-provisioning level 2.

    Layout: ``<dir>/<digest>/leaf_00000.npy .. leaf_NNNNN.npy + meta.json``
    where the digest is :func:`snapshot_digest` of the param tree. Writes go
    to a ``<digest>.<writer>.tmp`` directory and ``os.rename`` into place
    (crash-atomic; a writer that loses the rename to an identical snapshot
    counts a dedup hit); ``put``
    of an already-stored tree is a metadata touch (content-address dedup — a
    fleet of same-weights functions stores one copy). ``restore`` reads each
    leaf once from its memmap into a writable host buffer (pinned when the
    leaf goes to a CUDA device), re-hashes those host bytes against the
    digest, and copies them to the leaf's device once: a resurrect either
    gets bit-exact params or an integrity error, never silent corruption.

    ``retain`` > 0 keeps only the N most-recently-used snapshots (mtime LRU;
    both put-dedup and restore refresh recency). 0 disables eviction — the
    platform pins parked functions' snapshots simply by not enabling it.
    """

    GUARDED_FIELDS = {
        "puts": "_lock",
        "dedup_hits": "_lock",
        "restores": "_lock",
        "put_s": "_lock",
        "restore_s": "_lock",
        "evicted": "_lock",
    }

    def __init__(self, directory: str, *, retain: int = 0, clock=None):
        self.directory = directory
        self.retain = retain
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self.puts = 0
        self.dedup_hits = 0
        self.restores = 0
        self.put_s = 0.0
        self.restore_s = 0.0
        self.evicted = 0

    def path_of(self, digest: str) -> str:
        return os.path.join(self.directory, digest)

    def contains(self, digest: str) -> bool:
        return os.path.isdir(self.path_of(digest))

    def put(self, t) -> str:
        """Store ``t`` under its content address; returns the digest. Each
        leaf is fetched to the host once, hashed and written from there."""
        t0 = time.perf_counter()
        flat = _flatten_with_paths(t)
        host = {k: _host_leaf(x) for k, x in flat.items()}
        digest = _digest_host(t, host)
        final = self.path_of(digest)
        if os.path.isdir(final):
            os.utime(final)  # refresh LRU recency
            with self._lock:
                self.dedup_hits += 1
            return digest
        # a writer's own temporary directory: two parks of the same weights
        # at once (the idle tick racing an explicit scale_to_zero) must not
        # write into, or delete, each other's
        tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        keys = sorted(flat)
        meta = {
            "digest": digest,
            "keys": keys,
            "treedef": str(tree.flatten(t)[1]),
            "dtypes": {k: host[k][0] for k in keys},
            # the tensor's own shape: np.save of a 0-d array reads back as (1,)
            "shapes": {k: list(host[k][1]) for k in keys},
            "wall_time": self.clock.now(),
        }
        for i, key in enumerate(keys):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), np.ascontiguousarray(host[key][2]))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        try:
            os.rename(tmp, final)  # atomic publish
        except OSError:
            if not os.path.isdir(final):
                raise
            shutil.rmtree(tmp)  # an identical snapshot was published meanwhile
            with self._lock:
                self.dedup_hits += 1
            return digest
        with self._lock:
            self.puts += 1
            self.put_s += time.perf_counter() - t0
        self._evict()
        return digest

    def restore(self, digest: str, like, *, devices=None, verify: bool = True, parts: dict | None = None):
        """Rebuild the tree of ``like`` (tensors, or meta tensors as the
        port's ``ShapeDtypeStruct``) from the snapshot at ``digest``. Each
        leaf goes to its device in ``devices`` (a tree of the same structure),
        else to its ``like`` leaf's own device; a meta leaf without a device
        raises, so a leaf that lived on the card never lands on the host
        unasked. ``verify=True`` re-hashes the host bytes read and raises
        :class:`SnapshotIntegrityError` on a mismatch. ``parts``, when given,
        gets the seconds spent reading (``read_s``), hashing (``verify_s``)
        and copying to the devices (``copy_s``) added to it."""
        t0 = time.perf_counter()
        final = self.path_of(digest)
        if not os.path.isdir(final):
            raise FileNotFoundError(f"no snapshot {digest} in {self.directory}")
        os.utime(final)  # refresh LRU recency
        with open(os.path.join(final, "meta.json")) as f:
            meta = json.load(f)
        flat_like = _flatten_with_paths(like)
        flat_dev = _flatten_with_paths(devices) if devices is not None else {}
        index = {k: i for i, k in enumerate(meta["keys"])}
        h = hashlib.blake2b(digest_size=16)
        h.update(str(tree.flatten(like)[1]).encode())
        read_s = verify_s = copy_s = 0.0
        out: dict = {}
        cuda_devices = set()
        for key in sorted(flat_like):
            leaf = flat_like[key]
            dev = torch.device(flat_dev[key]) if key in flat_dev else leaf.device
            if dev.type == "meta":
                raise ValueError(f"snapshot leaf {key!r}: a meta tensor needs its device in devices=")
            name, shape = meta["dtypes"][key], tuple(meta["shapes"][key])
            t1 = time.perf_counter()
            # a memmap is never 0-d (np.load promotes it to (1,)): reshape
            # to the recorded shape, a view
            arr = np.load(os.path.join(final, f"leaf_{index[key]:05d}.npy"), mmap_mode="r").reshape(shape)
            stored = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            staged = torch.empty(shape, dtype=stored, pin_memory=dev.type == "cuda")
            np.copyto(staged.numpy(), arr)  # the one read; torch refuses a read-only memmap
            t2 = time.perf_counter()
            if verify:
                _update(h, key, name, shape, staged.numpy())
            t3 = time.perf_counter()
            value = staged.view(getattr(torch, name))
            out[key] = value.to(device=dev, dtype=leaf.dtype, non_blocking=True)
            if dev.type == "cuda":
                cuda_devices.add(dev)
            read_s, verify_s, copy_s = read_s + t2 - t1, verify_s + t3 - t2, copy_s + time.perf_counter() - t3
        t4 = time.perf_counter()
        for dev in cuda_devices:
            torch.cuda.synchronize(dev)
        copy_s += time.perf_counter() - t4
        if verify and h.hexdigest() != digest:
            raise SnapshotIntegrityError(f"snapshot {digest} restored with digest {h.hexdigest()}")
        if parts is not None:
            for k, v in (("read_s", read_s), ("verify_s", verify_s), ("copy_s", copy_s)):
                parts[k] = parts.get(k, 0.0) + v
        with self._lock:
            self.restores += 1
            self.restore_s += time.perf_counter() - t0
        return tree.unflatten(tree.flatten(like)[1], [out[k] for k in _flatten_with_paths(like)])

    def _evict(self) -> None:
        if not self.retain:
            return
        dirs = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.endswith(".tmp") or not os.path.isdir(path):
                continue
            dirs.append((os.path.getmtime(path), path))
        dirs.sort()
        for _, path in dirs[: -self.retain]:
            shutil.rmtree(path, ignore_errors=True)
            with self._lock:
                self.evicted += 1

    def stats(self) -> dict:
        with self._lock:
            out = {
                "puts": self.puts,
                "dedup_hits": self.dedup_hits,
                "restores": self.restores,
                "put_s": round(self.put_s, 4),
                "restore_s": round(self.restore_s, 4),
                "evicted": self.evicted,
            }
        out["entries"] = sum(
            1 for d in os.listdir(self.directory) if not d.endswith(".tmp")
        )
        return out
