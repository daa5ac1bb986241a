"""Step-atomic training checkpoints (:class:`CheckpointManager`) and
content-addressed instance snapshots (:class:`SnapshotStore`): the JAX
package's ``checkpointing/manager.py``.

A checkpoint is written to ``step_<N>.tmp/`` and ``os.rename``d into place,
so a crash mid-save never leaves a readable-but-corrupt checkpoint. Its
format is the reference's, so a checkpoint written by either package
restores into the other bit for bit: ``arrays.npz`` holds every leaf keyed
by its ``/``-joined tree path (bf16 as ``uint16`` views, float8 as
``uint8``), and ``meta.json`` the step, the keys, each leaf's dtype name and
shape, and the wall time.

On a mesh a state's leaves are ``DTensor``s: ``save`` writes each leaf's
global value (gathered on every rank, written by rank 0; the others wait),
so the format stays the reference's, and ``restore`` places each rank's
shard of the global value onto the placements asked for (or the ``like``
leaf's own), so a state saved on one mesh restores bit for bit on another
or on none.

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
from repro_torch.sharding import spmd

# dtypes numpy cannot hold, stored as same-width integer views
_VIEW_AS = {
    torch.bfloat16: torch.int16,
    torch.float8_e4m3fn: torch.uint8,
    torch.float8_e5m2: torch.uint8,
}


# the reference's views on disk (numpy's names: bf16 as uint16, float8 as uint8)
_NP_VIEW = {torch.bfloat16: np.uint16, torch.float8_e4m3fn: np.uint8, torch.float8_e5m2: np.uint8}
_VIEW_BACK = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


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


def _host_copy(x) -> torch.Tensor:
    """A host tensor that owns its bytes: a copy even of a CPU leaf, so a
    snapshot taken for an async save is not changed by later steps."""
    return torch.as_tensor(x).detach().to("cpu", copy=True)


def _stored_array(t: torch.Tensor) -> np.ndarray:
    """The array of a host tensor as the reference stores it: bf16 and
    float8 as same-width unsigned integer views."""
    t = t.contiguous()
    if t.dtype in _NP_VIEW:
        return t.view(_VIEW_AS[t.dtype]).numpy().view(_NP_VIEW[t.dtype])
    return t.numpy()


def _global(x):
    return x.full_tensor() if spmd.is_dtensor(x) else x


def _writer_rank() -> bool:
    """Whether this process writes a mesh state's checkpoint: rank 0."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointSaveError(RuntimeError):
    """An async save worker failed. Raised on the NEXT ``wait()`` /
    ``latest_step()`` / ``save()`` — the thread itself can only die silently,
    and a training loop that keeps stepping against a checkpointer that
    stopped persisting is the failure mode this surfaces."""


class CheckpointManager:
    """Save and restore a training state (a tree of tensors) by step, with
    retention (the newest ``retain`` steps are kept) and an optional async
    save on a worker thread, whose failure surfaces on the next ``wait``,
    ``latest_step`` or ``save``. ``writer`` replaces ``np.savez`` (tests
    inject a failing one); ``clock`` stamps ``meta.json``."""

    def __init__(self, directory: str, *, retain: int = 3, async_save: bool = False,
                 clock=None, writer=None):
        self.directory = directory
        self.retain = retain
        self.async_save = async_save
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        os.makedirs(directory, exist_ok=True)
        self._save_thread: threading.Thread | None = None
        self._save_error: BaseException | None = None
        self._writer = writer if writer is not None else np.savez
        self.save_log: list[dict] = []

    # --------------------------------------------------------------- save

    def save(self, step: int, state) -> None:
        if any(spmd.is_dtensor(x) for x in tree.leaves(state)):
            import torch.distributed as dist

            state = tree.map(_global, state)  # every rank gathers: a collective per leaf
            if _writer_rank():
                self._save_local(step, state)
            dist.barrier()  # a synchronous save is on disk for every rank
            return
        self._save_local(step, state)

    def _save_local(self, step: int, state) -> None:
        if self.async_save:
            host_state = tree.map(_host_copy, state)  # snapshot before the step moves on
            self.wait()  # one in-flight save at a time; surfaces a prior failure
            self._save_thread = threading.Thread(
                target=self._save_guarded, args=(step, host_state), daemon=True
            )
            self._save_thread.start()
        else:
            self._save_sync(step, state)

    def _save_guarded(self, step: int, state) -> None:
        try:
            self._save_sync(step, state)
        except BaseException as exc:  # noqa: BLE001 — captured, re-raised on wait()
            self._save_error = exc

    def _surface_save_error(self) -> None:
        exc = self._save_error
        if exc is not None:
            # surfaced once: the failed step is gone either way, and the next
            # save may succeed (transient disk pressure, fixed permissions)
            self._save_error = None
            raise CheckpointSaveError(f"async checkpoint save failed: {exc!r}") from exc

    def wait(self) -> None:
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        self._surface_save_error()

    def _save_sync(self, step: int, state) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f"step_{step:010d}.tmp")
        final = os.path.join(self.directory, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        host = {k: torch.as_tensor(v).detach().cpu() for k, v in _flatten_with_paths(state).items()}
        meta = {
            "step": step,
            "keys": sorted(host),
            "dtypes": {k: _dtype_name(v.dtype) for k, v in host.items()},
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "wall_time": self.clock.now(),
        }
        self._writer(os.path.join(tmp, "arrays.npz"), **{k: _stored_array(v) for k, v in host.items()})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._cleanup()
        self.save_log.append({"step": step, "seconds": time.perf_counter() - t0})

    def _cleanup(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.retain] if self.retain else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        # A finished-but-failed async worker must not let the PREVIOUS step
        # silently masquerade as latest. Only a completed thread is joined —
        # latest_step never blocks behind an in-flight save.
        t = self._save_thread
        if t is not None and not t.is_alive():
            self.wait()
        else:
            self._surface_save_error()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None, *, device=None, mesh=None, rules=None, shardings=None):
        """Restore into the structure of ``like`` (a tree of tensors, or of
        meta tensors as the port's ``ShapeDtypeStruct``): each leaf in its
        ``like`` leaf's dtype, on ``device`` when given, else on its ``like``
        leaf's device (a meta leaf without ``device`` raises). Re-shards onto
        ``shardings`` (a matching tree of ``sharding.spmd.Spec``s on ``mesh``) or onto
        each ``like`` leaf's own mesh and placements when it is a
        ``DTensor``. ``rules`` is accepted as the reference's is (the
        placements say everything)."""
        del rules
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}")
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            data = dict(npz.items())
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        flat_like = _flatten_with_paths(like)
        flat_shard = _flatten_with_paths(shardings) if shardings is not None else {}
        restored = {}
        for key, leaf in flat_like.items():
            dev = torch.device(device) if device is not None else spmd.local_of(leaf).device
            if dev.type == "meta":
                raise ValueError(f"checkpoint leaf {key!r}: a meta tensor needs a device= to restore onto")
            arr = data[key]
            if not arr.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d leaf (1,))
                arr = arr.copy()
            t = torch.from_numpy(arr)
            name = meta["dtypes"].get(key)
            if name in _VIEW_BACK:  # the integer view back to its true dtype
                t = t.view(_VIEW_AS[_VIEW_BACK[name]]).view(_VIEW_BACK[name])
            t = t.to(device=dev, dtype=leaf.dtype)
            spec = flat_shard.get(key)
            if spec is not None or spmd.is_dtensor(leaf):
                if spec is not None:
                    t = spmd.distribute(t, mesh, spmd.placements_of(spec, mesh))
                else:
                    t = spmd.distribute(t, leaf.device_mesh, leaf.placements)
            restored[key] = t
        return tree.unflatten(tree.flatten(like)[1], [restored[k] for k in flat_like])


# ------------------------------------------------------------------ snapshots


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
