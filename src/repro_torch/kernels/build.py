"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started together, to
an object for ``sm_90a``; the objects link into ONE shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
``build/repro_torch_kernels/<hash>/`` at the repository root (git-ignored),
keyed by a hash of the sources, the headers they include and the flags, so the first call after a source
change rebuilds and every later call reuses it. Nothing here runs at import
time: the CPU tests import every module, and only a CUDA tensor reaches
:func:`load`. Also here: the launch counters every wrapper bumps, and the
helpers of the wrappers' vmap rules.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "decode_attention.cu", "paged_attention.cu", "moe_gmm.cu",
           "moe_gmm_bwd.cu", "ssd_scan.cu", "ssd_scan_bwd.cu")
# included by sources; hashed with them, never compiled alone
HEADERS = ("async_copy.cuh", "mma_bf16.cuh", "row_policy.cuh", "decode_split.cuh", "flash_sweep.cuh",
           "wgmma_tma.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures (every pointer and the stream as c_void_p, every int as c_int,
# a row stride as c_longlong)
SIGNATURES = {
    # q, k, v, out, lse (or null), B, T, S, H, KV, D, causal, stream
    "repro_flash_attention_fwd": [_P] * 6 + [_I] * 7 + [_P],
    # o, dout, lse, dsum, lse2, sem, B, T, H, D, stream
    "repro_flash_attention_bwd_prep": [_P] * 6 + [_I] * 4 + [_P],
    # q, k, v, dout, lse2, dsum, dq_acc, sem, dk, dv, ws, B, T, S, H, KV, D, causal, n_split, stream
    "repro_flash_attention_bwd": [_P] * 11 + [_I] * 8 + [_P],
    # dq_acc, dq, ws, dk, dv, B, T, S, H, KV, D, n_split, stream
    "repro_flash_attention_bwd_post": [_P] * 5 + [_I] * 7 + [_P],
    # q, k, v, cur_len, out, lse (or null), B, S, batch (rows between sequences of k/v), H, KV, D, stream
    "repro_decode_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _P],
    # q, k_pages, v_pages, block_table, cur_len, out, B, P, page, n, H, KV, D, stream
    "repro_paged_decode_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k_pages, v_pages, block_table, start, out, B, C, P, page, n, H, KV, D, stream
    "repro_paged_chunk_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # xe, w, rows (or null), out, E, C, D, F, active, stream
    "repro_moe_gmm_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # xe, w, rows (or null), dy, dxe, dw, E, C, D, F, stream
    "repro_moe_gmm_bwd": [_P] * 6 + [_I] * 4 + [_P],
    # x, bm, cm, dt, a_log, d_skip, y, state, B, T, H, P, G, N, stream
    "repro_ssd_scan_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, bm, cm, dt, a_log, d_skip, dy, dstate (or null), ws_s, ws_z, part_bc, part, ticket, dx, dbm, dcm, ddt,
    # da_log, dd_skip, B, T, H, P, G, N, n_split, stream
    "repro_ssd_scan_bwd": [_P] * 19 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

#: The kernels whose launches are counted (one name per wrapper; the
#: gradients count each of their kernels by its own name: K3's three, K5's
#: two products, K6's walks and chunks).
KERNELS = ("flash_attention", "decode_attention", "paged_decode_attention", "paged_chunk_attention",
           "moe_gmm", "ssd_scan", "flash_attention_bwd_prep", "flash_attention_bwd", "flash_attention_bwd_post",
           "moe_gmm_bwd_dx", "moe_gmm_bwd_dw", "ssd_scan_bwd_walk", "ssd_scan_bwd_chunk")


class LaunchCounts:
    """Kernel launches, exact under threads and graph replays.

    A wrapper calls :func:`count_launch` where it launches its kernel. On a
    thread that is recording (a CUDA-graph capture: the launch is recorded,
    not run) the launch goes to that recording instead; a replay of the graph
    adds the recording once (:func:`add_replayed`). ``eager`` and
    ``replayed`` are kept apart so that a run can show both parts."""

    GUARDED_FIELDS = {"_eager": "_lock", "_replayed": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._eager = dict.fromkeys(KERNELS, 0)
        self._replayed = dict.fromkeys(KERNELS, 0)
        self._tls = threading.local()

    def count(self, name: str) -> None:
        recording = getattr(self._tls, "recording", None)
        if recording is not None:
            recording[name] = recording.get(name, 0) + 1
            return
        with self._lock:
            self._eager[name] += 1

    @contextlib.contextmanager
    def recording(self):
        """Launches made on this thread inside the block are collected in
        the yielded dict, not counted."""
        rec: dict[str, int] = {}
        prev = getattr(self._tls, "recording", None)
        self._tls.recording = rec
        try:
            yield rec
        finally:
            self._tls.recording = prev

    def add_replayed(self, rec: dict) -> None:
        with self._lock:
            for name, n in rec.items():
                self._replayed[name] += n

    def total(self) -> dict[str, int]:
        with self._lock:
            return {k: self._eager[k] + self._replayed[k] for k in KERNELS}

    def parts(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {"eager": dict(self._eager), "replayed": dict(self._replayed)}

    def reset(self) -> None:
        with self._lock:
            self._eager = dict.fromkeys(KERNELS, 0)
            self._replayed = dict.fromkeys(KERNELS, 0)


LAUNCHES = LaunchCounts()
count_launch = LAUNCHES.count


def launches(name: str) -> int:
    """Launches of one kernel since the last reset (eager + replayed)."""
    return LAUNCHES.total()[name]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _run(cmd: list[str], log: Path) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log.write_text(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({log}):\n{proc.stdout}{proc.stderr}")


def build() -> Path:
    """Compile (in parallel) and link the kernel library if it is not built
    yet; returns its path."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()

    def compile_one(name: str) -> str:
        obj = out / f"{name}.{os.getpid()}.o"  # another process may be building too
        _run([nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
             out / f"{name}.log")
        return str(obj)

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        objs = list(pool.map(compile_one, SOURCES))
    tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
    _run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs], out / "link.log")
    os.replace(tmp, lib)
    for obj in objs:
        os.remove(obj)
    return lib


def build_report() -> str:
    """The compiler's per-kernel register / shared-memory / spill report
    (``-Xptxas -v``) from the last build."""
    out = build_dir()
    return "\n".join(
        (out / f"{name}.log").read_text() for name in SOURCES if (out / f"{name}.log").exists()
    )


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_kernels_error_string.argtypes = [ctypes.c_int]
            lib.repro_kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def refuse_grad(what: str, *tensors) -> None:
    """Raise before a launch whose output would silently drop a gradient:
    the decode and paged kernels (K4, K1, K2) have no backward on the card
    (K3, K5 and K6 have theirs), and an output
    filled through ctypes carries no ``grad_fn``. Grad mode with an input that
    requires grad is refused; ``torch.no_grad()`` (the serve paths) passes."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors if isinstance(t, torch.Tensor)):
        raise RuntimeError(f"{what}: the kernel has no backward on the card yet, and an input requires "
                           "grad; run it under torch.no_grad() or detach the inputs")


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = load().repro_kernels_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# ------------------------------------------------------------- vmap rules
#
# Each kernel wrapper is a ``torch.library.custom_op`` whose vmap rule hands
# the kernel the mapped axis as part of its own batch axis, so k requests
# run as ONE launch (``torch.func.vmap`` over a fused unit, the batched
# execute). The kernels compute every row of their batch axis alone, so a
# folded launch gives each lane the bits a launch of that lane alone gives.


def fold_lanes(info, in_dims, *xs, contiguous: bool = True):
    """Each ``x`` with its mapped axis moved first (an unmapped ``x``
    expanded to the lanes) and merged into its own leading axis:
    (lanes, B, ...) -> (lanes * B, ...), contiguous, or with ``contiguous``
    False a view where the strides allow one (a copy where they do not)."""
    n = info.batch_size
    out = []
    for x, d in zip(xs, in_dims):
        x = x.movedim(d, 0) if d is not None else x.expand(n, *x.shape)
        x = x.reshape(n * x.shape[1], *x.shape[2:])
        out.append(x.contiguous() if contiguous else x)
    return out


def unfold_lanes(info, x):
    """(lanes * B, ...) -> (lanes, B, ...)."""
    return x.reshape(info.batch_size, x.shape[0] // info.batch_size, *x.shape[1:])


def per_lane(info, in_dims, op, *args):
    """The op once per lane, stacked on a new leading axis: the vmap rule of
    a kernel whose operands cannot fold into one batch axis."""
    outs = [op(*(a.select(d, i) if d is not None else a for a, d in zip(args, in_dims)))
            for i in range(info.batch_size)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])
    return torch.stack(outs), 0
