"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started together, to
an object for ``sm_90a``; the objects link into ONE shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
``build/repro_torch_kernels/<hash>/`` at the repository root (git-ignored),
keyed by a hash of the sources, the headers they include and the flags, so the first call after a source
change rebuilds and every later call reuses it. Nothing here runs at import
time: the CPU tests import every module, and only a CUDA tensor reaches
:func:`load`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention.cu", "decode_attention.cu", "paged_attention.cu", "moe_gmm.cu", "ssd_scan.cu")
# included by sources; hashed with them, never compiled alone
HEADERS = ("async_copy.cuh", "mma_bf16.cuh", "row_policy.cuh", "decode_split.cuh", "flash_sweep.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures (every pointer and the stream as c_void_p, every int as c_int)
SIGNATURES = {
    # q, k, v, out, B, T, S, H, KV, D, causal, stream
    "repro_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, cur_len, out, B, S, H, KV, D, stream
    "repro_decode_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k_pages, v_pages, block_table, cur_len, out, B, P, page, n, H, KV, D, stream
    "repro_paged_decode_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k_pages, v_pages, block_table, start, out, B, C, P, page, n, H, KV, D, stream
    "repro_paged_chunk_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # xe, w, rows (or null), out, E, C, D, F, active, stream
    "repro_moe_gmm_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, bm, cm, dt, a_log, d_skip, y, state, B, T, H, P, G, N, stream
    "repro_ssd_scan_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


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
    the kernels have no backward on the card yet, and an output filled
    through ctypes carries no ``grad_fn``. Grad mode with an input that
    requires grad is refused; ``torch.no_grad()`` (the serve paths) passes."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors if isinstance(t, torch.Tensor)):
        raise RuntimeError(f"{what}: the kernel has no backward on the card yet, and an input requires "
                           "grad; run it under torch.no_grad() or detach the inputs")


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = load().repro_kernels_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
