"""What K6's gradient gave up and gained in its redesign, on the card: the
first version's source (``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu`` of
the source tree given as argv[1]: fp32 chunk states, and the state and
weight operands of its chunk kernel's products as bf16 pairs, hi + lo) and a
textual variant of it without the lo products (``single``: each operand
rounded once, as the redesign rounds it; the lo halves are still written to
shared memory, not read), each compiled by ``nvcc`` into a shared library of
its own (under the git-ignored ``build/ssd_grad_variants/``), against this
tree's kernel through the port's wrapper. At the train shapes (B = 2, T =
4096; mamba2-370m: H = 32, N = 128; zamba2-7b: H = 112, N = 64), on
chip_smoke's inputs at the model's dt scale and at its slow decay
(``chip_smoke.SSD_GRAD_CASES``), it prints one JSON line per case:

- ``ms``: each version timed with ``chip_smoke.time_ms``, in turns (every
  version, then every version in reverse order); ``kernel_ms``: each
  version's walks and chunks apart (``chip_smoke.kernel_ms``, torch.profiler);
- ``rel_err``: each version's outputs against the plain backward in fp32
  over slices of 8 heads (``chip_smoke.ssd_plain_bwd_by_heads``), each over
  its max |g|, and this tree's kernel against the first version's.

Run from the repository root on the card, the first version unpacked into a
git-ignored directory:

    python3 tools/probes/ssd_grad_variants.py build/parent
"""
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as sd  # noqa: E402

FIRST = Path(sys.argv[1]).resolve() / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ssd_grad_variants"
CASES = [c for c in cs.SSD_GRAD_CASES if c[2] == 4096]
NAMES = ("dx", "dbm", "dcm", "ddt", "da_log", "dd_skip")
# the lo operand's ldmatrix and its two mma lines, wherever a product reads a pair
LO = re.compile(r"^\s*(ldmatrix_x4(_trans)?\((bl|al),[^;]*|mma_16816\([^;]*, (af, bl|al, bf)\[[^;]*)\);\s*\n", re.M)


def compile_variant(name: str, src: str):
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(src)
    cmd = [build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-shared", "-I", str(FIRST), "-o", str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    lib.repro_ssd_scan_bwd.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.repro_ssd_scan_bwd.restype = ctypes.c_int
    return lib


def first_version(lib):
    """The first version's entry as its wrapper called it: fp32 workspaces."""
    def run(x, bm, cm, dt, a_log, d_skip, dy, ds):
        b, t, h, p = x.shape
        g, n = bm.shape[2], bm.shape[3]
        nc = -(-t // sd.GRAD_CHUNK)
        outs = [torch.empty_like(v) for v in (x, bm, cm, dt, a_log, d_skip)]
        ws = [torch.empty(b, h, nc, p, n, dtype=torch.float32, device=x.device) for _ in range(2)]
        part = torch.empty(b, nc, h, 2, dtype=torch.float32, device=x.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
        err = lib.repro_ssd_scan_bwd(*(v.data_ptr() for v in (x, bm, cm, dt, a_log, d_skip, dy)),
                                     None if ds is None else ds.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(),
                                     part.data_ptr(), ticket.data_ptr(), *(o.data_ptr() for o in outs),
                                     b, t, h, p, g, n, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"first version: CUDA error {err}")
        return outs
    return run


def rel(a, w) -> float:
    return float((a.float() - w.float()).abs().max()) / float(w.float().abs().max())


def main() -> None:
    print(cs.device_line(), flush=True)
    build.load()
    src = (FIRST / "ssd_scan_bwd.cu").read_text()
    single = LO.sub("", src)
    removed = len(LO.findall(src))
    with ThreadPoolExecutor(2) as pool:
        libs = dict(zip(("first", "single"), pool.map(lambda a: compile_variant(*a),
                                                      [("first", src), ("single", single)])))
    versions = {"first": first_version(libs["first"]), "single": first_version(libs["single"]),
                "kernel": lambda *a: sd.backward(*a)}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    for label, b, t, h, g, n, _, slice_heads, scale in CASES:
        p = 64
        x = torch.randn(b, t, h, p, generator=gen, device=dev).to(torch.bfloat16)
        bm, cm = ((torch.randn(b, t, g, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16) for _ in range(2))
        shift = 0.0 if scale == "model" else -4.0
        dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen, device=dev) + shift)
        a_log = torch.randn(h, generator=gen, device=dev) * 0.3 + (0.0 if scale == "model" else -2.0)
        d_skip = torch.ones(h, device=dev)
        dy = torch.randn(b, t, h, p, generator=gen, device=dev).to(torch.bfloat16)
        ins = (x, bm, cm, dt, a_log, d_skip, dy, None)
        want = cs.ssd_plain_bwd_by_heads(torch, sd, ins[:6], dy, None, slice_heads)
        got = {k: fn(*ins) for k, fn in versions.items()}
        torch.cuda.synchronize()
        errs = {k: {nm: rel(a, w) for nm, a, w in zip(NAMES, outs, want)} for k, outs in got.items()}
        errs["kernel vs first"] = {nm: rel(a, w) for nm, a, w in zip(NAMES, got["kernel"], got["first"])}
        del want, got
        torch.cuda.empty_cache()
        turns = {k: [] for k in versions}
        for order in (list(versions), list(versions)[::-1]):
            for k in order:
                turns[k].append(cs.time_ms(torch, lambda: versions[k](*ins)))
        split = {k: cs.kernel_ms(torch, lambda: fn(*ins), ("ssd_bwd_walk_kernel", "ssd_bwd_chunk_kernel"))
                 for k, fn in versions.items()}
        print(json.dumps({"case": label, "dt_scale": scale, "lo_lines_removed": removed,
                          "ms": {k: min(v) for k, v in turns.items()}, "turns": turns, "kernel_ms": split,
                          "rel_err": errs}), flush=True)


if __name__ == "__main__":
    main()
