"""Where a K6 block's cycles go: a clock64 probe of ``csrc/ssd_scan.cu``.

Builds a textual copy of the kernel with clock64 reads around its phases
(per chunk: the wait for the chunk's tiles and the block barrier; the next
chunk's copies and the dt scan; the outputs of an own chunk; the state
update), runs it at the SSM and hybrid serve shapes on the card, and prints,
per rank, the mean cycles of each phase over the blocks of that rank (warp 3,
which has the most causal tiles). Run from the repository root on the card:

    python3 src/repro_torch/kernels/probes/ssd_phases.py

The copy lands in the git-ignored ``build/``; the kernel itself is untouched.
"""
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[4]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

PHASES = ("wait", "copies+scan", "outputs", "state")
# (text in csrc/ssd_scan.cu, what the probe adds after it)
MARKS = [
    ("namespace {\n\nconstexpr int kQ = 64;", "namespace {\n__device__ long long g_probe[65536][6];\nconstexpr int kQ = 64;"),
    ("  for (int c = 0; c < c_end; ++c) {\n",
     "  long long acc_[4] = {0, 0, 0, 0};\n  const long long start_ = clock64();\n"
     "  for (int c = 0; c < c_end; ++c) {\n    long long t_ = clock64();\n"),
    ("    __syncthreads();     // ... everyone's; the slot of chunk c - 1 is free\n",
     "    __syncthreads();     // ... everyone's; the slot of chunk c - 1 is free\n"
     "    acc_[0] += clock64() - t_; t_ = clock64();\n"),
    ("    __syncwarp();\n\n    if (own) {", "    __syncwarp();\n    acc_[1] += clock64() - t_; t_ = clock64();\n\n    if (own) {"),
    ("    // ---- state = exp(cum_Q) state", "    acc_[2] += clock64() - t_; t_ = clock64();\n    // ---- state = exp(cum_Q) state"),
    ("  cp_async_wait<0>();  // no copy is left in flight\n",
     "  cp_async_wait<0>();  // no copy is left in flight\n"
     "  if (tid == 96) { long long* o = g_probe[(rank * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x];"
     " for (int i = 0; i < 4; ++i) o[i] = acc_[i]; o[4] = clock64() - start_; o[5] = c_end - c_begin; }\n"),
]
CASES = (("mamba2-370m T=300", 1, 300, 32, 1, 64, 128), ("zamba2-7b T=300", 1, 300, 112, 1, 64, 64),
         ("T=37", 1, 37, 32, 1, 64, 128))


def probe_source() -> str:
    src = (build.CSRC / "ssd_scan.cu").read_text()
    for mark, added in MARKS:
        if mark not in src:
            raise SystemExit(f"ssd_scan.cu no longer has the probe's mark {mark!r}")
        src = src.replace(mark, added)
    loop_end = src.rindex("  }\n", 0, src.index("  cp_async_wait<0>();  // no copy is left in flight\n"))
    src = src[:loop_end] + "    acc_[3] += clock64() - t_;\n" + src[loop_end:]
    return src + '\nextern "C" int ssd_probe_copy(void* host, size_t bytes) {\n' \
                 '  return (int)cudaMemcpyFromSymbol(host, g_probe, bytes);\n}\n'


def main() -> int:
    print(cs.device_line(), flush=True)
    out = ROOT / "build" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd_phases.cu").write_text(probe_source())
    subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    f"-I{build.CSRC}", "-shared", "-o", str(out / "ssd_phases.so"), str(out / "ssd_phases.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out / "ssd_phases.so"))
    lib.repro_ssd_scan_fwd.argtypes = build.SIGNATURES["repro_ssd_scan_fwd"]
    lib.ssd_probe_copy.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    dev = torch.device("cuda")
    for label, b, t, h, g, p, n in CASES:
        gen = torch.Generator(device=dev).manual_seed(7)
        x = torch.randn(b, t, h, p, generator=gen, device=dev).to(torch.bfloat16)
        bm = (torch.randn(b, t, g, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        cm = (torch.randn(b, t, g, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen, device=dev))
        a_log = torch.randn(h, generator=gen, device=dev) * 0.3
        d = torch.ones(h, device=dev)
        y, st = torch.empty_like(x), torch.empty(b, h, p, n, device=dev)

        def run():
            err = lib.repro_ssd_scan_fwd(x.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                                         d.data_ptr(), y.data_ptr(), st.data_ptr(), b, t, h, p, g, n,
                                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        ms = cs.time_ms(torch, run)
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (65536 * 6))()
        if lib.ssd_probe_copy(buf, ctypes.sizeof(buf)):
            raise RuntimeError("probe copy failed")
        ranks = min(8, -(-t // 64))
        blocks_x = b * (p // 64 if p % 64 == 0 else p // 32)
        print(f"{label}: {ms:.5f} ms a call (CUDA events)", flush=True)
        for r in range(ranks):
            rows = [buf[((r * h + hh) * blocks_x + bx) * 6:((r * h + hh) * blocks_x + bx) * 6 + 6]
                    for hh in range(h) for bx in range(blocks_x)]
            means = {ph: statistics.mean(row[i] for row in rows) for i, ph in enumerate(PHASES)}
            total = statistics.mean(row[4] for row in rows)
            print(f"  rank {r} ({rows[0][5]} own chunk(s)): "
                  + ", ".join(f"{ph} {v:.0f}" for ph, v in means.items()) + f"; total {total:.0f} cycles", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
