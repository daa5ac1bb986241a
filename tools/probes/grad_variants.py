"""What the parts of K3's gradient sweep cost on the card: textual variants
of ``csrc/flash_attention_bwd.cu``, each compiled by ``nvcc`` into a shared
library of its own (under the git-ignored ``build/grad_variants/``), timed
through the port's wrapper in turns (every variant, then every variant in
reverse order) with ``chip_smoke.time_ms``, in one process on the card.
Prints one JSON line per shape: the sweep alone (with the memset that
re-zeroes its dQ counters) and the whole gradient per variant and turn,
and whether each variant's gradient equals the kernel's in bits.

The variants that break the gradient on purpose measure what a part costs
(their bits differ; they never hang: no barrier is left waiting):

- ``nochain``: the dQ writer does not wait for the earlier kv tiles (the
  fixed order of the dQ sum);
- ``nodq``: no dS K product (dQ's tensor-core work);
- ``nobarrier``: no named barrier between the consumer warpgroups before
  the dS K product;
- ``nowriter``: no dQ out at all (the shared tile, its barriers, the bulk
  reduction into the accumulator and the chain);
- ``warparrive``: one arrival a warp on the ring's and dQ's barriers, not
  one a thread (bits equal);
- ``evictlast``: the Q and dO loads with an L2 evict-last policy (bits equal).

Run from the repository root on the card:

    python3 tools/probes/grad_variants.py
"""
import ctypes
import json
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SRC = (build.CSRC / "flash_attention_bwd.cu").read_text()
OUT = ROOT / "build" / "grad_variants"
# (label, B, T = S, H, KV, hd, causal): chip_smoke's grad cases (a), (c) 48/1 and 64/8, (d), (e)
CASES = [("a", 2, 4096, 32, 8, 64, True), ("c 48/1", 1, 512, 48, 1, 128, True),
         ("c 64/8", 1, 512, 64, 8, 128, True), ("d", 1, 512, 32, 32, 112, True),
         ("e", 1, 300, 32, 8, 64, False)]

HINTED_LOAD = '''__device__ __forceinline__ void tma_load_4d_hint(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                                 int c2, int c3, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3, %4, %5}], [%6], %7;\\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ float bf16_lo'''

VARIANTS = {
    "kernel": [],
    "nochain": [("while (seen < j)", "while (false && seen < j)")],
    "nodq": [("""        wgmma_ss_n64<1, 1>(dq, wgmma_desc(sa + kk * 2048, kN * 128, 1024), wgmma_desc(kb + kk * 2048, kN * 128, 1024),
                           kk > 0);""", "        dq[kk] = 0.f;")],
    "nobarrier": [("      named_bar_sync(1, kConsumers);  // both warpgroups' dS^T are in place", "")],
    "nowriter": [("      mbar_wait(dq_empty, (it & 1) ^ 1);  // the writer has sent the last step's dQ", ""),
                 ("      fence_proxy_async_shared();\n      mbar_arrive(dq_full);", ""),
                 ("        mbar_wait(dq_full, it & 1);", ""),
                 ("        if (j == 0) bulk_store(dst, base + C::kOffDQ, kDqTile * 4);\n"
                  "        else bulk_reduce_add_f32(dst, base + C::kOffDQ, kDqTile * 4);", ""),
                 ("        mbar_arrive(dq_empty);", "")],
    "warparrive": [("      mbar_init(&empty[s], kConsumers);", "      mbar_init(&empty[s], kConsumers / 32);"),
                   ("    mbar_init(dq_full, kConsumers);", "    mbar_init(dq_full, kConsumers / 32);"),
                   ("      mbar_arrive(&empty[stage]);  // this step's Q, dO, lse and D are read",
                    "      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[stage]);"),
                   ("      mbar_arrive(dq_full);", "      __syncwarp();\n      if (lane == 0) mbar_arrive(dq_full);")],
    "evictlast": [("__device__ __forceinline__ float bf16_lo", HINTED_LOAD),
                  ("      for (int it = 0; it < n_iter; ++it) {\n        const int stage = it % kStages;\n"
                   "        mbar_wait(&empty[stage]",
                   "      uint64_t keep;\n"
                   "      asm volatile(\"createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n\" : \"=l\"(keep));\n"
                   "      for (int it = 0; it < n_iter; ++it) {\n        const int stage = it % kStages;\n"
                   "        mbar_wait(&empty[stage]"),
                  ("&qmap, &full[stage], c * 64, h,\n                      qt * kM, b);",
                   "&qmap, &full[stage], c * 64, h,\n                      qt * kM, b, keep);"),
                  ("&dmap, &full[stage], c * 64, h,\n                      qt * kM, b);",
                   "&dmap, &full[stage], c * 64, h,\n                      qt * kM, b, keep);"),
                  ("tma_load_4d(base + C::kOffQ", "tma_load_4d_hint(base + C::kOffQ"),
                  ("tma_load_4d(base + C::kOffDO", "tma_load_4d_hint(base + C::kOffDO")],
}


def compile_variant(name: str, reps: list) -> str:
    src = SRC
    for a, b in reps:
        if a not in src:
            raise SystemExit(f"variant {name}: the kernel source no longer holds {a[:60]!r}")
        src = src.replace(a, b)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "k.cu").write_text(src)
    cmd = [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-I", str(build.CSRC),
           "-shared", "-o", str(d / "k.so"), str(d / "k.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {name} failed to build:\n{proc.stderr[-3000:]}")
    return name


def load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(OUT / name / "k.so"))
    for fn in ("repro_flash_attention_bwd_prep", "repro_flash_attention_bwd", "repro_flash_attention_bwd_post"):
        getattr(lib, fn).argtypes = build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        list(pool.map(lambda kv: compile_variant(*kv), VARIANTS.items()))
    main_lib = build.load()  # the forward and the error strings
    libs = {name: load(name) for name in VARIANTS}
    gen = torch.Generator(device="cuda").manual_seed(24)
    dev = torch.device("cuda")
    device = cs.device_line()  # the card's name and power limit, as nvidia-smi gives them
    for label, b, t, h, kv, hd, causal in CASES:
        q, dout = (torch.randn(b, t, h, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, t, kv, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        lse = torch.empty(b, h, t, dtype=torch.float32, device=dev)
        out = torch.empty(q.shape, dtype=torch.float32, device=dev)  # the forward's fp32 output, prep's input
        build._lib = main_lib
        fa._forward(q, k, v, causal, lse, out)
        want = fa.backward(q, k, v, out, lse, dout, causal)
        res = {}
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            build._lib = libs[name]
            got = fa.backward(q, k, v, out, lse, dout, causal)
            dsum, lse2, sem = fa.backward_prep(out, dout, lse)
            sweep = cs.time_ms(torch, lambda: (sem.zero_(), fa.backward_sweep(q, k, v, dout, lse2, dsum, sem, causal)))
            total = cs.time_ms(torch, lambda: fa.backward(q, k, v, out, lse, dout, causal))
            res.setdefault(name, []).append({"sweep_ms": sweep, "ms": total,
                                             "equal_bits": all(torch.equal(a, c) for a, c in zip(got, want))})
        build._lib = main_lib
        print(json.dumps({"case": label, "shape": [b, t, h, kv, hd, causal], "device": device, **res}), flush=True)


if __name__ == "__main__":
    main()
