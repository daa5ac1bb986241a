// K5 — per-expert grouped GEMM, out[e] = xe[e] @ w[e], routed experts only,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/moe_gmm.py :: moe_gmm / _gmm_kernel (the Pallas
// TPU kernel behind the MoE layer's three expert products, models/moe.py:
// gate and up (E, C, d) x (E, d, f) and down (E, C, f) x (E, f, d)).
//
// What bounds it on this card: the weights of the experts that received a
// token. At the qwen3-moe-30b-a3b serving shapes (E = 128, d = 2048, f = 768,
// top 8) a batch-1 decode step routes its token to 8 experts, one row each:
// 8 x 2048 x 768 x 2 = 25.2 MB of weights, 7.5 us at 3.35 TB/s. A prefill
// routes to nearly every expert with 8-40 rows. At C rows an expert does 2C
// flop per weight element, C flop per byte, far below the ~295 flop/byte
// ridge at every serve shape: the bytes bound it everywhere.
//
// What the design does about it:
//   * rows (E,) int32 on the device holds each expert's kept rows (the MoE
//     layer's min(count, capacity)); rows of xe[e] at or past rows[e] are
//     taken as zero (the layer scatters into a zero buffer) and their outputs
//     written as exact zeros. An expert with rows[e] == 0 reads no weight
//     byte: its output is zero-filled, a share by every block. rows ==
//     nullptr keeps every row of every expert;
//   * work items are (active expert, C tile of up to 64 rows, 64-column f
//     tile). Each block compacts the active experts into shared memory (a
//     ballot scan of rows) and walks items blockIdx.x, + gridDim.x, ...; a C
//     tile at or past rows[e] loads and computes nothing, and within a tile
//     only the 16-row m-tiles below rows[e] are loaded and computed. The grid
//     is every block that fits on the card at once, and no more blocks than
//     A x C tiles x f tiles items, where A bounds the active experts (the
//     layer passes min(E, N k), known from shapes; any A >= 1 is correct);
//   * the weights stream through ONE ring per block that runs on across its
//     items (no drain and refill between them), loaded by the Tensor Memory
//     Accelerator (cp.async.bulk.tensor, a 3-D map (f, d, E) encoded on the
//     host per call; rows past d and columns past f come in as zeros) with
//     the 128-byte swizzle and an L2 evict-first hint (each weight is read
//     once), completing on an mbarrier per stage; the few xe rows of a stage
//     come in by cp.async (16 bytes a thread). Two ring shapes, chosen from
//     the grid (see Tall, Short): measured, a block's per-stage wait and
//     barrier, not the bytes in flight, cap its rate, so with no more items
//     than SMs (a decode step: 8 experts x 12 f tiles) stages of 256 d rows
//     (3-4 of them, 1 block per SM) win, and with more items stages of 128
//     rows and 2-3 blocks per SM;
//   * products on the tensor cores by mma.sync m16n8k16 (bf16 -> fp32): 4
//     warps, each 16 f columns x up to 4 m-tiles, B fragments by
//     ldmatrix.trans from the swizzled tile. Not wgmma: its 64-row minimum
//     exceeds every serve shape's rows per expert (1-40), so most of each
//     product would be padding, and the tensor cores are not what bounds it;
//   * deterministic: each output element is summed by one thread over d in
//     one fixed order, whatever the grid, the ring or rows (no split, no
//     atomics), so equal inputs give equal bits, and a routed call equals the
//     rows == nullptr call on the same masked input.
// The dynamic shared-memory limit is raised once per instantiation and device.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "async_copy.cuh"  // cp.async helpers, allow_smem_once

namespace {

constexpr int kBox = 64;      // f columns per TMA box: 128 bytes, the swizzle span
constexpr int kThreads = 128;  // 4 warps, a quarter of the item's f columns each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExperts = 256;  // the active list lives in shared memory
constexpr size_t kAlign = 1024;   // the 128-byte swizzle repeats every 1024 bytes

// The three ring shapes — d rows per stage, f columns per item, the shared
// memory a block's ring may take — chosen per call from the shapes (see
// repro_moe_gmm_fwd). Measured: a block's per-stage wait and barrier, not
// the bytes in flight, cap its rate. With no more items than SMs (a decode
// step: 8 experts x 12 f tiles) each block's own rate sets the time, and
// Tall stages of 256 rows halve the waits per byte (1 block per SM). With
// more items, Short stages of 128 rows and 3 blocks per SM overlap the waits
// (one m-tile); with 2-4 m-tiles (C 24-64) the xe rows a stage needs rival
// its weights, and each f tile of an expert reads them again, so Wide items
// of 128 columns read them half as often (2 blocks per SM). Each thread
// sums its products over d in the same order in all three: equal bits.
struct Tall {
  static constexpr int kBK = 256, kBF = 64, kShare = 200 * 1024;
};
struct Short {
  static constexpr int kBK = 128, kBF = 64, kShare = 64 * 1024;
};
struct Wide {
  static constexpr int kBK = 64, kBF = 128, kShare = 104 * 1024;
};

template <class Ring, int MT>
struct Shape {
  static constexpr int kBK = Ring::kBK;
  static constexpr int kBF = Ring::kBF;
  static constexpr int kNT = kBF / 32;       // n8 tiles per warp
  static constexpr int kXStride = kBK + 8;  // xe tile row stride (bf16): conflict-free A reads
  static constexpr int kWTileBytes = kBK * kBF * 2;
  static constexpr int kXTileBytes = MT * 16 * kXStride * 2;
  // as many stages as the ring's share holds, at most 8
  static constexpr int kFit = Ring::kShare / (kWTileBytes + kXTileBytes);
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr size_t kSmem = kAlign + (size_t)kStages * (kWTileBytes + kXTileBytes);
  static_assert(kStages >= 3, "the ring needs a stage in flight beside the one computed and the one refilled");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Four 8x8 bf16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8; register j holds this thread's pair of matrix j.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D (16x8, fp32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major).
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Every expert with rows > 0, in index order, and its kept rows (clamped to
// C), compacted into act_e / act_r; returns their count. Block-wide: every
// thread must call it.
__device__ int compact_active(const int* __restrict__ rows, int E, int C, int* act_e, int* act_r,
                              int* counts) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int seen = 0;  // active experts before this chunk
  for (int e0 = 0; e0 < E; e0 += kThreads) {
    const int e = e0 + tid;
    const int r = e >= E ? 0 : rows == nullptr ? C : min(rows[e], C);
    const unsigned ballot = __ballot_sync(0xffffffffu, r > 0);
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();
    int at = seen + __popc(ballot & ((1u << lane) - 1u));
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? counts[w] : 0;
      total += counts[w];
    }
    if (r > 0) {
      act_e[at] = e;
      act_r[at] = r;
    }
    seen += total;
    __syncthreads();  // counts may be rewritten; act_* are visible
  }
  return seen;
}

// A block's walk over its work items (active expert, C tile, f tile) — item
// q = blockIdx.x + i * gridDim.x, the f tile fastest — skipping the items
// whose C tile holds no kept row; and the d tiles of each.
struct Cursor {
  int q = 0;     // the current item, or >= total past the last
  int t = 0;     // its d tile
  int e = 0, re = 0, c0 = 0, f0 = 0, here = 0;  // its expert, kept rows, tile origin, rows with tokens
};

template <int kBM, int kBF>
__device__ __forceinline__ void seek(Cursor& c, int total, int f_tiles, int c_tiles, const int* act_e,
                                     const int* act_r) {
  for (; c.q < total; c.q += gridDim.x) {
    const int ft = c.q % f_tiles;
    const int rest = c.q / f_tiles;
    c.c0 = (rest % c_tiles) * kBM;
    c.re = act_r[rest / c_tiles];
    c.here = min(c.re - c.c0, kBM);
    if (c.here > 0) {
      c.e = act_e[rest / c_tiles];
      c.f0 = ft * kBF;
      return;
    }
  }
}

template <class Ring, int MT>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ xe,
               const int* __restrict__ rows, __nv_bfloat16* __restrict__ out, int E, int C, int D, int F) {
  using S = Shape<Ring, MT>;
  constexpr int STAGES = S::kStages;
  constexpr int kBlockK = S::kBK;   // d rows per stage
  constexpr int kXStride = S::kXStride;
  constexpr int kWTileBytes = S::kWTileBytes;
  constexpr int kBlockF = S::kBF;   // f columns per item
  constexpr int kNT = S::kNT;
  constexpr int kBoxBytes = kBlockK * kBox * 2;  // one box of a weight stage
  constexpr int kBM = MT * 16;  // rows of C per item
  constexpr int kXTile = kBM * kXStride;  // bf16 per xe stage

  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ int act_e[kMaxExperts], act_r[kMaxExperts];
  __shared__ int scan_counts[kWarps];
  extern __shared__ unsigned char smem_raw[];
  // the weight ring, 1024-byte aligned for the swizzle, then the xe ring
  unsigned char* wring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~(uintptr_t)(kAlign - 1));
  __nv_bfloat16* xring = reinterpret_cast<__nv_bfloat16*>(wring + STAGES * kWTileBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;  // row within the 8-row half of a fragment
  const int tig = lane & 3;   // thread in group: column pair
  const int wn0 = warp * (kBlockF / 4);  // this warp's f columns within the tile
  const CUtensorMap* wm = &wmap;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int count = compact_active(rows, E, C, act_e, act_r, scan_counts);  // ends in a barrier
  const int f_tiles = (F + kBlockF - 1) / kBlockF;
  const int c_tiles = (C + kBM - 1) / kBM;
  const int total = count * c_tiles * f_tiles;
  const int n_k = (D + kBlockK - 1) / kBlockK;
  uint64_t policy;  // the weights are read once: let them leave L2 first
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));

  // stage `c.t` of item `c` into ring slot `slot`: the weight tile by TMA
  // (thread 0), the xe rows below `here` by cp.async (rows up to the m-tile
  // edge zero-filled, never read)
  auto issue = [&](int slot, const Cursor& c) {
    const int k0 = c.t * kBlockK;
    if (tid == 0) {
      mbar_expect_tx(&full[slot], kWTileBytes);
#pragma unroll
      for (int box = 0; box < kBlockF / kBox; ++box)
        asm volatile(
            "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
            "[%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(smem_u32(wring + slot * kWTileBytes + box * kBoxBytes)),
            "l"(reinterpret_cast<uint64_t>(wm)), "r"(c.f0 + box * kBox), "r"(k0), "r"(c.e),
            "r"(smem_u32(&full[slot])), "l"(policy)
            : "memory");
    }
    const __nv_bfloat16* xb = xe + ((int64_t)c.e * C + c.c0) * D;
    __nv_bfloat16* xs = xring + slot * kXTile;
    const int m_rows = (c.here + 15) / 16 * 16;
    for (int i = tid; i < m_rows * (kBlockK / 8); i += kThreads) {
      const int r = i / (kBlockK / 8);
      const int col = (i % (kBlockK / 8)) * 8;
      const bool ok = r < c.here && k0 + col < D;
      cp_async_16(xs + r * kXStride + col, ok ? xb + (int64_t)r * D + k0 + col : xe, ok);
    }
  };
  auto advance = [&](Cursor& c) {
    if (++c.t == n_k) {
      c.t = 0;
      c.q += gridDim.x;
      seek<kBM, kBlockF>(c, total, f_tiles, c_tiles, act_e, act_r);
    }
  };

  Cursor prod, cons;
  prod.q = cons.q = blockIdx.x;
  seek<kBM, kBlockF>(prod, total, f_tiles, c_tiles, act_e, act_r);
  seek<kBM, kBlockF>(cons, total, f_tiles, c_tiles, act_e, act_r);
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (prod.q < total) {
      issue(s, prod);
      advance(prod);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  }

  // ---- zero output: experts that received no token (a share per block),
  // and the C tiles at or past an expert's kept rows (the block's items) ----
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (rows != nullptr) {
    const int64_t per_e = (int64_t)C * F / 8;  // 16-byte chunks of one expert's output
    for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < (int64_t)E * per_e;
         i += (int64_t)gridDim.x * kThreads) {
      if (__ldg(rows + i / per_e) <= 0) reinterpret_cast<uint4*>(out)[i] = zero;
    }
  }
  for (int q = blockIdx.x; q < total; q += gridDim.x) {
    const int rest = q / f_tiles;
    const int c0 = (rest % c_tiles) * kBM;
    if (act_r[rest / c_tiles] > c0) continue;  // computed, and its own rows past rows[e] zeroed below
    __nv_bfloat16* ob = out + (int64_t)act_e[rest / c_tiles] * C * F;
    const int f0 = (q % f_tiles) * kBlockF;
    for (int i = tid; i < (min(c0 + kBM, C) - c0) * (kBlockF / 8); i += kThreads) {
      const int col = f0 + (i % (kBlockF / 8)) * 8;
      if (col < F) *reinterpret_cast<uint4*>(ob + (int64_t)(c0 + i / (kBlockF / 8)) * F + col) = zero;
    }
  }

  float acc[MT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < kNT; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;

#pragma unroll 1
  for (uint32_t g = 0; cons.q < total; ++g) {
    const int slot = g % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's xe copies of stage g landed
    mbar_wait(&full[slot], (g / STAGES) & 1u);
    __syncthreads();  // ... everyone's; the slot of stage g - 1 is free
    if (prod.q < total) {
      issue((g + STAGES - 1) % STAGES, prod);
      advance(prod);
    }
    cp_async_commit();

    const int m_active = (cons.here + 15) / 16;
    const uint32_t wt = smem_u32(wring + slot * kWTileBytes);
    const __nv_bfloat16* xs = xring + slot * kXTile;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      // per 16 columns, matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
      // (k 8-15, n 8-15); a box row's 16-byte chunk sits at chunk ^ (row % 8)
      // (128-byte swizzle)
      const int mat = lane >> 3;
      const int krow = kk * 16 + (mat & 1) * 8 + (lane & 7);
      uint32_t b[kNT / 2][4];
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        const int col = wn0 + j * 16 + (mat >> 1) * 8;
        const int chunk = (col % kBox) >> 3;
        ldmatrix_x4_trans(b[j], wt + (col / kBox) * kBoxBytes + krow * (kBox * 2) + ((chunk ^ (krow & 7)) << 4));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < m_active) {  // warp-uniform: an m-tile past the tokens is skipped
          const __nv_bfloat16* xr = xs + (mt * 16) * kXStride + kk * 16 + tig * 2;
          uint32_t a[4];
          a[0] = ld_u32(xr + grp * kXStride);
          a[1] = ld_u32(xr + (grp + 8) * kXStride);
          a[2] = ld_u32(xr + grp * kXStride + 8);
          a[3] = ld_u32(xr + (grp + 8) * kXStride + 8);
#pragma unroll
          for (int j = 0; j < kNT / 2; ++j) {
            mma_16816(acc[mt][2 * j], a, b[j][0], b[j][1]);
            mma_16816(acc[mt][2 * j + 1], a, b[j][2], b[j][3]);
          }
        }
      }
    }

    if (cons.t == n_k - 1) {
      // the item's last d tile: its computed m-tiles from the accumulators
      // (rows at or past rows[e] exact zeros), the tile's other rows zeros
      __nv_bfloat16* ob = out + (int64_t)cons.e * C * F;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row_a = cons.c0 + mt * 16 + grp;
        const int row_b = row_a + 8;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int col = cons.f0 + wn0 + n * 8 + tig * 2;  // even; F % 8 == 0, so col + 1 < F too
          if (mt < m_active && col < F) {
            if (row_a < C)
              *reinterpret_cast<uint32_t*>(ob + (int64_t)row_a * F + col) =
                  row_a < cons.re ? pack_bf16(acc[mt][n][0], acc[mt][n][1]) : 0u;
            if (row_b < C)
              *reinterpret_cast<uint32_t*>(ob + (int64_t)row_b * F + col) =
                  row_b < cons.re ? pack_bf16(acc[mt][n][2], acc[mt][n][3]) : 0u;
          }
          acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
        }
      }
      const int z0 = cons.c0 + m_active * 16;
      const int z1 = min(cons.c0 + kBM, C);
      for (int i = tid; i < max(0, z1 - z0) * (kBlockF / 8); i += kThreads) {
        const int col = cons.f0 + (i % (kBlockF / 8)) * 8;
        if (col < F) *reinterpret_cast<uint4*>(ob + (int64_t)(z0 + i / (kBlockF / 8)) * F + col) = zero;
      }
    }
    advance(cons);
  }
  cp_async_wait<0>();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime (no link to libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <class Ring, int MT>
cudaError_t launch(const CUtensorMap& wmap, const void* xe, const int* rows, void* out, int E, int C, int D,
                   int F, int64_t items, int sms, cudaStream_t stream) {
  using S = Shape<Ring, MT>;
  static std::atomic<uint32_t> smem_set{0u};
  cudaError_t err = allow_smem_once(moe_gmm_kernel<Ring, MT>, S::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, moe_gmm_kernel<Ring, MT>, kThreads, S::kSmem);
  if (err != cudaSuccess) return err;
  // every block that fits at once, and no more than the items there can be
  const int blocks = (int)std::min<int64_t>(items, (int64_t)std::max(per_sm, 1) * sms);
  moe_gmm_kernel<Ring, MT><<<blocks, kThreads, S::kSmem, stream>>>(
      wmap, static_cast<const __nv_bfloat16*>(xe), rows, static_cast<__nv_bfloat16*>(out), E, C, D, F);
  return cudaGetLastError();
}

// The tensor map of w for the ring's stages, then the launch.
template <class Ring, int MT>
cudaError_t launch_ring(EncodeTiled encode, const void* xe, const void* w, const int* rows, void* out, int E,
                        int C, int D, int F, int64_t items, int sms, cudaStream_t stream) {
  CUtensorMap wmap;
  const cuuint64_t dims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {kBox, Ring::kBK, 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box, estrides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return launch<Ring, MT>(wmap, xe, rows, out, E, C, D, F, items, sms, stream);
}

}  // namespace

extern "C" {

// xe: (E, C, D); w: (E, D, F); out: (E, C, F); all bf16, contiguous, 16-byte
// aligned; D and F multiples of 8; E at most 256. rows: (E,) int32 on the
// device, or null (every row kept). active: an upper bound on the experts
// with rows > 0 (it sizes the grid; any value >= 1 is correct). Returns a
// cudaError_t (0 on a successful launch).
int repro_moe_gmm_fwd(const void* xe, const void* w, const void* rows, void* out, int E, int C, int D, int F,
                      int active, void* stream) {
  if (E <= 0 || E > kMaxExperts || C <= 0 || D <= 0 || F <= 0 || D % 8 != 0 || F % 8 != 0 || active <= 0)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int mt = (C < 64 ? C + 15 : 64) / 16;  // 16-row m-tiles per item: up to 4
  const int64_t slots = (int64_t)std::min(active, E) * ((C + mt * 16 - 1) / (mt * 16));
  const int64_t items64 = slots * ((F + kBox - 1) / kBox);
  const int* r = static_cast<const int*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t out_err;
  if (items64 <= sms) {  // a decode step's few experts
    switch (mt) {
      case 1: out_err = launch_ring<Tall, 1>(encode, xe, w, r, out, E, C, D, F, items64, sms, st); break;
      case 2: out_err = launch_ring<Tall, 2>(encode, xe, w, r, out, E, C, D, F, items64, sms, st); break;
      case 3: out_err = launch_ring<Tall, 3>(encode, xe, w, r, out, E, C, D, F, items64, sms, st); break;
      default: out_err = launch_ring<Tall, 4>(encode, xe, w, r, out, E, C, D, F, items64, sms, st);
    }
  } else if (mt == 1) {
    out_err = launch_ring<Short, 1>(encode, xe, w, r, out, E, C, D, F, items64, sms, st);
  } else {
    const int64_t items = slots * ((F + Wide::kBF - 1) / Wide::kBF);
    switch (mt) {
      case 2: out_err = launch_ring<Wide, 2>(encode, xe, w, r, out, E, C, D, F, items, sms, st); break;
      case 3: out_err = launch_ring<Wide, 3>(encode, xe, w, r, out, E, C, D, F, items, sms, st); break;
      default: out_err = launch_ring<Wide, 4>(encode, xe, w, r, out, E, C, D, F, items, sms, st);
    }
  }
  return (int)out_err;
}

}  // extern "C"
