// K5's gradient — the two products of the per-expert grouped GEMM's backward,
// routed experts only, for Hopper (sm_90a):
//
//   dxe[e] = dy[e] w[e]^T   (E, C, D) on the rows below rows[e], exact zeros past them
//   dw[e]  = xe[e]^T dy[e]  (E, D, F) over the rows below rows[e]; zeros where rows[e] == 0
//
// for out[e] = xe[e] w[e] (csrc/moe_gmm.cu), xe (E, C, D), w (E, D, F), dy
// (E, C, F), all bf16, fp32 accumulation.
//
// Replaces: no TPU kernel. The Pallas kernel src/repro/kernels/moe_gmm.py ::
// moe_gmm has no VJP; the JAX package differentiates the MoE layer's jnp
// einsums (models/moe.py). This is the gradient of the forward that K5
// computes, so that the MoE family trains on the card through the same
// routed products.
//
// What bounds it on this card: at qwen3-moe-30b-a3b's train shape (E = 128,
// d = 2048, f = 768, C = 640, 65,536 kept rows of a top-8 routing of 2 x 4096
// tokens) the two products are 2 x 2 x 65,536 d f = 412 GFLOP, 0.42 ms at the
// 989 TFLOP/s bf16 peak, against ~1.5 GB of inputs and outputs, 0.45 ms at
// 3.35 TB/s: the card's two limits about equal. The first version (64 x 64
// tiles of mma.sync on 4 warps through a cp.async ring, 49,152 blocks for dw)
// loaded a tile for every ~32 flop, far below the ~295 flop per byte of the
// ridge: its blocks waited on L2 and the tensor cores idled (2.98 ms on an
// NVIDIA H100 80GB HBM3 at 700.00 W; this design 0.88 ms, two torch.bmm on
// the full buffers 0.78: the products' loads from L2, ~48 KB a 4.2 MFLOP
// stage per SM, are what it waits on now).
//
// What the design does about it:
//   * one persistent kernel per product, one block per SM (the grid is the
//     SM count), striding statically over a tile list (tile += gridDim.x);
//     a block of 384 threads: one producer thread issues TMA loads through a
//     3-stage ring of mbarriers; two consumer warpgroups (registers raised
//     by setmaxnreg) each own 64 rows of a 128 x 256 output tile and issue
//     wgmma m64n128k16 twice per 16 of the contraction, both operands from
//     shared memory. A stage is 64 of the contraction: 16 KB of A and 32 KB
//     of B, 128-byte swizzled as TMA writes them (csrc/wgmma_tma.cuh), about
//     85 flop for each byte a block loads. A warpgroup writes its 64 x 256
//     outputs as bf16 to shared memory and one of its threads stores them
//     with TMA while the next tile's products run (stored straight from the
//     accumulators' registers, the call took 1.35 ms, against 0.88);
//   * the tile list is built in each block from rows, never on the host (a
//     host read of rows would sync the training step): a warp scans the
//     experts' units into a prefix in shared memory, the compute tiles come
//     first, and the tiles that lie wholly past rows[e] come last: they
//     write zeros and read nothing;
//   * dxe: M = C, N = D, K = F. A = dy[e]'s rows and B = w[e] itself, both
//     K-major (F, the contraction, is their contiguous axis): w is read in
//     place, with no transposed copy. The rows of the last M tile at or
//     past rows[e] are stored as exact zeros;
//   * dw: M = D, N = F, K = the expert's kept rows. A = xe[e]^T and B = dy[e]
//     have the contraction (C) as their row index: both MN-major (wgmma's
//     transpose bits; A's is for 16-bit types only). A TMA box cannot stop
//     at rows[e], so inside the last 64-row K tile the rows past rows[e] are
//     zeroed in shared memory once TMA has landed them (then
//     fence.proxy.async and a barrier over both consumer warpgroups, before
//     wgmma reads them): whatever xe and dy hold there adds nothing. An
//     expert with rows[e] == 0 writes zeros and reads nothing;
//   * no split over C and no atomics of any kind: each output element is
//     summed by one thread over the contraction in one fixed order, so equal
//     inputs give equal bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "async_copy.cuh"  // allow_smem_once
#include "mma_bf16.cuh"    // pack_bf16
#include "wgmma_tma.cuh"   // mbarriers, TMA, wgmma

namespace {
namespace gmm_bwd {

constexpr int kBM = 128;  // output rows of a tile: 64 per consumer warpgroup
constexpr int kBN = 256;  // output columns of a tile: two m64n128 products per warpgroup
constexpr int kBK = 64;   // contraction per stage: one 128-byte row of bf16
constexpr int kStages = 3;
constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65536
constexpr int kMaxExperts = 256;    // kernels/moe_gmm.py: MAX_EXPERTS
constexpr int kTile = 64 * 128;     // bytes of a 64-row x 64-column swizzled tile
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBBytes = kBN * kBK * 2;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOffOut = kStages * kStageBytes;  // the output tile (bf16), 32 KB per consumer warpgroup
constexpr int kOffBar = kOffOut + kBM * kBN * 2;  // full[kStages], empty[kStages]
constexpr int kOffPlan = kOffBar + 2 * kStages * 8;
constexpr size_t kSmem = 1024 + kOffPlan + 4 * (3 * kMaxExperts + 2);
static_assert(kSmem <= 232448, "shared memory of one block");

struct Args {
  const int* rows;  // (E,) or null: every row kept
  __nv_bfloat16* out;
  int E, C, D, F;
};

// The largest e in [0, E) with pref[e] <= u (pref non-decreasing, u < pref[E]):
// the expert that holds unit u.
__device__ __forceinline__ int find_expert(const int* pref, int E, int u) {
  int lo = 0, hi = E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pref[mid] <= u) lo = mid;
    else hi = mid;
  }
  return lo;
}

// dxe (kDW false): out (E, C, D) = dy w^T, M = C, N = D, K = F; amap: dy as
// (F, C, E) in boxes of 64 x 128, bmap: w as (F, D, E) in boxes of 64 x 256.
// dw (kDW true): out (E, D, F) = xe^T dy, M = D, N = F, K = kept rows; amap:
// xe as (D, C, E), bmap: dy as (F, C, E), both in boxes of 64 x 64.
// omap: the output as (N, M, E) in boxes of 64 x 64. The body of the two
// kernels below.
template <bool kDW>
__device__ __forceinline__ void gmm_bwd_tiles(const CUtensorMap& amap, const CUtensorMap& bmap,
                                              const CUtensorMap& omap, const Args& p) {
  const int M = kDW ? p.D : p.C;
  const int N = kDW ? p.F : p.D;
  const int nM = (M + kBM - 1) / kBM;
  const int nN = (N + kBN - 1) / kBN;
  const int per = kDW ? nM * nN : nN;  // tiles of one unit: a whole expert (dw), one M tile (dxe)
  const int total = p.E * nM * nN;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kOffBar);
  uint64_t* empty = full + kStages;
  int* pref = reinterpret_cast<int*>(base + kOffPlan);  // [E + 1] compute units before expert e
  int* zpref = pref + kMaxExperts + 1;                  // [E + 1] zero units before expert e
  int* kept_s = zpref + kMaxExperts + 1;                // [E] kept rows

  // ---- the tile list: each expert's kept rows and units, scanned by warp 0 ----
  if (threadIdx.x < 32) {
    constexpr int kPerLane = kMaxExperts / 32;
    const int lane = threadIdx.x;
    int cnt[kPerLane], zc[kPerLane], sc = 0, sz = 0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = lane * kPerLane + i;
      int c = 0, z = 0;
      if (e < p.E) {
        const int kept = p.rows == nullptr ? p.C : min(max(p.rows[e], 0), p.C);
        kept_s[e] = kept;
        c = kDW ? (kept > 0) : (kept + kBM - 1) / kBM;
        z = kDW ? 1 - c : nM - c;
      }
      cnt[i] = c;
      zc[i] = z;
      sc += c;
      sz += z;
    }
    int ic = sc, iz = sz;  // inclusive scan over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int uc = __shfl_up_sync(0xffffffffu, ic, o);
      const int uz = __shfl_up_sync(0xffffffffu, iz, o);
      if (lane >= o) {
        ic += uc;
        iz += uz;
      }
    }
    int bc = ic - sc, bz = iz - sz;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = lane * kPerLane + i;
      if (e <= p.E) {
        pref[e] = bc;
        zpref[e] = bz;
      }
      bc += cnt[i];
      bz += zc[i];
    }
    if (lane == 31 && p.E == kMaxExperts) {
      pref[kMaxExperts] = bc;
      zpref[kMaxExperts] = bz;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_compute = pref[p.E] * per;

  // Tile t of the list: its expert, M and N tile, the expert's kept rows;
  // true for a compute tile, false for one that only writes zeros.
  auto tile_of = [&](int t, int& e, int& m, int& n, int& kept) -> bool {
    const bool compute = t < n_compute;
    const int* pr = compute ? pref : zpref;
    const int tt = compute ? t : t - n_compute;
    const int u = tt / per;
    const int r = tt - u * per;
    e = find_expert(pr, p.E, u);
    kept = kept_s[e];
    if (kDW) {
      m = r / nN;
      n = r - m * nN;
    } else {
      m = u - pr[e] + (compute ? 0 : (kept + kBM - 1) / kBM);
      n = r;
    }
    return compute;
  };
  auto k_steps = [&](int kept) { return kDW ? (kept + kBK - 1) / kBK : (p.F + kBK - 1) / kBK; };

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------ producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < n_compute; t += gridDim.x) {
        int e, m, n, kept;
        tile_of(t, e, m, n, kept);
        const int nk = k_steps(kept);
        for (int k = 0; k < nk; ++k, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStageBytes);
          unsigned char* sa = base + s * kStageBytes;
          unsigned char* sb = sa + kABytes;
          if (kDW) {  // 64 kept rows of xe[e] and dy[e]: 64-column tiles of the tile's D and F columns
#pragma unroll
            for (int c = 0; c < kBM / 64; ++c) tma_load_3d(sa + c * kTile, &amap, &full[s], m * kBM + 64 * c, k * kBK, e);
#pragma unroll
            for (int c = 0; c < kBN / 64; ++c) tma_load_3d(sb + c * kTile, &bmap, &full[s], n * kBN + 64 * c, k * kBK, e);
          } else {  // 64 columns of F: 128 rows of dy[e], 256 rows of w[e]
            tma_load_3d(sa, &amap, &full[s], k * kBK, m * kBM, e);
            tma_load_3d(sb, &bmap, &full[s], k * kBK, n * kBN, e);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------ consumers
    regs_inc<kConsumerRegs>();
    const int w = wg - 1;                 // this warpgroup's rows of the tile: [64 w, 64 w + 64)
    const int ct = threadIdx.x - 128;     // 0 .. 255 over both consumer warpgroups
    const int t128 = threadIdx.x % 128;
    const int lane = t128 % 32;
    const int frag_row = 64 * w + (t128 / 32) * 16 + lane / 4;  // the fragment's upper row in the tile
    float acc[2][64];
    int it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int e, m, n, kept;
      const bool compute = tile_of(t, e, m, n, kept);
      const int m0 = m * kBM, n0 = n * kBN;
      __nv_bfloat16* out = p.out + (int64_t)e * M * N;
      if (!compute) {  // wholly past rows[e] (dxe) or an expert with no row (dw): zeros, nothing read
        const int rows = min(kBM, M - m0), chunks = min(kBN, N - n0) / 8;
        for (int i = ct; i < rows * chunks; i += kConsumers) {
          const int r = i / chunks;
          *reinterpret_cast<uint4*>(out + (int64_t)(m0 + r) * N + n0 + 8 * (i - r * chunks)) = make_uint4(0, 0, 0, 0);
        }
        continue;
      }
      const int nk = k_steps(kept);
      for (int k = 0; k < nk; ++k, ++it) {
        const int s = it % kStages;
        unsigned char* stage = base + s * kStageBytes;
        const uint32_t sa = smem_u32(stage);
        const uint32_t sb = sa + kABytes;
        mbar_wait(&full[s], (it / kStages) & 1);
        if (kDW && k == nk - 1 && kept % kBK != 0) {
          // the rows past rows[e] of the last K tile, in each of the stage's
          // 6 tiles (2 of A, 4 of B: 64 rows of 128 bytes; the swizzle moves
          // 16-byte chunks only inside a row): zeros before wgmma reads them
          const int r0 = kept % kBK;
          const int tail = (kBK - r0) * 8;
          for (int i = ct; i < (kStageBytes / kTile) * tail; i += kConsumers) {
            const int tile = i / tail, rest = i - tile * tail;
            *reinterpret_cast<uint4*>(stage + tile * kTile + (r0 + rest / 8) * 128 + (rest % 8) * 16) =
                make_uint4(0, 0, 0, 0);
          }
          fence_proxy_async_shared();
          named_bar_sync(1, kConsumers);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (kDW)  // MN-major: 16 contraction rows are 2048 bytes; the next 64 columns LBO = one tile on
              wgmma_ss_n128<1, 1>(acc[h], wgmma_desc(sa + w * kTile + kk * 2048, kTile, 1024),
                                  wgmma_desc(sb + 2 * h * kTile + kk * 2048, kTile, 1024), k > 0 || kk > 0);
            else  // K-major: 16 of the contraction are 32 bytes of a row
              wgmma_ss_n128<0, 0>(acc[h], wgmma_desc(sa + w * 64 * 128 + kk * 32, 16, 1024),
                                  wgmma_desc(sb + h * 128 * 128 + kk * 32, 16, 1024), k > 0 || kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the last step's products are done: its stage is free
        if (k > 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      mbar_arrive(&empty[(it - 1) % kStages]);
      fence_regs(acc[0]);
      fence_regs(acc[1]);

      // ---- the warpgroup's 64 rows to bf16 in shared memory (dxe rows at or
      // past rows[e] as exact zeros), 4 swizzled boxes of 64 x 64, then TMA
      // stores them while the next tile's products run (rows and columns
      // past the tensor are not written) ----
      unsigned char* otile = base + kOffOut + w * (64 * kBN * 2);
      if (t128 == 0) bulk_wait_read();  // the last tile's stores have read the buffer
      named_bar_sync(2 + w, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = frag_row - 64 * w + 8 * half;  // row within the warpgroup's 64
            const bool keep = kDW || m0 + 64 * w + r < kept;
            *reinterpret_cast<uint32_t*>(otile + (2 * h + j / 8) * kTile + r * 128 + (((j % 8) ^ (r % 8)) * 16) +
                                         4 * (lane % 4)) =
                pack_bf16(keep ? acc[h][4 * j + 2 * half] : 0.f, keep ? acc[h][4 * j + 2 * half + 1] : 0.f);
          }
      fence_proxy_async_shared();
      named_bar_sync(2 + w, 128);
      if (t128 == 0) {
#pragma unroll
        for (int c = 0; c < kBN / 64; ++c) tma_store_3d(&omap, otile + c * kTile, n0 + 64 * c, m0 + 64 * w, e);
        bulk_commit();
      }
    }
    if (t128 == 0) bulk_commit_and_wait_all();  // every store done before the block exits
  }
}

__global__ void __launch_bounds__(kThreads, 1)
moe_gmm_bwd_dx_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap omap, const Args p) {
  gmm_bwd_tiles<false>(amap, bmap, omap, p);
}

__global__ void __launch_bounds__(kThreads, 1)
moe_gmm_bwd_dw_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap omap, const Args p) {
  gmm_bwd_tiles<true>(amap, bmap, omap, p);
}

// ---------------------------------------------------------------- host

// A (d2, d1, d0) bf16 array as a 3-D tensor map of boxes of box0 x box1
// (one index of d2), 128-byte swizzled; elements past the dims zero-filled.
bool encode_3d(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d0, int d1, int d2, int box0,
               int box1) {
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, estrides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kDW>
cudaError_t launch(const CUtensorMap& amap, const CUtensorMap& bmap, const CUtensorMap& omap, const Args& p,
                   cudaStream_t stream) {
  static std::atomic<uint32_t> smem_set{0u};
  cudaError_t err = kDW ? allow_smem_once(moe_gmm_bwd_dw_kernel, kSmem, smem_set)
                        : allow_smem_once(moe_gmm_bwd_dx_kernel, kSmem, smem_set);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int M = kDW ? p.D : p.C, N = kDW ? p.F : p.D;
  const int64_t tiles = (int64_t)p.E * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  if constexpr (kDW) moe_gmm_bwd_dw_kernel<<<grid, kThreads, kSmem, stream>>>(amap, bmap, omap, p);
  else moe_gmm_bwd_dx_kernel<<<grid, kThreads, kSmem, stream>>>(amap, bmap, omap, p);
  return cudaGetLastError();
}

}  // namespace gmm_bwd
}  // namespace

extern "C" {

// xe: (E, C, D); w: (E, D, F); dy: (E, C, F); dxe: (E, C, D); dw: (E, D, F);
// all bf16, contiguous, 16-byte aligned; D and F multiples of 8; E at most
// 256. rows: (E,) int32 on the device, or null (every row kept). Two
// launches on `stream` (dxe, then dw); returns a cudaError_t (0 when both
// launched).
int repro_moe_gmm_bwd(const void* xe, const void* w, const void* rows, const void* dy, void* dxe, void* dw, int E,
                      int C, int D, int F, void* stream) {
  using namespace gmm_bwd;
  if (E <= 0 || E > kMaxExperts || C <= 0 || D <= 0 || F <= 0 || D % 8 != 0 || F % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return (int)bound;
  CUtensorMap dy_rows, w_rows, dxe_out, xe_k, dy_k, dw_out;
  if (!encode_3d(encode, &dy_rows, dy, F, C, E, kBK, kBM) || !encode_3d(encode, &w_rows, w, F, D, E, kBK, kBN) ||
      !encode_3d(encode, &dxe_out, dxe, D, C, E, 64, 64) || !encode_3d(encode, &xe_k, xe, D, C, E, 64, kBK) ||
      !encode_3d(encode, &dy_k, dy, F, C, E, 64, kBK) || !encode_3d(encode, &dw_out, dw, F, D, E, 64, 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  cudaError_t err =
      launch<false>(dy_rows, w_rows, dxe_out, Args{r, static_cast<__nv_bfloat16*>(dxe), E, C, D, F}, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<true>(xe_k, dy_k, dw_out, Args{r, static_cast<__nv_bfloat16*>(dw), E, C, D, F}, st);
}

}  // extern "C"
