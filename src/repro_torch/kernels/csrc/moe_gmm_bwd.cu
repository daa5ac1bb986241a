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
// What bounds it on this card: the tensor cores. At qwen3-moe-30b-a3b's
// train shape (E = 128, d = 2048, f = 768, C = 640 at 2 x 4096 tokens) each
// of the two products is 2 E C d f = 258 GFLOP against 2 (E C (d + f) + E d
// f) = 0.86 GB of bytes, about 300 flop per byte, at the ridge of the card.
//
// What the design does about it (a first version: right and deterministic,
// not yet fast):
//   * two kernels, one per product, each a plain tiled GEMM on the tensor
//     cores (mma.sync m16n8k16 bf16 -> fp32): 64 x 64 output tiles, 4 warps
//     of 32 x 32, K in steps of 32 through a 3-stage cp.async ring, padded
//     shared-memory rows so that ldmatrix is bank-conflict free;
//   * dxe: A = dy[e] rows (ldmatrix), B = w[e]^T read in place: w's rows are
//     the output columns and its f axis, contiguous, is the product's K, so
//     its fragments come from w as stored (no transposed copy of w). A tile
//     of rows at or past rows[e] reads nothing and writes zeros; inside a
//     tile, rows past rows[e] are zero-filled on load and written as zeros;
//   * dw: K is the expert's kept rows only. A = xe[e]^T and B = dy[e], both
//     read transposed from their row-major tiles by ldmatrix.trans. An
//     expert with rows[e] == 0 reads no byte and writes zeros. There is no
//     split over C: each output element is summed by one thread over the
//     kept rows in one fixed order;
//   * no atomics and no split anywhere, so equal inputs give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"  // cp.async helpers
#include "mma_bf16.cuh"    // ldmatrix, mma.sync m16n8k16

namespace {

constexpr int kBM = 64;  // output rows per block
constexpr int kBN = 64;  // output columns per block
constexpr int kBK = 32;  // K per stage
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps, 2 x 2, each 32 x 32 of the tile
constexpr int kPad = 8;        // bf16 per shared-memory row

// A tile stored [m][k] (kAT false) or [k][m] (kAT true), B tile [n][k] (kBT
// false) or [k][n] (kBT true).
template <bool kAT, bool kBT>
struct Tiles {
  static constexpr int kAStride = kAT ? kBM + kPad : kBK + kPad;
  static constexpr int kBStride = kBT ? kBN + kPad : kBK + kPad;
  static constexpr int kAElems = kAT ? kBK * kAStride : kBM * kAStride;
  static constexpr int kBElems = kBT ? kBK * kBStride : kBN * kBStride;
};

// One operand's tile (R rows of W columns, 16-byte chunks) into shared memory;
// chunks past (rows, cols) are zero-filled and read nothing.
template <int R, int W>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, int stride, const __nv_bfloat16* g, int64_t ld,
                                          int rows, int cols, int tid) {
  constexpr int kChunks = R * (W / 8);
#pragma unroll
  for (int i = tid; i < kChunks; i += kThreads) {
    const int r = i / (W / 8);
    const int c = (i - r * (W / 8)) * 8;
    const bool ok = r < rows && c < cols;
    cp_async_16(s + r * stride + c, ok ? g + r * ld + c : g, ok);
  }
}

// acc (this warp's 32 x 32: 2 m16 x 4 n8 tiles) += A B over K, A (M x K) at
// `a` with leading dimension lda, B (K x N) at `b` with ldb, as stored per
// kAT / kBT; rows of A past a_rows (kAT: K rows past k_rows) are zero.
template <bool kAT, bool kBT>
__device__ __forceinline__ void gemm_tile(float acc[2][4][4], __nv_bfloat16* smem, const __nv_bfloat16* a,
                                          int64_t lda, const __nv_bfloat16* b, int64_t ldb, int m_rows, int n_cols,
                                          int k_len) {
  using L = Tiles<kAT, kBT>;
  __nv_bfloat16* as = smem;
  __nv_bfloat16* bs = smem + kStages * L::kAElems;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int wm = (w & 1) * 32;  // this warp's rows and columns of the tile
  const int wn = (w >> 1) * 32;
  const int mat = lane >> 3;
  const int mrow = lane & 7;
  const int nk = (k_len + kBK - 1) / kBK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const int kr = k_len - k0;
    if (kAT)  // [k][m]: K rows, M columns
      load_tile<kBK, kBM>(as + stage * L::kAElems, L::kAStride, a + k0 * lda, lda, kr, m_rows, tid);
    else  // [m][k]
      load_tile<kBM, kBK>(as + stage * L::kAElems, L::kAStride, a + k0, lda, m_rows, kr, tid);
    if (kBT)  // [k][n]
      load_tile<kBK, kBN>(bs + stage * L::kBElems, L::kBStride, b + k0 * ldb, ldb, kr, n_cols, tid);
    else  // [n][k]
      load_tile<kBN, kBK>(bs + stage * L::kBElems, L::kBStride, b + k0, ldb, n_cols, kr, tid);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt landed (this thread's copies) ...
    __syncthreads();               // ... everyone's; the slot of kt - 1 is free
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* at = as + (kt % kStages) * L::kAElems;
    const __nv_bfloat16* bt = bs + (kt % kStages) * L::kBElems;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m0 = wm + 16 * mi;
        if (kAT)  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15) of [k][m]
          ldmatrix_x4_trans(af[mi], at + (16 * kk + (mat >> 1) * 8 + mrow) * L::kAStride + m0 + (mat & 1) * 8);
        else
          ldmatrix_x4(af[mi], at + (m0 + (mat & 1) * 8 + mrow) * L::kAStride + 16 * kk + (mat >> 1) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n0 = wn + 16 * nj;
        uint32_t bf[4];  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        if (kBT)
          ldmatrix_x4_trans(bf, bt + (16 * kk + (mat & 1) * 8 + mrow) * L::kBStride + n0 + (mat >> 1) * 8);
        else
          ldmatrix_x4(bf, bt + (n0 + (mat >> 1) * 8 + mrow) * L::kBStride + 16 * kk + (mat & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_16816(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_16816(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The tile's outputs (bf16) at `out` (leading dimension ldo): rows past
// keep_rows are written as zeros, rows past m_rows and columns past n_cols
// not at all.
__device__ __forceinline__ void store_tile(const float acc[2][4][4], __nv_bfloat16* out, int64_t ldo, int m_rows,
                                           int n_cols, int keep_rows) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = (w & 1) * 32 + 16 * mi + grp + 8 * hf;
        const int c = (w >> 1) * 32 + 8 * ni + 2 * tig;
        if (r < m_rows && c < n_cols) {
          const bool keep = r < keep_rows;
          *reinterpret_cast<uint32_t*>(out + r * ldo + c) =
              pack_bf16(keep ? acc[mi][ni][2 * hf] : 0.f, keep ? acc[mi][ni][2 * hf + 1] : 0.f);
        }
      }
}

// dxe[e] tile (blockIdx.y: 64 rows of C, blockIdx.x: 64 columns of D).
__global__ void __launch_bounds__(kThreads)
moe_gmm_bwd_dx_kernel(const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ dy,
                      const int* __restrict__ rows, __nv_bfloat16* __restrict__ dxe, int C, int D, int F) {
  using L = Tiles<false, false>;
  __shared__ __align__(16) __nv_bfloat16 smem[kStages * (L::kAElems + L::kBElems)];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kept = rows == nullptr ? C : min(rows[e], C);
  const int m_rows = min(kBM, C - m0);
  const int n_cols = min(kBN, D - n0);
  float acc[2][4][4] = {};
  if (m0 < kept)  // a tile at or past the kept rows reads nothing
    gemm_tile<false, false>(acc, smem, dy + ((int64_t)e * C + m0) * F, F, w + ((int64_t)e * D + n0) * F, F,
                            min(m_rows, kept - m0), n_cols, F);
  store_tile(acc, dxe + ((int64_t)e * C + m0) * D + n0, D, m_rows, n_cols, kept - m0);
}

// dw[e] tile (blockIdx.y: 64 rows of D, blockIdx.x: 64 columns of F).
__global__ void __launch_bounds__(kThreads)
moe_gmm_bwd_dw_kernel(const __nv_bfloat16* __restrict__ xe, const __nv_bfloat16* __restrict__ dy,
                      const int* __restrict__ rows, __nv_bfloat16* __restrict__ dw, int C, int D, int F) {
  using L = Tiles<true, true>;
  __shared__ __align__(16) __nv_bfloat16 smem[kStages * (L::kAElems + L::kBElems)];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kept = rows == nullptr ? C : min(rows[e], C);
  const int m_rows = min(kBM, D - m0);
  const int n_cols = min(kBN, F - n0);
  float acc[2][4][4] = {};
  if (kept > 0)  // an expert with no kept row reads nothing
    gemm_tile<true, true>(acc, smem, xe + (int64_t)e * C * D + m0, D, dy + (int64_t)e * C * F + n0, F, m_rows,
                          n_cols, kept);
  store_tile(acc, dw + ((int64_t)e * D + m0) * F + n0, F, m_rows, n_cols, m_rows);
}

}  // namespace

extern "C" {

// xe: (E, C, D); w: (E, D, F); dy: (E, C, F); dxe: (E, C, D); dw: (E, D, F);
// all bf16, contiguous, 16-byte aligned; D and F multiples of 8. rows: (E,)
// int32 on the device, or null (every row kept). Two launches on `stream`;
// returns a cudaError_t (0 when both launched).
int repro_moe_gmm_bwd(const void* xe, const void* w, const void* rows, const void* dy, void* dxe, void* dw, int E,
                      int C, int D, int F, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0 || D % 8 != 0 || F % 8 != 0) return (int)cudaErrorInvalidValue;
  if ((C + kBM - 1) / kBM > 65535 || (D + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  const dim3 grid_dx((D + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  moe_gmm_bwd_dx_kernel<<<grid_dx, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(w),
                                                      static_cast<const __nv_bfloat16*>(dy), r,
                                                      static_cast<__nv_bfloat16*>(dxe), C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_dw((F + kBN - 1) / kBN, (D + kBM - 1) / kBM, E);
  moe_gmm_bwd_dw_kernel<<<grid_dw, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(xe),
                                                      static_cast<const __nv_bfloat16*>(dy), r,
                                                      static_cast<__nv_bfloat16*>(dw), C, D, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
