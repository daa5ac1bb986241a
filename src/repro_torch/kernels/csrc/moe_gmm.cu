// K5 — per-expert grouped GEMM, out[e] = xe[e] @ w[e], for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/moe_gmm.py :: moe_gmm / _gmm_kernel (the Pallas
// TPU kernel behind the MoE layer's three expert products, models/moe.py:
// gate and up (E, C, d) x (E, d, f) and down (E, C, f) x (E, f, d)).
//
// What bounds it on this card: the expert weights. At the qwen3-moe-30b-a3b
// serving shapes (E = 128, d = 2048, f = 768) one call reads all 128 experts'
// weights, 403 MB, whatever C is; the tokens it multiplies are C = 8 rows per
// expert at a decode step and 8-40 at a prefill. At C = 8 that is 2 * 8 = 16
// flop per weight element (8 flop per byte), far below the H100's ~295
// flop/byte ridge, so the bound is the bytes: 0.120 ms at 3.35 TB/s. The
// design therefore aims at streaming the weights once at full rate, with the
// tensor cores only as the way to do the small products.
//
// What the design does about it:
//   * one block per (expert, C tile of 32 rows, f tile of 64 columns); the
//     C tile is the fastest grid axis, so the blocks that share a weight tile
//     run together and a tile is read from device memory once, through L2;
//   * the contraction over d is a loop inside the block (it replaces the TPU
//     kernel's sequential minor grid axis and its fp32 VMEM accumulator): a
//     3-stage cp.async ring of 64-deep xe and w tiles in shared memory keeps
//     two tiles of loads in flight while the tensor cores work on the third;
//   * 4 warps as 2 x 2, each a 16 x 32 output tile: mma.sync m16n8k16 bf16 ->
//     fp32 accumulators in registers; A fragments are 32-bit loads from the
//     row-major xe tile, B fragments ldmatrix.trans loads from the row-major
//     (d, f) weight tile; a warp whose 16 rows lie past C skips its products;
//   * ragged edges are masked: any C (rows past it are zero-filled and never
//     stored) and any d, f that are multiples of 8 (a 16-byte chunk past the
//     edge is zero-filled, so it adds nothing to the sum);
//   * deterministic: every output element is summed by one thread in one fixed
//     order (no split-K, no atomics), so equal inputs give equal bits.
// Shared-memory rows are padded by 8 bf16 so fragment loads are bank-conflict
// free. No TMA or wgmma yet, and experts that received no token are still
// computed (the reference's dense capacity buffers): that is performance work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockC = 32;  // rows of C per block (2 warps of 16)
constexpr int kBlockF = 64;  // columns of f per block (2 warps of 32)
constexpr int kBlockK = 64;  // depth of d per pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kPad = 8;                       // bf16 padding per shared-memory row
constexpr int kXStride = kBlockK + kPad;      // xe tile row stride (bf16)
constexpr int kWStride = kBlockF + kPad;      // w tile row stride (bf16)
constexpr int kXTile = kBlockC * kXStride;    // bf16 per xe stage
constexpr int kWTile = kBlockK * kWStride;    // bf16 per w stage

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared, asynchronously; src_bytes == 0 zero-fills.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8; register j holds this thread's pair of matrix j.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// D (16x8, fp32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major).
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const __nv_bfloat16* __restrict__ xe, const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kStages][kBlockC][kXStride]
  __nv_bfloat16* Ws = Xs + kStages * kXTile;                        // [kStages][kBlockK][kWStride]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;  // row within the 8-row half of a fragment
  const int tig = lane & 3;   // thread in group: column pair
  const int wm = warp >> 1;   // warp row: output rows wm*16 .. +15
  const int wn = warp & 1;    // warp column: output columns wn*32 .. +31

  const int c0 = blockIdx.x * kBlockC;
  const int f0 = blockIdx.y * kBlockF;
  const int e = blockIdx.z;
  const __nv_bfloat16* xb = xe + (int64_t)e * C * D;
  const __nv_bfloat16* wb = w + (int64_t)e * D * F;
  __nv_bfloat16* ob = out + (int64_t)e * C * F;

  // Stage `kt` of the d sweep into ring slot `slot`: the (32, 64) xe tile
  // (2 chunks of 16 bytes per thread) and the (64, 64) w tile (4 chunks).
  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * kBlockK;
    __nv_bfloat16* xs = Xs + slot * kXTile;
    __nv_bfloat16* ws = Ws + slot * kWTile;
#pragma unroll
    for (int i = 0; i < (kBlockC * kBlockK / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBlockK / 8);
      const int col = (c % (kBlockK / 8)) * 8;
      const bool ok = c0 + r < C && k0 + col < D;
      const __nv_bfloat16* src = ok ? xb + (int64_t)(c0 + r) * D + k0 + col : xe;
      cp_async_16(xs + r * kXStride + col, src, ok);
    }
#pragma unroll
    for (int i = 0; i < (kBlockK * kBlockF / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBlockF / 8);
      const int col = (c % (kBlockF / 8)) * 8;
      const bool ok = k0 + r < D && f0 + col < F;
      const __nv_bfloat16* src = ok ? wb + (int64_t)(k0 + r) * F + f0 + col : w;
      cp_async_16(ws + r * kWStride + col, src, ok);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_k = (D + kBlockK - 1) / kBlockK;
  const bool active = c0 + wm * 16 < C;  // warp-uniform: this warp's rows hold tokens

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; slot (kt - 1) % kStages is free
    const int nxt = kt + kStages - 1;
    if (nxt < n_k) load_stage(nxt % kStages, nxt);
    cp_async_commit();  // an empty group at the tail keeps the count uniform

    if (active) {
      const __nv_bfloat16* xs = Xs + (kt % kStages) * kXTile + (wm * 16) * kXStride;
      const __nv_bfloat16* ws = Ws + (kt % kStages) * kWTile;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        uint32_t a[4];
        a[0] = ld_u32(xs + grp * kXStride + kk * 16 + tig * 2);
        a[1] = ld_u32(xs + (grp + 8) * kXStride + kk * 16 + tig * 2);
        a[2] = ld_u32(xs + grp * kXStride + kk * 16 + tig * 2 + 8);
        a[3] = ld_u32(xs + (grp + 8) * kXStride + kk * 16 + tig * 2 + 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
          const int mat = lane >> 3;
          const int krow = kk * 16 + (mat & 1) * 8 + (lane & 7);
          const int ncol = wn * 32 + j * 16 + (mat >> 1) * 8;
          uint32_t b[4];
          ldmatrix_x4_trans(b, ws + krow * kWStride + ncol);
          mma_16816(acc[2 * j], a, b[0], b[1]);
          mma_16816(acc[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!active) return;
  const int row_a = c0 + wm * 16 + grp;
  const int row_b = row_a + 8;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = f0 + wn * 32 + n * 8 + tig * 2;  // even; F % 8 == 0, so col + 1 < F too
    if (col >= F) continue;
    if (row_a < C)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_a * F + col) = pack_bf16(acc[n][0], acc[n][1]);
    if (row_b < C)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_b * F + col) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

}  // namespace

extern "C" {

// xe: (E, C, D); w: (E, D, F); out: (E, C, F); all bf16, contiguous, 16-byte
// aligned; D and F multiples of 8. Returns a cudaError_t (0 on a successful
// launch).
int repro_moe_gmm_fwd(const void* xe, const void* w, void* out, int E, int C, int D, int F,
                      void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || D % 8 != 0 || F % 8 != 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  // 41,472 bytes: under the 48 KB a launch may ask for without an attribute
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)kStages * (kXTile + kWTile);
  const dim3 grid((C + kBlockC - 1) / kBlockC, (F + kBlockF - 1) / kBlockF, E);
  moe_gmm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xe), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), C, D, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
