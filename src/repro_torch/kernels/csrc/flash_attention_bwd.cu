// K3's gradient — the backward of causal / non-causal GQA flash attention,
// for Hopper (sm_90a).
//
// Replaces: nothing on the TPU. The Pallas kernel
// src/repro/kernels/flash_attention.py :: flash_attention has no VJP; the JAX
// train step (src/repro/training/train_step.py, jax.value_and_grad)
// differentiates the attention through XLA. On the card the forward is K3
// (csrc/flash_attention.cu), so training needs this kernel: without it a
// gradient would have to go through the plain version or a library kernel.
//
// What it computes, from bf16 q (B, T, H, D), k, v (B, S, KV, D), the
// forward's output o and its gradient dO (B, T, H, D), and the forward's
// row logsumexp lse (B, H, T) fp32, with P = exp(scale * q k^T - lse)
// recomputed tile by tile (the (T, S) matrix is never stored):
//   D_i  = sum_d dO_id * o_id                       (fp32, one per row)
//   dV_j = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dQ_i = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i
// GQA: kv head g serves query heads [g * H/KV, (g + 1) * H/KV); its dK and dV
// sum over all of them. Causal row i sees the columns j <= i.
//
// Two kernels, launched in this order on one stream:
//   * dq: one block per (b, h, 64-row query tile), four warps of 16 rows.
//     It first takes D for its 64 rows from o and dO in global memory (one
//     fixed order) and writes it out for the next kernel; then it loops over
//     the K/V tiles its rows can see (a 2-stage cp.async ring), recomputes
//     each warp's P and dP = dO V^T 32 columns at a time, and accumulates dQ
//     in fp32 registers; dQ is written once.
//   * dkdv: one block per (b, kv head, 64-row K/V tile), four warps of 16 kv
//     rows. Its K and V tiles stay in shared memory; it loops over the
//     group's query heads and, for each, over the query tiles that can see
//     its tile (causal: from the tile holding row k0 on), with the Q and dO
//     tiles, their lse and D in a 2-stage cp.async ring; each warp
//     recomputes P^T = exp(scale K Q^T - lse) and dP^T = V dO^T for 32 query
//     columns at a time and accumulates dV += P^T dO and dK += dS^T Q in fp32
//     registers; dK and dV are written once.
// No atomics and one fixed order for every sum, so two launches give equal
// bits. Any T and S (ragged edges zero-filled and masked), head dim 64, 112
// or 128, causal or not, any group size.
//
// Every product is mma.sync m16n8k16 bf16 -> fp32 through csrc/mma_bf16.cuh:
// A fragments by ldmatrix from shared memory, B fragments by ldmatrix (row
// layout, for X Y^T) or ldmatrix.trans (for P Y). P and dS are rounded to
// bf16 before the products that take them, as the forward rounds P.
//
// What bounds it on this card: at the train shape (B = 2, T = S = 4096, 32/8
// heads of 64, causal) the five T x S x D products are ~344 GFLOP, ~0.35 ms
// at the 989 TFLOP/s bf16 peak, against ~0.03 ms for its 118 MB of inputs
// and outputs: the operations bound it. This first kernel recomputes S and
// dP in both kernels (seven products instead of five) on mma.sync, not
// wgmma, with one warpgroup per block; a faster schedule (wgmma, TMA, one
// pass with dQ written per K/V tile) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "async_copy.cuh"  // cp.async ring helpers, allow_smem_once
#include "mma_bf16.cuh"    // ldmatrix, mma.sync m16n8k16, ex2

namespace {
namespace flash_bwd {

constexpr int kBlock = 64;   // rows of every tile: a dq block's query rows, a dkdv block's kv rows
constexpr int kWarps = 4;    // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kHalf = 32;    // the columns of a tile a warp computes at once
constexpr int kPad = 8;      // bf16 padding per shared-memory row (bank-conflict-free ldmatrix)
constexpr int kStages = 2;   // ring depth: tile k + 1 loads while tile k is computed
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes() {  // two fixed tiles and two ring stages of two tiles, plus 2 x 64 fp32 a stage
  return sizeof(__nv_bfloat16) * (size_t)(2 + 2 * kStages) * kBlock * (D + kPad) +
         sizeof(float) * (size_t)2 * kStages * kBlock;
}

// A fragment (16 x 16, row-major) of the tile at `p` (row stride `stride`).
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* p, int stride, int lane) {
  const int mat = lane >> 3, mrow = lane & 7;
  // matrices: (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  ldmatrix_x4(a, p + ((mat & 1) * 8 + mrow) * stride + (mat >> 1) * 8);
}

// s (16 x 32, fp32) = A (16 rows x D at `a`) . B^T (B: 32 rows x D at `bt`),
// both tiles in shared memory with row stride `stride`.
template <int D>
__device__ __forceinline__ void mul_abt(float s[4][4], const __nv_bfloat16* a, const __nv_bfloat16* bt,
                                        int stride, int lane) {
  const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    load_a(af, a + kk * 16, stride, lane);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      // matrices: (B rows j, dims 0-7), (j, 8-15), (j + 1, 0-7), (j + 1, 8-15)
      uint32_t bf[4];
      ldmatrix_x4(bf, bt + ((j + (mat >> 1)) * 8 + mrow) * stride + kk * 16 + (mat & 1) * 8);
      mma_16816(s[j], af, bf[0], bf[1]);
      mma_16816(s[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D, fp32) += P (16 x 32: the fp32 accumulators p, rounded to
// bf16) . M (32 rows x D at `m`, shared memory, row stride `stride`).
template <int D>
__device__ __forceinline__ void mul_pm(float acc[D / 8][4], const float p[4][4], const __nv_bfloat16* m,
                                       int stride, int lane) {
  const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kHalf / 16; ++kk) {
    uint32_t pf[4];
    pf[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pf[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pf[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pf[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      // matrices: (M rows 0-7, dims n), (8-15, n), (0-7, n + 1), (8-15, n + 1)
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, m + (kk * 16 + (mat & 1) * 8 + mrow) * stride + (n + (mat >> 1)) * 8);
      mma_16816(acc[n], pf, bf[0], bf[1]);
      mma_16816(acc[n + 1], pf, bf[2], bf[3]);
    }
  }
}

// 64 rows of a (rows, heads, D) bf16 array into a tile of row stride
// D + kPad: rows [r0, r0 + 64) of head `head`, those at or past `n` zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t row_stride,
                                          int r0, int n, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < (kBlock * kChunks + kThreads - 1) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    if (c < kBlock * kChunks) {
      const int r = c / kChunks;
      const int col = (c - r * kChunks) * 8;
      const bool ok = r0 + r < n;
      cp_async_16(dst + r * (D + kPad) + col, src + (ok ? (int64_t)(r0 + r) * row_stride + col : 0), ok);
    }
  }
}

// ---------------------------------------------------------------- dq (+ D)

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    __nv_bfloat16* __restrict__ dq, float* __restrict__ dsum, int T, int S, int H, int KV,
                    int causal, float scale_log2, float scale) {
  constexpr int kStride = D + kPad;
  constexpr int kTile = kBlock * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][kStride]
  __nv_bfloat16* dOs = Qs + kTile;                                  // [64][kStride]
  __nv_bfloat16* Ks = dOs + kTile;                                  // [kStages][64][kStride]
  __nv_bfloat16* Vs = Ks + kStages * kTile;                         // [kStages][64][kStride]
  __shared__ float Dsm[kBlock];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;  // heaviest causal tiles first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int64_t q_row_stride = (int64_t)H * D;
  const int64_t kv_row_stride = (int64_t)KV * D;
  const int64_t q_off = ((int64_t)b * T) * q_row_stride + (int64_t)h * D;
  const __nv_bfloat16* kb = k + ((int64_t)b * S) * kv_row_stride + (int64_t)kvh * D;
  const __nv_bfloat16* vb = v + ((int64_t)b * S) * kv_row_stride + (int64_t)kvh * D;
  const int64_t row_off = ((int64_t)b * H + h) * T;  // (B, H, T) arrays

  int n_tiles = (S + kBlock - 1) / kBlock;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlock, T) - 1) / kBlock + 1);

  // ---- prologue: Q and dO join the first group, with the first K/V tile ----
  load_tile<D>(Qs, q + q_off, q_row_stride, q0, T, tid);
  load_tile<D>(dOs, dout + q_off, q_row_stride, q0, T, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      load_tile<D>(Ks + s * kTile, kb, kv_row_stride, s * kBlock, S, tid);
      load_tile<D>(Vs + s * kTile, vb, kv_row_stride, s * kBlock, S, tid);
    }
    cp_async_commit();
  }

  // ---- D = rowsum(dO * o) for the block's rows, fp32, while the copies fly:
  // two threads a row, each half the dims in order, then their two sums ----
  {
    const int r = tid >> 1;
    const int half = tid & 1;
    float acc = 0.f;
    if (q0 + r < T) {
      const int64_t at = q_off + (int64_t)(q0 + r) * q_row_stride + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + at + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + at + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          acc = fmaf(of.x, df.x, acc);
          acc = fmaf(of.y, df.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Dsm[r] = acc;
      if (q0 + r < T) dsum[row_off + q0 + r] = acc;
    }
  }
  __syncthreads();

  const int row_lo = q0 + warp * 16;  // this warp's first query row
  const bool active = row_lo < T;     // warp-uniform
  const int row_a = row_lo + grp;     // this thread's two query rows
  const int row_b = row_a + 8;
  const float d_a = Dsm[warp * 16 + grp];
  const float d_b = Dsm[warp * 16 + grp + 8];
  const float l2_a = row_a < T ? lse[row_off + row_a] * kLog2e : 0.f;
  const float l2_b = row_b < T ? lse[row_off + row_b] * kLog2e : 0.f;
  const __nv_bfloat16* qw = Qs + (warp * 16) * kStride;
  const __nv_bfloat16* dow = dOs + (warp * 16) * kStride;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt (and Q, dO) landed: this thread's copies
    __syncthreads();               // ... everyone's; the slot of tile kt - 1 is free
    const int nxt = kt + kStages - 1;
    if (nxt < n_tiles) {
      load_tile<D>(Ks + (nxt % kStages) * kTile, kb, kv_row_stride, nxt * kBlock, S, tid);
      load_tile<D>(Vs + (nxt % kStages) * kTile, vb, kv_row_stride, nxt * kBlock, S, tid);
    }
    cp_async_commit();
    if (!active) continue;
    const __nv_bfloat16* ks = Ks + (kt % kStages) * kTile;
    const __nv_bfloat16* vs = Vs + (kt % kStages) * kTile;
#pragma unroll 1
    for (int hf = 0; hf < kBlock / kHalf; ++hf) {
      const int c0 = kt * kBlock + hf * kHalf;  // the first kv column of this half
      // warp-uniform: skip columns that all lie past S or past every row's limit
      if (c0 >= S || (causal && c0 > row_lo + 15)) continue;
      float p[4][4];
      mul_abt<D>(p, qw, ks + hf * kHalf * kStride, kStride, lane);  // S = Q K^T
      const bool edge = c0 + kHalf > S || (causal && c0 + kHalf - 1 > row_lo);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + j * 8 + tig * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (edge && (col >= S || (causal && col > row))) p[j][e] = kNegInf;
          p[j][e] = fast_exp2(fmaf(p[j][e], scale_log2, -(e < 2 ? l2_a : l2_b)));
        }
      }
      float ds[4][4];
      mul_abt<D>(ds, dow, vs + hf * kHalf * kStride, kStride, lane);  // dP = dO V^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ds[j][0] = p[j][0] * (ds[j][0] - d_a);
        ds[j][1] = p[j][1] * (ds[j][1] - d_a);
        ds[j][2] = p[j][2] * (ds[j][2] - d_b);
        ds[j][3] = p[j][3] * (ds[j][3] - d_b);
      }
      mul_pm<D>(acc, ds, ks + hf * kHalf * kStride, kStride, lane);  // dQ += dS K
    }
  }
  cp_async_wait<0>();  // no copy is left in flight
  if (!active) return;
  __nv_bfloat16* dqb = dq + q_off;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (row_a < T)
      *reinterpret_cast<uint32_t*>(dqb + (int64_t)row_a * q_row_stride + col) =
          pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    if (row_b < T)
      *reinterpret_cast<uint32_t*>(dqb + (int64_t)row_b * q_row_stride + col) =
          pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// ---------------------------------------------------------------- dk, dv

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int T, int S, int H,
                      int KV, int causal, float scale_log2, float scale) {
  constexpr int kStride = D + kPad;
  constexpr int kTile = kBlock * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][kStride]
  __nv_bfloat16* Vs = Ks + kTile;                                   // [64][kStride]
  __nv_bfloat16* Qs = Vs + kTile;                                   // [kStages][64][kStride]
  __nv_bfloat16* dOs = Qs + kStages * kTile;                        // [kStages][64][kStride]
  float* Ls = reinterpret_cast<float*>(dOs + kStages * kTile);      // [kStages][64]: lse
  float* Dl = Ls + kStages * kBlock;                                // [kStages][64]: D

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;

  const int k0 = blockIdx.y * kBlock;  // the first tiles see the most query tiles: issued first
  const int bkv = blockIdx.x;
  const int b = bkv / KV;
  const int kvh = bkv - b * KV;
  const int G = H / KV;
  const int64_t q_row_stride = (int64_t)H * D;
  const int64_t kv_row_stride = (int64_t)KV * D;
  const int64_t kv_off = ((int64_t)b * S) * kv_row_stride + (int64_t)kvh * D;

  const int nq = (T + kBlock - 1) / kBlock;
  const int qt0 = causal ? k0 / kBlock : 0;  // causal: rows before k0 see none of this tile
  const int per_head = max(0, nq - qt0);
  const int n_iter = G * per_head;

  // (query head, query tile) of iteration `it` into ring slot `slot`: the Q
  // and dO tiles, and the rows' lse and D (rows at or past T zero-filled)
  auto load_q = [&](int slot, int it) {
    const int h = kvh * G + it / per_head;
    const int qt = qt0 + it % per_head;
    const int64_t q_off = ((int64_t)b * T) * q_row_stride + (int64_t)h * D;
    load_tile<D>(Qs + slot * kTile, q + q_off, q_row_stride, qt * kBlock, T, tid);
    load_tile<D>(dOs + slot * kTile, dout + q_off, q_row_stride, qt * kBlock, T, tid);
    const int r = tid & (kBlock - 1);
    const bool ok = qt * kBlock + r < T;
    const int64_t at = ((int64_t)b * H + h) * T + (ok ? qt * kBlock + r : 0);
    if (tid < kBlock) cp_async_4(Ls + slot * kBlock + r, lse + at, ok);
    else cp_async_4(Dl + slot * kBlock + r, dsum + at, ok);
  };

  // ---- prologue: the block's K and V tiles join the first group ----
  load_tile<D>(Ks, k + kv_off, kv_row_stride, k0, S, tid);
  load_tile<D>(Vs, v + kv_off, kv_row_stride, k0, S, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load_q(s, s);
    cp_async_commit();
  }

  const int j_lo = k0 + warp * 16;  // this warp's first kv row
  const int row_a = j_lo + grp;     // this thread's two kv rows
  const int row_b = row_a + 8;
  const __nv_bfloat16* kw = Ks + (warp * 16) * kStride;
  const __nv_bfloat16* vw = Vs + (warp * 16) * kStride;
  const bool active = j_lo < S;  // warp-uniform

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();  // iteration it's tiles (and K, V) landed
    __syncthreads();               // ... everyone's; the slot of it - 1 is free
    const int nxt = it + kStages - 1;
    if (nxt < n_iter) load_q(nxt % kStages, nxt);
    cp_async_commit();
    if (!active) continue;
    const int slot = it % kStages;
    const int qt = qt0 + it % per_head;
    const __nv_bfloat16* qs = Qs + slot * kTile;
    const __nv_bfloat16* dos = dOs + slot * kTile;
    const float* ls = Ls + slot * kBlock;
    const float* dl = Dl + slot * kBlock;
#pragma unroll 1
    for (int hf = 0; hf < kBlock / kHalf; ++hf) {
      const int i0 = qt * kBlock + hf * kHalf;  // the first query row of this half
      // warp-uniform: skip query rows that all lie past T or before every kv row
      if (i0 >= T || (causal && i0 + kHalf - 1 < j_lo)) continue;
      float p[4][4];
      mul_abt<D>(p, kw, qs + hf * kHalf * kStride, kStride, lane);  // S^T = K Q^T
      const bool edge = i0 + kHalf > T || (causal && i0 < j_lo + 15);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = hf * kHalf + j * 8 + tig * 2 + (e & 1);  // query row within the tile
          const int i = qt * kBlock + c;
          const int row = e < 2 ? row_a : row_b;
          if (edge && (i >= T || (causal && i < row))) p[j][e] = kNegInf;
          p[j][e] = fast_exp2(fmaf(p[j][e], scale_log2, -ls[c] * kLog2e));
        }
      }
      mul_pm<D>(acc_v, p, dos + hf * kHalf * kStride, kStride, lane);  // dV += P^T dO
      float ds[4][4];
      mul_abt<D>(ds, vw, dos + hf * kHalf * kStride, kStride, lane);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = hf * kHalf + j * 8 + tig * 2 + (e & 1);
          ds[j][e] = p[j][e] * (ds[j][e] - dl[c]);
        }
      }
      mul_pm<D>(acc_k, ds, qs + hf * kHalf * kStride, kStride, lane);  // dK += dS^T Q
    }
  }
  cp_async_wait<0>();  // no copy is left in flight
  if (!active) return;
  __nv_bfloat16* dkb = dk + kv_off;
  __nv_bfloat16* dvb = dv + kv_off;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (row_a < S) {
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)row_a * kv_row_stride + col) =
          pack_bf16(acc_k[n][0] * scale, acc_k[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)row_a * kv_row_stride + col) =
          pack_bf16(acc_v[n][0], acc_v[n][1]);
    }
    if (row_b < S) {
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)row_b * kv_row_stride + col) =
          pack_bf16(acc_k[n][2] * scale, acc_k[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)row_b * kv_row_stride + col) =
          pack_bf16(acc_v[n][2], acc_v[n][3]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                      const void* lse, void* dq, void* dsum, int B, int T, int S, int H, int KV, int causal,
                      cudaStream_t stream) {
  static std::atomic<uint32_t> smem_set{0u};
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = allow_smem_once(flash_bwd_dq_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)D);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);  // as the forward's sweep
  const dim3 grid(B * H, (T + kBlock - 1) / kBlock);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(dsum), T, S, H, KV, causal, scale_log2, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                        const void* dsum, void* dk, void* dv, int B, int T, int S, int H, int KV, int causal,
                        cudaStream_t stream) {
  static std::atomic<uint32_t> smem_set{0u};
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = allow_smem_once(flash_bwd_dkdv_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)D);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  const dim3 grid(B * KV, (S + kBlock - 1) / kBlock);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, S, H, KV, causal, scale_log2, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int S, int H, int KV) {
  return B <= 0 || T <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || (T + kBlock - 1) / kBlock > 65535 ||
         (S + kBlock - 1) / kBlock > 65535;
}

}  // namespace flash_bwd
}  // namespace

extern "C" {

// First half of K3's gradient. q, o, dout, dq: (B, T, H, D); k, v: (B, S, KV,
// D); all bf16, contiguous, 16-byte aligned; lse: (B, H, T) fp32 from the
// forward; dsum: (B, H, T) fp32, written (D = rowsum(dO * o)) for
// repro_flash_attention_bwd_dkdv. Returns a cudaError_t (0 on a successful launch).
int repro_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                 const void* lse, void* dq, void* dsum, int B, int T, int S, int H, int KV,
                                 int D, int causal, void* stream) {
  if (flash_bwd::bad_shape(B, T, S, H, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)flash_bwd::launch_dq<64>(q, k, v, o, dout, lse, dq, dsum, B, T, S, H, KV, causal, st);
    case 112:
      return (int)flash_bwd::launch_dq<112>(q, k, v, o, dout, lse, dq, dsum, B, T, S, H, KV, causal, st);
    case 128:
      return (int)flash_bwd::launch_dq<128>(q, k, v, o, dout, lse, dq, dsum, B, T, S, H, KV, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Second half: dk, dv (B, S, KV, D) bf16 from the same inputs and the dsum
// that repro_flash_attention_bwd_dq wrote. Returns a cudaError_t.
int repro_flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* dsum, void* dk, void* dv, int B, int T, int S,
                                   int H, int KV, int D, int causal, void* stream) {
  if (flash_bwd::bad_shape(B, T, S, H, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)flash_bwd::launch_dkdv<64>(q, k, v, dout, lse, dsum, dk, dv, B, T, S, H, KV, causal, st);
    case 112:
      return (int)flash_bwd::launch_dkdv<112>(q, k, v, dout, lse, dsum, dk, dv, B, T, S, H, KV, causal, st);
    case 128:
      return (int)flash_bwd::launch_dkdv<128>(q, k, v, dout, lse, dsum, dk, dv, B, T, S, H, KV, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
