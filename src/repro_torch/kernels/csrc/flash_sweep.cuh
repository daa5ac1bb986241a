// GQA flash attention of a 64-row query tile over a K/V cache, forward only,
// shared by K3 (flash_attention.cu, a contiguous cache) and K2
// (paged_attention.cu, a paged arena read through a block table). The two
// differ only in where logical row j of sequence b lives (a row-address
// policy of row_policy.cuh) and in the queries' absolute offset: K3's query
// row i is position i, K2's is start[b] + i.
//
// The design (K3's, now for both):
//   * grid (B*H, ceil(T/64)), 256 threads = two warpgroups of 4 warps; warp w
//     of each warpgroup owns query rows [16w, 16w + 16) of the block's 64; the
//     query tile index is blockIdx.y reversed, so the heaviest causal tiles of
//     every head are issued first and the light ones fill in behind them;
//   * the kv sweep is a loop inside the block over a 2-stage ring of 64-row K
//     and V tiles in shared memory, filled by cp.async 16-byte copies, each
//     from its own row's address (rows past the cache's capacity are
//     zero-filled): tile k+1 is in flight while tile k is computed, with one
//     cp.async.wait_group and one __syncthreads per tile;
//   * the two warpgroups split every tile's 64 kv columns, 32 each, and keep
//     separate online-softmax states (m, l, acc) for the same query rows; at
//     the end warpgroup 1 leaves its state in the idle ring and warpgroup 0
//     merges it (rescale by exp(m_i - m), add, divide by l) and writes the
//     output;
//   * the Q tile comes in with the first K/V tile and is then held in
//     registers as mma.sync A fragments for the whole sweep; K's B fragments
//     are ldmatrix loads, V's are ldmatrix.trans loads straight from V's
//     natural row layout (no transposed copy of V);
//   * QK^T and PV run on the tensor cores as mma.sync m16n8k16 bf16 -> fp32;
//     the online-softmax state stays in fp32 registers with the reference's
//     -1e30 sentinel, in raw score units: the scale is folded with log2(e)
//     into one FMA before ex2.approx; P is rounded to bf16 before PV;
//     causal blocks stop at the tile holding their last row's limit, a warp
//     skips a tile whose 32 columns all lie past the capacity or its rows'
//     limits, and only warp tiles that cross either are masked;
//   * every ragged edge is handled here (any T, any capacity, any offset):
//     out-of-range K/V rows are zero-filled and their probabilities are
//     exactly 0, a warp whose 16 rows all lie past T skips the math, and a
//     row with no valid column divides by l = 1 and writes exact zeros;
//   * every sum is taken in one fixed order, so equal inputs give equal bits;
//   * with a non-null `lse` (K3 under autograd), warpgroup 0 also writes each
//     row's natural-log logsumexp of the scaled scores, (B, H, T) fp32, for
//     the backward (csrc/flash_attention_bwd.cu) to recompute P from; a row
//     with no valid column writes +inf, so its P recomputes to exact zeros.
//     The output's arithmetic is the same with or without it;
//   * with a non-null `o32` (K3 under autograd), the output is also written
//     in fp32 before its rounding to bf16, (B, T, H, D): the backward's
//     D = rowsum(dO * O) is taken from it. From the bf16 output, D carries
//     that rounding (2^-9 of |O|), and where the rows of V share a large
//     common component, dP - D cancels and the rounding moves dq and dk by
//     tens of percent of their max (measured on the enc-dec's
//     cross-attention, whose V reads the encoder's un-normalized states).
// Shared-memory rows are padded by 8 bf16 so ldmatrix and fragment loads are
// bank-conflict free.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "async_copy.cuh"  // cp.async ring helpers, allow_smem_once
#include "mma_bf16.cuh"    // ldmatrix, mma.sync m16n8k16, ex2
#include "row_policy.cuh"  // Contiguous, Paged

namespace {
namespace flash_sweep {

constexpr int kBlockQ = 64;   // query rows per block (16 per warp)
constexpr int kBlockK = 64;   // kv rows per tile
constexpr int kWarps = 4;             // per warpgroup: 16 query rows each
constexpr int kThreads = 2 * kWarps * 32;  // two warpgroups split each kv tile's columns
constexpr int kPad = 8;       // bf16 padding per shared-memory row
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kStages = 2;    // K/V ring depth: tile k + 1 loads while tile k is computed

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kBlockQ + 2 * kStages * kBlockK) * (D + kPad);
}

// One block's query tile. q, out: (B, T, H, D); k, v: (rows, KV, D) read
// through `rows` (capacity S = rows.capacity() per sequence); `lse`: (B, H,
// T) or null; `o32`: (B, T, H, D) fp32 or null; `start`: (B,) absolute
// position of query row 0 (null: 0); causal row i attends the columns <=
// start + i.
template <int D, class Rows>
__device__ __forceinline__ void sweep(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                                      float* __restrict__ lse, float* __restrict__ o32,
                                      const int* __restrict__ start, int T, int H, int KV, int causal,
                                      float scale_log2, const Rows& rows) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + kPad;          // row stride of every tile (bf16)
  constexpr int kTile = kBlockK * kStride;   // bf16 per K or V stage
  constexpr int kChunks = D / 8;             // 16-byte chunks per head row
  constexpr int kCols = kBlockK / 2;         // kv columns of a tile per warpgroup
  constexpr int kLoads = (kBlockK * kChunks + kThreads - 1) / kThreads;  // chunks per thread per tile
  static_assert(kWarps * 32 * (4 + D / 2) * sizeof(float) <= 2 * kStages * kTile * sizeof(__nv_bfloat16),
                "the ring must hold warpgroup 1's partial state for the combine");
  static_assert(kBlockQ == kBlockK, "the Q tile is loaded with the K/V tiles' chunk count");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBlockQ][kStride]
  __nv_bfloat16* Ks = Qs + kBlockQ * kStride;                       // [kStages][kBlockK][kStride]
  __nv_bfloat16* Vs = Ks + kStages * kTile;                         // [kStages][kBlockK][kStride]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;   // warpgroup: kv columns [wg * 32, wg * 32 + 32) of each tile
  const int wq = warp & 3;    // query rows [wq * 16, wq * 16 + 16) of the block's 64
  const int grp = lane >> 2;  // row within the 8-row half of a fragment
  const int tig = lane & 3;   // thread in group: column pair
  const int mat = lane >> 3;  // ldmatrix: the 8x8 matrix this lane addresses
  const int mrow = lane & 7;  // ... and its row within it

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest causal tiles first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);  // GQA: query head h reads kv head h // G
  const int S = rows.capacity();
  const int off = start == nullptr ? 0 : start[b];  // absolute position of query row 0

  const int64_t q_row_stride = (int64_t)H * D;   // elements between tokens
  const int64_t kv_row_stride = (int64_t)KV * D;
  const __nv_bfloat16* qb = q + ((int64_t)b * T) * q_row_stride + (int64_t)h * D;
  const __nv_bfloat16* kb = k + (int64_t)kvh * D;
  const __nv_bfloat16* vb = v + (int64_t)kvh * D;
  __nv_bfloat16* ob = out + ((int64_t)b * T) * q_row_stride + (int64_t)h * D;
  float* o32b = o32 == nullptr ? nullptr : o32 + ((int64_t)b * T) * q_row_stride + (int64_t)h * D;

  int n_tiles = (S + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last = off + min(q0 + kBlockQ, T) - 1;  // the block's last column limit
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBlockK + 1);
  }

  // K / V tile kt into ring slot `slot` (rows past the capacity zero-filled).
  auto load_kv = [&](int slot, int kt) {
    const int k0 = kt * kBlockK;
    __nv_bfloat16* ks = Ks + slot * kTile;
    __nv_bfloat16* vs = Vs + slot * kTile;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = tid + i * kThreads;
      if (c < kBlockK * kChunks) {
        const int r = c / kChunks;
        const int col = (c - r * kChunks) * 8;
        const bool ok = k0 + r < S;
        const int64_t o = ok ? rows.row(b, k0 + r) * kv_row_stride + col : 0;
        cp_async_16(ks + r * kStride + col, kb + o, ok);
        cp_async_16(vs + r * kStride + col, vb + o, ok);
      }
    }
  };

  // ---- prologue: Q joins the first group, with the first K/V tile ----
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = tid + i * kThreads;
    if (c < kBlockQ * kChunks) {
      const int r = c / kChunks;
      const int col = (c - r * kChunks) * 8;
      const bool ok = q0 + r < T;
      cp_async_16(Qs + r * kStride + col, qb + (ok ? (int64_t)(q0 + r) * q_row_stride + col : 0), ok);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_kv(s, s);
    cp_async_commit();  // an empty group keeps the count uniform
  }

  const int row_lo = q0 + wq * 16;         // this warp's first query row
  const bool active = row_lo < T;          // warp-uniform: some of its rows exist
  const int lim_lo = off + row_lo;         // its first row's causal limit
  const int row_a = row_lo + grp;          // this thread's two query rows
  const int row_b = row_a + 8;
  uint32_t qf[D / 16][4];
  // online-softmax state in raw score units (the scale is folded into exp2)
  float m_a = kNegInf, m_b = kNegInf;  // running row max
  float l_a = 0.f, l_b = 0.f;          // running row sum (this thread's columns)
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt (and Q) landed: this thread's copies
    __syncthreads();               // ... everyone's; the slot of tile kt - 1 is free
    const int nxt = kt + kStages - 1;
    if (nxt < n_tiles) load_kv(nxt % kStages, nxt);
    cp_async_commit();

    if (kt == 0) {  // Q tile -> A fragments in registers, held for the sweep
      const __nv_bfloat16* base = Qs + (wq * 16) * kStride;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qf[kk][0] = ld_u32(base + grp * kStride + kk * 16 + tig * 2);
        qf[kk][1] = ld_u32(base + (grp + 8) * kStride + kk * 16 + tig * 2);
        qf[kk][2] = ld_u32(base + grp * kStride + kk * 16 + tig * 2 + 8);
        qf[kk][3] = ld_u32(base + (grp + 8) * kStride + kk * 16 + tig * 2 + 8);
      }
    }
    const int c0 = kt * kBlockK + wg * kCols;  // this warp's first kv column
    // warp-uniform: skip a warp tile whose columns all lie past S or its rows' limits
    if (!active || c0 >= S || (causal && c0 > lim_lo + 15)) continue;

    const __nv_bfloat16* ks = Ks + (kt % kStages) * kTile + (wg * kCols) * kStride;
    const __nv_bfloat16* vs = Vs + (kt % kStages) * kTile + (wg * kCols) * kStride;

    // ---- S = Q K^T for this warp's 16 rows x 32 columns ----
    float s[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kCols / 8; j += 2) {
        // matrices: (kv rows j, dims 0-7), (j, 8-15), (j + 1, 0-7), (j + 1, 8-15)
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + ((j + (mat >> 1)) * 8 + mrow) * kStride + kk * 16 + (mat & 1) * 8);
        mma_16816(s[j], qf[kk], bf[0], bf[1]);
        mma_16816(s[j + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // ---- mask (only warp tiles that cross S or a row's limit), row max ----
    if (c0 + kCols > S || (causal && c0 + kCols - 1 > lim_lo)) {
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + j * 8 + tig * 2 + (e & 1);
          const int lim = off + (e < 2 ? row_a : row_b);
          if (col >= S || (causal && col > lim)) s[j][e] = kNegInf;
        }
      }
    }
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    // the four threads of a quad share a row
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = fast_exp2((m_a - mn_a) * scale_log2);
    const float alpha_b = fast_exp2((m_b - mn_b) * scale_log2);
    m_a = mn_a;
    m_b = mn_b;
    // a row with no valid column yet keeps m = -1e30: subtract 0 there, so
    // its masked entries still give exactly 0
    const float off_a = (mn_a == kNegInf ? 0.f : mn_a) * scale_log2;
    const float off_b = (mn_b == kNegInf ? 0.f : mn_b) * scale_log2;

    // ---- P = exp2(S * scale * log2(e) - m * scale * log2(e)); masked -> 0 ----
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      s[j][0] = fast_exp2(fmaf(s[j][0], scale_log2, -off_a));
      s[j][1] = fast_exp2(fmaf(s[j][1], scale_log2, -off_a));
      s[j][2] = fast_exp2(fmaf(s[j][2], scale_log2, -off_b));
      s[j][3] = fast_exp2(fmaf(s[j][3], scale_log2, -off_b));
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * alpha_a + sum_a;  // quad-reduced once, after the sweep
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }

    // ---- O += P V: the S accumulators become the A fragments of P ----
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        // matrices: (kv rows 0-7, dims n), (8-15, n), (0-7, n + 1), (8-15, n + 1)
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + (kk * 16 + (mat & 1) * 8 + mrow) * kStride + (n + (mat >> 1)) * 8);
        mma_16816(o[n], pf, bf[0], bf[1]);
        mma_16816(o[n + 1], pf, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy is left in flight
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);

  // ---- combine the two warpgroups' states through the (now idle) ring ----
  // thread (wq, lane) of warpgroup 1 holds the same rows and output columns
  // as thread (wq, lane) of warpgroup 0; word i of its state lands at
  // xs[i][wq * 32 + lane], so each warp's stores and loads are contiguous
  __syncthreads();  // every warp is done with the ring
  float* xs = reinterpret_cast<float*>(Ks);
  const int slot = wq * 32 + lane;
  constexpr int kSlots = kWarps * 32;
  if (wg == 1) {
    xs[0 * kSlots + slot] = m_a;
    xs[1 * kSlots + slot] = m_b;
    xs[2 * kSlots + slot] = l_a;
    xs[3 * kSlots + slot] = l_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 + 4 * n + e) * kSlots + slot] = o[n][e];
    }
  }
  __syncthreads();
  if (wg == 1 || !active) return;
  const float m1_a = xs[0 * kSlots + slot], m1_b = xs[1 * kSlots + slot];
  const float mn_a = fmaxf(m_a, m1_a), mn_b = fmaxf(m_b, m1_b);
  const float w0_a = fast_exp2((m_a - mn_a) * scale_log2), w1_a = fast_exp2((m1_a - mn_a) * scale_log2);
  const float w0_b = fast_exp2((m_b - mn_b) * scale_log2), w1_b = fast_exp2((m1_b - mn_b) * scale_log2);
  l_a = w0_a * l_a + w1_a * xs[2 * kSlots + slot];
  l_b = w0_b * l_b + w1_b * xs[3 * kSlots + slot];

  // ---- the rows' logsumexp for the backward (l == 0 -> +inf) ----
  if (lse != nullptr && tig == 0) {
    float* lb = lse + ((int64_t)b * H + h) * T;
    const float inf = __int_as_float(0x7f800000);
    if (row_a < T) lb[row_a] = l_a == 0.f ? inf : (mn_a * scale_log2 + log2f(l_a)) * kLn2;
    if (row_b < T) lb[row_b] = l_b == 0.f ? inf : (mn_b * scale_log2 + log2f(l_b)) * kLn2;
  }

  // ---- finalize: divide by l (l == 0 -> 1: a fully masked row writes 0) ----
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
    const float* x1 = xs + (4 + 4 * n) * kSlots + slot;
    const float a0 = (w0_a * o[n][0] + w1_a * x1[0]) * inv_a, a1 = (w0_a * o[n][1] + w1_a * x1[kSlots]) * inv_a;
    const float b0 = (w0_b * o[n][2] + w1_b * x1[2 * kSlots]) * inv_b;
    const float b1 = (w0_b * o[n][3] + w1_b * x1[3 * kSlots]) * inv_b;
    if (row_a < T) {
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_a * q_row_stride + col) = pack_bf16(a0, a1);
      if (o32b != nullptr) *reinterpret_cast<float2*>(o32b + (int64_t)row_a * q_row_stride + col) = make_float2(a0, a1);
    }
    if (row_b < T) {
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_b * q_row_stride + col) = pack_bf16(b0, b1);
      if (o32b != nullptr) *reinterpret_cast<float2*>(o32b + (int64_t)row_b * q_row_stride + col) = make_float2(b0, b1);
    }
  }
}

// Launch `kernel` (a __global__ wrapper of sweep<D, Rows>) over B sequences
// of T query rows and H heads. Returns a cudaError_t.
template <int D, class Rows, class Kernel>
cudaError_t launch(Kernel kernel, std::atomic<uint32_t>& smem_set, const void* q, const void* k, const void* v,
                   void* out, void* lse, void* o32, const void* start, int B, int T, int H, int KV, int causal,
                   const Rows& rows, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T + kBlockQ - 1) / kBlockQ);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);  // log2(e) / sqrt(D)
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      static_cast<float*>(o32), static_cast<const int*>(start), T,
      H, KV, causal, scale_log2, rows);
  return cudaGetLastError();
}

}  // namespace flash_sweep
}  // namespace
