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
//   D_i  = sum_d dO_id * o_id                       (fp32, one per row; o the
//                                                    forward's fp32 output,
//                                                    not its bf16 rounding)
//   dV_j = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dQ_i = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i
// GQA: kv head g serves query heads [g * H/KV, (g + 1) * H/KV); its dK and dV
// sum over all of them. Causal row i sees the columns j <= i.
//
// Three kernels, launched in this order on one stream:
//   * prep: D for every row, and lse * log2(e), into arrays padded to whole
//     query tiles (a padded row gets D = 0 and lse = +inf, so its P is 0 and
//     no later step masks rows past T); it also zeroes the sweep's dQ
//     counters.
//   * the sweep, one pass with five products per (query tile, kv tile) pair:
//     one block per (b, kv head, split of the group's query heads, 128-row
//     kv tile). Warpgroup 0 is the producer: one warp issues TMA loads (the
//     block's K and V tiles once; then per step a query tile of Q and dO
//     and its lse and D through a 2-stage ring of mbarriers), one warp writes
//     dQ. Warpgroups 1 and 2 (registers raised by setmaxnreg) own 64 kv rows
//     each and, per step, compute on wgmma
//        S^T = K Q^T, dP^T = V dO^T             (both operands in shared memory)
//        P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - D)
//        dV += P^T dO, dK += dS^T Q             (P^T, dS^T from registers)
//     then store dS^T (bf16) to shared memory and, after a named barrier
//     over both warpgroups, compute this query tile's dQ contribution
//        dQ_tile = dS K                         (over the block's 128 kv rows)
//     each warpgroup one 64 x 64 half, into a shared fp32 buffer (in the
//     accumulators' fragment order, which post undoes). The
//     writer warp adds it to an fp32 dQ accumulator in global memory with
//     one bulk copy: a per-query-tile counter admits the kv tiles in index
//     order (tile 0 stores, tile j waits until j tiles have added), so the
//     sum runs in one fixed order and two launches give equal bits. The
//     blocks visit their query tiles from the last down, so a kv tile never
//     waits on one that has more left to do.
//   * post: dQ = scale * accumulator, cast to bf16; with a head split also
//     dK and dV as the sum of the splits' fp32 partials in split order.
// No atomic adds data; every sum has one order.
//
// Head split: when B * KV * ceil(S / 128) blocks cannot fill the card, the
// group's query heads are split over blocks (the count is chosen by the
// wrapper, kernels/flash_attention.py: grad_splits); each split writes fp32
// partial dK and dV to a workspace that post sums. Causal balance: the kv
// tile is the slowest index of the grid, so the blocks of tile 0 (which sees
// every query tile) start first and the short ones fill the tail.
//
// Tiles: 128 kv rows a block; 128 query rows a step at head dim 64 and 64 at
// 112 and 128 (112 runs as 128, the last 16 columns zero-filled by TMA), so
// each warpgroup's accumulators (dK, dV, S^T, dP^T) fit 240 registers. Every
// operand tile is 128-byte swizzled as TMA writes it (csrc/wgmma_tma.cuh).
// P and dS are rounded to bf16 before the products that take them, as the
// forward rounds P.
//
// What bounds it on this card: at the train shape (B = 2, T = S = 4096, 32/8
// heads of 64, causal) the five T x S x D products are ~344 GFLOP, ~0.35 ms
// at the 989 TFLOP/s bf16 peak, against ~0.03 ms for its 118 MB of inputs
// and outputs: the operations bound it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "async_copy.cuh"  // allow_smem_once
#include "mma_bf16.cuh"    // pack_bf16, fast_exp2
#include "wgmma_tma.cuh"   // mbarriers, TMA, bulk copies, wgmma

namespace {
namespace flash_bwd {

constexpr int kN = 128;               // kv rows of a block: 64 per consumer warpgroup
constexpr int kStages = 2;            // ring of query tiles: one computed while the next loads
constexpr int kThreads = 384;         // warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumers = 256;
constexpr int kDqTile = 2 * 64 * 64;  // fp32 of one step's dQ: a 64 x 64 tile per consumer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;    // 128 * 24 + 256 * 240 <= 65536
constexpr int kPrepRows = 32;         // rows of a prep block, 8 threads a row
constexpr float kLog2e = 1.4426950408889634f;

// The query rows of a step at head dim D (kernels/flash_attention.py:
// GRAD_QUERY_ROWS says the same).
template <int D>
__host__ __device__ constexpr int query_rows() {
  return D <= 64 ? 128 : 64;
}

template <int D>
struct Cfg {
  static constexpr int kDp = D <= 64 ? 64 : 128;  // head dim in whole 64-column tiles
  static constexpr int kChunks = kDp / 64;
  static constexpr int kM = query_rows<D>();
  static constexpr int kKBytes = kN * kDp * 2;  // a K or V tile: kChunks tiles of kN x 64
  static constexpr int kQBytes = kM * kDp * 2;  // a Q or dO tile: kChunks tiles of kM x 64
  static constexpr int kSBytes = kN * kM * 2;   // dS^T: kM / 64 tiles of kN x 64
  // byte offsets from the 1024-aligned base of shared memory
  static constexpr int kOffK = 0;
  static constexpr int kOffV = kKBytes;
  static constexpr int kOffQ = 2 * kKBytes;
  static constexpr int kOffDO = kOffQ + kStages * kQBytes;
  static constexpr int kOffS = kOffDO + kStages * kQBytes;  // two buffers, by step parity
  static constexpr int kOffDQ = kOffS + 2 * kSBytes;
  static constexpr int kOffL = kOffDQ + kDqTile * 4;  // [kStages][kM] lse * log2 e
  static constexpr int kOffD = kOffL + kStages * kM * 4;  // [kStages][kM] D
  static constexpr int kOffBar = kOffD + kStages * kM * 4;
  static constexpr int kBars = 2 * kStages + 3;  // full, empty, kv_full, dq_full, dq_empty
  static constexpr size_t kSmem = 1024 + kOffBar + 8 * kBars;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// ---------------------------------------------------------------- prep

template <int D>
__global__ void __launch_bounds__(kPrepRows * 8)
flash_bwd_prep_kernel(const float* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ dsum, float* __restrict__ lse2,
                      int* __restrict__ sem, int T, int H, int Tp) {
  const int row = blockIdx.x * kPrepRows + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  float acc = 0.f;
  if (row < T) {
    const int64_t at = (((int64_t)b * T + row) * H + h) * D;
    for (int c = part; c < D / 8; c += 8) {  // each thread its 8-column chunks, in order
      const float4 oa = *reinterpret_cast<const float4*>(o + at + c * 8);
      const float4 ob = *reinterpret_cast<const float4*>(o + at + c * 8 + 4);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + at + c * 8);
      const float o8[8] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y, ob.z, ob.w};
      const uint32_t* d2 = reinterpret_cast<const uint32_t*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc = fmaf(o8[2 * e], bf16_lo(d2[e]), acc);
        acc = fmaf(o8[2 * e + 1], bf16_hi(d2[e]), acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);  // the row's 8 threads, one fixed tree
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (part == 0 && row < Tp) {
    const int64_t out = (int64_t)bh * Tp + row;
    dsum[out] = row < T ? acc : 0.f;
    lse2[out] = row < T ? lse[(int64_t)bh * T + row] * kLog2e : INFINITY;
    if (row % query_rows<D>() == 0) sem[out / query_rows<D>()] = 0;  // the tile's dQ counter, for the sweep
  }
}

// ---------------------------------------------------------------- sweep

struct Sweep {
  const float* lse2;
  const float* dsum;
  float* dq_acc;
  int* sem;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* ws;
  int B, T, S, H, KV, causal, n_split;
  float scale_log2, scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
                 const Sweep p) {
  using C = Cfg<D>;
  constexpr int kM = C::kM;
  constexpr int kDp = C::kDp;

  const int nq = (p.T + kM - 1) / kM;
  const int G = p.H / p.KV;
  const int hps = (G + p.n_split - 1) / p.n_split;
  int r = blockIdx.x;
  const int b = r % p.B;
  r /= p.B;
  const int kvh = r % p.KV;
  r /= p.KV;
  const int split = r % p.n_split;
  const int j = r / p.n_split;  // the kv tile: the slowest index
  const int h_lo = kvh * G + split * hps;
  const int n_heads = max(0, min(hps, G - split * hps));
  const int qt_first = p.causal ? j * kN / kM : 0;  // causal: rows before j * kN see none of the tile
  const int n_iter = n_heads * max(0, nq - qt_first);
  // step `it`: query tile nq - 1 - it / n_heads (the last first), head h_lo + it % n_heads

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  uint64_t* dq_full = kv_full + 1;
  uint64_t* dq_empty = dq_full + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kv_full, 1);
    mbar_init(dq_full, kConsumers);
    mbar_init(dq_empty, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------ producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_iter > 0) {  // TMA loads
      mbar_expect_tx(kv_full, 2 * C::kKBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(base + C::kOffK + c * kN * 128, &kmap, kv_full, c * 64, kvh, j * kN, b);
        tma_load_4d(base + C::kOffV + c * kN * 128, &vmap, kv_full, c * 64, kvh, j * kN, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int stage = it % kStages;
        mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        const int qt = nq - 1 - it / n_heads;
        const int h = h_lo + it % n_heads;
        mbar_expect_tx(&full[stage], 2 * C::kQBytes + 2 * kM * 4);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_4d(base + C::kOffQ + stage * C::kQBytes + c * kM * 128, &qmap, &full[stage], c * 64, h,
                      qt * kM, b);
          tma_load_4d(base + C::kOffDO + stage * C::kQBytes + c * kM * 128, &dmap, &full[stage], c * 64, h,
                      qt * kM, b);
        }
        const int64_t rows = (((int64_t)b * p.H + h) * nq + qt) * kM;
        bulk_load(base + C::kOffL + stage * kM * 4, p.lse2 + rows, kM * 4, &full[stage]);
        bulk_load(base + C::kOffD + stage * kM * 4, p.dsum + rows, kM * 4, &full[stage]);
      }
    } else if (threadIdx.x == 32 && n_iter > 0) {  // the dQ writer
      for (int it = 0; it < n_iter; ++it) {
        const int qt = nq - 1 - it / n_heads;
        const int h = h_lo + it % n_heads;
        const int64_t tile = ((int64_t)b * p.H + h) * nq + qt;
        int* sem = p.sem + tile;
        if (j > 0) {  // kv tiles 0 .. j - 1 have added theirs
          int seen = -1;
          while (seen < j) asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(seen) : "l"(sem) : "memory");
        }
        mbar_wait(dq_full, it & 1);
        fence_proxy_async_global();
        float* dst = p.dq_acc + tile * kDqTile;
        if (j == 0) bulk_store(dst, base + C::kOffDQ, kDqTile * 4);
        else bulk_reduce_add_f32(dst, base + C::kOffDQ, kDqTile * 4);
        bulk_commit_and_wait_all();
        mbar_arrive(dq_empty);
        asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(sem) : "memory");
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    regs_inc<kConsumerRegs>();
    const int w = wg - 1;  // this warpgroup's kv rows: j * kN + [64 w, 64 w + 64)
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int n_row = j * kN + 64 * w + (t / 32) * 16 + lane / 4;  // kv row of the fragment's upper half
    const uint32_t sK = smem_u32(base + C::kOffK);
    const uint32_t sV = smem_u32(base + C::kOffV);

    float dk_acc[kDp / 2], dv_acc[kDp / 2];
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    if (n_iter > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int stage = it % kStages;
      const int qt = nq - 1 - it / n_heads;
      const uint32_t sQ = smem_u32(base + C::kOffQ + stage * C::kQBytes);
      const uint32_t sDO = smem_u32(base + C::kOffDO + stage * C::kQBytes);
      mbar_wait(&full[stage], (it / kStages) & 1);

      // ---- S^T = K Q^T and dP^T = V dO^T (K-major operands) ----
      float s[kM / 2], dp[kM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDp / 16; ++kk) {
        const uint32_t ka = (kk / 4) * (kN * 128) + w * 64 * 128 + (kk % 4) * 32;
        const uint32_t qb = (kk / 4) * (kM * 128) + (kk % 4) * 32;
        if constexpr (kM == 128)
          wgmma_ss_n128<0, 0>(s, wgmma_desc(sK + ka, 16, 1024), wgmma_desc(sQ + qb, 16, 1024), kk > 0);
        else
          wgmma_ss_n64<0, 0>(s, wgmma_desc(sK + ka, 16, 1024), wgmma_desc(sQ + qb, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kDp / 16; ++kk) {
        const uint32_t ka = (kk / 4) * (kN * 128) + w * 64 * 128 + (kk % 4) * 32;
        const uint32_t qb = (kk / 4) * (kM * 128) + (kk % 4) * 32;
        if constexpr (kM == 128)
          wgmma_ss_n128<0, 0>(dp, wgmma_desc(sV + ka, 16, 1024), wgmma_desc(sDO + qb, 16, 1024), kk > 0);
        else
          wgmma_ss_n64<0, 0>(dp, wgmma_desc(sV + ka, 16, 1024), wgmma_desc(sDO + qb, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // ---- P^T (bf16 A fragments), masked where the query row precedes the kv row ----
      const float* ls = reinterpret_cast<const float*>(base + C::kOffL + stage * kM * 4);
      uint32_t pa[kM / 16][4];
      auto softmax = [&](auto masked) {
#pragma unroll
        for (int jj = 0; jj < kM / 8; ++jj) {
          const int col = jj * 8 + 2 * (lane % 4);  // query column within the tile
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[e] = fmaf(s[4 * jj + e], p.scale_log2, -((e & 1) ? l2.y : l2.x));
            if constexpr (decltype(masked)::value)
              if (qt * kM + col + (e & 1) < n_row + ((e >> 1) << 3)) x[e] = -INFINITY;
            x[e] = fast_exp2(x[e]);
          }
          pa[jj / 2][(jj % 2) * 2] = pack_bf16(x[0], x[1]);
          pa[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(x[2], x[3]);
        }
      };
      if (p.causal && qt * kM < j * kN + kN - 1) softmax(std::true_type{});  // the tile meets the diagonal
      else softmax(std::false_type{});

      // ---- dV += P^T dO (dO MN-major) ----
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk) {
        const uint64_t db = wgmma_desc(sDO + kk * 2048, kM * 128, 1024);
        if constexpr (kDp == 128) wgmma_rs_n128<1>(dv_acc, pa[kk], db);
        else wgmma_rs_n64<1>(dv_acc, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dp);

      // ---- dS^T = P^T (dP^T - D) (bf16 A fragments) ----
      const float* dl = reinterpret_cast<const float*>(base + C::kOffD + stage * kM * 4);
      uint32_t dsa[kM / 16][4];
#pragma unroll
      for (int jj = 0; jj < kM / 8; ++jj) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl + jj * 8 + 2 * (lane % 4));
        const uint32_t lo = pa[jj / 2][(jj % 2) * 2], hi = pa[jj / 2][(jj % 2) * 2 + 1];
        dsa[jj / 2][(jj % 2) * 2] = pack_bf16(bf16_lo(lo) * (dp[4 * jj] - d2.x), bf16_hi(lo) * (dp[4 * jj + 1] - d2.y));
        dsa[jj / 2][(jj % 2) * 2 + 1] =
            pack_bf16(bf16_lo(hi) * (dp[4 * jj + 2] - d2.x), bf16_hi(hi) * (dp[4 * jj + 3] - d2.y));
      }

      // ---- dK += dS^T Q (Q MN-major) ----
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk) {
        const uint64_t db = wgmma_desc(sQ + kk * 2048, kM * 128, 1024);
        if constexpr (kDp == 128) wgmma_rs_n128<1>(dk_acc, dsa[kk], db);
        else wgmma_rs_n64<1>(dk_acc, dsa[kk], db);
      }
      wgmma_commit();

      // ---- dS^T to shared memory: rows are kv rows, 64-column tiles of query columns ----
      unsigned char* ss = base + C::kOffS + (it & 1) * C::kSBytes;
      {
        // lane l gives row l % 8 of the fragment's 8x8 matrix l / 8 (kv rows
        // + 8 for odd matrices, query columns + 8 from matrix 2 on)
        const int n = 64 * w + (t / 32) * 16 + (lane % 8) + 8 * ((lane / 8) & 1);  // kv row within the block
        const uint32_t row_at = smem_u32(ss) + n * 128;
#pragma unroll
        for (int kk = 0; kk < kM / 16; ++kk) {
          const int m = kk * 16 + 8 * (lane / 16);  // the matrix's first query column
          stmatrix_x4(row_at + (m / 64) * (kN * 128) + ((((m % 64) / 8) ^ (n % 8)) * 16), dsa[kk][0], dsa[kk][1],
                      dsa[kk][2], dsa[kk][3]);
        }
      }
      fence_proxy_async_shared();
      named_bar_sync(1, kConsumers);  // both warpgroups' dS^T are in place

      // ---- this warpgroup's 64 x 64 of the step's dQ = dS K (both MN-major) ----
      // head dim 64: query rows [64 w, 64 w + 64), every column; else every
      // query row, head-dim columns [64 w, 64 w + 64)
      float dq[32];
      const uint32_t sa = smem_u32(ss) + (kM == 128 ? w * kN * 128 : 0);
      const uint32_t kb = sK + (kM == 128 ? 0 : w * kN * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_ss_n64<1, 1>(dq, wgmma_desc(sa + kk * 2048, kN * 128, 1024), wgmma_desc(kb + kk * 2048, kN * 128, 1024),
                           kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      mbar_arrive(&empty[stage]);  // this step's Q, dO, lse and D are read

      mbar_wait(dq_empty, (it & 1) ^ 1);  // the writer has sent the last step's dQ
      float* sdq = reinterpret_cast<float*>(base + C::kOffDQ) + w * 4096;
#pragma unroll
      for (int r4 = 0; r4 < 8; ++r4)  // fragment order: [r4][thread][4] (post undoes it)
        *reinterpret_cast<float4*>(sdq + (r4 * 128 + t) * 4) =
            make_float4(dq[4 * r4], dq[4 * r4 + 1], dq[4 * r4 + 2], dq[4 * r4 + 3]);
      fence_proxy_async_shared();
      mbar_arrive(dq_full);
    }
    fence_regs(dk_acc);
    fence_regs(dv_acc);

    // ---- dK (scaled) and dV: bf16 out, or fp32 partials of this split ----
    const int Sp = (p.S + kN - 1) / kN * kN;
    const int64_t part = (int64_t)p.n_split * p.B * p.KV * Sp * kDp;  // one of dK, dV in the workspace
#pragma unroll
    for (int jj = 0; jj < kDp / 8; ++jj) {
      const int col = jj * 8 + 2 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = n_row + 8 * half;
        const float k0 = dk_acc[4 * jj + 2 * half] * p.scale, k1 = dk_acc[4 * jj + 2 * half + 1] * p.scale;
        const float v0 = dv_acc[4 * jj + 2 * half], v1 = dv_acc[4 * jj + 2 * half + 1];
        if (p.n_split == 1) {
          if (row < p.S && col < D) {
            const int64_t at = (((int64_t)b * p.S + row) * p.KV + kvh) * D + col;
            *reinterpret_cast<uint32_t*>(p.dk + at) = pack_bf16(k0, k1);
            *reinterpret_cast<uint32_t*>(p.dv + at) = pack_bf16(v0, v1);
          }
        } else {
          const int64_t at = ((((int64_t)split * p.B + b) * p.KV + kvh) * Sp + row) * kDp + col;
          *reinterpret_cast<float2*>(p.ws + at) = make_float2(k0, k1);
          *reinterpret_cast<float2*>(p.ws + part + at) = make_float2(v0, v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- post

// Blocks [0, B * H * nq) each turn one query tile's dQ accumulator (fragment
// order) into bf16 dq rows through shared memory; with a head split the
// rest sum the splits' dK and dV partials, 4 columns a thread, in split order.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_post_kernel(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
                      const float* __restrict__ ws, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                      int B, int T, int S, int H, int KV, int n_split, float scale) {
  using C = Cfg<D>;
  constexpr int kM = C::kM;
  constexpr int kCols = kDqTile / kM;  // head-dim columns of a tile: kM x kCols
  constexpr int kStride = kCols + 4;   // padded shared rows
  __shared__ __align__(16) float tile[kM * kStride];
  const int nq = (T + kM - 1) / kM;
  const int64_t n_tiles = (int64_t)B * H * nq;
  if (blockIdx.x < n_tiles) {
    const int64_t t0 = blockIdx.x;
    const float4* src = reinterpret_cast<const float4*>(dq_acc + t0 * kDqTile);
#pragma unroll
    for (int k = 0; k < kDqTile / 4 / 256; ++k) {
      const int f = threadIdx.x + 256 * k;  // (warpgroup w, r4, thread t): rows row, row + 8 at col, col + 1
      const int w = f / 1024, r4 = (f % 1024) / 128, t = f % 128;
      const int row = (kM == 128 ? 64 * w : 0) + (t / 32) * 16 + (t % 32) / 4;
      const int col = (kM == 128 ? 0 : 64 * w) + r4 * 8 + 2 * (t % 4);
      const float4 v = src[f];
      *reinterpret_cast<float2*>(tile + row * kStride + col) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(tile + (row + 8) * kStride + col) = make_float2(v.z, v.w);
    }
    __syncthreads();
    const int qt = (int)(t0 % nq);
    const int64_t bh = t0 / nq;
#pragma unroll
    for (int k = 0; k < kDqTile / 4 / 256; ++k) {
      const int g = threadIdx.x + 256 * k;
      const int row = g / (kCols / 4), d = (g % (kCols / 4)) * 4;
      const int q = qt * kM + row;
      if (q >= T || d >= D) continue;
      const float4 v = *reinterpret_cast<const float4*>(tile + row * kStride + d);
      uint2 packed;
      packed.x = pack_bf16(v.x * scale, v.y * scale);
      packed.y = pack_bf16(v.z * scale, v.w * scale);
      *reinterpret_cast<uint2*>(dq + ((bh / H * T + q) * H + bh % H) * D + d) = packed;
    }
    return;
  }
  const int64_t n_k4 = (int64_t)B * S * KV * (D / 4);
  const int Sp = (S + kN - 1) / kN * kN;
  const int64_t part = (int64_t)n_split * B * KV * Sp * C::kDp;
  for (int64_t i = (blockIdx.x - n_tiles) * 256 + threadIdx.x; i < 2 * n_k4;
       i += (int64_t)(gridDim.x - n_tiles) * 256) {
    const int64_t e = i % n_k4;
    const int which = (int)(i / n_k4);  // 0: dK, 1: dV
    const int d4 = (int)(e % (D / 4));
    int64_t rest = e / (D / 4);
    const int kvh = (int)(rest % KV);
    rest /= KV;
    const int row = (int)(rest % S);
    const int b = (int)(rest / S);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_split; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(
          ws + which * part + ((((int64_t)s * B + b) * KV + kvh) * Sp + row) * C::kDp + d4 * 4);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    uint2 packed;
    packed.x = pack_bf16(acc.x, acc.y);
    packed.y = pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>((which == 0 ? dk : dv) + (((int64_t)b * S + row) * KV + kvh) * D + d4 * 4) = packed;
  }
}

// ---------------------------------------------------------------- host

// A (B, rows, heads, D) bf16 array as a 4-D tensor map of boxes of 64
// columns x `box_rows` rows of one head, 128-byte swizzled; columns past D
// and rows past `rows` are zero-filled.
bool encode_rows(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int rows, int heads, int D,
                 int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2, (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, estrides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_prep(const void* o, const void* dout, const void* lse, void* dsum, void* lse2, void* sem, int B,
                        int T, int H, cudaStream_t stream) {
  constexpr int kM = query_rows<D>();
  const int Tp = (T + kM - 1) / kM * kM;
  const dim3 grid((Tp + kPrepRows - 1) / kPrepRows, B * H);
  flash_bwd_prep_kernel<D><<<grid, kPrepRows * 8, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<float*>(lse2), static_cast<int*>(sem), T, H, Tp);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_sweep(const void* q, const void* k, const void* v, const void* dout, const Sweep& sw,
                         cudaStream_t stream) {
  using C = Cfg<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap, dmap;
  if (!encode_rows(encode, &qmap, q, sw.B, sw.T, sw.H, D, C::kM) ||
      !encode_rows(encode, &dmap, dout, sw.B, sw.T, sw.H, D, C::kM) ||
      !encode_rows(encode, &kmap, k, sw.B, sw.S, sw.KV, D, kN) ||
      !encode_rows(encode, &vmap, v, sw.B, sw.S, sw.KV, D, kN))
    return cudaErrorInvalidValue;
  static std::atomic<uint32_t> smem_set{0u};
  cudaError_t err = allow_smem_once(flash_bwd_kernel<D>, C::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)((sw.S + kN - 1) / kN) * sw.n_split * sw.KV * sw.B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_bwd_kernel<D><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(qmap, kmap, vmap, dmap, sw);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_post(const void* dq_acc, void* dq, const void* ws, void* dk, void* dv, int B, int T, int S,
                        int H, int KV, int n_split, cudaStream_t stream) {
  constexpr int kM = query_rows<D>();
  const int64_t n_k4 = n_split > 1 ? 2 * (int64_t)B * S * KV * (D / 4) : 0;
  const int64_t blocks = (int64_t)B * H * ((T + kM - 1) / kM) + std::min<int64_t>((n_k4 + 255) / 256, 1 << 16);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_bwd_post_kernel<D><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<__nv_bfloat16*>(dq), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, T, S, H, KV, n_split,
      1.f / sqrtf((float)D));
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int S, int H, int KV) {
  return B <= 0 || T <= 0 || S <= 0 || KV <= 0 || H <= 0 || H % KV != 0;
}

}  // namespace flash_bwd
}  // namespace

extern "C" {

// K3's gradient, first kernel. o: (B, T, H, D) fp32, the forward's output
// before its rounding (its o32); dout: (B, T, H, D) bf16; lse: (B, H, T)
// fp32 from the forward; dsum, lse2: (B, H, Tp) fp32 with Tp = T rounded up
// to whole query tiles of GRAD_QUERY_ROWS(D) rows, written; sem: (B, H, Tp /
// rows) int32, zeroed. Returns a cudaError_t (0 on a successful launch).
int repro_flash_attention_bwd_prep(const void* o, const void* dout, const void* lse, void* dsum, void* lse2,
                                   void* sem, int B, int T, int H, int D, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)flash_bwd::launch_prep<64>(o, dout, lse, dsum, lse2, sem, B, T, H, st);
    case 112: return (int)flash_bwd::launch_prep<112>(o, dout, lse, dsum, lse2, sem, B, T, H, st);
    case 128: return (int)flash_bwd::launch_prep<128>(o, dout, lse, dsum, lse2, sem, B, T, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The sweep. q, dout: (B, T, H, D); k, v: (B, S, KV, D); bf16, contiguous,
// 16-byte aligned. lse2, dsum, sem from prep. dq_acc: (B, H, Tp / rows, 8192)
// fp32 (every element written). With
// n_split == 1, dk and dv (B, S, KV, D) bf16 are written and ws is unused;
// else ws holds 2 x (n_split, B, KV, Sp, Dp) fp32 partials (Sp = S rounded
// up to 128, Dp = 64 at D = 64 and 128 else) for post. Returns a cudaError_t.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse2,
                              const void* dsum, void* dq_acc, void* sem, void* dk, void* dv, void* ws, int B, int T,
                              int S, int H, int KV, int D, int causal, int n_split, void* stream) {
  if (flash_bwd::bad_shape(B, T, S, H, KV) || n_split < 1 || n_split > H / KV) return (int)cudaErrorInvalidValue;
  const flash_bwd::Sweep sw{static_cast<const float*>(lse2), static_cast<const float*>(dsum),
                            static_cast<float*>(dq_acc), static_cast<int*>(sem),
                            static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                            static_cast<float*>(ws), B, T, S, H, KV, causal, n_split,
                            1.4426950408889634f / sqrtf((float)D), 1.f / sqrtf((float)D)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)flash_bwd::launch_sweep<64>(q, k, v, dout, sw, st);
    case 112: return (int)flash_bwd::launch_sweep<112>(q, k, v, dout, sw, st);
    case 128: return (int)flash_bwd::launch_sweep<128>(q, k, v, dout, sw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Last kernel: dq (B, T, H, D) bf16 from dq_acc; with n_split > 1 also dk
// and dv from the partials in ws. Returns a cudaError_t.
int repro_flash_attention_bwd_post(const void* dq_acc, void* dq, const void* ws, void* dk, void* dv, int B, int T,
                                   int S, int H, int KV, int D, int n_split, void* stream) {
  if (flash_bwd::bad_shape(B, T, S, H, KV) || n_split < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)flash_bwd::launch_post<64>(dq_acc, dq, ws, dk, dv, B, T, S, H, KV, n_split, st);
    case 112: return (int)flash_bwd::launch_post<112>(dq_acc, dq, ws, dk, dv, B, T, S, H, KV, n_split, st);
    case 128: return (int)flash_bwd::launch_post<128>(dq_acc, dq, ws, dk, dv, B, T, S, H, KV, n_split, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
