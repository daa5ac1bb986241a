// One-token GQA decode attention by split-K across a thread-block cluster,
// shared by K4 (decode_attention.cu, a contiguous cache) and K1
// (paged_attention.cu, rows read through a block table). The two differ only
// in where logical row j of sequence b lives: a row-address policy
// (`Contiguous`, `Paged`) maps (b, j) to a row of a (rows, KV, D) array.
//
// Bound on this card: bytes. One query token per sequence does 4*H*D flops
// per cached row against 2*KV*D*2 bytes of K and V, 2*G flop per byte (8 for
// G = 4), far below the ~295 flop/byte ridge; the least time is the rows
// below cur_len over 3.35 TB/s. At the serve shapes a call is bound by
// latency instead: one block per (sequence, kv head) walks every tile of the
// cache in series. The design spreads the row sweep over the card.
//
// The design, in ONE launch:
//   * grid (splits, KV, B), cluster (splits, 1, 1), 256 threads; splits =
//     min(8, ceil(capacity/64)) (8 is the portable cluster size) is set from
//     the cache's capacity (K4: S; K1: the table's n * page), never from
//     cur_len, so the split layout and the summation order are the same for
//     every call on one cache shape. Split i takes the contiguous run of
//     64-row tiles [i*n/splits, (i+1)*n/splits) of the n = ceil(capacity/64);
//     tiles at or past cur_len (read on the device: no host sync) are never
//     loaded, so an empty split leaves m = -1e30, l = 0. Each block serves
//     the G query heads that share its kv head, so every K/V row is read
//     from device memory once;
//   * any G: the G heads are taken in slices of at most 1024 / D heads (the
//     outputs a slice gives 256 threads, two pairs each); every tile, loaded
//     once, serves each slice from shared memory in turn, and the per-head
//     softmax state and fp32 accumulators live in shared memory;
//   * K/V tiles come in through a 2-stage cp.async ring (16-byte copies,
//     each from its own row's address, rows past cur_len zero-filled without
//     a read), so the next tile loads while this one is computed;
//   * scores are computed warp per row: the lanes span D with bf16x2 reads
//     of K, each lane holding its dims of the current head's q; a warp's 8
//     rows are summed across lanes by a reduce-scatter butterfly (9 shuffles
//     per head for 8 rows, not 5 per row) that leaves each row's dot product
//     on four lanes;
//   * the per-head online softmax (fp32, -1e30 sentinel) runs one warp per
//     head; P stays fp32 in PV, as in the TPU kernels;
//   * PV gives every thread (head, dim-pair) outputs with bf16x2 reads of V;
//     where a slice's pairs are fewer than the threads (G = 1 to 4 at D 64)
//     the tile's rows are split among up to 8 thread groups, so no thread
//     idles; the groups' partials are summed in order before the combine;
//   * combine: each block leaves (m, l, acc[G*D]) in its shared memory, then
//     cluster.sync(); rank 0 reads the other ranks' partials through
//     distributed shared memory (every remote load of a thread issued
//     before any is used), rescales each by exp(m_i - m) in rank order,
//     sums, divides by l (l == 0 -> 1) and writes the output; a second
//     cluster barrier (a relaxed arrive) keeps every block's shared memory
//     alive until rank 0 has read it. No float atomics, no global workspace,
//     no second launch: two launches on the same inputs give equal bits;
//   * cur_len == 0 gives exact zeros (every split empty: l == 0 -> 1);
//   * with `lse` (K4 only; null otherwise) rank 0 also writes each head's
//     logsumexp of its scaled scores, m + log(l) from the combine's own
//     (m, l) (-inf at cur_len == 0): the weight of the output in a
//     combine across caches split over devices (flash-decoding on a mesh).
// The dynamic shared-memory limit is raised once per kernel and device.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "async_copy.cuh"  // cp.async ring helpers, allow_smem_once
#include "row_policy.cuh"  // Contiguous, Paged

namespace {
namespace decode_split {

namespace cg = cooperative_groups;

constexpr int kTile = 64;        // cached rows per tile
constexpr int kMaxSplits = 8;    // blocks per cluster: the portable cluster size
constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kTile / kWarps;  // 8 score rows per warp per tile
constexpr int kMaxPairs = 2;     // (head, dim-pair) outputs per thread
constexpr int kSliceWidth = 2 * kMaxPairs * kThreads;  // outputs of one head slice: 1024
constexpr int kMaxGroups = 8;    // PV row groups: 8 rows each at the most
constexpr int kStages = 2;       // K/V ring depth: tile k + 1 loads while tile k is computed
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // the dynamic shared memory one block may use on sm_90

// Row addresses: K4 reads a contiguous cache, K1 pages through a block table.
using row_policy::Contiguous;
using row_policy::Paged;

// Heads per slice at group size G and head dim D.
__host__ __device__ inline int slice_heads(int G, int D) { return G < kSliceWidth / D ? G : kSliceWidth / D; }

// PV row groups for a slice of `heads` heads: as many (up to 8) as keep
// every thread busy.
__host__ __device__ inline int pv_groups(int heads, int D) {
  const int pairs = heads * D / 2;
  int groups = 1;
  while (groups < kMaxGroups && 2 * groups * pairs <= kThreads) groups *= 2;
  return groups;
}

// Shared memory at group size G: the K/V ring, then fp32 q (every head), one
// slice's scores, the PV accumulators (row groups x every head), m / l /
// alpha and the combine's weights.
template <int D>
size_t smem_bytes(int G) {
  const int gs = slice_heads(G, D);
  return sizeof(__nv_bfloat16) * 2 * (size_t)kStages * kTile * D +
         sizeof(float) * ((size_t)G * D + (size_t)gs * kTile + (size_t)pv_groups(gs, D) * G * D +
                          3 * (size_t)G + (size_t)kMaxSplits * G);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sweep and, on rank 0, the cluster's combine. q, out: (B, H, D);
// lse: (B, H) fp32 or null; k, v: (rows, KV, D) addressed through `rows`;
// cur_len: (B,).
template <int D, class Rows>
__device__ __forceinline__ void sweep(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ cur_len,
                                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int KV,
                                      float scale, const Rows& rows) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kChunks = D / 8;          // 16-byte chunks per head row
  constexpr int kWords = D / 2;           // bf16x2 words per head row
  constexpr int kLaneWords = (kWords + 31) / 32;  // words of a row per lane
  constexpr int kStage = kTile * D;       // bf16 per K or V stage
  constexpr int kLoads = (kTile * kChunks + kThreads - 1) / kThreads;  // chunks per thread per tile
  constexpr int kLevels = 3;  // reduce-scatter levels: log2(kWarpRows)
  static_assert(kWarpRows == 1 << kLevels, "the butterfly takes 8 rows per warp");

  cg::cluster_group cluster = cg::this_cluster();
  const int G = H / KV;
  const int GD = G * D;
  const int gs_max = slice_heads(G, D);
  const int slices = (G + gs_max - 1) / gs_max;
  // PV layout: `groups` thread groups split the tile's rows, each of `per`
  // threads owning pairs t, t + per, ... of the slice
  const int groups = pv_groups(gs_max, D);
  const int per = kThreads / groups;
  const int rows_per_group = kTile / groups;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kStages][kTile][D]
  __nv_bfloat16* Vs = Ks + kStages * kStage;                        // [kStages][kTile][D]
  float* qs = reinterpret_cast<float*>(Vs + kStages * kStage);      // [G][D]
  float* ps = qs + GD;                                              // [gs_max][kTile] scores, then P
  float* accs = ps + gs_max * kTile;                                // [groups][G*D] PV accumulators
  float* ms = accs + groups * GD;                                   // [G] running max
  float* ls = ms + G;                                               // [G] running sum
  float* as = ls + G;                                               // [G] tile rescale; rank 0: l
  float* wm = as + G;                                               // [kMaxSplits][G] rank 0: weights

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int split = blockIdx.x;  // == cluster.block_rank(): the cluster spans x
  const int splits = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  const int64_t kv_row_stride = (int64_t)KV * D;
  const int64_t qo = ((int64_t)b * H + (int64_t)kvh * G) * D;  // G heads are contiguous

  const int cap = rows.capacity();
  const int n = max(0, min(cur_len[b], cap));
  const int n_all = (cap + kTile - 1) / kTile;
  const int t_begin = split * n_all / splits;
  const int t_end = min((split + 1) * n_all / splits, (n + kTile - 1) / kTile);
  const int n_tiles = max(0, t_end - t_begin);

  // tile t (absolute) into ring slot `slot`; rows at or past cur_len zero-filled
  auto load_tile = [&](int slot, int t) {
    const int r0 = t * kTile;
    __nv_bfloat16* ks = Ks + slot * kStage;
    __nv_bfloat16* vs = Vs + slot * kStage;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = tid + i * kThreads;
      if (c < kTile * kChunks) {
        const int r = c / kChunks;
        const int col = (c - r * kChunks) * 8;
        const bool ok = r0 + r < n;
        const int64_t off = ok ? rows.row(b, r0 + r) * kv_row_stride + (int64_t)kvh * D + col : 0;
        cp_async_16(ks + r * D + col, k + off, ok);
        cp_async_16(vs + r * D + col, v + off, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, t_begin + s);
    cp_async_commit();  // an empty group keeps the count uniform
  }
  for (int i = tid; i < GD; i += kThreads) qs[i] = __bfloat162float(q[qo + i]);
  for (int i = tid; i < groups * GD; i += kThreads) accs[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }

  // this thread's PV outputs: pairs t, t + per, ... of its row group
  const int grp_id = tid / per;
  const int t_in = tid - grp_id * per;
  float* acc_grp = accs + grp_id * GD;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = (t_begin + it) * kTile;
    const int nrows = min(kTile, n - t0);
    cp_async_wait<kStages - 2>();  // tile `it` landed: this thread's copies
    __syncthreads();               // ... everyone's; the previous tile's slot, ps are free
    const int nxt = it + kStages - 1;
    if (nxt < n_tiles) load_tile(nxt % kStages, t_begin + nxt);
    cp_async_commit();
    const __nv_bfloat16* ks = Ks + (it % kStages) * kStage;
    const __nv_bfloat16* vs = Vs + (it % kStages) * kStage;

    // this lane's words of the warp's K rows [8 warp, 8 warp + 8), for every slice
    const int r_base = warp * kWarpRows;
    uint32_t kw[kWarpRows][kLaneWords];
    if (r_base < nrows) {
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        const uint32_t* krow = reinterpret_cast<const uint32_t*>(ks + (r_base + r) * D);
#pragma unroll
        for (int i = 0; i < kLaneWords; ++i) {
          const int w = lane + 32 * i;
          kw[r][i] = w < kWords ? krow[w] : 0u;
        }
      }
    }

#pragma unroll 1
    for (int s = 0; s < slices; ++s) {
      const int g0 = s * gs_max;
      const int gs = min(gs_max, G - g0);
      if (s > 0) __syncthreads();  // the previous slice's PV is done with ps

      // ---- scores of the slice's heads ----
      if (r_base < nrows) {
#pragma unroll 1  // unrolling the heads measured slower at G = 1 and 4
        for (int gl = 0; gl < gs; ++gl) {
          const float* qg = qs + (g0 + gl) * D;
          float2 qv[kLaneWords];
#pragma unroll
          for (int i = 0; i < kLaneWords; ++i) {
            const int w = lane + 32 * i;
            qv[i] = w < kWords ? reinterpret_cast<const float2*>(qg)[w] : make_float2(0.f, 0.f);
          }
          float dot[kWarpRows];
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r) {
            float d = 0.f;
#pragma unroll
            for (int i = 0; i < kLaneWords; ++i) {
              const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kw[r][i]));
              d += qv[i].x * kf.x + qv[i].y * kf.y;
            }
            dot[r] = d;
          }
          // reduce-scatter: after the xor-16, 8, 4 levels lane l holds the sum
          // of row (l >> 2) over 8 lanes; xor 2 and 1 complete it
#pragma unroll
          for (int level = 0; level < kLevels; ++level) {
            const int half = (kWarpRows / 2) >> level;
            const int o = 16 >> level;
            const bool upper = lane & o;
#pragma unroll
            for (int i = 0; i < kWarpRows / 2; ++i) {
              if (i < half) {
                const float send = upper ? dot[i] : dot[i + half];
                const float keep = upper ? dot[i + half] : dot[i];
                dot[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
              }
            }
          }
          float sum = dot[0];
#pragma unroll
          for (int o = (16 >> kLevels); o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          const int r = r_base + (lane >> (5 - kLevels));
          if ((lane & ((32 >> kLevels) - 1)) == 0) ps[gl * kTile + r] = r < nrows ? sum * scale : kNegInf;
        }
      }
      __syncthreads();

      // ---- online softmax, one warp per head; rows past cur_len give p = 0 ----
      for (int gl = warp; gl < gs; gl += kWarps) {
        const int g = g0 + gl;
        float* pg = ps + gl * kTile;
        const float s0 = lane < nrows ? pg[lane] : kNegInf;
        const float s1 = lane + 32 < nrows ? pg[lane + 32] : kNegInf;
        const float m_old = ms[g];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float p0 = lane < nrows ? __expf(s0 - m_new) : 0.f;
        const float p1 = lane + 32 < nrows ? __expf(s1 - m_new) : 0.f;
        pg[lane] = p0;
        pg[lane + 32] = p1;
        const float sum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float alpha = __expf(m_old - m_new);
          as[g] = alpha;
          ls[g] = ls[g] * alpha + sum;
          ms[g] = m_new;
        }
      }
      __syncthreads();

      // ---- acc = acc * alpha + P V over this thread's row group ----
      // rows past cur_len have p = 0 and zero-filled V, so the sweep may run
      // to a multiple of 4 past `nrows`
      const int j0 = grp_id * rows_per_group;
      const int j1 = min(j0 + rows_per_group, (nrows + 3) & ~3);
      const int pairs = gs * D / 2;
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        const int p = t_in + i * per;
        if (p < pairs) {
          const int gl = p / kWords;
          const int w = p - gl * kWords;
          const float* pg = ps + gl * kTile;
          const uint32_t* vcol = reinterpret_cast<const uint32_t*>(vs) + w;
          float2* ap = reinterpret_cast<float2*>(acc_grp + (g0 + gl) * D) + w;
          float2 a = *ap;
          const float alpha = as[g0 + gl];
          a.x *= alpha;
          a.y *= alpha;
#pragma unroll 2
          for (int j = j0; j < j1; j += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pg + j);
            const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const uint32_t word = vcol[(j + u) * kWords];
              const float2 vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&word));
              a.x += pj[u] * vf.x;
              a.y += pj[u] * vf.y;
            }
          }
          *ap = a;
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy is left in flight

  // ---- this block's partial acc: accs[0, G*D), the row groups summed in order ----
  if (groups > 1) {  // block-uniform
    __syncthreads();
    for (int o = tid; o < GD; o += kThreads) {
      float sum = accs[o];
      for (int gi = 1; gi < groups; ++gi) sum += accs[gi * GD + o];
      accs[o] = sum;
    }
  }
  cluster.sync();  // every rank's (m, l, acc) is visible cluster-wide

  if (split == 0) {
    // Every remote load below is unconditional (a rank past `splits` reads
    // rank splits - 1 and gets weight 0), so a thread's loads are in flight
    // together.
    for (int g = tid; g < G; g += kThreads) {
      float mr[kMaxSplits], lr[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        const int rr = min(r, splits - 1);
        mr[r] = cluster.map_shared_rank(ms, rr)[g];
        lr[r] = cluster.map_shared_rank(ls, rr)[g];
      }
      // weights exp(m_r - m) per rank, in rank order
      float m = kNegInf;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) m = r < splits ? fmaxf(m, mr[r]) : m;
      float l = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        const float w = r < splits ? __expf(mr[r] - m) : 0.f;
        wm[r * G + g] = w;
        l += w * lr[r];
      }
      as[g] = l == 0.f ? 1.f : l;  // l == 0 (cur_len == 0) -> exact zeros
      if (lse != nullptr) lse[qo / D + g] = l == 0.f ? -INFINITY : m + logf(l);
    }
    __syncthreads();
    for (int o = tid; o < GD; o += kThreads) {
      const int g = o / D;
      float part[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) part[r] = cluster.map_shared_rank(accs, min(r, splits - 1))[o];
      float a = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) a += wm[r * G + g] * part[r];  // 0 past `splits`
      out[qo + o] = __float2bfloat16(a / as[g]);
    }
  }
  // rank 0 is done reading: every block may exit. A relaxed arrive (no
  // release fence): rank 0 consumed every remote value before it arrives,
  // and no block publishes anything after the first barrier
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Launch `kernel` (a __global__ wrapper of sweep<D, Rows>) over a cache of
// `capacity` rows per sequence. Returns a cudaError_t.
template <int D, class Rows, class Kernel>
cudaError_t launch(Kernel kernel, std::atomic<uint32_t>& smem_set, const void* q, const void* k, const void* v,
                   const void* cur_len, void* out, void* lse, int B, int H, int KV, int capacity,
                   const Rows& rows, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(H / KV);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;  // a group too wide for one block's shared memory
  cudaError_t err = allow_smem_once(kernel, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const int splits = std::min(kMaxSplits, (capacity + kTile - 1) / kTile);

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, KV, B);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;  // the whole split row of one (kv head, sequence)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const float scale = 1.0f / sqrtf((float)D);
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
                           static_cast<const int*>(cur_len), static_cast<__nv_bfloat16*>(out),
                           static_cast<float*>(lse), H, KV, scale, rows);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error too
  return err != cudaSuccess ? err : last;
}

}  // namespace decode_split
}  // namespace
