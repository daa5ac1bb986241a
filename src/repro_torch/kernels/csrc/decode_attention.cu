// K4 — one-token GQA decode attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py :: decode_attention / _decode_kernel
// (the Pallas TPU split-K flash-decoding kernel behind every dense decode
// step, models/attention.py).
//
// What bounds it on this card: bytes. One query token per sequence does
// 4*H*hd flops per cached row against 2*KV*hd*2 bytes of K and V — about
// 2*G = 8 flop per byte for llama3.2-1b (G = 4 query heads per kv head), far
// below the ~295 flop/byte ridge. The least time is the K/V rows below
// cur_len over 3.35 TB/s.
//
// What the design does about it:
//   * grid (B, KV), 128 threads: each block serves the G query heads that
//     share one kv head, so every K/V row is read from device memory ONCE
//     (the TPU grid (B, H, S/bk) reads it once per query head);
//   * the block loops over 64-row tiles of rows < cur_len only (cur_len is
//     read on the device: no host sync, and rows past it are never loaded),
//     staging each K / V tile in shared memory with 16-byte coalesced loads;
//   * scores, the per-head online softmax (m, l in shared memory, fp32,
//     -1e30 sentinel) and the PV accumulators (fp32 registers, one or more
//     (head, dim) outputs per thread) all stay on chip;
//   * cur_len == 0 gives exact zeros (l == 0 -> 1), the paged kernel's
//     contract; the TPU kernel returns the mean of V there.
// Known limit: at B = 1 the grid is KV = 8 blocks on 132 SMs, so one call
// reaches a small fraction of the card's memory rate. Splitting the row
// sweep across SMs (flash-decoding's split-K with a second combine pass) is
// the performance follow-up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // cached rows per tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKPad = 2;       // bf16 padding per K row: conflict-free score reads
constexpr int kMaxOut = 8;     // (head, dim) outputs per thread: G * hd <= 1024
constexpr float kNegInf = -1e30f;

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

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ cur_len,
                        __nv_bfloat16* __restrict__ out, int S, int H, int KV, float scale) {
  constexpr int kKStride = D + kKPad;
  constexpr int kChunks = D / 8;  // 16-byte chunks per head row
  const int G = H / KV;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kTile][kKStride]
  __nv_bfloat16* Vs = Ks + kTile * kKStride;                        // [kTile][D]
  float* qs = reinterpret_cast<float*>(Vs + kTile * D);             // [G][D]
  float* ps = qs + G * D;                                           // [G][kTile]
  float* ms = ps + G * kTile;                                       // [G] running max
  float* ls = ms + G;                                               // [G] running sum
  float* as = ls + G;                                               // [G] this tile's rescale

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;

  const int64_t kv_row_stride = (int64_t)KV * D;
  const __nv_bfloat16* kb = k + (int64_t)b * S * kv_row_stride + (int64_t)kvh * D;
  const __nv_bfloat16* vb = v + (int64_t)b * S * kv_row_stride + (int64_t)kvh * D;
  const int64_t qo = ((int64_t)b * H + (int64_t)kvh * G) * D;  // G heads are contiguous

  for (int i = tid; i < G * D; i += kThreads) qs[i] = __bfloat162float(q[qo + i]);
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  const int n = max(0, min(cur_len[b], S));

  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int rows = min(kTile, n - t0);
    // ---- stage K / V rows [t0, t0 + rows) ----
    for (int c = tid; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c - r * kChunks) * 8;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) {
        kval = *reinterpret_cast<const uint4*>(kb + (int64_t)(t0 + r) * kv_row_stride + col);
        vval = *reinterpret_cast<const uint4*>(vb + (int64_t)(t0 + r) * kv_row_stride + col);
      }
      // K rows are padded (not 16-byte aligned): store as four 32-bit words
      const uint32_t* kw = reinterpret_cast<const uint32_t*>(&kval);
      uint32_t* kdst = reinterpret_cast<uint32_t*>(Ks + r * kKStride + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) kdst[i] = kw[i];
      *reinterpret_cast<uint4*>(Vs + r * D + col) = vval;
    }
    __syncthreads();

    // ---- scores: one (head, row) pair per thread per step ----
    for (int p = tid; p < G * kTile; p += kThreads) {
      const int g = p / kTile;
      const int j = p - g * kTile;
      float s = kNegInf;
      if (j < rows) {
        const float* qg = qs + g * D;
        const __nv_bfloat162* krow = reinterpret_cast<const __nv_bfloat162*>(Ks + j * kKStride);
        float dot = 0.f;
#pragma unroll 8
        for (int d2 = 0; d2 < D / 2; ++d2) {
          const float2 kf = __bfloat1622float2(krow[d2]);
          dot += qg[2 * d2] * kf.x + qg[2 * d2 + 1] * kf.y;
        }
        s = dot * scale;
      }
      ps[p] = s;
    }
    __syncthreads();

    // ---- online softmax, one warp per head ----
    for (int g = warp; g < G; g += kWarps) {
      float* pg = ps + g * kTile;
      const float s0 = pg[lane];
      const float s1 = pg[lane + 32];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < rows ? __expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < rows ? __expf(s1 - m_new) : 0.f;
      pg[lane] = p0;
      pg[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        as[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + P V for this thread's (head, dim) outputs ----
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < G * D) {
        const int g = o / D;
        const int d = o - g * D;
        const float* pg = ps + g * kTile;
        float a = acc[i] * as[g];
        for (int j = 0; j < rows; ++j) a += pg[j] * __bfloat162float(Vs[j * D + d]);
        acc[i] = a;
      }
    }
    __syncthreads();  // the next tile overwrites Ks / Vs / ps
  }

  // ---- finalize: l == 0 (cur_len == 0) -> exact zeros ----
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * kThreads;
    if (o < G * D) {
      const float l = ls[o / D];
      out[qo + o] = __float2bfloat16(acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* cur_len, void* out,
                   int B, int S, int H, int KV, cudaStream_t stream) {
  const int G = H / KV;
  if (G * D > kMaxOut * kThreads) return cudaErrorInvalidValue;
  const size_t smem = sizeof(__nv_bfloat16) * ((size_t)kTile * (D + kKPad) + (size_t)kTile * D) +
                      sizeof(float) * ((size_t)G * D + (size_t)G * kTile + 3 * (size_t)G);
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, KV);
  const float scale = 1.0f / sqrtf((float)D);
  decode_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(cur_len),
      static_cast<__nv_bfloat16*>(out), S, H, KV, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: (B, H, D); k, v: (B, S, KV, D); all bf16, contiguous, 16-byte
// aligned; cur_len: (B,) int32 on the device. Returns a cudaError_t.
int repro_decode_attention_fwd(const void* q, const void* k, const void* v, const void* cur_len,
                               void* out, int B, int S, int H, int KV, int D, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, cur_len, out, B, S, H, KV, st);
    case 128:
      return (int)launch<128>(q, k, v, cur_len, out, B, S, H, KV, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
