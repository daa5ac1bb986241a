// K3 — causal / non-causal GQA flash attention, forward only, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention / _flash_kernel
// (the Pallas TPU kernel behind the dense prompt prefill, models/attention.py).
//
// What bounds it on this card: at the serving chain's prompt shapes (B = 1,
// T = S = 300, 32 query heads over 8 kv heads, head dim 64, causal) one call
// does 0.37 GFLOP over 3.1 MB of q, k, v and output: about 120 flop per
// byte, below the H100's ~295 flop/byte ridge, so its bound is the bytes
// (under a microsecond). A call this small is in practice bound by latency:
// ceil(300/64) * 32 = 160 blocks of 4 warps for 132 SMs, each sweeping its
// kv tiles in series.
//
// What the design does about it:
//   * grid (ceil(T/64), B*H), 128 threads: each of the 4 warps owns 16 query
//     rows; the Q tile is staged once in shared memory and then held in
//     registers as mma.sync A fragments for the whole kv sweep;
//   * the kv sweep is a loop inside the block (it replaces the TPU's
//     sequential `ik` grid axis): 64-row K and V tiles are staged in shared
//     memory (V transposed, so PV's B fragments are 32-bit loads), QK^T and
//     PV run on the tensor cores as mma.sync m16n8k16 bf16 -> fp32;
//   * the online-softmax state (m, l, acc) stays in fp32 registers with the
//     reference's -1e30 sentinel; P is rounded to bf16 before PV as the TPU
//     kernel does (flash_attention.py:61-63); causal blocks stop at the
//     diagonal tile;
//   * every ragged edge is masked here (any T, any S): out-of-range K/V rows
//     are zero-filled and their probabilities forced to exactly 0, and a row
//     with no valid column divides by l = 1 and writes exact zeros.
// Shared-memory rows are padded by 8 bf16 so fragment loads are bank-conflict
// free. No cp.async / TMA pipelining yet: that is performance work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block (16 per warp)
constexpr int kBlockK = 64;   // kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 padding per shared-memory row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8, fp32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major).
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       int T, int S, int H, int KV, int causal, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kQStride = D + kPad;       // Qs / Ks row stride (bf16)
  constexpr int kVStride = kBlockK + kPad;  // Vt row stride (bf16)
  constexpr int kChunks = D / 8;            // 16-byte chunks per head row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBlockQ][kQStride]
  __nv_bfloat16* Ks = Qs + kBlockQ * kQStride;                      // [kBlockK][kQStride]
  __nv_bfloat16* Vt = Ks + kBlockK * kQStride;                      // [D][kVStride]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;  // row within the 8-row half of a fragment
  const int tig = lane & 3;   // thread in group: column pair

  const int q0 = blockIdx.x * kBlockQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);  // GQA: query head h reads kv head h // G

  const int64_t q_row_stride = (int64_t)H * D;   // elements between tokens
  const int64_t kv_row_stride = (int64_t)KV * D;
  const __nv_bfloat16* qb = q + ((int64_t)b * T) * q_row_stride + (int64_t)h * D;
  const __nv_bfloat16* kb = k + ((int64_t)b * S) * kv_row_stride + (int64_t)kvh * D;
  const __nv_bfloat16* vb = v + ((int64_t)b * S) * kv_row_stride + (int64_t)kvh * D;
  __nv_bfloat16* ob = out + ((int64_t)b * T) * q_row_stride + (int64_t)h * D;

  // ---- stage the Q tile (rows past T are zero) ----
  for (int c = tid; c < kBlockQ * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < T) val = *reinterpret_cast<const uint4*>(qb + (int64_t)(q0 + r) * q_row_stride + col);
    *reinterpret_cast<uint4*>(Qs + r * kQStride + col) = val;
  }
  __syncthreads();

  // ---- Q tile -> A fragments in registers (held for the whole sweep) ----
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* base = Qs + (warp * 16) * kQStride;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = ld_u32(base + grp * kQStride + kk * 16 + tig * 2);
      qf[kk][1] = ld_u32(base + (grp + 8) * kQStride + kk * 16 + tig * 2);
      qf[kk][2] = ld_u32(base + grp * kQStride + kk * 16 + tig * 2 + 8);
      qf[kk][3] = ld_u32(base + (grp + 8) * kQStride + kk * 16 + tig * 2 + 8);
    }
  }

  const int row_a = q0 + warp * 16 + grp;  // this thread's two query rows
  const int row_b = row_a + 8;
  float m_a = kNegInf, m_b = kNegInf;  // running row max
  float l_a = 0.f, l_b = 0.f;          // running row sum (this thread's columns)
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int n_tiles = (S + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_row = min(q0 + kBlockQ, T) - 1;  // columns <= row attend
    n_tiles = min(n_tiles, last_row / kBlockK + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K / V tile
    for (int c = tid; c < kBlockK * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c - r * kChunks) * 8;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) {
        kval = *reinterpret_cast<const uint4*>(kb + (int64_t)(k0 + r) * kv_row_stride + col);
        vval = *reinterpret_cast<const uint4*>(vb + (int64_t)(k0 + r) * kv_row_stride + col);
      }
      *reinterpret_cast<uint4*>(Ks + r * kQStride + col) = kval;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(col + i) * kVStride + r] = ve[i];
    }
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 columns ----
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (j * 8 + grp) * kQStride + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_16816(s[j], qf[kk], ld_u32(krow + kk * 16), ld_u32(krow + kk * 16 + 8));
      }
    }

    // ---- scale, mask, row max ----
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + tig * 2 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool valid = col < S && (!causal || col <= row);
        s[j][e] = valid ? s[j][e] * scale : kNegInf;
      }
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
    const float alpha_a = __expf(m_a - mn_a);
    const float alpha_b = __expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // ---- P = exp(S - m); masked entries are exactly 0 ----
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + tig * 2 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool valid = col < S && (!causal || col <= row);
        s[j][e] = valid ? __expf(s[j][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
      }
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
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vrow = Vt + (n * 8 + grp) * kVStride + kk * 16 + tig * 2;
        mma_16816(o[n], pf, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }
  }

  // ---- finalize: divide by l (l == 0 -> 1: a fully masked row writes 0) ----
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (row_a < T)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_a * q_row_stride + col) =
          pack_bf16(o[n][0] * inv_a, o[n][1] * inv_a);
    if (row_b < T)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_b * q_row_stride + col) =
          pack_bf16(o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int T, int S,
                   int H, int KV, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)(kBlockQ + kBlockK) * (D + kPad) + (size_t)D * (kBlockK + kPad));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, B * H);
  const float scale = 1.0f / sqrtf((float)D);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T, S, H, KV, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: (B, T, H, D); k, v: (B, S, KV, D); all bf16, contiguous, 16-byte
// aligned. Returns a cudaError_t (0 on a successful launch).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, int B,
                              int T, int S, int H, int KV, int D, int causal, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, out, B, T, S, H, KV, causal, st);
    case 128:
      return (int)launch<128>(q, k, v, out, B, T, S, H, KV, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* repro_kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
