// K1 and K2 — GQA attention through a block table over a paged KV arena,
// for Hopper (sm_90a).
//
// The arena holds K and V as pages (P, page, KV, D); sequence b's logical
// row j lives in physical page block_table[b, j / page], slot j % page.
//
// K1, paged decode (one query token per sequence).
//   Replaces: src/repro/kernels/paged_attention.py :: paged_decode_attention
//   / _paged_kernel (the Pallas TPU split-K kernel behind every batched
//   decode step of the continuous batcher).
//   Bound on this card: bytes. 4*H*D flops per cached row against
//   2*KV*D*2 bytes of K and V — 2*G = 8 flop per byte for llama3.2-1b, far
//   below the ~295 flop/byte ridge. The least time is the rows below each
//   cur_len over 3.35 TB/s.
//   Design: K4's split-K across a thread-block cluster (decode_split.cuh),
//   whose `Paged` policy reads logical row j of sequence b from slot
//   j % page of page block_table[b, j / page]. Grid (splits, KV, B) with
//   cluster (splits, 1, 1), splits = min(8, ceil(n * page / 64)) from the
//   table's width, never from cur_len; a block serves the G query heads
//   that share one kv head (any G, in slices of 1024 / D heads), so each
//   K/V row is read once; cur_len and the table are read on the device (no
//   host sync; tiles past cur_len are never loaded); the 2-stage cp.async
//   ring fetches each row's 16-byte chunks from its own page; rank 0
//   combines the splits through distributed shared memory in rank order.
//   cur_len == 0 gives exact zeros (the TPU kernel's explicit-zero guard,
//   :66-71).
//
// K2, paged chunked prefill (C query rows starting at absolute position
// start[b]).
//   Replaces: src/repro/kernels/paged_attention.py :: paged_chunk_attention
//   / _paged_chunk_kernel (the Pallas TPU kernel behind every chunked
//   prefill chunk).
//   Bound on this card: a 512-row chunk from position 0 (llama3.2-1b) does
//   1.1 GFLOP (causal) over 5.2 MB of q, output and the K/V rows it needs:
//   about 200 flop per byte, below the ridge, so the bytes bound it (about
//   1.6 us); in practice latency bounds it, as K3.
//   Design: K3's (flash_attention.cu). Grid (ceil(C/64), B*H), 128
//   threads, 16 query rows per warp held as mma.sync A fragments; the kv
//   sweep is a loop of 64-row K/V tiles, each tile gathered row by row
//   through the block table (four 16-row pages at page = 16), QK^T and PV
//   on the tensor cores (m16n8k16 bf16 -> fp32), online softmax in fp32
//   registers. Row i's causal limit is start + i; the sweep stops at the
//   tile holding start + C - 1 and never reads past the table's n * page
//   rows. Masked probabilities are exactly 0; a row with no valid column
//   writes exact zeros. Any C and any start. Rows past the caller's valid
//   count are padding: they are computed like any other row.
//
// A block-table entry outside [0, P) is clamped into the arena, so a bad
// table reads wrong rows but never faults; the arena never hands one out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "decode_split.cuh"  // K1's split-K sweep and its launch

namespace {

constexpr int kThreads = 128;  // K2: 4 warps
constexpr float kNegInf = -1e30f;

// ----------------------------------------------------------------- helpers

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

// Element offset of (logical row j, kv head kvh, column col) of one
// sequence's block-table row `bt` in a (P, page, KV, D) arena.
template <int D>
__device__ __forceinline__ int64_t page_offset(const int* bt, int j, int page, int P, int KV,
                                               int kvh, int col) {
  int phys = bt[j / page];
  phys = min(max(phys, 0), P - 1);
  return (((int64_t)phys * page + (j % page)) * KV + kvh) * D + col;
}

// ------------------------------------------------------------ K1: decode

template <int D>
__global__ void __launch_bounds__(decode_split::kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ cur_len,
                    __nv_bfloat16* __restrict__ out, int H, int KV, float scale, decode_split::Paged rows) {
  decode_split::sweep<D>(q, kp, vp, cur_len, out, H, KV, scale, rows);
}

template <int D>
cudaError_t launch_decode(const void* q, const void* kp, const void* vp, const void* block_table,
                          const void* cur_len, void* out, int B, int P, int page, int n, int H,
                          int KV, cudaStream_t stream) {
  static std::atomic<uint32_t> smem_set{0u};
  const decode_split::Paged rows{static_cast<const int*>(block_table), n, page, P};
  return decode_split::launch<D>(paged_decode_kernel<D>, smem_set, q, kp, vp, cur_len, out, B, H, KV, n * page,
                                 rows, stream);
}

// ------------------------------------------------------ K2: chunked prefill

constexpr int kBlockQ = 64;  // query rows per block (16 per warp)
constexpr int kBlockK = 64;  // kv rows per tile
constexpr int kPad = 8;      // bf16 padding per shared-memory row

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                   const __nv_bfloat16* __restrict__ vp, const int* __restrict__ block_table,
                   const int* __restrict__ start, __nv_bfloat16* __restrict__ out, int C, int P,
                   int page, int n, int H, int KV, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kQStride = D + kPad;        // Qs / Ks row stride (bf16)
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
  const int* bt = block_table + (int64_t)b * n;
  const int s0 = start[b];
  const int S = n * page;  // rows the table can address

  const int64_t q_row_stride = (int64_t)H * D;
  const __nv_bfloat16* qb = q + ((int64_t)b * C) * q_row_stride + (int64_t)h * D;
  __nv_bfloat16* ob = out + ((int64_t)b * C) * q_row_stride + (int64_t)h * D;

  // ---- stage the Q tile (rows past C are zero) ----
  for (int c = tid; c < kBlockQ * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < C) val = *reinterpret_cast<const uint4*>(qb + (int64_t)(q0 + r) * q_row_stride + col);
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

  // this thread's two query rows, as absolute positions (the causal limits)
  const int lim_a = s0 + q0 + warp * 16 + grp;
  const int lim_b = lim_a + 8;
  float m_a = kNegInf, m_b = kNegInf;  // running row max
  float l_a = 0.f, l_b = 0.f;          // running row sum (this thread's columns)
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // stop at the tile holding the block's last absolute position
  const int last = s0 + min(q0 + kBlockQ, C) - 1;
  const int n_tiles = last < 0 ? 0 : min((S + kBlockK - 1) / kBlockK, last / kBlockK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K / V tile
    for (int c = tid; c < kBlockK * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c - r * kChunks) * 8;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) {
        const int64_t off = page_offset<D>(bt, k0 + r, page, P, KV, kvh, col);
        kval = *reinterpret_cast<const uint4*>(kp + off);
        vval = *reinterpret_cast<const uint4*>(vp + off);
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

    // ---- scale, mask (causal from start, table width), row max ----
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + tig * 2 + (e & 1);
        const bool valid = col < S && col <= (e < 2 ? lim_a : lim_b);
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
        const bool valid = col < S && col <= (e < 2 ? lim_a : lim_b);
        s[j][e] = valid ? __expf(s[j][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
      }
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * alpha_a + sum_a;  // quad-reduced once, after the sweep
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha_a;
      o[j][1] *= alpha_a;
      o[j][2] *= alpha_b;
      o[j][3] *= alpha_b;
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
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vrow = Vt + (j * 8 + grp) * kVStride + kk * 16 + tig * 2;
        mma_16816(o[j], pf, ld_u32(vrow), ld_u32(vrow + 8));
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
  const int row_a = q0 + warp * 16 + grp;
  const int row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + tig * 2;
    if (row_a < C)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_a * q_row_stride + col) =
          pack_bf16(o[j][0] * inv_a, o[j][1] * inv_a);
    if (row_b < C)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_b * q_row_stride + col) =
          pack_bf16(o[j][2] * inv_b, o[j][3] * inv_b);
  }
}

template <int D>
cudaError_t launch_chunk(const void* q, const void* kp, const void* vp, const void* block_table,
                         const void* start, void* out, int B, int C, int P, int page, int n, int H,
                         int KV, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)(kBlockQ + kBlockK) * (D + kPad) + (size_t)D * (kBlockK + kPad));
  cudaError_t err = cudaFuncSetAttribute(paged_chunk_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kBlockQ - 1) / kBlockQ, B * H);
  const float scale = 1.0f / sqrtf((float)D);
  paged_chunk_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(block_table),
      static_cast<const int*>(start), static_cast<__nv_bfloat16*>(out), C, P, page, n, H, KV,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: (B, H, D); k_pages, v_pages: (P, page, KV, D); all bf16,
// contiguous, 16-byte aligned; block_table: (B, n) int32 and cur_len: (B,)
// int32 on the device. Returns a cudaError_t.
int repro_paged_decode_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                     const void* block_table, const void* cur_len, void* out,
                                     int B, int P, int page, int n, int H, int KV, int D,
                                     void* stream) {
  if (B <= 0 || P <= 0 || page <= 0 || n <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_decode<64>(q, k_pages, v_pages, block_table, cur_len, out, B, P, page, n,
                                    H, KV, st);
    case 128:
      return (int)launch_decode<128>(q, k_pages, v_pages, block_table, cur_len, out, B, P, page,
                                     n, H, KV, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q, out: (B, C, H, D); k_pages, v_pages: (P, page, KV, D); all bf16,
// contiguous, 16-byte aligned; block_table: (B, n) int32 and start: (B,)
// int32 on the device. Returns a cudaError_t.
int repro_paged_chunk_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                    const void* block_table, const void* start, void* out, int B,
                                    int C, int P, int page, int n, int H, int KV, int D,
                                    void* stream) {
  if (B <= 0 || C <= 0 || P <= 0 || page <= 0 || n <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_chunk<64>(q, k_pages, v_pages, block_table, start, out, B, C, P, page, n,
                                   H, KV, st);
    case 128:
      return (int)launch_chunk<128>(q, k_pages, v_pages, block_table, start, out, B, C, P, page,
                                    n, H, KV, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
