// K6 — the Mamba-2 SSD chunked scan (state-space duality), forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py :: ssd_scan / _ssd_kernel (the Pallas
// TPU kernel behind every SSM layer's prefill, models/ssm.py: ssd_chunked).
// Like it, this kernel returns y only; the final state is the closed form
// models/ssm.py: _final_state_only computes outside the kernel.
//
// What it computes, per (batch b, head h), over t = 0 .. T-1:
//   state_t = exp(dt_t * a) * state_{t-1} + dt_t * x_t B_t^T      (P x N, fp32)
//   y_t     = C_t state_t^T + D * x_t,   a = -exp(A_log[h])
// with B and C of group h / (H / G). The dual form evaluates it chunk by
// chunk: inside a chunk of Q rows, y_intra = (C B^T o L) x with
// L[i][j] = exp(cum_i - cum_j) * dt_j for j <= i (cum the chunk's running
// sum of dt * a); the rows before the chunk enter through the carried state,
// y_inter[i] = exp(cum_i) C_i state^T, and the state moves on by
// state' = exp(cum_Q) state + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T.
//
// What bounds it on this card: at the serving shapes (B = 1, T = 300;
// mamba2-370m H = 32, P = 64, N = 128; zamba2-7b H = 112, P = 64, N = 64) one
// call reads and writes 2.5-8.6 MB (x, y, B, C, dt) and does 0.5-1.1 GFLOP
// of dual-form products at the kernel's chunk of 64: about 1 us either way,
// bytes and tensor-core operations alike. This first version does its
// products with fp32 FMAs on the CUDA cores, so it is bound by those and
// sits far off its bound; tensor cores (mma.sync / wgmma on bf16 B, C, x),
// sharing C B^T across the heads of a group, and TMA are later work.
//
// What the design does about the TPU kernel's shape:
//   * the TPU grid (B, H, T/Q) carries the state across its sequential chunk
//     axis in VMEM; here one block owns one (b, h, 32-row slice of P) and
//     loops over the chunks itself, carrying its 32 x N slice of the fp32
//     state in shared memory (the rows of the state are independent, so P
//     splits across blocks: grid (B*H, P/32), 128 threads);
//   * the chunk is 64 rows, not the configured 256: a 256 x 256 fp32 decay
//     tile alone is 256 KB, more than an SM's 227 KB of shared memory. The
//     result does not depend on the chunking up to rounding;
//   * L is formed only where j <= i: cum_i - cum_j is positive above the
//     diagonal and exp there can overflow to inf (inf * 0 = NaN under a 0/1
//     mask), so exp is never evaluated there; exp(cum_i) and
//     exp(cum_Q - cum_j) have exponents <= 0 and can only underflow;
//   * any T: the last chunk is partial; its rows past T are loaded as zeros
//     (dt = 0 there, so they add nothing to y or to the state) and not stored;
//   * B, C, x tiles are staged once per chunk as fp32 in shared memory, rows
//     padded so the 16-byte fragment loads are bank-conflict free; every
//     product keeps a register tile (4 x 8 or 4 x 4 outputs per thread) and
//     sums in fp32 in one fixed order, so equal inputs give equal bits.
// Shared memory: 108.5 KB a block at N = 128, 68.5 KB at N = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;         // rows per internal chunk
constexpr int kPS = 32;        // state rows (a slice of the head dim P) per block
constexpr int kThreads = 128;  // 4 warps
constexpr int kMS = kQ + 4;    // row stride of the transposed L o (C B^T) tile

template <int N>
constexpr int smem_floats() {
  return 2 * kQ * (N + 4)      // B, C chunk tiles
         + kQ * kPS            // x chunk tile (this block's 32 columns)
         + kQ * kMS            // Mt[j][i] = L[i][j] (C B^T)[i][j]
         + kPS * (N + 4)       // the carried state slice
         + 4 * kQ;             // cum, dt, w_j, exp(cum_i)
}

// 8 bf16 (one 16-byte load) -> 8 floats at a 16-byte aligned address.
__device__ __forceinline__ void store8(float* dst, uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 f0 = __bfloat1622float2(h[0]);
  const float2 f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]);
  const float2 f3 = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ bm,
                const __nv_bfloat16* __restrict__ cm, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ d_skip,
                __nv_bfloat16* __restrict__ y, int T, int H, int P, int G) {
  static_assert(N % 64 == 0, "state dim must be a multiple of 64");
  constexpr int kNS = N + 4;   // B / C / state row stride (floats)
  constexpr int kNK = N / 64;  // state-update column groups per thread

  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;               // [kQ][kNS]
  float* Cs = Bs + kQ * kNS;      // [kQ][kNS]
  float* Xs = Cs + kQ * kNS;      // [kQ][kPS]
  float* Mt = Xs + kQ * kPS;      // [kQ (j)][kMS (i)]
  float* Ss = Mt + kQ * kMS;      // [kPS][kNS]
  float* cum = Ss + kPS * kNS;    // [kQ] running sum of dt * a in the chunk
  float* dts = cum + kQ;          // [kQ] dt (0 past T)
  float* wj = dts + kQ;           // [kQ] exp(cum_Q - cum_j) * dt_j
  float* ec = wj + kQ;            // [kQ] exp(cum_i)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ti = tid >> 3;  // 0..15: chunk rows i = ti + 16 r (r < 4); state columns tn = ti
  const int t8 = tid & 7;   // 0..7: chunk columns j = t8 + 8 jj; head-dim columns p = t8 + 8 q

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int p0 = blockIdx.y * kPS;
  const int g = h / (H / G);
  const float a = -expf(a_log[h]);
  const float dskip = d_skip[h];

  const int64_t xrow = (int64_t)H * P;  // elements between tokens in x / y
  const int64_t brow = (int64_t)G * N;  // ... in B / C
  const __nv_bfloat16* xb = x + (int64_t)b * T * xrow + (int64_t)h * P + p0;
  __nv_bfloat16* yb = y + (int64_t)b * T * xrow + (int64_t)h * P + p0;
  const __nv_bfloat16* bb = bm + (int64_t)b * T * brow + (int64_t)g * N;
  const __nv_bfloat16* cb = cm + (int64_t)b * T * brow + (int64_t)g * N;
  const float* dtb = dt + (int64_t)b * T * H + h;

  for (int i = tid; i < kPS * kNS; i += kThreads) Ss[i] = 0.f;

  for (int c0 = 0; c0 < T; c0 += kQ) {
    const int rows = min(kQ, T - c0);

    // ---- stage the chunk: B, C (Q x N), x (Q x 32) as fp32, dt; rows past T are 0 ----
    for (int c = tid; c < kQ * (N / 8); c += kThreads) {
      const int r = c / (N / 8);
      const int col = (c - r * (N / 8)) * 8;
      uint4 bv = make_uint4(0u, 0u, 0u, 0u);
      uint4 cv = bv;
      if (r < rows) {
        bv = *reinterpret_cast<const uint4*>(bb + (int64_t)(c0 + r) * brow + col);
        cv = *reinterpret_cast<const uint4*>(cb + (int64_t)(c0 + r) * brow + col);
      }
      store8(Bs + r * kNS + col, bv);
      store8(Cs + r * kNS + col, cv);
    }
    for (int c = tid; c < kQ * (kPS / 8); c += kThreads) {
      const int r = c / (kPS / 8);
      const int col = (c - r * (kPS / 8)) * 8;
      uint4 xv = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) xv = *reinterpret_cast<const uint4*>(xb + (int64_t)(c0 + r) * xrow + col);
      store8(Xs + r * kPS + col, xv);
    }
    if (tid < kQ) dts[tid] = tid < rows ? dtb[(int64_t)(c0 + tid) * H] : 0.f;
    __syncthreads();

    // ---- cum: inclusive running sum of dt * a (warp 0, two rows per lane) ----
    if (warp == 0) {
      const float v0 = dts[2 * lane] * a;
      const float v1 = dts[2 * lane + 1] * a;
      float s = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += u;
      }
      float before = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) before = 0.f;
      cum[2 * lane] = before + v0;
      cum[2 * lane + 1] = before + v0 + v1;
    }
    __syncthreads();

    // ---- Mt[j][i] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0 ----
    {
      float s[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[r][jj] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = *reinterpret_cast<const float4*>(Cs + (ti + 16 * r) * kNS + n);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4 bv = *reinterpret_cast<const float4*>(Bs + (t8 + 8 * jj) * kNS + n);
#pragma unroll
          for (int r = 0; r < 4; ++r) s[r][jj] = dot4(cv[r], bv, s[r][jj]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = t8 + 8 * jj;
          // mask BEFORE exp: above the diagonal cum_i - cum_j > 0
          Mt[j * kMS + i] = j <= i ? s[r][jj] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
      if (tid < kQ) {
        wj[tid] = expf(cum[kQ - 1] - cum[tid]) * dts[tid];
        ec[tid] = expf(cum[tid]);
      }
    }
    __syncthreads();

    // ---- y = Mt^T x + exp(cum_i) C state^T + D x: rows i = ti + 16 r, columns p = t8 + 8 q ----
    {
      float acc[4][4], inter[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = inter[r][q] = 0.f;
      const int jmax = min(rows, ti + 48 + 1);  // this thread's last row is ti + 48
      for (int j = 0; j < jmax; ++j) {
        float m[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) m[r] = Mt[j * kMS + ti + 16 * r];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = Xs[j * kPS + t8 + 8 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(m[r], xv[q], acc[r][q]);
      }
      if (c0 > 0) {  // the carried state is zero before the first chunk
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], sv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = *reinterpret_cast<const float4*>(Cs + (ti + 16 * r) * kNS + n);
#pragma unroll
          for (int q = 0; q < 4; ++q) sv[q] = *reinterpret_cast<const float4*>(Ss + (t8 + 8 * q) * kNS + n);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) inter[r][q] = dot4(cv[r], sv[q], inter[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        if (i < rows) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = t8 + 8 * q;
            const float v = acc[r][q] + ec[i] * inter[r][q] + dskip * Xs[i * kPS + p];
            yb[(int64_t)(c0 + i) * xrow + p] = __float2bfloat16(v);
          }
        }
      }
    }
    __syncthreads();  // every thread has read the old state

    // ---- state' = exp(cum_Q) state + sum_j w_j x_j B_j^T: rows p = t8 + 8 q,
    //      columns n = 4 ti + 64 k .. + 3 ----
    {
      const float decay = expf(cum[kQ - 1]);
      float acc[4][kNK][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < kNK; ++k) acc[q][k][0] = acc[q][k][1] = acc[q][k][2] = acc[q][k][3] = 0.f;
      for (int j = 0; j < rows; ++j) {
        const float w = wj[j];
        float xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = w * Xs[j * kPS + t8 + 8 * q];
#pragma unroll
        for (int k = 0; k < kNK; ++k) {
          const float4 bv = *reinterpret_cast<const float4*>(Bs + j * kNS + 4 * ti + 64 * k);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q][k][0] = fmaf(xv[q], bv.x, acc[q][k][0]);
            acc[q][k][1] = fmaf(xv[q], bv.y, acc[q][k][1]);
            acc[q][k][2] = fmaf(xv[q], bv.z, acc[q][k][2]);
            acc[q][k][3] = fmaf(xv[q], bv.w, acc[q][k][3]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < kNK; ++k) {
          float4* sp = reinterpret_cast<float4*>(Ss + (t8 + 8 * q) * kNS + 4 * ti + 64 * k);
          float4 sv = *sp;
          sv.x = fmaf(sv.x, decay, acc[q][k][0]);
          sv.y = fmaf(sv.y, decay, acc[q][k][1]);
          sv.z = fmaf(sv.z, decay, acc[q][k][2]);
          sv.w = fmaf(sv.w, decay, acc[q][k][3]);
          *sp = sv;
        }
    }
    __syncthreads();  // the next chunk overwrites B, C, x, Mt and reads the state
  }
}

template <int N>
cudaError_t launch(const void* x, const void* bm, const void* cm, const void* dt, const void* a_log,
                   const void* d_skip, void* y, int B, int T, int H, int P, int G,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats<N>();
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, P / kPS);
  ssd_scan_kernel<N><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<__nv_bfloat16*>(y), T, H, P, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (B, T, H, P) bf16; bm, cm: (B, T, G, N) bf16; dt: (B, T, H) fp32;
// a_log, d_skip: (H,) fp32; all contiguous, the bf16 ones 16-byte aligned;
// P a multiple of 32, N 64 or 128, G dividing H. Returns a cudaError_t (0 on
// a successful launch).
int repro_ssd_scan_fwd(const void* x, const void* bm, const void* cm, const void* dt,
                       const void* a_log, const void* d_skip, void* y, int B, int T, int H, int P,
                       int G, int N, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P % kPS != 0 ||
      P / kPS > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 64:
      return (int)launch<64>(x, bm, cm, dt, a_log, d_skip, y, B, T, H, P, G, st);
    case 128:
      return (int)launch<128>(x, bm, cm, dt, a_log, d_skip, y, B, T, H, P, G, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
