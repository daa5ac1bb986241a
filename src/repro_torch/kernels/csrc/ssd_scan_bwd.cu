// K6's gradient — the backward of the Mamba-2 SSD chunked scan
// (csrc/ssd_scan.cu), for Hopper (sm_90a).
//
// Replaces: no TPU kernel. The Pallas kernel src/repro/kernels/ssd_scan.py ::
// ssd_scan has no VJP; the JAX package differentiates its jnp chunked scan
// (models/ssm.py: ssd_chunked). This is the gradient of the forward that K6
// computes, so that the SSM and hybrid families train on the card.
//
// What it computes, per (batch b, head h), from y's cotangent dy and the final
// state's dS (zero when not given), with a = -exp(A_log[h]) and, inside a
// chunk of Q = 64 rows, cl_i = sum_{s<=i} a dt_s, E[i][j] = exp(cl_i - cl_j)
// (j <= i), L = E dt_j, CB = C_i.B_j, M = dy_i.x_j, w_j = exp(cl_Q - cl_j) dt_j:
//   S_c  the state before chunk c (the forward's recurrence),
//   Z_c  the cotangent of the state after chunk c: Z_last = dS,
//        Z_{c-1} = exp(cl_Q) Z_c + sum_k exp(cl_k) dy_k C_k^T,
//   dx_j = D dy_j + sum_i L_ij CB_ij dy_i + w_j Z_c B_j,
//   dB_j = sum_i L_ij M_ij C_i + w_j Z_c^T x_j,
//   dC_i = sum_j L_ij M_ij B_j + exp(cl_i) S_c^T dy_i      (dB, dC summed over a group's heads),
//   dcl_t = sum_j A_tj - sum_i A_it + e_t - s_t (+ exp(cl_Q) <Z_c, S_c> + sum_j s_j at t = Q - 1),
//        A = L CB M, e_t = exp(cl_t) dy_t.(S_c C_t), s_t = w_t x_t.(Z_c B_t),
//   ddt_s = sum_i E_is CB_is M_is + exp(cl_Q - cl_s) x_s.(Z_c B_s) + a sum_{t>=s} dcl_t,
//   dA_log = a sum_{b,s} dt_s sum_{t>=s} dcl_t,  dD = sum_{b,t} dy.x.
// (tests/test_torch_ssd_grad.py walks these formulas on the host against the
// plain backward, kernels/ref.py: ssd_ref_bwd, and jax.vjp.)
//
// What bounds it on this card: at mamba2-370m's train shape (B = 2, T =
// 4096, H = 32, P = 64, N = 128) one call does about 31 GFLOP of 64-row
// products (the Q x Q products of an attention backward per chunk and head,
// and the state products) against 0.2 GB of inputs and outputs: the tensor
// cores bound it on paper; what sets the time of this first version is the
// chain of dependent steps in a block (see below).
//
// What the design does about it (right and deterministic first, not fast):
//   * two kernels. The first walks each (b, h, 32-wide slice of P) over its
//     chunks twice, the state in the mma accumulators of 4 warps as the
//     forward keeps it: forward for S_c (x, B, dt), in reverse for Z_c (dy,
//     C, dt), writing every chunk's S_c and Z_c (fp32, B H nc P N each) to a
//     workspace. The chunk-boundary states are recomputed here, not stored by
//     the forward: 2 B H P N 4 bytes per chunk and layer, transient
//     (mamba2-370m at B = 2, T = 4096: 268 MB while one layer's backward runs);
//   * the second kernel takes one block per (chunk, b, group) and walks the
//     group's heads in order: the chunk's B, C and C B^T (fp32) stay in shared
//     memory for every head, and dB and dC of the group accumulate in shared
//     memory (fp32), each element by one thread, head after head: the sum over
//     a group's heads (all 32 or 112 with G = 1) has one fixed order;
//   * every product on the tensor cores (mma.sync m16n8k16 bf16 -> fp32): the
//     64 x 64 products C B^T and dy x^T in registers, then L o (C B^T) and
//     L o M written to shared memory as bf16 pairs (hi + lo, about 16
//     significant bits, as the forward keeps L o (C B^T)) and read back both
//     ways (ldmatrix and ldmatrix.trans) for dC, dx and dB; S_c and Z_c enter
//     as bf16 pairs too; the walks round exp(cl) dy and w x to bf16 once, as
//     the forward's state update rounds w x;
//   * per-row sums (rows and columns of A, e, s) go through shared memory and
//     one warp takes the chunk's reverse cumulative sum by shuffles in a fixed
//     order; dA_log and dD are reduced over (b, chunk) by the last block to
//     finish (an integer ticket; no floating-point atomics), in one fixed order;
//   * rows past T are zero-filled (dt = 0 there: they add nothing) and not
//     stored; equal inputs give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "async_copy.cuh"  // cp.async helpers, allow_smem_once
#include "mma_bf16.cuh"    // ldmatrix, mma.sync m16n8k16, ex2

namespace {

constexpr int kQ = 64;  // rows per chunk
constexpr int kP = 64;  // the head dim the second kernel takes
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 per shared-memory row
constexpr int kSlice = 32;  // the walks' slice of the head dim
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 r = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - r.x, b - r.y);
}

__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float2 w) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * w.x, f.y * w.y);
}

__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ the walks

template <int N>
struct WalkSmem {
  static constexpr int kUS = kSlice + kPad;
  static constexpr int kVS = N + kPad;
  static constexpr size_t kStage = 2 * (size_t)kQ * (kUS + kVS) + 4 * (size_t)kQ;
  static constexpr size_t kScan = 2 * kStage;
  static constexpr size_t bytes = kScan + 4 * (size_t)kWarps * kQ;
};

// grid (B * P / 32, H): the state slice (32 rows of P, all N) of one (b, h),
// walked forward over the chunks for S_c and in reverse for Z_c.
template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_walk_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ bm,
                    const __nv_bfloat16* __restrict__ cm, const float* __restrict__ dt,
                    const float* __restrict__ a_log, const __nv_bfloat16* __restrict__ dy,
                    const float* __restrict__ dstate, float* __restrict__ ws_s, float* __restrict__ ws_z, int T,
                    int H, int P, int G) {
  using L = WalkSmem<N>;
  constexpr int kUS = L::kUS;
  constexpr int kVS = L::kVS;
  constexpr int kWN = N / 8 / kWarps;  // n-tiles of the state per warp (each warp: all 32 rows)
  static_assert(kWN % 2 == 0, "state dim must be a multiple of 64");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int mat = lane >> 3;
  const int mrow = lane & 7;
  const int nps = P / kSlice;
  const int b = blockIdx.x / nps;
  const int p0 = (blockIdx.x - b * nps) * kSlice;
  const int h = blockIdx.y;
  const int g = h / (H / G);
  const int nc = (T + kQ - 1) / kQ;
  const float a = -expf(a_log[h]);
  const int64_t xrow = (int64_t)H * P;
  const int64_t brow = (int64_t)G * N;

  auto us = [&](int slot) { return reinterpret_cast<__nv_bfloat16*>(smem + slot * L::kStage); };
  auto vs = [&](int slot) { return us(slot) + kQ * kUS; };
  auto dts = [&](int slot) { return reinterpret_cast<float*>(smem + slot * L::kStage + 2 * (size_t)kQ * (kUS + kVS)); };
  float* vj = reinterpret_cast<float*>(smem + L::kScan) + w * kQ;

  float st[2][kWN][4];
  for (int pass = 0; pass < 2; ++pass) {
    // pass 0: S (U = x, V = B, scale w_j); pass 1: Z (U = dy, V = C, scale exp(cl_k))
    const __nv_bfloat16* ug = (pass ? dy : x) + (int64_t)b * T * xrow + (int64_t)h * P + p0;
    const __nv_bfloat16* vg = (pass ? cm : bm) + (int64_t)b * T * brow + (int64_t)g * N;
    const float* dtg = dt + (int64_t)b * T * H + h;
    float* out = (pass ? ws_z : ws_s) + (((int64_t)b * H + h) * nc) * P * N + (int64_t)p0 * N;
    auto chunk = [&](int s) { return pass ? nc - 1 - s : s; };
    auto load_stage = [&](int slot, int c) {
      const int row0 = c * kQ;
      for (int i = tid; i < kQ * (kSlice / 8); i += kThreads) {
        const int r = i / (kSlice / 8);
        const int col = (i - r * (kSlice / 8)) * 8;
        const bool ok = row0 + r < T;
        cp_async_16(us(slot) + r * kUS + col, ug + (ok ? (row0 + r) * xrow + col : 0), ok);
      }
      for (int i = tid; i < kQ * (N / 8); i += kThreads) {
        const int r = i / (N / 8);
        const int col = (i - r * (N / 8)) * 8;
        const bool ok = row0 + r < T;
        cp_async_16(vs(slot) + r * kVS + col, vg + (ok ? (row0 + r) * brow + col : 0), ok);
      }
      if (tid < kQ) {
        const bool ok = row0 + tid < T;
        cp_async_4(dts(slot) + tid, dtg + (ok ? (int64_t)(row0 + tid) * H : 0), ok);
      }
    };
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kWN; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 16 * mi + grp + (e >= 2 ? 8 : 0);
          const int n = 8 * (w * kWN + ni) + 2 * tig + (e & 1);
          st[mi][ni][e] = (pass && dstate != nullptr)
                              ? dstate[(((int64_t)b * H + h) * P + p0 + p) * N + n]
                              : 0.f;
        }
    __syncthreads();  // the last pass's ring is free
    load_stage(0, chunk(0));
    cp_async_commit();
    for (int s = 0; s < nc; ++s) {
      const int c = chunk(s);
      cp_async_wait<0>();
      __syncthreads();
      if (s + 1 < nc) load_stage((s + 1) % 2, chunk(s + 1));
      cp_async_commit();
      const __nv_bfloat16* uq = us(s % 2);
      const __nv_bfloat16* vq = vs(s % 2);
      const float* dq = dts(s % 2);

      // the state before this chunk's update: S_c (pass 0) or Z_c (pass 1)
      float* oc = out + (int64_t)c * P * N;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kWN; ++ni) {
          const int p = 16 * mi + grp;
          const int n = 8 * (w * kWN + ni) + 2 * tig;
          *reinterpret_cast<float2*>(oc + (int64_t)p * N + n) = make_float2(st[mi][ni][0], st[mi][ni][1]);
          *reinterpret_cast<float2*>(oc + (int64_t)(p + 8) * N + n) = make_float2(st[mi][ni][2], st[mi][ni][3]);
        }

      // cl over the chunk (two rows per lane), the decay and the rows' scales
      float decay;
      {
        const float2 d = reinterpret_cast<const float2*>(dq)[lane];
        const float v0 = d.x * a, v1 = d.y * a;
        float sum = v0 + v1;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, sum, o);
          if (lane >= o) sum += u;
        }
        float before = __shfl_up_sync(0xffffffffu, sum, 1);
        if (lane == 0) before = 0.f;
        const float s0 = before + v0;
        const float s1 = s0 + v1;
        const float tot = __shfl_sync(0xffffffffu, s1, 31);
        reinterpret_cast<float2*>(vj)[lane] =
            pass ? make_float2(fast_exp2(s0 * kLog2e), fast_exp2(s1 * kLog2e))
                 : make_float2(fast_exp2(fminf(tot - s0, 0.f) * kLog2e) * d.x,
                               fast_exp2(fminf(tot - s1, 0.f) * kLog2e) * d.y);
        decay = fast_exp2(tot * kLog2e);
      }
      __syncwarp();

      // state = decay state + (v o U)^T V
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kWN; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[mi][ni][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        const int j0 = 16 * kk + 2 * tig;
        const float2 v01 = reinterpret_cast<const float2*>(vj)[j0 / 2];
        const float2 v89 = reinterpret_cast<const float2*>(vj)[j0 / 2 + 4];
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // A = U^T: matrices (p 0-7, j 0-7), (p 8-15, j 0-7), (p 0-7, j 8-15), (p 8-15, j 8-15)
          ldmatrix_x4_trans(af[mi], uq + (16 * kk + (mat >> 1) * 8 + mrow) * kUS + 16 * mi + (mat & 1) * 8);
          af[mi][0] = scale_pair(af[mi][0], v01);
          af[mi][1] = scale_pair(af[mi][1], v01);
          af[mi][2] = scale_pair(af[mi][2], v89);
          af[mi][3] = scale_pair(af[mi][3], v89);
        }
#pragma unroll
        for (int ni = 0; ni < kWN; ni += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, vq + (16 * kk + (mat & 1) * 8 + mrow) * kVS + (w * kWN + ni + (mat >> 1)) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_16816(st[mi][ni], af[mi], bf[0], bf[1]);
            mma_16816(st[mi][ni + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
  }
}

// ------------------------------------------------------------ the chunks

template <int N>
struct ChunkSmem {
  static constexpr int kNS = N + kPad;   // B, C, S/Z rows (bf16)
  static constexpr int kXS = kP + kPad;  // x, dy rows (bf16)
  static constexpr int kWS = kQ + kPad;  // L o CB and L o M rows (bf16)
  static constexpr int kFS = kQ + kPad;  // C B^T rows (fp32)
  static constexpr int kAS = N + kPad;   // dB, dC accumulator rows (fp32)
  static constexpr size_t kB = 0;
  static constexpr size_t kC = kB + 2 * (size_t)kQ * kNS;
  static constexpr size_t kSZh = kC + 2 * (size_t)kQ * kNS;
  static constexpr size_t kSZl = kSZh + 2 * (size_t)kP * kNS;
  static constexpr size_t kX = kSZl + 2 * (size_t)kP * kNS;
  static constexpr size_t kDY = kX + 2 * (size_t)kQ * kXS;
  static constexpr size_t kW1h = kDY + 2 * (size_t)kQ * kXS;
  static constexpr size_t kW1l = kW1h + 2 * (size_t)kQ * kWS;
  static constexpr size_t kW2h = kW1l + 2 * (size_t)kQ * kWS;
  static constexpr size_t kW2l = kW2h + 2 * (size_t)kQ * kWS;
  static constexpr size_t kCB = kW2l + 2 * (size_t)kQ * kWS;
  static constexpr size_t kDB = kCB + 4 * (size_t)kQ * kFS;
  static constexpr size_t kDC = kDB + 4 * (size_t)kQ * kAS;
  static constexpr size_t kScal = kDC + 4 * (size_t)kQ * kAS;
  // scalars: dt, c2, rowA, e, q, s (kQ each), colA, colP (kWarps x kQ each), the warps' <Z,S> and dD
  static constexpr size_t bytes = kScal + 4 * (6 * (size_t)kQ + 2 * (size_t)kWarps * kQ + 2 * kWarps + 4);
};

// One bf16 pair (hi, lo) of four fp32 values of a P x N matrix in global
// memory, stored at row p, columns n..n+3 of `hi` / `lo`.
__device__ __forceinline__ void store_pair4(__nv_bfloat16* hi, __nv_bfloat16* lo, float4 v) {
  uint32_t h0, l0, h1, l1;
  split_bf16(v.x, v.y, h0, l0);
  split_bf16(v.z, v.w, h1, l1);
  *reinterpret_cast<uint2*>(hi) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(lo) = make_uint2(l0, l1);
}

// grid (nc, B, G): one chunk of one sequence, the group's heads in order.
template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ bm,
                     const __nv_bfloat16* __restrict__ cm, const float* __restrict__ dt,
                     const float* __restrict__ a_log, const float* __restrict__ d_skip,
                     const __nv_bfloat16* __restrict__ dy, const float* __restrict__ ws_s,
                     const float* __restrict__ ws_z, float* __restrict__ part, unsigned int* __restrict__ ticket,
                     __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ dbm, __nv_bfloat16* __restrict__ dcm,
                     float* __restrict__ ddt, float* __restrict__ da_log, float* __restrict__ dd_skip, int T, int H,
                     int G) {
  using L = ChunkSmem<N>;
  constexpr int kNS = L::kNS, kXS = L::kXS, kWS = L::kWS, kFS = L::kFS, kAS = L::kAS;
  constexpr int kNH = N / 16;  // n-tiles of dB / dC per half of N
  extern __shared__ __align__(16) unsigned char smem[];
  auto bfp = [&](size_t off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
  auto fp = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
  __nv_bfloat16 *Bs = bfp(L::kB), *Cs = bfp(L::kC), *SZh = bfp(L::kSZh), *SZl = bfp(L::kSZl);
  __nv_bfloat16 *Xs = bfp(L::kX), *DYs = bfp(L::kDY);
  __nv_bfloat16 *W1h = bfp(L::kW1h), *W1l = bfp(L::kW1l), *W2h = bfp(L::kW2h), *W2l = bfp(L::kW2l);
  float *CB = fp(L::kCB), *dBa = fp(L::kDB), *dCa = fp(L::kDC);
  float* dts = fp(L::kScal);
  float* c2 = dts + kQ;  // cl * log2(e)
  float* rowA = c2 + kQ;
  float* ev = rowA + kQ;
  float* qv = ev + kQ;
  float* sv = qv + kQ;
  float* colA = sv + kQ;  // [warp][j]
  float* colP = colA + kWarps * kQ;
  float* zsw = colP + kWarps * kQ;  // per warp: <Z, S>
  float* ddw = zsw + kWarps;        // per warp: dy.x
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int mat = lane >> 3;
  const int mrow = lane & 7;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const int nc = gridDim.x;
  const int hpg = H / G;
  const int row0 = c * kQ;
  const int rows = min(kQ, T - row0);
  const int64_t xrow = (int64_t)H * kP;
  const int64_t brow = (int64_t)G * N;
  const int ia = 16 * w + grp;  // this thread's two rows of the chunk (i in phase 1, j in phase 2)
  const int ib = ia + 8;

  // ---- the chunk's B and C, zero past T; the accumulators ----
  {
    const __nv_bfloat16* bg = bm + ((int64_t)b * T + row0) * brow + (int64_t)g * N;
    const __nv_bfloat16* cg = cm + ((int64_t)b * T + row0) * brow + (int64_t)g * N;
    for (int i = tid; i < kQ * (N / 8); i += kThreads) {
      const int r = i / (N / 8);
      const int col = (i - r * (N / 8)) * 8;
      const bool ok = r < rows;
      cp_async_16(Bs + r * kNS + col, bg + (ok ? r * brow + col : 0), ok);
      cp_async_16(Cs + r * kNS + col, cg + (ok ? r * brow + col : 0), ok);
    }
    cp_async_commit();
    for (int i = tid; i < kQ * kAS; i += kThreads) dBa[i] = dCa[i] = 0.f;
    cp_async_wait<0>();
    __syncthreads();
  }

  // ---- C B^T (fp32), rows of each warp up to its diagonal ----
  {
    float cb[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, Cs + (16 * w + (mat & 1) * 8 + mrow) * kNS + 16 * kk + (mat >> 1) * 8);
#pragma unroll
      for (int jt = 0; jt < 8; jt += 2) {
        if (jt < 2 * w + 2) {
          uint32_t bf[4];
          ldmatrix_x4(bf, Bs + ((jt + (mat >> 1)) * 8 + mrow) * kNS + 16 * kk + (mat & 1) * 8);
          mma_16816(cb[jt], af, bf[0], bf[1]);
          mma_16816(cb[jt + 1], af, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const int j = 8 * jt + 2 * tig;
      *reinterpret_cast<float2*>(CB + ia * kFS + j) = make_float2(cb[jt][0], cb[jt][1]);
      *reinterpret_cast<float2*>(CB + ib * kFS + j) = make_float2(cb[jt][2], cb[jt][3]);
    }
  }

  for (int hh = 0; hh < hpg; ++hh) {
    const int h = g * hpg + hh;
    const float a = -expf(a_log[h]);
    const float dsk = d_skip[h];
    const int64_t st_off = (((int64_t)b * H + h) * nc + c) * kP * N;

    // ---- this head's x, dy and dt (zero past T); S_c as a bf16 pair; <Z_c, S_c> ----
    {
      const __nv_bfloat16* xg = x + ((int64_t)b * T + row0) * xrow + (int64_t)h * kP;
      const __nv_bfloat16* yg = dy + ((int64_t)b * T + row0) * xrow + (int64_t)h * kP;
      for (int i = tid; i < kQ * (kP / 8); i += kThreads) {
        const int r = i / (kP / 8);
        const int col = (i - r * (kP / 8)) * 8;
        const bool ok = r < rows;
        cp_async_16(Xs + r * kXS + col, xg + (ok ? r * xrow + col : 0), ok);
        cp_async_16(DYs + r * kXS + col, yg + (ok ? r * xrow + col : 0), ok);
      }
      if (tid < kQ) {
        const bool ok = tid < rows;
        cp_async_4(dts + tid, dt + (ok ? ((int64_t)b * T + row0 + tid) * H + h : 0), ok);
      }
      cp_async_commit();
      float zs = 0.f;
      const float4* s4 = reinterpret_cast<const float4*>(ws_s + st_off);
      const float4* z4 = reinterpret_cast<const float4*>(ws_z + st_off);
      for (int i = tid; i < kP * N / 4; i += kThreads) {
        const float4 sv4 = s4[i], zv4 = z4[i];
        zs += sv4.x * zv4.x + sv4.y * zv4.y + sv4.z * zv4.z + sv4.w * zv4.w;
        const int p = (4 * i) / N;
        const int n = 4 * i - p * N;
        store_pair4(SZh + p * kNS + n, SZl + p * kNS + n, sv4);
      }
      zs = warp_sum(zs);
      if (lane == 0) zsw[w] = zs;
      cp_async_wait<0>();
      __syncthreads();
    }

    // ---- cl over the chunk (warp 0) ----
    if (w == 0) {
      const float2 d = reinterpret_cast<const float2*>(dts)[lane];
      const float v0 = d.x * a, v1 = d.y * a;
      float sum = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, sum, o);
        if (lane >= o) sum += u;
      }
      float before = __shfl_up_sync(0xffffffffu, sum, 1);
      if (lane == 0) before = 0.f;
      const float s0 = before + v0;
      reinterpret_cast<float2*>(c2)[lane] = make_float2(s0 * kLog2e, (s0 + v1) * kLog2e);
    }
    __syncthreads();

    // ---- phase 1, rows i: M = dy x^T, the chunk's weights, dC ----
    {
      float m[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, DYs + (16 * w + (mat & 1) * 8 + mrow) * kXS + 16 * kk + (mat >> 1) * 8);
#pragma unroll
        for (int jt = 0; jt < 8; jt += 2) {
          if (jt < 2 * w + 2) {
            uint32_t bf[4];
            ldmatrix_x4(bf, Xs + ((jt + (mat >> 1)) * 8 + mrow) * kXS + 16 * kk + (mat & 1) * 8);
            mma_16816(m[jt], af, bf[0], bf[1]);
            mma_16816(m[jt + 1], af, bf[2], bf[3]);
          }
        }
      }
      const float c2a = c2[ia], c2b = c2[ib];
      float ra = 0.f, rb = 0.f;
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        float w1[4], w2[4], ca[2] = {0.f, 0.f}, cp[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib;
          const int j = 8 * jt + 2 * tig + (e & 1);
          const float ex = j <= i ? fast_exp2(fminf((e < 2 ? c2a : c2b) - c2[j], 0.f)) : 0.f;
          const float cbv = CB[i * kFS + j];
          const float lv = ex * dts[j];
          w1[e] = lv * cbv;
          w2[e] = lv * m[jt][e];
          const float av = w2[e] * cbv;
          if (e < 2) ra += av; else rb += av;
          ca[e & 1] += av;
          cp[e & 1] += ex * cbv * m[jt][e];
        }
        uint32_t hi, lo;
        split_bf16(w1[0], w1[1], hi, lo);
        *reinterpret_cast<uint32_t*>(W1h + ia * kWS + 8 * jt + 2 * tig) = hi;
        *reinterpret_cast<uint32_t*>(W1l + ia * kWS + 8 * jt + 2 * tig) = lo;
        split_bf16(w1[2], w1[3], hi, lo);
        *reinterpret_cast<uint32_t*>(W1h + ib * kWS + 8 * jt + 2 * tig) = hi;
        *reinterpret_cast<uint32_t*>(W1l + ib * kWS + 8 * jt + 2 * tig) = lo;
        split_bf16(w2[0], w2[1], hi, lo);
        *reinterpret_cast<uint32_t*>(W2h + ia * kWS + 8 * jt + 2 * tig) = hi;
        *reinterpret_cast<uint32_t*>(W2l + ia * kWS + 8 * jt + 2 * tig) = lo;
        split_bf16(w2[2], w2[3], hi, lo);
        *reinterpret_cast<uint32_t*>(W2h + ib * kWS + 8 * jt + 2 * tig) = hi;
        *reinterpret_cast<uint32_t*>(W2l + ib * kWS + 8 * jt + 2 * tig) = lo;
        // columns: the sum over this warp's 16 rows (the 8 groups of the warp)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            ca[k] += __shfl_xor_sync(0xffffffffu, ca[k], o);
            cp[k] += __shfl_xor_sync(0xffffffffu, cp[k], o);
          }
        }
        if (grp == 0) {
          const int j = 8 * jt + 2 * tig;
          colA[w * kQ + j] = ca[0];
          colA[w * kQ + j + 1] = ca[1];
          colP[w * kQ + j] = cp[0];
          colP[w * kQ + j + 1] = cp[1];
        }
      }
      ra = quad_sum(ra);
      rb = quad_sum(rb);
      if (tig == 0) {
        rowA[ia] = ra;
        rowA[ib] = rb;
      }
      __syncwarp();  // this warp's rows of L o M, read back below

      // dC (rows i) += exp(cl_i) dy S_c + (L o M) B, a half of N at a time; e_i from the first term
      const float ea = fast_exp2(c2a), eb = fast_exp2(c2b);
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nb = half * kNH;
        float acc[kNH][4], tmp[kNH][4];
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          const int n = 8 * (nb + nt) + 2 * tig;
          const float2 u = *reinterpret_cast<const float2*>(dCa + ia * kAS + n);
          const float2 v = *reinterpret_cast<const float2*>(dCa + ib * kAS + n);
          acc[nt][0] = u.x, acc[nt][1] = u.y, acc[nt][2] = v.x, acc[nt][3] = v.y;
          tmp[nt][0] = tmp[nt][1] = tmp[nt][2] = tmp[nt][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, DYs + (16 * w + (mat & 1) * 8 + mrow) * kXS + 16 * kk + (mat >> 1) * 8);
#pragma unroll
          for (int nt = 0; nt < kNH; nt += 2) {
            const int o = (16 * kk + (mat & 1) * 8 + mrow) * kNS + (nb + nt + (mat >> 1)) * 8;
            uint32_t bh[4], bl[4];
            ldmatrix_x4_trans(bh, SZh + o);
            ldmatrix_x4_trans(bl, SZl + o);
            mma_16816(tmp[nt], af, bh[0], bh[1]);
            mma_16816(tmp[nt + 1], af, bh[2], bh[3]);
            mma_16816(tmp[nt], af, bl[0], bl[1]);
            mma_16816(tmp[nt + 1], af, bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          const int n = 8 * (nb + nt) + 2 * tig;
          const float2 cva = bf2(Cs + ia * kNS + n), cvb = bf2(Cs + ib * kNS + n);
          pa += cva.x * tmp[nt][0] + cva.y * tmp[nt][1];
          pb += cvb.x * tmp[nt][2] + cvb.y * tmp[nt][3];
          acc[nt][0] += ea * tmp[nt][0];
          acc[nt][1] += ea * tmp[nt][1];
          acc[nt][2] += eb * tmp[nt][2];
          acc[nt][3] += eb * tmp[nt][3];
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk > w) continue;  // warp-uniform: L o M is zero past the diagonal
          uint32_t ah[4], al[4];
          const int o = (16 * w + (mat & 1) * 8 + mrow) * kWS + 16 * kk + (mat >> 1) * 8;
          ldmatrix_x4(ah, W2h + o);
          ldmatrix_x4(al, W2l + o);
#pragma unroll
          for (int nt = 0; nt < kNH; nt += 2) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, Bs + (16 * kk + (mat & 1) * 8 + mrow) * kNS + (nb + nt + (mat >> 1)) * 8);
            mma_16816(acc[nt], ah, bf[0], bf[1]);
            mma_16816(acc[nt + 1], ah, bf[2], bf[3]);
            mma_16816(acc[nt], al, bf[0], bf[1]);
            mma_16816(acc[nt + 1], al, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          const int n = 8 * (nb + nt) + 2 * tig;
          *reinterpret_cast<float2*>(dCa + ia * kAS + n) = make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(dCa + ib * kAS + n) = make_float2(acc[nt][2], acc[nt][3]);
        }
      }
      pa = quad_sum(pa);
      pb = quad_sum(pb);
      if (tig == 0) {
        ev[ia] = ea * pa;
        ev[ib] = eb * pb;
      }
    }
    __syncthreads();  // every warp's weights; S_c read by all

    // ---- Z_c as a bf16 pair ----
    {
      const float4* z4 = reinterpret_cast<const float4*>(ws_z + st_off);
      for (int i = tid; i < kP * N / 4; i += kThreads) {
        const int p = (4 * i) / N;
        const int n = 4 * i - p * N;
        store_pair4(SZh + p * kNS + n, SZl + p * kNS + n, z4[i]);
      }
    }
    __syncthreads();

    // ---- phase 2, rows j: dx, dB ----
    {
      const float c2q = c2[kQ - 1];
      const float fa = fast_exp2(fminf(c2q - c2[ia], 0.f)), fb = fast_exp2(fminf(c2q - c2[ib], 0.f));
      const float wa = fa * dts[ia], wb = fb * dts[ib];
      float dxa[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {  // B Z^T over the state dim
        uint32_t af[4];
        ldmatrix_x4(af, Bs + (16 * w + (mat & 1) * 8 + mrow) * kNS + 16 * kk + (mat >> 1) * 8);
#pragma unroll
        for (int pt = 0; pt < 8; pt += 2) {
          const int o = ((pt + (mat >> 1)) * 8 + mrow) * kNS + 16 * kk + (mat & 1) * 8;
          uint32_t bh[4], bl[4];
          ldmatrix_x4(bh, SZh + o);
          ldmatrix_x4(bl, SZl + o);
          mma_16816(dxa[pt], af, bh[0], bh[1]);
          mma_16816(dxa[pt + 1], af, bh[2], bh[3]);
          mma_16816(dxa[pt], af, bl[0], bl[1]);
          mma_16816(dxa[pt + 1], af, bl[2], bl[3]);
        }
      }
      float qa = 0.f, qb = 0.f;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        const int p = 8 * pt + 2 * tig;
        const float2 xa = bf2(Xs + ia * kXS + p), xb = bf2(Xs + ib * kXS + p);
        qa += xa.x * dxa[pt][0] + xa.y * dxa[pt][1];
        qb += xb.x * dxa[pt][2] + xb.y * dxa[pt][3];
        dxa[pt][0] *= wa;
        dxa[pt][1] *= wa;
        dxa[pt][2] *= wb;
        dxa[pt][3] *= wb;
      }
      qa = quad_sum(qa);
      qb = quad_sum(qb);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // (L o CB)^T dy over the rows i >= j
        if (kk < w) continue;  // warp-uniform
        uint32_t ah[4], al[4];
        const int o = (16 * kk + (mat >> 1) * 8 + mrow) * kWS + 16 * w + (mat & 1) * 8;
        ldmatrix_x4_trans(ah, W1h + o);
        ldmatrix_x4_trans(al, W1l + o);
#pragma unroll
        for (int pt = 0; pt < 8; pt += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, DYs + (16 * kk + (mat & 1) * 8 + mrow) * kXS + (pt + (mat >> 1)) * 8);
          mma_16816(dxa[pt], ah, bf[0], bf[1]);
          mma_16816(dxa[pt + 1], ah, bf[2], bf[3]);
          mma_16816(dxa[pt], al, bf[0], bf[1]);
          mma_16816(dxa[pt + 1], al, bf[2], bf[3]);
        }
      }
      float dd = 0.f;
      __nv_bfloat16* dxg = dx + ((int64_t)b * T + row0) * xrow + (int64_t)h * kP;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        const int p = 8 * pt + 2 * tig;
        const float2 ya = bf2(DYs + ia * kXS + p), yb = bf2(DYs + ib * kXS + p);
        const float2 xa = bf2(Xs + ia * kXS + p), xb = bf2(Xs + ib * kXS + p);
        dd += ya.x * xa.x + ya.y * xa.y + yb.x * xb.x + yb.y * xb.y;
        if (ia < rows)
          *reinterpret_cast<uint32_t*>(dxg + ia * xrow + p) =
              pack_bf16(dxa[pt][0] + dsk * ya.x, dxa[pt][1] + dsk * ya.y);
        if (ib < rows)
          *reinterpret_cast<uint32_t*>(dxg + ib * xrow + p) =
              pack_bf16(dxa[pt][2] + dsk * yb.x, dxa[pt][3] + dsk * yb.y);
      }
      dd = warp_sum(dd);
      if (lane == 0) ddw[w] = dd;
      if (tig == 0) {
        qv[ia] = qa;
        qv[ib] = qb;
        sv[ia] = wa * qa;
        sv[ib] = wb * qb;
      }

      // dB (rows j) += w_j x Z_c + (L o M)^T C, a half of N at a time
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nb = half * kNH;
        float acc[kNH][4], tmp[kNH][4];
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          const int n = 8 * (nb + nt) + 2 * tig;
          const float2 u = *reinterpret_cast<const float2*>(dBa + ia * kAS + n);
          const float2 v = *reinterpret_cast<const float2*>(dBa + ib * kAS + n);
          acc[nt][0] = u.x, acc[nt][1] = u.y, acc[nt][2] = v.x, acc[nt][3] = v.y;
          tmp[nt][0] = tmp[nt][1] = tmp[nt][2] = tmp[nt][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, Xs + (16 * w + (mat & 1) * 8 + mrow) * kXS + 16 * kk + (mat >> 1) * 8);
#pragma unroll
          for (int nt = 0; nt < kNH; nt += 2) {
            const int o = (16 * kk + (mat & 1) * 8 + mrow) * kNS + (nb + nt + (mat >> 1)) * 8;
            uint32_t bh[4], bl[4];
            ldmatrix_x4_trans(bh, SZh + o);
            ldmatrix_x4_trans(bl, SZl + o);
            mma_16816(tmp[nt], af, bh[0], bh[1]);
            mma_16816(tmp[nt + 1], af, bh[2], bh[3]);
            mma_16816(tmp[nt], af, bl[0], bl[1]);
            mma_16816(tmp[nt + 1], af, bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          acc[nt][0] += wa * tmp[nt][0];
          acc[nt][1] += wa * tmp[nt][1];
          acc[nt][2] += wb * tmp[nt][2];
          acc[nt][3] += wb * tmp[nt][3];
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < w) continue;  // warp-uniform
          uint32_t ah[4], al[4];
          const int o = (16 * kk + (mat >> 1) * 8 + mrow) * kWS + 16 * w + (mat & 1) * 8;
          ldmatrix_x4_trans(ah, W2h + o);
          ldmatrix_x4_trans(al, W2l + o);
#pragma unroll
          for (int nt = 0; nt < kNH; nt += 2) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, Cs + (16 * kk + (mat & 1) * 8 + mrow) * kNS + (nb + nt + (mat >> 1)) * 8);
            mma_16816(acc[nt], ah, bf[0], bf[1]);
            mma_16816(acc[nt + 1], ah, bf[2], bf[3]);
            mma_16816(acc[nt], al, bf[0], bf[1]);
            mma_16816(acc[nt + 1], al, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          const int n = 8 * (nb + nt) + 2 * tig;
          *reinterpret_cast<float2*>(dBa + ia * kAS + n) = make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(dBa + ib * kAS + n) = make_float2(acc[nt][2], acc[nt][3]);
        }
      }
    }
    __syncthreads();

    // ---- phase 3 (warp 0): dcl, its reverse cumulative sum, ddt; the head's partials ----
    if (w == 0) {
      const int t0 = 2 * lane, t1 = t0 + 1;
      float d[2], cpv[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = t0 + k;
        float ca = 0.f, cp = 0.f;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) {
          ca += colA[v * kQ + t];
          cp += colP[v * kQ + t];
        }
        d[k] = rowA[t] - ca + ev[t] - sv[t];
        cpv[k] = cp;
      }
      const float s_all = warp_sum(sv[t0] + sv[t1]);
      if (lane == 31) {
        const float zs = zsw[0] + zsw[1] + zsw[2] + zsw[3];
        d[1] += fast_exp2(c2[kQ - 1]) * zs + s_all;
      }
      // R_t = sum_{t' >= t} dcl_t'
      float suf = d[0] + d[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += u;
      }
      const float r0 = suf, r1 = suf - d[0];
      const float c2q = c2[kQ - 1];
      float* ddg = ddt + ((int64_t)b * T + row0) * H + h;
      const float g0 = cpv[0] + fast_exp2(fminf(c2q - c2[t0], 0.f)) * qv[t0] + a * r0;
      const float g1 = cpv[1] + fast_exp2(fminf(c2q - c2[t1], 0.f)) * qv[t1] + a * r1;
      if (t0 < rows) ddg[(int64_t)t0 * H] = g0;
      if (t1 < rows) ddg[(int64_t)t1 * H] = g1;
      const float da = warp_sum(dts[t0] * r0 + dts[t1] * r1);
      if (lane == 0) {
        float* pp = part + (((int64_t)b * nc + c) * H + h) * 2;
        pp[0] = da;
        pp[1] = ddw[0] + ddw[1] + ddw[2] + ddw[3];
      }
    }
    __syncthreads();  // this head's buffers are free
  }

  // ---- the group's dB and dC (bf16) ----
  {
    __nv_bfloat16* dbg = dbm + ((int64_t)b * T + row0) * brow + (int64_t)g * N;
    __nv_bfloat16* dcg = dcm + ((int64_t)b * T + row0) * brow + (int64_t)g * N;
    for (int i = tid; i < kQ * (N / 2); i += kThreads) {
      const int r = i / (N / 2);
      const int n = (i - r * (N / 2)) * 2;
      if (r < rows) {
        *reinterpret_cast<uint32_t*>(dbg + r * brow + n) = pack_bf16(dBa[r * kAS + n], dBa[r * kAS + n + 1]);
        *reinterpret_cast<uint32_t*>(dcg + r * brow + n) = pack_bf16(dCa[r * kAS + n], dCa[r * kAS + n + 1]);
      }
    }
  }

  // ---- the last block to finish reduces dA_log and dD over (b, chunk), in order ----
  if (tid == 0) {
    __threadfence();  // this block's partials, before its ticket
    const unsigned int total = gridDim.x * gridDim.y * gridDim.z;
    is_last = atomicAdd(ticket, 1u) == total - 1;
  }
  __syncthreads();
  if (is_last) {
    __threadfence();
    const int nb = gridDim.y;
    for (int h = tid; h < H; h += kThreads) {
      float da = 0.f, dd = 0.f;
      for (int bb = 0; bb < nb; ++bb)
        for (int cc = 0; cc < nc; ++cc) {
          const float* pp = part + (((int64_t)bb * nc + cc) * H + h) * 2;
          da += __ldcg(pp);
          dd += __ldcg(pp + 1);
        }
      da_log[h] = -expf(a_log[h]) * da;
      dd_skip[h] = dd;
    }
  }
}

template <int N>
cudaError_t launch(const void* x, const void* bm, const void* cm, const void* dt, const void* a_log,
                   const void* d_skip, const void* dy, const void* dstate, void* ws_s, void* ws_z, void* part,
                   void* ticket, void* dx, void* dbm, void* dcm, void* ddt, void* da_log, void* dd_skip, int B, int T,
                   int H, int P, int G, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  static std::atomic<uint32_t> walk_set{0u}, chunk_set{0u};
  cudaError_t err = allow_smem_once(ssd_bwd_walk_kernel<N>, WalkSmem<N>::bytes, walk_set);
  if (err == cudaSuccess) err = allow_smem_once(ssd_bwd_chunk_kernel<N>, ChunkSmem<N>::bytes, chunk_set);
  if (err != cudaSuccess) return err;
  const int nc = (T + kQ - 1) / kQ;
  ssd_bwd_walk_kernel<N><<<dim3(B * (P / kSlice), H), kThreads, WalkSmem<N>::bytes, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(bm), static_cast<const bf*>(cm),
      static_cast<const float*>(dt), static_cast<const float*>(a_log), static_cast<const bf*>(dy),
      static_cast<const float*>(dstate), static_cast<float*>(ws_s), static_cast<float*>(ws_z), T, H, P, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<N><<<dim3(nc, B, G), kThreads, ChunkSmem<N>::bytes, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(bm), static_cast<const bf*>(cm),
      static_cast<const float*>(dt), static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<const bf*>(dy), static_cast<const float*>(ws_s), static_cast<const float*>(ws_z),
      static_cast<float*>(part), static_cast<unsigned int*>(ticket), static_cast<bf*>(dx), static_cast<bf*>(dbm),
      static_cast<bf*>(dcm), static_cast<float*>(ddt), static_cast<float*>(da_log), static_cast<float*>(dd_skip), T,
      H, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy, dx: (B, T, H, P) bf16; bm, cm, dbm, dcm: (B, T, G, N) bf16; dt, ddt:
// (B, T, H) fp32; a_log, d_skip, da_log, dd_skip: (H,) fp32; dstate: (B, H, P,
// N) fp32 or null (a zero cotangent); ws_s, ws_z: (B, H, ceil(T / 64), P, N)
// fp32 each; part: (B, ceil(T / 64), H, 2) fp32; ticket: one uint32 that is 0
// at the call. All contiguous, the bf16 ones 16-byte aligned; P = 64, N 64 or
// 128, G dividing H. Two launches on `stream`; returns a cudaError_t.
int repro_ssd_scan_bwd(const void* x, const void* bm, const void* cm, const void* dt, const void* a_log,
                       const void* d_skip, const void* dy, const void* dstate, void* ws_s, void* ws_z, void* part,
                       void* ticket, void* dx, void* dbm, void* dcm, void* ddt, void* da_log, void* dd_skip, int B,
                       int T, int H, int P, int G, int N, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535 || G <= 0 || G > 65535 || H % G != 0 || P != kP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 64:
      return (int)launch<64>(x, bm, cm, dt, a_log, d_skip, dy, dstate, ws_s, ws_z, part, ticket, dx, dbm, dcm, ddt,
                             da_log, dd_skip, B, T, H, P, G, st);
    case 128:
      return (int)launch<128>(x, bm, cm, dt, a_log, d_skip, dy, dstate, ws_s, ws_z, part, ticket, dx, dbm, dcm, ddt,
                              da_log, dd_skip, B, T, H, P, G, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
