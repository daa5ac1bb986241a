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
// (tests/test_torch_ssd_grad.py walks these formulas, and this kernel's
// split of a group's heads, on the host against the plain backward,
// kernels/ref.py: ssd_ref_bwd, and jax.vjp.)
//
// What bounds it on this card: at mamba2-370m's train shape (B = 2, T = 4096,
// H = 32, P = 64, N = 128) one call does about 31 GFLOP of 64-row products
// against 0.2 GB of inputs and outputs: 0.04 ms at the tensor cores' peak. A
// design that keeps the recomputed chunk-boundary states in device memory
// also writes and reads them once: 2 B H ceil(T/64) P N values, 134 MB in
// bf16 (268 MB in fp32) at that shape, 235 MB (470) at zamba2-7b's (H = 112,
// N = 64): 0.08 ms and 0.14 ms at 3.35 TB/s, more than the function's own
// bound. Times below: NVIDIA H100 80GB HBM3 at 700.00 W, CUDA events and
// torch.profiler. The first version (fp32 states, the chunk kernel one block of 4
// warps per (chunk, sequence, group) walking all 32 or 112 heads with 212 KB
// of shared memory: one block per SM) took 0.68 ms and 1.50 ms; its walks
// (0.20 and 0.36 ms) were bound by their fp32 state writes (~1.3 TB/s), not
// by their chains (each pass in a block of its own: -10 % and +4 %), and its
// chunk kernel (0.47 and 1.13 ms) by its 4 warps an SM: a head's phases are
// a chain of short dependent products, barriers and fp32 state loads (those
// loads alone 0.13 and 0.20 ms).
//
// What the design does about it:
//   * two kernels. The walks: one block per (b, h, slice of P, pass) walks
//     its chunks once, forward for S_c (x, B, dt) or in reverse for Z_c (dy,
//     C, dt), the state in the mma accumulators of 4 warps as the forward
//     keeps it, and writes every chunk's state rounded once to bf16 (half
//     the first version's bytes) through shared memory as whole 16-byte
//     rows. A slice holds 4096 of the state's values (32 rows of P at N =
//     128, all 64 at N = 64), so zamba2-7b's 448 walks fit the card in one
//     wave (its 896 walks of 32 rows took two: 0.29 ms, now 0.22). The
//     states are recomputed here, not stored by the forward: a transient
//     workspace of 2 B H nc P N bf16 values;
//   * the chunks: one block per (chunk, b, group, split of the group's
//     heads), 4 warps and 108 KB (N = 128) or 110 KB (N = 64) of shared
//     memory, so two blocks share an SM, and the split (chosen by the
//     wrapper, kernels/ssd_scan.py: grad_splits) makes the grid fill them:
//     256 blocks at both train shapes (0.30 and 0.56 ms, from 0.47 and
//     1.13). A block's B, C and C B^T (in registers) serve its heads; per
//     head x, dy, dt, S_c and Z_c arrive by cp.async into buffers the
//     previous head has finished with (dt double-buffered), so the loads
//     overlap the products. Each split sums its heads' dB and dC in head
//     order into an fp32 partial, each element read, added and written by
//     one thread: in shared memory at N = 64 (still two blocks an SM; the
//     call 0.79 ms at zamba2's train shape against 0.83 through device
//     memory), in device memory at N = 128 (it stays in L2); the last of a
//     chunk's splits to take an integer ticket sums the partials in split
//     order into bf16 dB and dC;
//   * every product on the tensor cores (mma.sync m16n8k16 bf16 -> fp32),
//     each operand rounded once to bf16: S_c, Z_c, L o (C B^T), L o M and
//     exp(cl) dy / w x in the walks (a single rounding keeps every gradient
//     within ~3e-3 of its max |g| at the checked shapes, host-emulated in
//     tests/test_torch_ssd_grad.py; the limit is 2e-2);
//   * per-row sums (rows and columns of A, e, s) go through shared memory and
//     one warp takes the chunk's reverse cumulative sum by shuffles in a fixed
//     order; dA_log and dD are reduced over (b, chunk) by the last block to
//     finish (an integer ticket; no floating-point atomics), in one fixed order;
//   * rows past T are zero-filled (dt = 0 there: they add nothing) and not
//     stored; every sum has one order, so equal inputs give equal bits.

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
template <int N>
__host__ __device__ constexpr int walk_slice() { return 4096 / N; }  // the walks' slice of the head dim: a block's state is 4096 values
constexpr float kLog2e = 1.4426950408889634f;

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

// Rows [0, 64) x `cols` bf16 (cols a multiple of 8) from global rows `ld`
// apart into shared rows `stride` apart, 16 bytes a copy; rows at or past
// `valid` zero-filled without reading.
__device__ __forceinline__ void load_rows(__nv_bfloat16* s, int stride, const __nv_bfloat16* g, int64_t ld,
                                          int cols, int valid, int tid) {
  const int chunks = cols / 8;
  for (int i = tid; i < kQ * chunks; i += kThreads) {
    const int r = i / chunks;
    const int col = (i - r * chunks) * 8;
    const bool ok = r < valid;
    cp_async_16(s + r * stride + col, g + (ok ? r * ld + col : 0), ok);
  }
}

// ------------------------------------------------------------ the walks

template <int N>
struct WalkSmem {
  static constexpr int kUS = walk_slice<N>() + kPad;
  static constexpr int kVS = N + kPad;
  static constexpr int kOS = N + kPad;  // the state's bf16 rows on their way out
  static constexpr size_t kStage = 2 * (size_t)kQ * (kUS + kVS) + 4 * (size_t)kQ;
  static constexpr size_t kScan = 2 * kStage;
  static constexpr size_t kOut = kScan + 4 * (size_t)kWarps * kQ;
  static constexpr size_t bytes = kOut + 2 * (size_t)walk_slice<N>() * kOS;
};

// grid (B * P / slice, H, 2): the state slice (walk_slice rows of P, all N) of one (b, h),
// walked forward over the chunks for S_c (blockIdx.z 0) or in reverse for Z_c
// (1); each chunk's state written as bf16 to ws (B, H, nc, P, N).
template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_walk_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ bm,
                    const __nv_bfloat16* __restrict__ cm, const float* __restrict__ dt,
                    const float* __restrict__ a_log, const __nv_bfloat16* __restrict__ dy,
                    const float* __restrict__ dstate, __nv_bfloat16* __restrict__ ws_s,
                    __nv_bfloat16* __restrict__ ws_z, int T, int H, int P, int G) {
  using L = WalkSmem<N>;
  constexpr int kUS = L::kUS;
  constexpr int kVS = L::kVS;
  constexpr int kOS = L::kOS;
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
  const int nps = P / walk_slice<N>();
  const int b = blockIdx.x / nps;
  const int p0 = (blockIdx.x - b * nps) * walk_slice<N>();
  const int h = blockIdx.y;
  const int pass = blockIdx.z;  // 0: S (U = x, V = B, scale w_j); 1: Z (U = dy, V = C, scale exp(cl_k))
  const int g = h / (H / G);
  const int nc = (T + kQ - 1) / kQ;
  const float a = -expf(a_log[h]);
  const int64_t xrow = (int64_t)H * P;
  const int64_t brow = (int64_t)G * N;

  auto us = [&](int slot) { return reinterpret_cast<__nv_bfloat16*>(smem + slot * L::kStage); };
  auto vs = [&](int slot) { return us(slot) + kQ * kUS; };
  auto dts = [&](int slot) { return reinterpret_cast<float*>(smem + slot * L::kStage + 2 * (size_t)kQ * (kUS + kVS)); };
  float* vj = reinterpret_cast<float*>(smem + L::kScan) + w * kQ;
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem + L::kOut);

  const __nv_bfloat16* ug = (pass ? dy : x) + (int64_t)b * T * xrow + (int64_t)h * P + p0;
  const __nv_bfloat16* vg = (pass ? cm : bm) + (int64_t)b * T * brow + (int64_t)g * N;
  const float* dtg = dt + (int64_t)b * T * H + h;
  __nv_bfloat16* out = (pass ? ws_z : ws_s) + (((int64_t)b * H + h) * nc) * P * N + (int64_t)p0 * N;
  auto chunk = [&](int s) { return pass ? nc - 1 - s : s; };
  auto load_stage = [&](int slot, int c) {
    const int row0 = c * kQ;
    for (int i = tid; i < kQ * (walk_slice<N>() / 8); i += kThreads) {
      const int r = i / (walk_slice<N>() / 8);
      const int col = (i - r * (walk_slice<N>() / 8)) * 8;
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

  float st[walk_slice<N>() / 16][kWN][4];
#pragma unroll
  for (int mi = 0; mi < walk_slice<N>() / 16; ++mi)
#pragma unroll
    for (int ni = 0; ni < kWN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * mi + grp + (e >= 2 ? 8 : 0);
        const int n = 8 * (w * kWN + ni) + 2 * tig + (e & 1);
        st[mi][ni][e] = (pass && dstate != nullptr) ? dstate[(((int64_t)b * H + h) * P + p0 + p) * N + n] : 0.f;
      }
  load_stage(0, chunk(0));
  cp_async_commit();
  for (int s = 0; s < nc; ++s) {
    const int c = chunk(s);
    cp_async_wait<0>();
    __syncthreads();  // this chunk's inputs landed; the last chunk's state rows are out
    if (s + 1 < nc) load_stage((s + 1) % 2, chunk(s + 1));
    cp_async_commit();
    const __nv_bfloat16* uq = us(s % 2);
    const __nv_bfloat16* vq = vs(s % 2);
    const float* dq = dts(s % 2);

    // the state before this chunk's update, S_c (pass 0) or Z_c (pass 1),
    // rounded once to bf16 and written as whole rows through shared memory
#pragma unroll
    for (int mi = 0; mi < walk_slice<N>() / 16; ++mi)
#pragma unroll
      for (int ni = 0; ni < kWN; ++ni) {
        const int p = 16 * mi + grp;
        const int n = 8 * (w * kWN + ni) + 2 * tig;
        *reinterpret_cast<uint32_t*>(so + p * kOS + n) = pack_bf16(st[mi][ni][0], st[mi][ni][1]);
        *reinterpret_cast<uint32_t*>(so + (p + 8) * kOS + n) = pack_bf16(st[mi][ni][2], st[mi][ni][3]);
      }
    __syncthreads();
    __nv_bfloat16* oc = out + (int64_t)c * P * N;
    for (int i = tid; i < walk_slice<N>() * (N / 8); i += kThreads) {
      const int r = i / (N / 8);
      const int col = (i - r * (N / 8)) * 8;
      *reinterpret_cast<uint4*>(oc + (int64_t)r * N + col) = *reinterpret_cast<const uint4*>(so + r * kOS + col);
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
    for (int mi = 0; mi < walk_slice<N>() / 16; ++mi)
#pragma unroll
      for (int ni = 0; ni < kWN; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[mi][ni][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      const int j0 = 16 * kk + 2 * tig;
      const float2 v01 = reinterpret_cast<const float2*>(vj)[j0 / 2];
      const float2 v89 = reinterpret_cast<const float2*>(vj)[j0 / 2 + 4];
      uint32_t af[walk_slice<N>() / 16][4];
#pragma unroll
      for (int mi = 0; mi < walk_slice<N>() / 16; ++mi) {
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
        for (int mi = 0; mi < walk_slice<N>() / 16; ++mi) {
          mma_16816(st[mi][ni], af[mi], bf[0], bf[1]);
          mma_16816(st[mi][ni + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------ the chunks

template <int N>
struct ChunkSmem {
  static constexpr int kNS = N + kPad;   // B, C, S, Z rows (bf16)
  static constexpr int kXS = kP + kPad;  // x, dy rows (bf16)
  static constexpr int kWS = kQ + kPad;  // L o CB and L o M rows (bf16)
  static constexpr size_t kB = 0;
  static constexpr size_t kC = kB + 2 * (size_t)kQ * kNS;
  static constexpr size_t kS = kC + 2 * (size_t)kQ * kNS;
  static constexpr size_t kZ = kS + 2 * (size_t)kP * kNS;
  static constexpr size_t kX = kZ + 2 * (size_t)kP * kNS;
  static constexpr size_t kDY = kX + 2 * (size_t)kQ * kXS;
  static constexpr size_t kW1 = kDY + 2 * (size_t)kQ * kXS;
  static constexpr size_t kW2 = kW1 + 2 * (size_t)kQ * kWS;
  static constexpr size_t kScal = kW2 + 2 * (size_t)kQ * kWS;
  // scalars: dt (two buffers), c2, rowA, e, q, s (kQ each), colA, colP (kWarps x kQ each), the warps' <Z,S> and dD
  // N = 64: the split's dB and dC accumulate in shared memory (rows of kAS
  // floats), and two blocks still share an SM; N = 128: in device memory
  static constexpr bool kSmemAcc = N <= 64;
  static constexpr int kAS = kSmemAcc ? N + 4 : N;
  static constexpr size_t kAcc = kScal + 4 * (7 * (size_t)kQ + 2 * (size_t)kWarps * kQ + 2 * kWarps);
  static constexpr size_t bytes = kAcc + (kSmemAcc ? 4 * 2 * (size_t)kQ * kAS : 0);
};

struct ChunkArgs {
  const __nv_bfloat16 *x, *bm, *cm, *dy, *ws_s, *ws_z;
  const float *dt, *a_log, *d_skip;
  float* part_bc;  // (n_split, B, G, nc, 2, kQ, N): each split's dB, dC
  float* part;     // (B, nc, H, 2): each head's dA_log and dD terms
  unsigned int* ticket;  // [0]: every block; [1 + tile]: a tile's splits
  __nv_bfloat16 *dx, *dbm, *dcm;
  float *ddt, *da_log, *dd_skip;
  int T, H, G, n_split;
};

// grid (nc, B, G * n_split): one chunk of one sequence, one split of a group's
// heads, in order.
template <int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_chunk_kernel(const ChunkArgs p) {
  using L = ChunkSmem<N>;
  constexpr int kNS = L::kNS, kXS = L::kXS, kWS = L::kWS;
  constexpr int kNH = N / 16;  // n-tiles of dB / dC per half of N
  extern __shared__ __align__(16) unsigned char smem[];
  auto bfp = [&](size_t off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
  __nv_bfloat16 *Bs = bfp(L::kB), *Cs = bfp(L::kC), *Ss = bfp(L::kS), *Zs = bfp(L::kZ);
  __nv_bfloat16 *Xs = bfp(L::kX), *DYs = bfp(L::kDY), *W1s = bfp(L::kW1), *W2s = bfp(L::kW2);
  float* dts = reinterpret_cast<float*>(smem + L::kScal);  // [2][kQ]
  float* c2 = dts + 2 * kQ;  // cl * log2(e)
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
  const int g = blockIdx.z / p.n_split;
  const int split = blockIdx.z - g * p.n_split;
  const int nc = gridDim.x;
  const int nb = gridDim.y;
  const int T = p.T, H = p.H, G = p.G;
  const int hpg = H / G;
  const int hps = (hpg + p.n_split - 1) / p.n_split;
  const int h_lo = g * hpg + split * hps;
  const int nh = min(hps, hpg - split * hps);
  const int row0 = c * kQ;
  const int rows = min(kQ, T - row0);
  const int64_t xrow = (int64_t)H * kP;
  const int64_t brow = (int64_t)G * N;
  const int ia = 16 * w + grp;  // this thread's two rows of the chunk (i in phases 1, j in phase 2)
  const int ib = ia + 8;
  const int tile = (b * G + g) * nc + c;
  unsigned int* ticket = p.ticket;
  float* pbc = p.part_bc + (((int64_t)split * nb * G + (int64_t)b * G + g) * nc + c) * 2 * kQ * N;  // dB, dC
  constexpr int kAS = L::kAS;
  float* accb = L::kSmemAcc ? reinterpret_cast<float*>(smem + L::kAcc) : pbc;  // this split's dB, then dC

  auto load_x = [&](int h) { load_rows(Xs, kXS, p.x + ((int64_t)b * T + row0) * xrow + (int64_t)h * kP, xrow, kP, rows, tid); };
  auto load_dy = [&](int h) { load_rows(DYs, kXS, p.dy + ((int64_t)b * T + row0) * xrow + (int64_t)h * kP, xrow, kP, rows, tid); };
  auto load_state = [&](__nv_bfloat16* s, const __nv_bfloat16* ws, int h) {
    load_rows(s, kNS, ws + (((int64_t)b * H + h) * nc + c) * kP * N, N, N, kP, tid);
  };
  auto load_dt = [&](int buf, int h) {
    if (tid < kQ) {
      const bool ok = tid < rows;
      cp_async_4(dts + buf * kQ + tid, p.dt + (ok ? ((int64_t)b * T + row0 + tid) * H + h : 0), ok);
    }
  };

  // ---- the chunk's B and C (zero past T) and the first head's inputs ----
  load_rows(Bs, kNS, p.bm + ((int64_t)b * T + row0) * brow + (int64_t)g * N, brow, N, rows, tid);
  load_rows(Cs, kNS, p.cm + ((int64_t)b * T + row0) * brow + (int64_t)g * N, brow, N, rows, tid);
  if (nh > 0) {
    load_x(h_lo);
    load_dy(h_lo);
    load_state(Ss, p.ws_s, h_lo);
    load_state(Zs, p.ws_z, h_lo);
    load_dt(0, h_lo);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- C B^T (fp32) in registers: this warp's rows i, the columns up to its diagonal ----
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

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h_lo + hh;
    const int buf = hh & 1;
    const float* dtb = dts + buf * kQ;
    const float a = -expf(p.a_log[h]);
    const float dsk = p.d_skip[h];
    if (hh > 0) {
      cp_async_wait<0>();  // this head's x, dy, dt, S_c and Z_c
      __syncthreads();
    }
    if (hh + 1 < nh) {
      load_dt(buf ^ 1, h + 1);
      cp_async_commit();
    }

    // ---- cl over the chunk (warp 0); <Z_c, S_c> (every thread, then per warp) ----
    if (w == 0) {
      const float2 d = reinterpret_cast<const float2*>(dtb)[lane];
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
    {
      float zs = 0.f;
      for (int i = tid; i < kP * (N / 8); i += kThreads) {
        const int r = i / (N / 8);
        const int col = (i - r * (N / 8)) * 8;
        const uint4 s4 = *reinterpret_cast<const uint4*>(Ss + r * kNS + col);
        const uint4 z4 = *reinterpret_cast<const uint4*>(Zs + r * kNS + col);
        const uint32_t* s2 = reinterpret_cast<const uint32_t*>(&s4);
        const uint32_t* z2 = reinterpret_cast<const uint32_t*>(&z4);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 sf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s2 + k));
          const float2 zf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(z2 + k));
          zs = fmaf(sf.x, zf.x, zs);
          zs = fmaf(sf.y, zf.y, zs);
        }
      }
      zs = warp_sum(zs);
      if (lane == 0) zsw[w] = zs;
    }
    __syncthreads();

    // ---- phase 1a, rows i: M = dy x^T, the chunk's weights (bf16) and their row and column sums ----
    const float c2a = c2[ia], c2b = c2[ib];
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
      float ra = 0.f, rb = 0.f;
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        float w1[4], w2[4], ca[2] = {0.f, 0.f}, cp[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib;
          const int j = 8 * jt + 2 * tig + (e & 1);
          const float ex = j <= i ? fast_exp2(fminf((e < 2 ? c2a : c2b) - c2[j], 0.f)) : 0.f;
          const float cbv = cb[jt][e];
          const float lv = ex * dtb[j];
          w1[e] = lv * cbv;
          w2[e] = lv * m[jt][e];
          const float av = w2[e] * cbv;
          if (e < 2) ra += av; else rb += av;
          ca[e & 1] += av;
          cp[e & 1] += ex * cbv * m[jt][e];
        }
        *reinterpret_cast<uint32_t*>(W1s + ia * kWS + 8 * jt + 2 * tig) = pack_bf16(w1[0], w1[1]);
        *reinterpret_cast<uint32_t*>(W1s + ib * kWS + 8 * jt + 2 * tig) = pack_bf16(w1[2], w1[3]);
        *reinterpret_cast<uint32_t*>(W2s + ia * kWS + 8 * jt + 2 * tig) = pack_bf16(w2[0], w2[1]);
        *reinterpret_cast<uint32_t*>(W2s + ib * kWS + 8 * jt + 2 * tig) = pack_bf16(w2[2], w2[3]);
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
    }
    __syncthreads();  // every warp's weights

    // ---- phase 2, rows j: dx; dB += w_j x Z_c + (L o M)^T C ----
    {
      const float c2q = c2[kQ - 1];
      const float fa = fast_exp2(fminf(c2q - c2[ia], 0.f)), fb = fast_exp2(fminf(c2q - c2[ib], 0.f));
      const float wa = fa * dtb[ia], wb = fb * dtb[ib];
      float dxa[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {  // B Z^T over the state dim
        uint32_t af[4];
        ldmatrix_x4(af, Bs + (16 * w + (mat & 1) * 8 + mrow) * kNS + 16 * kk + (mat >> 1) * 8);
#pragma unroll
        for (int pt = 0; pt < 8; pt += 2) {
          uint32_t bz[4];
          ldmatrix_x4(bz, Zs + ((pt + (mat >> 1)) * 8 + mrow) * kNS + 16 * kk + (mat & 1) * 8);
          mma_16816(dxa[pt], af, bz[0], bz[1]);
          mma_16816(dxa[pt + 1], af, bz[2], bz[3]);
        }
      }
      float qa = 0.f, qb = 0.f;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        const int pc = 8 * pt + 2 * tig;
        const float2 xa = bf2(Xs + ia * kXS + pc), xb = bf2(Xs + ib * kXS + pc);
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
        uint32_t aw[4];
        ldmatrix_x4_trans(aw, W1s + (16 * kk + (mat >> 1) * 8 + mrow) * kWS + 16 * w + (mat & 1) * 8);
#pragma unroll
        for (int pt = 0; pt < 8; pt += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, DYs + (16 * kk + (mat & 1) * 8 + mrow) * kXS + (pt + (mat >> 1)) * 8);
          mma_16816(dxa[pt], aw, bf[0], bf[1]);
          mma_16816(dxa[pt + 1], aw, bf[2], bf[3]);
        }
      }
      float dd = 0.f;
      __nv_bfloat16* dxg = p.dx + ((int64_t)b * T + row0) * xrow + (int64_t)h * kP;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        const int pc = 8 * pt + 2 * tig;
        const float2 ya = bf2(DYs + ia * kXS + pc), yb = bf2(DYs + ib * kXS + pc);
        const float2 xa = bf2(Xs + ia * kXS + pc), xb = bf2(Xs + ib * kXS + pc);
        dd += ya.x * xa.x + ya.y * xa.y + yb.x * xb.x + yb.y * xb.y;
        if (ia < rows)
          *reinterpret_cast<uint32_t*>(dxg + ia * xrow + pc) =
              pack_bf16(dxa[pt][0] + dsk * ya.x, dxa[pt][1] + dsk * ya.y);
        if (ib < rows)
          *reinterpret_cast<uint32_t*>(dxg + ib * xrow + pc) =
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

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nb0 = half * kNH;
        float acc[kNH][4], tmp[kNH][4];
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          const int n = 8 * (nb0 + nt) + 2 * tig;
          float2 u = make_float2(0.f, 0.f), v = u;
          if (hh > 0) {  // this split's dB so far
            u = *reinterpret_cast<const float2*>(accb + ia * kAS + n);
            v = *reinterpret_cast<const float2*>(accb + ib * kAS + n);
          }
          acc[nt][0] = u.x, acc[nt][1] = u.y, acc[nt][2] = v.x, acc[nt][3] = v.y;
          tmp[nt][0] = tmp[nt][1] = tmp[nt][2] = tmp[nt][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, Xs + (16 * w + (mat & 1) * 8 + mrow) * kXS + 16 * kk + (mat >> 1) * 8);
#pragma unroll
          for (int nt = 0; nt < kNH; nt += 2) {
            uint32_t bz[4];
            ldmatrix_x4_trans(bz, Zs + (16 * kk + (mat & 1) * 8 + mrow) * kNS + (nb0 + nt + (mat >> 1)) * 8);
            mma_16816(tmp[nt], af, bz[0], bz[1]);
            mma_16816(tmp[nt + 1], af, bz[2], bz[3]);
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
          uint32_t aw[4];
          ldmatrix_x4_trans(aw, W2s + (16 * kk + (mat >> 1) * 8 + mrow) * kWS + 16 * w + (mat & 1) * 8);
#pragma unroll
          for (int nt = 0; nt < kNH; nt += 2) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, Cs + (16 * kk + (mat & 1) * 8 + mrow) * kNS + (nb0 + nt + (mat >> 1)) * 8);
            mma_16816(acc[nt], aw, bf[0], bf[1]);
            mma_16816(acc[nt + 1], aw, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          const int n = 8 * (nb0 + nt) + 2 * tig;
          *reinterpret_cast<float2*>(accb + ia * kAS + n) = make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(accb + ib * kAS + n) = make_float2(acc[nt][2], acc[nt][3]);
        }
      }
    }
    __syncthreads();  // x and Z_c are read: the next head's go in
    if (hh + 1 < nh) {
      load_x(h + 1);
      load_state(Zs, p.ws_z, h + 1);
      cp_async_commit();
    }

    // ---- phase 1b, rows i: dC += exp(cl_i) dy S_c + (L o M) B; e_i from the first term ----
    {
      const float ea = fast_exp2(c2a), eb = fast_exp2(c2b);
      float* pc = accb + kQ * kAS;
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nb0 = half * kNH;
        float acc[kNH][4], tmp[kNH][4];
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          const int n = 8 * (nb0 + nt) + 2 * tig;
          float2 u = make_float2(0.f, 0.f), v = u;
          if (hh > 0) {  // this split's dC so far
            u = *reinterpret_cast<const float2*>(pc + ia * kAS + n);
            v = *reinterpret_cast<const float2*>(pc + ib * kAS + n);
          }
          acc[nt][0] = u.x, acc[nt][1] = u.y, acc[nt][2] = v.x, acc[nt][3] = v.y;
          tmp[nt][0] = tmp[nt][1] = tmp[nt][2] = tmp[nt][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, DYs + (16 * w + (mat & 1) * 8 + mrow) * kXS + 16 * kk + (mat >> 1) * 8);
#pragma unroll
          for (int nt = 0; nt < kNH; nt += 2) {
            uint32_t bs[4];
            ldmatrix_x4_trans(bs, Ss + (16 * kk + (mat & 1) * 8 + mrow) * kNS + (nb0 + nt + (mat >> 1)) * 8);
            mma_16816(tmp[nt], af, bs[0], bs[1]);
            mma_16816(tmp[nt + 1], af, bs[2], bs[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          const int n = 8 * (nb0 + nt) + 2 * tig;
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
          uint32_t aw[4];
          ldmatrix_x4(aw, W2s + (16 * w + (mat & 1) * 8 + mrow) * kWS + 16 * kk + (mat >> 1) * 8);
#pragma unroll
          for (int nt = 0; nt < kNH; nt += 2) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, Bs + (16 * kk + (mat & 1) * 8 + mrow) * kNS + (nb0 + nt + (mat >> 1)) * 8);
            mma_16816(acc[nt], aw, bf[0], bf[1]);
            mma_16816(acc[nt + 1], aw, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt) {
          const int n = 8 * (nb0 + nt) + 2 * tig;
          *reinterpret_cast<float2*>(pc + ia * kAS + n) = make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(pc + ib * kAS + n) = make_float2(acc[nt][2], acc[nt][3]);
        }
      }
      pa = quad_sum(pa);
      pb = quad_sum(pb);
      if (tig == 0) {
        ev[ia] = ea * pa;
        ev[ib] = eb * pb;
      }
    }
    __syncthreads();  // dy and S_c are read; every row's sums are in
    if (hh + 1 < nh) {
      load_dy(h + 1);
      load_state(Ss, p.ws_s, h + 1);
      cp_async_commit();
    }

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
      float* ddg = p.ddt + ((int64_t)b * T + row0) * H + h;
      const float g0 = cpv[0] + fast_exp2(fminf(c2q - c2[t0], 0.f)) * qv[t0] + a * r0;
      const float g1 = cpv[1] + fast_exp2(fminf(c2q - c2[t1], 0.f)) * qv[t1] + a * r1;
      if (t0 < rows) ddg[(int64_t)t0 * H] = g0;
      if (t1 < rows) ddg[(int64_t)t1 * H] = g1;
      const float da = warp_sum(dtb[t0] * r0 + dtb[t1] * r1);
      if (lane == 0) {
        float* pp = p.part + (((int64_t)b * nc + c) * H + h) * 2;
        pp[0] = da;
        pp[1] = ddw[0] + ddw[1] + ddw[2] + ddw[3];
      }
    }
  }
  __syncthreads();  // every head's partials are written
  if (L::kSmemAcc) {  // this split's sums out to its partial in device memory, as whole rows
    for (int i = tid; i < 2 * kQ * (N / 4); i += kThreads) {
      const int r = i / (N / 4), n = (i - r * (N / 4)) * 4;
      *reinterpret_cast<float4*>(pbc + r * N + n) = *reinterpret_cast<const float4*>(accb + r * kAS + n);
    }
    __syncthreads();
  }

  // ---- the last of the chunk's splits sums their dB and dC in split order (bf16 out) ----
  if (p.n_split == 1) {
    if (tid == 0) is_last = 1;
  } else if (tid == 0) {
    __threadfence();  // this split's partials, before its ticket
    is_last = atomicAdd(ticket + 1 + tile, 1u) == (unsigned int)p.n_split - 1;
  }
  __syncthreads();
  if (is_last) {
    __threadfence();
    __nv_bfloat16* dbg = p.dbm + ((int64_t)b * T + row0) * brow + (int64_t)g * N;
    __nv_bfloat16* dcg = p.dcm + ((int64_t)b * T + row0) * brow + (int64_t)g * N;
    const int64_t split_stride = (int64_t)nb * G * nc * 2 * kQ * N;
    const float* first = p.part_bc + (((int64_t)b * G + g) * nc + c) * 2 * kQ * N;
    for (int i = tid; i < 2 * kQ * (N / 4); i += kThreads) {
      const int which = i / (kQ * (N / 4));  // 0: dB, 1: dC
      const int rest = i - which * (kQ * (N / 4));
      const int r = rest / (N / 4);
      const int n = (rest - r * (N / 4)) * 4;
      if (r >= rows) continue;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp = 0; sp < p.n_split; ++sp) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(first + sp * split_stride + which * kQ * N + r * N + n));
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      *reinterpret_cast<uint2*>((which ? dcg : dbg) + r * brow + n) =
          make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
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
    for (int hd = tid; hd < H; hd += kThreads) {
      float da = 0.f, dd = 0.f;
      for (int bb = 0; bb < nb; ++bb)
        for (int cc = 0; cc < nc; ++cc) {
          const float* pp = p.part + (((int64_t)bb * nc + cc) * H + hd) * 2;
          da += __ldcg(pp);
          dd += __ldcg(pp + 1);
        }
      p.da_log[hd] = -expf(p.a_log[hd]) * da;
      p.dd_skip[hd] = dd;
    }
  }
}

template <int N>
cudaError_t launch(const void* x, const void* bm, const void* cm, const void* dt, const void* a_log,
                   const void* d_skip, const void* dy, const void* dstate, void* ws_s, void* ws_z, void* part_bc,
                   void* part, void* ticket, void* dx, void* dbm, void* dcm, void* ddt, void* da_log, void* dd_skip,
                   int B, int T, int H, int P, int G, int n_split, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  static std::atomic<uint32_t> walk_set{0u}, chunk_set{0u};
  cudaError_t err = allow_smem_once(ssd_bwd_walk_kernel<N>, WalkSmem<N>::bytes, walk_set);
  if (err == cudaSuccess) err = allow_smem_once(ssd_bwd_chunk_kernel<N>, ChunkSmem<N>::bytes, chunk_set);
  if (err != cudaSuccess) return err;
  const int nc = (T + kQ - 1) / kQ;
  ssd_bwd_walk_kernel<N><<<dim3(B * (P / walk_slice<N>()), H, 2), kThreads, WalkSmem<N>::bytes, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(bm), static_cast<const bf*>(cm),
      static_cast<const float*>(dt), static_cast<const float*>(a_log), static_cast<const bf*>(dy),
      static_cast<const float*>(dstate), static_cast<bf*>(ws_s), static_cast<bf*>(ws_z), T, H, P, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const ChunkArgs args{static_cast<const bf*>(x), static_cast<const bf*>(bm), static_cast<const bf*>(cm),
                       static_cast<const bf*>(dy), static_cast<const bf*>(ws_s), static_cast<const bf*>(ws_z),
                       static_cast<const float*>(dt), static_cast<const float*>(a_log),
                       static_cast<const float*>(d_skip), static_cast<float*>(part_bc), static_cast<float*>(part),
                       static_cast<unsigned int*>(ticket), static_cast<bf*>(dx), static_cast<bf*>(dbm),
                       static_cast<bf*>(dcm), static_cast<float*>(ddt), static_cast<float*>(da_log),
                       static_cast<float*>(dd_skip), T, H, G, n_split};
  ssd_bwd_chunk_kernel<N><<<dim3(nc, B, G * n_split), kThreads, ChunkSmem<N>::bytes, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy, dx: (B, T, H, P) bf16; bm, cm, dbm, dcm: (B, T, G, N) bf16; dt, ddt:
// (B, T, H) fp32; a_log, d_skip, da_log, dd_skip: (H,) fp32; dstate: (B, H, P,
// N) fp32 or null (a zero cotangent); ws_s, ws_z: (B, H, ceil(T / 64), P, N)
// bf16 each; part_bc: (n_split, B, G, ceil(T / 64), 2, 64, N) fp32; part: (B,
// ceil(T / 64), H, 2) fp32; ticket: 1 + ceil(T / 64) B G uint32 that are 0 at
// the call. All contiguous, the bf16 ones 16-byte aligned; P = 64, N 64 or
// 128, G dividing H, n_split in [1, H / G] with every split holding a head.
// Two launches on `stream`; returns a cudaError_t.
int repro_ssd_scan_bwd(const void* x, const void* bm, const void* cm, const void* dt, const void* a_log,
                       const void* d_skip, const void* dy, const void* dstate, void* ws_s, void* ws_z, void* part_bc,
                       void* part, void* ticket, void* dx, void* dbm, void* dcm, void* ddt, void* da_log,
                       void* dd_skip, int B, int T, int H, int P, int G, int N, int n_split, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535 || G <= 0 || H % G != 0 || P != kP || n_split < 1 ||
      n_split > H / G || (int64_t)G * n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const int hps = (H / G + n_split - 1) / n_split;
  if ((n_split - 1) * hps >= H / G) return (int)cudaErrorInvalidValue;  // an empty split
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 64:
      return (int)launch<64>(x, bm, cm, dt, a_log, d_skip, dy, dstate, ws_s, ws_z, part_bc, part, ticket, dx, dbm,
                             dcm, ddt, da_log, dd_skip, B, T, H, P, G, n_split, st);
    case 128:
      return (int)launch<128>(x, bm, cm, dt, a_log, d_skip, dy, dstate, ws_s, ws_z, part_bc, part, ticket, dx, dbm,
                              dcm, ddt, da_log, dd_skip, B, T, H, P, G, n_split, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
