// K6 — the Mamba-2 SSD chunked scan (state-space duality), forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py :: ssd_scan / _ssd_kernel (the Pallas
// TPU kernel behind every SSM layer's prefill, models/ssm.py: ssd_chunked).
// Unlike it, this kernel also writes the final state, so the model needs no
// second pass for it.
//
// What it computes, per (batch b, head h), over t = 0 .. T-1:
//   state_t = exp(dt_t * a) * state_{t-1} + dt_t * x_t B_t^T      (P x N, fp32)
//   y_t     = C_t state_t^T + D * x_t,   a = -exp(A_log[h])
// with B and C of group h / (H / G). The dual form evaluates it chunk by
// chunk: inside a chunk of Q rows, y_intra = (L o C B^T) x with
// L[i][j] = exp(cum_i - cum_j) * dt_j for j <= i (cum the chunk's running
// sum of dt * a); the rows before the chunk enter through the carried state,
// y_inter[i] = exp(cum_i) C_i state^T, and the state moves on by
// state' = exp(cum_Q) state + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T.
//
// What bounds it on this card: at the serving shapes (B = 1, T = 300;
// mamba2-370m H = 32, P = 64, N = 128; zamba2-7b H = 112, P = 64, N = 64) one
// call reads x, B, C, dt and writes y and the final state, 3.7-10.6 MB, and
// does 0.5-1.1 GFLOP of dual-form products at the kernel's chunk of 64:
// about 1-3 us either way, bytes and tensor-core operations alike. What sets
// the time of a call this small is the longest chain of dependent steps in
// one block: a sequence's chunks depend on each other through the state, and
// the first version of this kernel walked all of them in series on the CUDA
// cores with 64 blocks on 132 SMs.
//
// What the design does about it:
//   * grid (B * P / PS, H, R), 128 threads, one head per block: R =
//     min(8, ceil(T/64)) ranks split the sequence's chunks into contiguous
//     runs (rank r takes chunks [r * n / R, (r + 1) * n / R) of n), so the
//     chunks' outputs are computed in parallel; a block owns a PS-wide slice
//     of the head dim (PS = 64 where P is a multiple of 64, else 32); the
//     last ranks, whose chains are longest, are issued first (blockIdx.z
//     reversed), and the short ones fill in behind them;
//   * the carried state is not passed between blocks: rank r re-walks the
//     state recurrence over the chunks before its run itself (x, B and dt
//     only: no C, no outputs), then computes its own chunks. A thread-block
//     cluster could pass it through distributed shared memory instead, but
//     a block reads a peer's shared memory at about 28 GB/s
//     (src/repro_torch/kernels/probes/dsmem_rate.cu, NVIDIA H100 80GB HBM3 at
//     700.00 W), so one 32 KB fp32 state takes about 1.2 us a hop, more than
//     a chunk's state update here; a variant built that way was slower at
//     every shape. The R <= 8 runs keep the total work linear in T (each
//     chunk's update is redone by at most 7 later ranks) and need no global
//     workspace;
//   * the state stays fp32, in the mma accumulators of the block's 4 warps
//     (each holds 2 m-tiles of the head-dim rows by a range of the state's
//     columns), decayed and updated in place: state = exp(cum_Q) state +
//     (w o x)^T B on the tensor cores (mma.sync m16n8k16 bf16 -> fp32; x
//     scaled by w_j = exp(cum_Q - cum_j) dt_j in the fragment and rounded to
//     bf16);
//   * C B^T is computed once per chunk and slice on the tensor cores, only
//     the column tiles at or below each warp's diagonal, and scaled by the
//     head's decay matrix L, masked before exp (exp is evaluated only where
//     its exponent is <= 0: above the diagonal cum_i - cum_j is positive and
//     could overflow). Sharing it between two heads of a group (one 4-warp
//     quad each, 8 warps a block) was built and measured slower at every
//     shape: it halves the blocks, and a block's chain, not the products,
//     sets the time; with G = 1 the heads' blocks on an SM share B and C
//     through L1 instead (cp.async.ca);
//   * L o (C B^T) multiplies x, and C multiplies the state (y_inter =
//     exp(cum_i) C_i state^T, in the same pass over N as C B^T), each as a
//     pair of bf16 products, hi + lo (about 16 significant bits). Rounded
//     once to bf16, as the attention kernels round P, L o (C B^T) (entries
//     near dt_i C_i.B_i, up to about 10 at unit-scale inputs) put 2-7 of the
//     0.6-3.7 million outputs of the serve shapes' unit-scale cases beyond
//     the 2e-2 tolerance; tests/test_torch_ssd_split.py emulates the
//     rounding on the host and finds the same;
//   * the chunk's x, B and dt come through a 2-stage cp.async ring (C,
//     needed only for a rank's own chunks, through one buffer refilled
//     behind each own chunk's outputs), so the next chunk is in flight while
//     this one is computed; every warp scans the chunk's dt itself, so a
//     chunk costs one block barrier (two on own chunks);
//   * the last rank writes the final state (B, H, P, N) in fp32;
//   * any T: the last chunk is partial; its rows past T are zero-filled (dt
//     = 0 there, so they add nothing to y or to the state) and not stored;
//   * every sum is taken in one fixed order, so equal inputs give equal bits.
// Shared-memory rows are padded by 8 bf16 so ldmatrix is bank-conflict free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "async_copy.cuh"  // cp.async helpers, allow_smem_once
#include "mma_bf16.cuh"    // ldmatrix, mma.sync m16n8k16, ex2

namespace {

constexpr int kQ = 64;          // rows per chunk
constexpr int kMaxRanks = 8;    // blocks along one sequence's chunks
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;      // x / B / dt ring: chunk c + 1 lands while chunk c is computed
constexpr int kPad = 8;         // bf16 padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block: the ring of (x, B, dt), the C tile, the state
// as a bf16 pair (hi, lo) for y_inter, and each warp's scan.
template <int N, int PS>
struct Smem {
  static constexpr int kXS = PS + kPad;  // x row stride (bf16)
  static constexpr int kNS = N + kPad;   // B, C and state row stride (bf16)
  static constexpr int kXTile = kQ * kXS;
  static constexpr int kBTile = kQ * kNS;
  static constexpr size_t kStage = 2 * (size_t)(kXTile + kBTile) + 4 * (size_t)kQ;
  static constexpr size_t kC = kStages * kStage;
  static constexpr size_t kS = kC + 2 * (size_t)kBTile;
  static constexpr size_t kScan = kS + 2 * 2 * (size_t)PS * kNS;
  static constexpr size_t bytes = kScan + 4 * (size_t)kWarps * 2 * kQ;
};

// Two floats as a bf16 pair `hi` and the bf16 pair of what it leaves, `lo`:
// hi + lo carries about 16 significant bits.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 r = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - r.x, b - r.y);
}

// A bf16 pair scaled by two floats, rounded back to bf16.
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float2 w) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * w.x, f.y * w.y);
}

template <int N, int PS>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ bm,
                const __nv_bfloat16* __restrict__ cm, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ d_skip,
                __nv_bfloat16* __restrict__ y, float* __restrict__ state, int T, int H, int P, int G) {
  using L = Smem<N, PS>;
  constexpr int kXS = L::kXS;
  constexpr int kNS = L::kNS;
  constexpr int kPT = PS / 8;               // y: a warp's 16 rows x all PS columns, in n-tiles of 8
  constexpr int kWarpsM = PS / 32;          // state: warps along the head dim (2 m-tiles each) ...
  constexpr int kWarpsN = kWarps / kWarpsM;  // ... and along the state columns
  constexpr int kWN = N / 8 / kWarpsN;      // state n-tiles per warp
  static_assert(PS == 32 || PS == 64, "head-dim slice of 32 or 64");
  static_assert(N % 64 == 0 && kWN % 2 == 0, "state dim must be a multiple of 64");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem + L::kC);
  __nv_bfloat16* Sh = reinterpret_cast<__nv_bfloat16*>(smem + L::kS);  // [PS][kNS] state, bf16 hi
  __nv_bfloat16* Sl = Sh + PS * kNS;                                     // ... and lo
  const int tid = threadIdx.x;
  const int w = tid >> 5;      // y: rows [16w, 16w + 16) of the chunk
  const int lane = tid & 31;
  const int wm = w % kWarpsM;  // state: m-tiles 2 wm, 2 wm + 1 ...
  const int wn = w / kWarpsM;  // ... and n-tiles [wn kWN, wn kWN + kWN)
  const int grp = lane >> 2;   // row within the 8-row half of a fragment
  const int tig = lane & 3;    // thread in group: column pair
  const int mat = lane >> 3;   // ldmatrix: the 8x8 matrix this lane addresses
  const int mrow = lane & 7;   // ... and its row within it

  const int ranks = gridDim.z;
  const int rank = ranks - 1 - blockIdx.z;  // the longest runs (the last ranks) are issued first
  const int h = blockIdx.y;
  const int nps = P / PS;
  const int b = blockIdx.x / nps;
  const int p0 = (blockIdx.x - b * nps) * PS;
  const int g = h / (H / G);
  const int nc = (T + kQ - 1) / kQ;
  const int c_begin = rank * nc / ranks;
  const int c_end = (rank + 1) * nc / ranks;
  const bool last_rank = rank == ranks - 1;
  const float a = -expf(a_log[h]);
  const float dskip = d_skip[h];

  const int64_t xrow = (int64_t)H * P;  // elements between tokens in x / y
  const int64_t brow = (int64_t)G * N;  // ... in B / C
  const __nv_bfloat16* xg = x + (int64_t)b * T * xrow + (int64_t)h * P + p0;
  const __nv_bfloat16* bg = bm + (int64_t)b * T * brow + (int64_t)g * N;
  const __nv_bfloat16* cg = cm + (int64_t)b * T * brow + (int64_t)g * N;
  const float* dtg = dt + (int64_t)b * T * H + h;

  auto xs = [&](int slot) { return reinterpret_cast<__nv_bfloat16*>(smem + slot * L::kStage); };
  auto bs = [&](int slot) { return xs(slot) + L::kXTile; };
  auto dts = [&](int slot) { return reinterpret_cast<float*>(smem + slot * L::kStage + 2 * (L::kXTile + L::kBTile)); };
  auto rows_of = [&](int c) { return min(kQ, T - c * kQ); };

  // chunk c's x (this block's PS columns), B and dt into ring slot `slot`;
  // rows past T are zero-filled. B and C rows go through L1: the blocks of
  // the group's other heads on this SM read the same rows
  auto load_stage = [&](int slot, int c) {
    const int row0 = c * kQ;
    constexpr int kXC = PS / 8;  // 16-byte chunks per x row
    for (int i = tid; i < kQ * kXC; i += kThreads) {
      const int r = i / kXC;
      const int col = (i - r * kXC) * 8;
      const bool ok = row0 + r < T;
      cp_async_16(xs(slot) + r * kXS + col, xg + (ok ? (row0 + r) * xrow + col : 0), ok);
    }
    for (int i = tid; i < kQ * (N / 8); i += kThreads) {
      const int r = i / (N / 8);
      const int col = (i - r * (N / 8)) * 8;
      const bool ok = row0 + r < T;
      cp_async_16_ca(bs(slot) + r * kNS + col, bg + (ok ? (row0 + r) * brow + col : 0), ok);
    }
    if (tid < kQ) {
      const bool ok = row0 + tid < T;
      cp_async_4(dts(slot) + tid, dtg + (ok ? (int64_t)(row0 + tid) * H : 0), ok);
    }
  };
  auto load_c = [&](int c) {
    const int row0 = c * kQ;
    for (int i = tid; i < kQ * (N / 8); i += kThreads) {
      const int r = i / (N / 8);
      const int col = (i - r * (N / 8)) * 8;
      const bool ok = row0 + r < T;
      cp_async_16_ca(Cs + r * kNS + col, cg + (ok ? (row0 + r) * brow + col : 0), ok);
    }
  };

  // the state rows [p0, p0 + PS) of head h, fp32, in this warp's mma accumulators
  float st[2][kWN][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kWN; ++ni) st[mi][ni][0] = st[mi][ni][1] = st[mi][ni][2] = st[mi][ni][3] = 0.f;

  load_c(c_begin);  // joins the first group
  load_stage(0, 0);
  cp_async_commit();

  float* c2 = reinterpret_cast<float*>(smem + L::kScan) + w * 2 * kQ;  // cum_i * log2(e)
  float* wj = c2 + kQ;                                                  // exp(cum_Q - cum_j) dt_j
  for (int c = 0; c < c_end; ++c) {
    cp_async_wait<0>();  // chunk c (and C where it is own) landed: this thread's copies
    __syncthreads();     // ... everyone's; the slot of chunk c - 1 is free
    if (c + 1 < c_end) load_stage((c + 1) % kStages, c + 1);
    cp_async_commit();
    const int slot = c % kStages;
    const __nv_bfloat16* xq = xs(slot);
    const __nv_bfloat16* bq = bs(slot);
    const float* dq = dts(slot);
    const int row0 = c * kQ;
    const bool own = c >= c_begin;

    // ---- cum: every warp scans the chunk's dt * a itself (two rows per lane) ----
    float decay;  // exp(cum_Q)
    {
      const float2 d = reinterpret_cast<const float2*>(dq)[lane];
      const float v0 = d.x * a, v1 = d.y * a;
      float s = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += u;
      }
      float before = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) before = 0.f;
      const float s0 = before + v0;
      const float s1 = s0 + v1;
      const float tot = __shfl_sync(0xffffffffu, s1, 31);  // cum_Q
      reinterpret_cast<float2*>(c2)[lane] = make_float2(s0 * kLog2e, s1 * kLog2e);
      // exponents cum_Q - cum_j <= 0: only underflow is possible
      reinterpret_cast<float2*>(wj)[lane] = make_float2(fast_exp2(fminf(tot - s0, 0.f) * kLog2e) * d.x,
                                                        fast_exp2(fminf(tot - s1, 0.f) * kLog2e) * d.y);
      decay = fast_exp2(tot * kLog2e);
    }
    __syncwarp();

    if (own) {
      // ---- the state as a bf16 pair (hi, lo), this warp's tiles, for y_inter ----
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kWN; ++ni)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int o = (16 * (2 * wm + mi) + grp + (e ? 8 : 0)) * kNS + 8 * (wn * kWN + ni) + 2 * tig;
            uint32_t hi, lo;
            split_bf16(st[mi][ni][e], st[mi][ni][e + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(Sh + o) = hi;
            *reinterpret_cast<uint32_t*>(Sl + o) = lo;
          }
      __syncthreads();  // every warp's state tiles

      // ---- C B^T (rows 16w.., column tiles up to the diagonal) and C state^T, one pass over N ----
      const bool inter = c > 0;  // the carried state is zero before chunk 0
      const int jt_end = 2 * w + 2;
      float cb[8][4];
      float ya[kPT][4];
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) cb[jt][0] = cb[jt][1] = cb[jt][2] = cb[jt][3] = 0.f;
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt) ya[pt][0] = ya[pt][1] = ya[pt][2] = ya[pt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        // matrices: (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
        uint32_t af[4];
        ldmatrix_x4(af, Cs + (16 * w + (mat & 1) * 8 + mrow) * kNS + 16 * kk + (mat >> 1) * 8);
#pragma unroll
        for (int jt = 0; jt < 8; jt += 2) {
          if (jt < jt_end) {
            uint32_t bf[4];
            ldmatrix_x4(bf, bq + ((jt + (mat >> 1)) * 8 + mrow) * kNS + 16 * kk + (mat & 1) * 8);
            mma_16816(cb[jt], af, bf[0], bf[1]);
            mma_16816(cb[jt + 1], af, bf[2], bf[3]);
          }
        }
        if (inter) {
#pragma unroll
          for (int pt = 0; pt < kPT; pt += 2) {
            const int o = ((pt + (mat >> 1)) * 8 + mrow) * kNS + 16 * kk + (mat & 1) * 8;
            uint32_t bh[4], bl[4];
            ldmatrix_x4(bh, Sh + o);
            ldmatrix_x4(bl, Sl + o);
            mma_16816(ya[pt], af, bh[0], bh[1]);
            mma_16816(ya[pt + 1], af, bh[2], bh[3]);
            mma_16816(ya[pt], af, bl[0], bl[1]);
            mma_16816(ya[pt + 1], af, bl[2], bl[3]);
          }
        }
      }

      // ---- y = exp(cum_i) C state^T + (L o C B^T) x + D x ----
      const int ia = 16 * w + grp;  // this thread's two rows of the chunk
      const int ib = ia + 8;
      const float c2a = c2[ia], c2b = c2[ib];
      if (inter) {
        const float ea = fast_exp2(c2a), eb = fast_exp2(c2b);  // exponents <= 0
#pragma unroll
        for (int pt = 0; pt < kPT; ++pt) {
          ya[pt][0] *= ea;
          ya[pt][1] *= ea;
          ya[pt][2] *= eb;
          ya[pt][3] *= eb;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > w) continue;  // warp-uniform: columns past the diagonal tile
        const bool diag = kk == w;
        const int j0 = 16 * kk + 2 * tig;
        const float2 cj = reinterpret_cast<const float2*>(c2)[j0 / 2];
        const float2 cj8 = reinterpret_cast<const float2*>(c2)[j0 / 2 + 4];
        const float2 dj = reinterpret_cast<const float2*>(dq)[j0 / 2];
        const float2 dj8 = reinterpret_cast<const float2*>(dq)[j0 / 2 + 4];
        // L o C B^T at (row i, column j): masked before exp
        auto m = [&](float v, float c2i, float c2j, float dtj, int i, int j) {
          return diag && j > i ? 0.f : v * fast_exp2(fminf(c2i - c2j, 0.f)) * dtj;
        };
        uint32_t ph[4], pl[4];  // L o C B^T as a bf16 pair (hi, lo)
        split_bf16(m(cb[2 * kk][0], c2a, cj.x, dj.x, ia, j0), m(cb[2 * kk][1], c2a, cj.y, dj.y, ia, j0 + 1), ph[0],
                   pl[0]);
        split_bf16(m(cb[2 * kk][2], c2b, cj.x, dj.x, ib, j0), m(cb[2 * kk][3], c2b, cj.y, dj.y, ib, j0 + 1), ph[1],
                   pl[1]);
        split_bf16(m(cb[2 * kk + 1][0], c2a, cj8.x, dj8.x, ia, j0 + 8),
                   m(cb[2 * kk + 1][1], c2a, cj8.y, dj8.y, ia, j0 + 9), ph[2], pl[2]);
        split_bf16(m(cb[2 * kk + 1][2], c2b, cj8.x, dj8.x, ib, j0 + 8),
                   m(cb[2 * kk + 1][3], c2b, cj8.y, dj8.y, ib, j0 + 9), ph[3], pl[3]);
#pragma unroll
        for (int pt = 0; pt < kPT; pt += 2) {
          // matrices: (rows j 0-7, cols pt), (8-15, pt), (0-7, pt + 1), (8-15, pt + 1)
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, xq + (16 * kk + (mat & 1) * 8 + mrow) * kXS + (pt + (mat >> 1)) * 8);
          mma_16816(ya[pt], ph, bf[0], bf[1]);
          mma_16816(ya[pt + 1], ph, bf[2], bf[3]);
          mma_16816(ya[pt], pl, bf[0], bf[1]);
          mma_16816(ya[pt + 1], pl, bf[2], bf[3]);
        }
      }
      const int rows = rows_of(c);
      __nv_bfloat16* yq = y + ((int64_t)b * T + row0) * xrow + (int64_t)h * P + p0;
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt) {
        const int p = 8 * pt + 2 * tig;
        if (ia < rows) {
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xq + ia * kXS + p));
          *reinterpret_cast<uint32_t*>(yq + ia * xrow + p) =
              pack_bf16(ya[pt][0] + dskip * xv.x, ya[pt][1] + dskip * xv.y);
        }
        if (ib < rows) {
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xq + ib * kXS + p));
          *reinterpret_cast<uint32_t*>(yq + ib * xrow + p) =
              pack_bf16(ya[pt][2] + dskip * xv.x, ya[pt][3] + dskip * xv.y);
        }
      }
      if (c + 1 < c_end) {  // the next own chunk's C, behind this one's outputs
        __syncthreads();    // every warp is done with C and the state pair
        load_c(c + 1);
        cp_async_commit();
      }
    }

    // ---- state = exp(cum_Q) state + (w o x)^T B (not after a non-last rank's last chunk) ----
    if (c + 1 < c_end || last_rank) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kWN; ++ni) {
          st[mi][ni][0] *= decay;
          st[mi][ni][1] *= decay;
          st[mi][ni][2] *= decay;
          st[mi][ni][3] *= decay;
        }
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        const int j0 = 16 * kk + 2 * tig;
        const float2 w01 = reinterpret_cast<const float2*>(wj)[j0 / 2];
        const float2 w89 = reinterpret_cast<const float2*>(wj)[j0 / 2 + 4];
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // A = x^T: matrices (p 0-7, j 0-7), (p 8-15, j 0-7), (p 0-7, j 8-15), (p 8-15, j 8-15)
          ldmatrix_x4_trans(af[mi], xq + (16 * kk + (mat >> 1) * 8 + mrow) * kXS + 16 * (2 * wm + mi) + (mat & 1) * 8);
          af[mi][0] = scale_pair(af[mi][0], w01);
          af[mi][1] = scale_pair(af[mi][1], w01);
          af[mi][2] = scale_pair(af[mi][2], w89);
          af[mi][3] = scale_pair(af[mi][3], w89);
        }
#pragma unroll
        for (int ni = 0; ni < kWN; ni += 2) {
          // B = B rows j: matrices (j 0-7, n), (8-15, n), (0-7, n + 1), (8-15, n + 1)
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, bq + (16 * kk + (mat & 1) * 8 + mrow) * kNS + (wn * kWN + ni + (mat >> 1)) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_16816(st[mi][ni], af[mi], bf[0], bf[1]);
            mma_16816(st[mi][ni + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy is left in flight

  if (last_rank) {  // the final state (B, H, P, N), fp32
    float* sg = state + (((int64_t)b * H + h) * P + p0) * N;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kWN; ++ni) {
        const int p = 16 * (2 * wm + mi) + grp;
        const int n = 8 * (wn * kWN + ni) + 2 * tig;
        *reinterpret_cast<float2*>(sg + (int64_t)p * N + n) = make_float2(st[mi][ni][0], st[mi][ni][1]);
        *reinterpret_cast<float2*>(sg + (int64_t)(p + 8) * N + n) = make_float2(st[mi][ni][2], st[mi][ni][3]);
      }
  }
}

template <int N, int PS>
cudaError_t launch(const void* x, const void* bm, const void* cm, const void* dt, const void* a_log,
                   const void* d_skip, void* y, void* state, int B, int T, int H, int P, int G,
                   cudaStream_t stream) {
  static std::atomic<uint32_t> smem_set{0u};
  constexpr size_t smem = Smem<N, PS>::bytes;
  cudaError_t err = allow_smem_once(ssd_scan_kernel<N, PS>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int nc = (T + kQ - 1) / kQ;
  const dim3 grid(B * (P / PS), H, nc < kMaxRanks ? nc : kMaxRanks);
  ssd_scan_kernel<N, PS><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(state), T, H, P, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (B, T, H, P) bf16; bm, cm: (B, T, G, N) bf16; dt: (B, T, H) fp32;
// a_log, d_skip: (H,) fp32; state: (B, H, P, N) fp32, written with the final
// state; all contiguous, the bf16 ones 16-byte aligned; P a multiple of 32,
// N 64 or 128, G dividing H. Returns a cudaError_t (0 on a successful launch).
int repro_ssd_scan_fwd(const void* x, const void* bm, const void* cm, const void* dt,
                       const void* a_log, const void* d_skip, void* y, void* state, int B, int T, int H,
                       int P, int G, int N, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P % 32 != 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = P % 64 == 0;  // head-dim slices of 64, else of 32
  switch (N) {
    case 64:
      return (int)(wide ? launch<64, 64>(x, bm, cm, dt, a_log, d_skip, y, state, B, T, H, P, G, st)
                        : launch<64, 32>(x, bm, cm, dt, a_log, d_skip, y, state, B, T, H, P, G, st));
    case 128:
      return (int)(wide ? launch<128, 64>(x, bm, cm, dt, a_log, d_skip, y, state, B, T, H, P, G, st)
                        : launch<128, 32>(x, bm, cm, dt, a_log, d_skip, y, state, B, T, H, P, G, st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
