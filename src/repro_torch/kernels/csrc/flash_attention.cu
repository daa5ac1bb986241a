// K3 — causal / non-causal GQA flash attention, forward, for Hopper (sm_90a);
// its gradient is csrc/flash_attention_bwd.cu.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention / _flash_kernel
// (the Pallas TPU kernel behind the dense prompt prefill, models/attention.py).
//
// What bounds it on this card: at the serving chain's prompt shapes (B = 1,
// T = S = 300, 32 query heads over 8 kv heads, head dim 64, causal) one call
// does 0.37 GFLOP over 3.1 MB of q, k, v and output: about 120 flop per
// byte, below the H100's ~295 flop/byte ridge, so its bound is the bytes
// (under a microsecond; zamba2's shared block, 32/32 heads of 112, 2.6 us).
// A call this small is in practice bound by latency: all ceil(T/64) * B * H
// blocks are resident at once, so the call lasts as long as its heaviest
// block, the last causal query tile, which sweeps ceil(T/64) kv tiles in
// series. The design shortens that sweep's per-tile critical path.
//
// What the design does about it: the sweep of csrc/flash_sweep.cuh (shared
// with K2, which reads the same tiles through a block table; K3 reads row j
// of sequence b at b * S + j). Grid (B*H, ceil(T/64)) with the query tile
// reversed, so the heaviest causal tiles go out first; 256 threads, two
// warpgroups splitting each 64-row K/V tile's columns, each with its own
// online-softmax state, merged once at the end; a 2-stage cp.async ring of
// K/V tiles; Q held as mma.sync A fragments, K by ldmatrix, V by
// ldmatrix.trans from its row layout; exp2 with the scale folded into one
// FMA; only warp tiles that cross S or the diagonal are masked. This halves
// each warp's serial work per tile and puts two warps on every scheduler,
// which is what the measured per-tile time needed: the call is
// latency-bound, not tensor-core-bound. Every ragged edge (any T, any S) is
// handled in the sweep, and every sum is taken in one fixed order.
//
// Why not wgmma or TMA: a T = 300 call is 0.37 GFLOP, under a microsecond of
// tensor-core time even at mma.sync rates, and each block sweeps at most a
// few 9-17 KB tiles; what sets the time is the serial per-tile path (load
// latency, softmax, barriers), which the ring, the column split and ldmatrix
// shorten. wgmma's 64-row warpgroup tiles and TMA's descriptors would add
// set-up to that path and buy nothing at these sizes.
//
// ptxas (-Xptxas -v, sm_90a; kernels/build.py build_report(), printed by
// chip_smoke.py): registers at hd 64 / 112 / 128 were 128 / 167 / 168 in the
// first, single-warpgroup kernel, 99 / 162 / 170 in the two-warpgroup one
// before the sweep was shared, and are 120 / 166 / 174 behind the shared
// sweep's row policy; no spills in any.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "flash_sweep.cuh"  // the query tile's sweep and its launch

namespace {

template <int D>
__global__ void __launch_bounds__(flash_sweep::kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, float* __restrict__ o32, const int* __restrict__ start, int T,
                       int H, int KV, int causal, float scale_log2, row_policy::Contiguous rows) {
  flash_sweep::sweep<D>(q, k, v, out, lse, o32, start, T, H, KV, causal, scale_log2, rows);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse, void* o32, int B, int T,
                   int S, int H, int KV, int causal, cudaStream_t stream) {
  static std::atomic<uint32_t> smem_set{0u};
  return flash_sweep::launch<D>(flash_attention_kernel<D>, smem_set, q, k, v, out, lse, o32, nullptr, B, T, H, KV,
                                causal, row_policy::Contiguous{S, S}, stream);
}

}  // namespace

extern "C" {

// q, out: (B, T, H, D); k, v: (B, S, KV, D); all bf16, contiguous, 16-byte
// aligned; lse: (B, H, T) fp32, and o32: (B, T, H, D) fp32 (the output
// before its rounding, for the backward's D), or null (the serve paths: not
// written). Returns a cudaError_t (0 on a successful launch).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse, void* o32,
                              int B, int T, int S, int H, int KV, int D, int causal, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || (T + flash_sweep::kBlockQ - 1) / flash_sweep::kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, out, lse, o32, B, T, S, H, KV, causal, st);
    case 112:  // zamba2-7b's shared attention block
      return (int)launch<112>(q, k, v, out, lse, o32, B, T, S, H, KV, causal, st);
    case 128:
      return (int)launch<128>(q, k, v, out, lse, o32, B, T, S, H, KV, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* repro_kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
