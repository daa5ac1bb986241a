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
//   1.6 us); in practice latency bounds it, as K3: the call lasts as long as
//   its heaviest block, the last query tile, which sweeps every K/V tile up
//   to start + C in series.
//   Design: K3's sweep (flash_sweep.cuh), whose `Paged` policy reads logical
//   row j of sequence b from slot j % page of page block_table[b, j / page].
//   Grid (B*H, ceil(C/64)) with the query tile reversed (the heaviest causal
//   tiles go out first), 256 threads: two warpgroups split each 64-row K/V
//   tile's columns and keep their own online-softmax states, merged once at
//   the end; a 2-stage cp.async ring fetches each row's 16-byte chunks from
//   its own page, so tile k + 1 is in flight while tile k is computed; Q
//   comes in with the first tile and is held as mma.sync A fragments; K by
//   ldmatrix, V by ldmatrix.trans from its row layout (no scalar transpose);
//   exp2 with the scale and log2(e) folded into one FMA. Row i's causal limit
//   is start + i: the sweep stops at the tile holding start + C - 1, never
//   reads past the table's n * page rows, and masks only the warp tiles that
//   cross either. Masked probabilities are exactly 0; a row with no valid
//   column writes exact zeros. Any C and any start. Rows past the caller's
//   valid count are padding: they are computed like any other row.
//
// A block-table entry outside [0, P) is clamped into the arena, so a bad
// table reads wrong rows but never faults; the arena never hands one out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "decode_split.cuh"  // K1's split-K sweep and its launch
#include "flash_sweep.cuh"   // K2's query-tile sweep and its launch

namespace {

// ------------------------------------------------------------ K1: decode

template <int D>
__global__ void __launch_bounds__(decode_split::kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ cur_len,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int KV, float scale,
                    decode_split::Paged rows) {
  decode_split::sweep<D>(q, kp, vp, cur_len, out, lse, H, KV, scale, rows);  // lse: null (K4's alone)
}

template <int D>
cudaError_t launch_decode(const void* q, const void* kp, const void* vp, const void* block_table,
                          const void* cur_len, void* out, int B, int P, int page, int n, int H,
                          int KV, cudaStream_t stream) {
  static std::atomic<uint32_t> smem_set{0u};
  const decode_split::Paged rows{static_cast<const int*>(block_table), n, page, P};
  return decode_split::launch<D>(paged_decode_kernel<D>, smem_set, q, kp, vp, cur_len, out, nullptr, B, H, KV,
                                 n * page, rows, stream);
}

// ------------------------------------------------------ K2: chunked prefill

template <int D>
__global__ void __launch_bounds__(flash_sweep::kThreads)
paged_chunk_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                   const __nv_bfloat16* __restrict__ vp, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, float* __restrict__ o32, const int* __restrict__ start, int C, int H,
                   int KV, int causal, float scale_log2, row_policy::Paged rows) {
  flash_sweep::sweep<D>(q, kp, vp, out, lse, o32, start, C, H, KV, causal, scale_log2, rows);
}

template <int D>
cudaError_t launch_chunk(const void* q, const void* kp, const void* vp, const void* block_table,
                         const void* start, void* out, int B, int C, int P, int page, int n, int H,
                         int KV, cudaStream_t stream) {
  static std::atomic<uint32_t> smem_set{0u};
  const row_policy::Paged rows{static_cast<const int*>(block_table), n, page, P};
  return flash_sweep::launch<D>(paged_chunk_kernel<D>, smem_set, q, kp, vp, out, nullptr, nullptr, start, B, C, H,
                                KV, 1, rows, stream);
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
  if (B <= 0 || C <= 0 || P <= 0 || page <= 0 || n <= 0 || KV <= 0 || H % KV != 0 ||
      (C + flash_sweep::kBlockQ - 1) / flash_sweep::kBlockQ > 65535)
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
