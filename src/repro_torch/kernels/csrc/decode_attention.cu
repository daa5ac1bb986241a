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
// cur_len over 3.35 TB/s: 0.25 us at llama's S = 512, 2.5 us at S = 4096.
// At the serve shapes (B = 1, S = 512) a call is bound by latency instead:
// a grid of (B, KV) blocks is 8 blocks on 132 SMs, each walking every tile
// in series.
//
// What the design does about it: split-K across a thread-block cluster,
// combined through distributed shared memory, in ONE launch — the sweep of
// decode_split.cuh, whose `Contiguous` policy reads row j of sequence b at
// row b * batch + j of the (B, S, KV, hd) cache (batch = S when contiguous); splits = min(8, ceil(S/64)),
// from S, never from cur_len. Any group G (heads in slices of 1024 / hd);
// cur_len == 0 gives exact zeros (the paged kernel's contract; the TPU kernel
// returns the mean of V there).
//
// ptxas (-Xptxas -v, sm_90a; kernels/build.py build_report(), printed by
// chip_smoke.py): registers at hd 64 / 112 / 128 were 64 / 80 / 64 in the
// one-block-per-kv-head kernel of slice 1 and 64 / 74 / 74 with the split
// sweep's accumulators in registers; no spills in either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "decode_split.cuh"  // the split-K sweep and its launch

namespace {

template <int D>
__global__ void __launch_bounds__(decode_split::kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ cur_len,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int KV, float scale,
                        decode_split::Contiguous rows) {
  decode_split::sweep<D>(q, k, v, cur_len, out, lse, H, KV, scale, rows);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* cur_len, void* out, void* lse, int B,
                   int S, int64_t batch, int H, int KV, cudaStream_t stream) {
  static std::atomic<uint32_t> smem_set{0u};
  return decode_split::launch<D>(decode_attention_kernel<D>, smem_set, q, k, v, cur_len, out, lse, B, H, KV, S,
                                 decode_split::Contiguous{S, batch}, stream);
}

}  // namespace

extern "C" {

// q, out: (B, H, D), contiguous; k, v: (B, S, KV, D) with each sequence's
// (S, KV, D) contiguous and sequences `batch` rows of KV * D apart (batch >=
// S: a batched step's lanes read one layer of their stacked caches in
// place); all bf16, 16-byte aligned; cur_len: (B,) int32 on the device;
// lse: null, or (B, H) fp32 for each head's logsumexp of its scaled scores
// (-inf where cur_len == 0). Returns a cudaError_t.
int repro_decode_attention_fwd(const void* q, const void* k, const void* v, const void* cur_len,
                               void* out, void* lse, int B, int S, long long batch, int H, int KV, int D,
                               void* stream) {
  if (B <= 0 || S <= 0 || batch < S || KV <= 0 || H % KV != 0 || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, cur_len, out, lse, B, S, batch, H, KV, st);
    case 112:  // zamba2-7b's shared attention block
      return (int)launch<112>(q, k, v, cur_len, out, lse, B, S, batch, H, KV, st);
    case 128:
      return (int)launch<128>(q, k, v, cur_len, out, lse, B, S, batch, H, KV, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
