// Helpers shared by the hand-written kernels that stream tiles through a
// cp.async ring (flash_sweep.cuh, decode_split.cuh, moe_gmm.cu, ssd_scan.cu):
// the 16- and 4-byte asynchronous copies with their commit / wait, and the host-side raise
// of a kernel's dynamic shared-memory limit, once per device.
//
// Each .cu includes this header by its relative path and compiles to an
// object of its own (kernels/build.py), so everything here has internal
// linkage. kernels/build.py hashes this header with the sources, so a change
// here rebuilds the library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// 16 bytes global -> shared, asynchronously; valid == false zero-fills
// without reading global memory.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

// 16 bytes global -> shared through L1 (for data that neighbouring blocks of
// the SM read too); valid == false zero-fills without reading global memory.
__device__ __forceinline__ void cp_async_16_ca(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

// 4 bytes global -> shared, asynchronously (through L1: only .ca copies 4
// bytes); valid == false zero-fills without reading global memory.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raise a kernel's dynamic shared-memory limit once per device (bit `dev` of
// `done`), not on every launch.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, size_t bytes, std::atomic<uint32_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0u && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace
