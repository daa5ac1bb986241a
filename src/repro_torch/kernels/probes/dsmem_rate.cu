// How fast a block reads a cluster peer's shared memory (distributed shared
// memory, DSMEM) on this card, against its own shared memory: the rate that
// decides whether K6 (csrc/ssd_scan.cu) passes chunk states between blocks.
//
// Each block of a grid of clusters fills 32 KB of its shared memory, then
// reads a peer's (rank r + 1) or its own 50 times with float4 loads, one or
// eight loads in flight per thread. Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//     -o build/dsmem_rate src/repro_torch/kernels/probes/dsmem_rate.cu && build/dsmem_rate
//
// One line per (source, loads in flight, cluster size, threads, blocks):
// the time, the bytes over it per block and over the card.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace cg = cooperative_groups;

constexpr int kBytes = 32 * 1024;
constexpr int kReps = 50;

template <int kInFlight>
__global__ void read_kernel(float* out, bool peer) {
  extern __shared__ float4 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  constexpr int n4 = kBytes / 16;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) sm[i] = make_float4(rank, i, 1.f, 2.f);
  cluster.sync();
  const float4* src = peer ? cluster.map_shared_rank(sm, (rank + 1) % cluster.num_blocks()) : sm;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int rep = 0; rep < kReps; ++rep) {
    for (int i = threadIdx.x; i < n4; i += kInFlight * blockDim.x) {
      float4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) v[u] = src[(i + u * blockDim.x) % n4];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        acc.x += v[u].x;
        acc.y += v[u].y;
        acc.z += v[u].z;
        acc.w += v[u].w;
      }
    }
  }
  cluster.sync();  // no block leaves while a peer reads its shared memory
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}

template <int kInFlight>
void measure(float* out, bool peer, int cluster, int threads, int blocks) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = kBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaLaunchKernelEx(&config, read_kernel<kInFlight>, out, peer);  // warm-up
  cudaEventRecord(a);
  cudaLaunchKernelEx(&config, read_kernel<kInFlight>, out, peer);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const double per_block = (double)kBytes * kReps;
  printf("%s in_flight=%d cluster=%d threads=%d blocks=%d ms=%.4f per_block_GB/s=%.1f card_GB/s=%.0f %s\n",
         peer ? "peer" : "own", kInFlight, cluster, threads, blocks, ms, per_block / ms / 1e6,
         per_block * blocks / ms / 1e6, cudaGetErrorString(cudaGetLastError()));
  cudaEventDestroy(a);
  cudaEventDestroy(b);
}

int main() {
  float* out = nullptr;
  cudaMalloc(&out, 1 << 24);
  for (bool peer : {true, false})
    for (int cluster : {2, 5, 8})
      for (int threads : {128, 256})
        for (int blocks : {cluster * 13, cluster * 26}) {
          measure<1>(out, peer, cluster, threads, blocks);
          measure<8>(out, peer, cluster, threads, blocks);
        }
  cudaFree(out);
  return 0;
}
