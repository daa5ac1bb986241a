// Row-address policies shared by the attention sweeps over a K/V cache
// (decode_split.cuh: K4 and K1; flash_sweep.cuh: K3 and K2). A policy maps
// logical row j of sequence b to a row of a (rows, KV, D) array, so one
// sweep reads a contiguous cache or a paged arena through a block table.
//
// Each .cu includes this header by its relative path and compiles to an
// object of its own (kernels/build.py), so everything here has internal
// linkage; kernels/build.py hashes it with the sources.
#pragma once

#include <stdint.h>

namespace {
namespace row_policy {

// K4 and K3: (B, S, KV, D) whose sequences lie `batch` rows apart (S when
// the array is contiguous; more when it is one slice of a larger cache, such
// as one layer of k requests' stacked caches), row j of sequence b is row
// b * batch + j.
struct Contiguous {
  int S;
  int64_t batch;
  __device__ int capacity() const { return S; }
  __device__ int64_t row(int b, int j) const { return (int64_t)b * batch + j; }
};

// K1 and K2: pages (P, page, KV, D) and a block table (B, n); row j of
// sequence b is slot j % page of page block_table[b, j / page], clamped into
// [0, P) so that a bad table reads wrong rows but never faults (the arena
// never hands one out).
struct Paged {
  const int* table;
  int n, page, P;
  __device__ int capacity() const { return n * page; }
  __device__ int64_t row(int b, int j) const {
    const int phys = min(max(table[(int64_t)b * n + j / page], 0), P - 1);
    return (int64_t)phys * page + j % page;
  }
};

}  // namespace row_policy
}  // namespace
