// Launch helpers shared by the port's kernels: the opt-in for dynamic shared
// memory (the gradient's box kernel of grid_sample_bwd.cu takes nearly all
// of it), the occupancy query that sizes persistent grids (the MLP kernels
// of snake_mlp_tc.cuh, the fetch of grid_sample_fwd.cu), and a cache of
// what a card's queries give.  Host code only; nothing here allocates or
// synchronises, so a launch sized by it can be captured in a CUDA graph.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace lfgc {

constexpr int kMaxCards = 64;   // cards a process caches per_card values for

// Two ints that a query gives for the current card (SMs, blocks an SM,
// shared-memory limits: nothing that changes while a process runs), from
// `query(a, b)` at a card's first use and from `cache` after.
struct PerCard {
  std::atomic<int> a[kMaxCards], b[kMaxCards];
};

template <class Query>
inline cudaError_t per_card(PerCard& cache, int* a, int* b, Query&& query) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev < kMaxCards;
  if (keep && cache.b[dev].load() > 0) {
    *a = cache.a[dev].load();
    *b = cache.b[dev].load();
    return cudaSuccess;
  }
  err = query(a, b);
  if (err == cudaSuccess && keep) {
    cache.a[dev].store(*a);
    cache.b[dev].store(*b);
  }
  return err;
}

// Lets `kernel` take `bytes` of dynamic shared memory (needed above 48 KB).
template <class K>
inline cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

// The current card's SMs and how many blocks of `kernel` (`threads` threads,
// `smem` bytes of dynamic shared memory) one SM holds at once.  A kernel
// that holds none returns cudaErrorInvalidValue.
template <class K>
inline cudaError_t occupancy(K* kernel, int threads, size_t smem, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  }
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidValue;
  return err;
}

}  // namespace lfgc
