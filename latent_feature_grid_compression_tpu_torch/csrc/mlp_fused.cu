// The fused SnakeAlt MLP, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// latent_feature_grid_compression_tpu/ops/mlp_pallas.py:
//   _fwd_kernel  (the forward, from _mlp_fwd)
//   _bwd_kernel  (the backward, from _mlp_bwd: recompute the chain, then dX,
//                 dW and db accumulated over sample blocks)
// Those pad every layer to the 128-lane MXU tile and keep the activations in
// VMEM.  Here a block keeps a tile of samples and one layer's weights at a
// time in shared memory (snake_mlp.cuh); no activation goes to device memory.
//
// Bound on the card: at the flagship widths (31 -> 4 x 32 -> 1) a sample
// costs 8,192 FLOPs forward and about three times that backward, against
// 128 bytes of input and 4 of output (plus dX backward): far above the
// float32 ridge, so operations, not bytes.  This first kernel multiplies on
// the CUDA cores with float32 FMAs (bf16 operands are rounded, then
// multiplied exactly in float32); the bf16 tensor cores (wgmma) are later
// work.
//
// dW and db are reduced per block into slots and then summed in a fixed order
// (snake_mlp.cuh): the backward is reproducible bit for bit on one card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "snake_mlp.cuh"

namespace {

using namespace lfgc;

template <bool BF16>
__global__ void __launch_bounds__(kMlpThreads)
mlp_fwd_kernel(Mlp m, const float* __restrict__ x, float* __restrict__ out,
               int64_t n) {
  extern __shared__ float smem[];
  const int S = kFwdTile, P = m.pitch, K0 = m.dim[0];
  float* a = smem;
  float* b = a + S * P;
  float* wst = b + S * P;
  const int64_t row0 = int64_t(blockIdx.x) * S;
  for (int e = threadIdx.x; e < S * K0; e += blockDim.x) {
    const int s = e / K0, k = e - s * K0;
    a[s * P + k] = row0 + s < n ? op<BF16>(x[(row0 + s) * K0 + k]) : 0.0f;
  }
  tile_forward<BF16>(m, a, b, wst, S, out, row0, n);
}

template <bool BF16>
__global__ void __launch_bounds__(kMlpThreads)
mlp_bwd_kernel(Mlp m, const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ dx, float* __restrict__ partial, int64_t n,
               int S) {
  extern __shared__ float smem[];
  const int P = m.pitch, K0 = m.dim[0], D = m.dim[m.nw];
  float* dz = smem + (2 * m.nw - 1) * S * P;
  float* slot = partial + int64_t(blockIdx.x) * m.total;
  const int64_t tiles = (n + S - 1) / S;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row0 = t * S;
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < S * K0; e += blockDim.x) {
      const int s = e / K0, k = e - s * K0;
      smem[s * P + k] = row0 + s < n ? op<BF16>(x[(row0 + s) * K0 + k]) : 0.0f;
    }
    for (int e = threadIdx.x; e < S * D; e += blockDim.x) {
      const int s = e / D, o = e - s * D;
      dz[s * P + o] = row0 + s < n ? g[(row0 + s) * D + o] : 0.0f;
    }
    const float* dxs = tile_backward<BF16>(m, smem, S, slot, t == blockIdx.x);
    for (int e = threadIdx.x; e < S * K0; e += blockDim.x) {
      const int s = e / K0, k = e - s * K0;
      if (row0 + s < n) dx[(row0 + s) * K0 + k] = dxs[s * P + k];
    }
  }
}

template <bool BF16>
cudaError_t launch_fwd(const Mlp& m, const float* x, float* out, int64_t n,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(m);
  cudaError_t err = allow_smem(mlp_fwd_kernel<BF16>, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (n + kFwdTile - 1) / kFwdTile;
  mlp_fwd_kernel<BF16><<<dim3(unsigned(blocks)), kMlpThreads, smem, stream>>>(
      m, x, out, n);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_bwd(const Mlp& m, const float* x, const float* g, float* dx,
                       float* dparams, float* partial, int64_t n,
                       cudaStream_t stream) {
  const int S = bwd_tile(m);
  if (S == 0) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(m, S);
  cudaError_t err = allow_smem(mlp_bwd_kernel<BF16>, smem);
  if (err != cudaSuccess) return err;
  const int slots = bwd_slots(n, S);
  mlp_bwd_kernel<BF16><<<dim3(unsigned(slots)), kMlpThreads, smem, stream>>>(
      m, x, g, dx, partial, n, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_slots(partial, dparams, m.total, slots, stream);
}

}  // namespace

// Plain C entries for ctypes.  Pointers are device pointers except `w`, `b`
// (host arrays of nw device pointers, one per layer) and `dims` (host array
// of nw + 1 widths); the launcher copies them into the kernel's by-value
// parameters.  Each returns the CUDA error of its launches (0 on success).

// out (n, dims[nw]) = the MLP of x (n, dims[0]).
extern "C" int lfgc_mlp_fused_fwd(const void* x, const void* const* w,
                                  const void* const* b, const int* dims, int nw,
                                  void* out, int64_t n, int bf16, void* stream) {
  Mlp m;
  if (!make_mlp(&m, w, b, dims, nw)) return int(cudaErrorInvalidValue);
  if (n <= 0) return int(cudaSuccess);
  const float* xp = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bf16 ? launch_fwd<true>(m, xp, o, n, s) : launch_fwd<false>(m, xp, o, n, s));
}

// The number of partial slots (rows of `partial`, each of the flat
// [dW .., db ..] length) that lfgc_mlp_fused_bwd needs; 0 if the widths do
// not fit.
extern "C" int lfgc_mlp_fused_bwd_slots(int64_t n, const int* dims, int nw) {
  Mlp m;
  if (!make_mlp(&m, nullptr, nullptr, dims, nw) || n <= 0) return 0;
  const int S = bwd_tile(m);
  return S ? bwd_slots(n, S) : 0;
}

// For the output gradient g (n, dims[nw]): dx (n, dims[0]) and the flat
// dparams = [dW_0 .. dW_{nw-1} ((out, in) each), db_0 .. db_{nw-1}].
extern "C" int lfgc_mlp_fused_bwd(const void* x, const void* const* w,
                                  const void* const* b, const int* dims, int nw,
                                  const void* g, void* dx, void* dparams,
                                  void* partial, int64_t n, int bf16, void* stream) {
  Mlp m;
  if (!make_mlp(&m, w, b, dims, nw)) return int(cudaErrorInvalidValue);
  if (n <= 0) return int(cudaSuccess);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  float* dxp = static_cast<float*>(dx);
  float* dpp = static_cast<float*>(dparams);
  float* pp = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bf16 ? launch_bwd<true>(m, xp, gp, dxp, dpp, pp, n, s)
                  : launch_bwd<false>(m, xp, gp, dxp, dpp, pp, n, s));
}

extern "C" const char* lfgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
