// The fused SnakeAlt MLP, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// latent_feature_grid_compression_tpu/ops/mlp_pallas.py:
//   _fwd_kernel  (the forward, from _mlp_fwd)
//   _bwd_kernel  (the backward, from _mlp_bwd: recompute the chain, then dX,
//                 dW and db accumulated over sample blocks)
// Those pad every layer to the 128-lane MXU tile and keep the activations in
// VMEM.  Here a block keeps a tile of samples and the weights in shared
// memory; no activation goes to device memory.
//
// Bound on the card: at the flagship widths (31 -> 4 x 32 -> 1) a sample
// costs 8,192 FLOPs forward and about three times that backward, against
// 128 bytes of input and 4 of output (plus dX backward).  With bf16 operands
// (989 TFLOP/s on the tensor cores) that is below the ridge: the forward is
// bound by bytes at 0.00126 ms for 32,768 samples, the backward at 0.00248
// ms; in float32 (67 TFLOP/s) by operations.  The 'bf16' kernels run their
// products on the tensor cores (mma.sync on bf16 fragments loaded by
// ldmatrix, snake_mlp_tc.cuh) in blocks that stage every layer's weights
// once and walk tiles of samples: the forward's routine is the backward's
// recompute of the chain.  The 'f32' kernels multiply on the CUDA cores with
// float32 FMAs out of shared memory (snake_mlp.cuh), a forward block a tile
// of kFwdTile samples, one layer's weights at a time.  Both precisions do the
// same arithmetic as the plain versions up to the order of the float32 sums.
//
// dW and db are reduced per block into slots and then summed in a fixed order
// (snake_mlp.cuh): the backward is reproducible bit for bit on one card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "snake_mlp.cuh"
#include "snake_mlp_tc.cuh"

namespace {

using namespace lfgc;

// 'f32': tile_forward of snake_mlp.cuh, a block a tile of kFwdTile samples
// (the plan p unused).
template <bool BF16>
__global__ void __launch_bounds__(kMlpThreads)
mlp_fwd_kernel(const __grid_constant__ Mlp m, const __grid_constant__ TcPlan p,
               const float* __restrict__ x, float* __restrict__ out, int64_t n) {
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

// 'bf16': the tensor-core tile_forward_tc (snake_mlp_tc.cuh) on tiles of
// p.S samples in blocks of kTcFwdThreads that stage the weights once (where
// they stay) and walk tiles blockIdx.x, + gridDim.x, ...
template <>
__global__ void __launch_bounds__(kTcFwdThreads, kTcFwdMinBlocks)
mlp_fwd_kernel<true>(const __grid_constant__ Mlp m, const __grid_constant__ TcPlan p,
                     const float* __restrict__ x, float* __restrict__ out, int64_t n) {
  extern __shared__ float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  tc_stage_resident(m, p, base);
  const int64_t tiles = (n + p.S - 1) / p.S;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row0 = t * p.S;
    __syncthreads();  // the previous tile's readers are done
    tc_zero_x0_pad(m, p, base);   // a later layer's h shares h_0's buffer
    tc_load_x(m, p, base, x, row0, n);
    tile_forward_tc(m, p, base, out, row0, n);
  }
}

// 'f32': tile_backward of snake_mlp.cuh on tiles of S samples (the plan p
// unused).
template <bool BF16>
__global__ void __launch_bounds__(kMlpThreads)
mlp_bwd_kernel(const __grid_constant__ Mlp m, const __grid_constant__ TcPlan p,
               const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ dx, float* __restrict__ partial, int64_t n, int S) {
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

// 'bf16': the tensor-core tile_backward_tc (snake_mlp_tc.cuh) on tiles of
// p.S samples, two blocks of kTcThreads an SM; dW and db summed across the
// block's tiles in `acc` and written to its slot once.
template <>
__global__ void __launch_bounds__(kTcThreads, 2)
mlp_bwd_kernel<true>(const __grid_constant__ Mlp m, const __grid_constant__ TcPlan p,
                     const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ dx, float* __restrict__ partial, int64_t n, int) {
  extern __shared__ float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int S = p.S, K0 = m.dim[0], P0 = tc_x0_pitch(p);
  float* slot = partial + int64_t(blockIdx.x) * m.total;
  float* acc = tc_acc(p, base, slot);
  tc_begin(m, p, base, acc);
  const int64_t tiles = (n + S - 1) / S;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row0 = t * S;
    __syncthreads();  // the previous tile's readers are done
    tc_load_x(m, p, base, x, row0, n);
    tc_load_grad(m, p, base, g, row0, n);
    const float* dxs = tile_backward_tc(m, p, base, acc);
    for (int e = threadIdx.x; e < S * K0; e += blockDim.x) {
      const int s = e / K0, k = e - s * K0;
      if (row0 + s < n) dx[(row0 + s) * K0 + k] = dxs[s * P0 + k];
    }
  }
  tc_end(m, p, base, acc, slot);
}

// The forward kernel at a precision.
inline decltype(&mlp_fwd_kernel<true>) fwd_kernel(bool bf16) {
  return bf16 ? mlp_fwd_kernel<true> : mlp_fwd_kernel<false>;
}

template <bool BF16>
cudaError_t launch_fwd(const Mlp& m, const float* x, float* out, int64_t n,
                       cudaStream_t stream) {
  Launch b;
  cudaError_t err = fwd_launch(fwd_kernel(BF16), BF16, m, n, &b);
  if (err != cudaSuccess) return err;
  mlp_fwd_kernel<BF16><<<dim3(unsigned(b.blocks)), b.threads, b.smem, stream>>>(
      m, b.p, x, out, n);
  return cudaGetLastError();
}

// The backward kernel at a precision.
inline decltype(&mlp_bwd_kernel<true>) bwd_kernel(bool bf16) {
  return bf16 ? mlp_bwd_kernel<true> : mlp_bwd_kernel<false>;
}

template <bool BF16>
cudaError_t launch_bwd(const Mlp& m, const float* x, const float* g, float* dx,
                       float* dparams, float* partial, int64_t n,
                       cudaStream_t stream) {
  Launch b;
  cudaError_t err = bwd_launch(bwd_kernel(BF16), BF16, m, n, &b);
  if (err != cudaSuccess) return err;
  mlp_bwd_kernel<BF16><<<dim3(unsigned(b.blocks)), b.threads, b.smem, stream>>>(
      m, b.p, x, g, dx, partial, n, b.S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_slots(partial, dparams, m.total, b.blocks, stream);
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

// For reports, the forward's launch at these widths and precision on the
// current card: out = [samples a tile, dynamic shared bytes a block, blocks
// an SM, weights resident] (snake_mlp_tc.cuh launch_report).
extern "C" int lfgc_mlp_fused_fwd_plan(const int* dims, int nw, int bf16, int* out) {
  Mlp m;
  Launch b;
  if (!make_mlp(&m, nullptr, nullptr, dims, nw)) return int(cudaErrorInvalidValue);
  const cudaError_t err = fwd_launch(fwd_kernel(bf16), bf16, m, 1, &b);
  if (err == cudaSuccess) launch_report(b, out);
  return int(err);
}

// The number of partial slots (rows of `partial`, each of the flat
// [dW .., db ..] length) that lfgc_mlp_fused_bwd needs at this precision on
// the current card; 0 if the widths do not fit.
extern "C" int lfgc_mlp_fused_bwd_slots(int64_t n, const int* dims, int nw, int bf16) {
  Mlp m;
  if (!make_mlp(&m, nullptr, nullptr, dims, nw) || n <= 0) return 0;
  Launch b;
  return bwd_launch(bwd_kernel(bf16), bf16, m, n, &b) == cudaSuccess ? b.blocks : 0;
}

// For reports, the backward's launch at these widths and precision on the
// current card: out = [samples a tile, dynamic shared bytes a block, blocks
// an SM, weights and sums resident] (snake_mlp_tc.cuh launch_report).
extern "C" int lfgc_mlp_fused_bwd_plan(const int* dims, int nw, int bf16, int* out) {
  Mlp m;
  Launch b;
  if (!make_mlp(&m, nullptr, nullptr, dims, nw)) return int(cudaErrorInvalidValue);
  const cudaError_t err = bwd_launch(bwd_kernel(bf16), bf16, m, 1, &b);
  if (err == cudaSuccess) launch_report(b, out);
  return int(err);
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
