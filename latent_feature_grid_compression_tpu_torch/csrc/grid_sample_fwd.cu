// Trilinear feature-grid fetch, forward, for Hopper (sm_90a).
//
// Replaces the two forward Pallas TPU kernels of
// latent_feature_grid_compression_tpu/ops/pallas_kernels.py:
//   _fwd_kernel          (H*W <= 512, grids up to 22, the flagship grid 15)
//   _fwd_kernel_blocked  (H*W > 512, grids 23..62)
// Those build a one-hot weight tile and run it through the MXU, only to avoid
// scatter/gather on the TPU.  Here the same function is computed directly:
//
//   out[n, c] = sum over the 8 corners of w * G[z, y, x, c]
//
// with torch grid_sample semantics (align_corners=False, zero padding):
// pix = ((coord + 1) * size - 1) / 2, coords[:, 0] -> W, [:, 1] -> H,
// [:, 2] -> D, floor (not truncation) for the lower corner, out-of-range
// corners skipped.  The grid is channel-minor (D, H, W, C), so a corner is one
// contiguous row of C floats.
//
// Bound on the card: bytes.  Per sample it reads 12 bytes of coordinates and
// writes 4*C bytes; the grid (216 KB at the flagship 16 x 15^3, 15.2 MB at
// 16 x 62^3) stays in the 50 MB L2, so its 8*C-float corner reads per sample
// are L2 traffic, not DRAM traffic.  Arithmetic is ~2*8*C FLOPs per sample,
// far below the float32 rate.  Design: one thread per sample, f32
// accumulators in registers, float4 loads and stores where C % 4 == 0.  Each
// channel block of up to 32 is a compile-time width so the accumulators stay
// in registers; C > 32 loops over blocks.  Making it faster (staging the grid
// in shared memory, more samples per thread) is later work.
//
// The pixel map and corner weights come from trilinear.cuh (shared with the
// gradient and the one-kernel forward); they round exactly as the plain
// PyTorch version does, and the two differ only in the rounding of the 8-term
// sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "trilinear.cuh"

namespace {

constexpr int kThreads = 256;

template <int CB, bool VEC4>
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_kernel(const float* __restrict__ grid,    // (D*H*W, C)
                       const float* __restrict__ coords,  // (N, 3)
                       float* __restrict__ out,           // (N, C)
                       int64_t n, int C, int D, int H, int W) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const lfgc::Cell cell =
      lfgc::cell_of(coords[3 * i + 0], coords[3 * i + 1], coords[3 * i + 2], D, H, W);

  float* __restrict__ dst = out + i * int64_t(C);

  for (int c0 = 0; c0 < C; c0 += CB) {
    float acc[CB];
#pragma unroll
    for (int k = 0; k < CB; ++k) acc[k] = 0.0f;

    lfgc::for_each_corner(cell, D, H, W, [&](int64_t r, float w) {
      const float* __restrict__ row = grid + r * int64_t(C) + c0;
      if (VEC4) {
#pragma unroll
        for (int k = 0; k < CB; k += 4) {
          if (c0 + k < C) {
            const float4 g = __ldg(reinterpret_cast<const float4*>(row + k));
            acc[k + 0] = fmaf(w, g.x, acc[k + 0]);
            acc[k + 1] = fmaf(w, g.y, acc[k + 1]);
            acc[k + 2] = fmaf(w, g.z, acc[k + 2]);
            acc[k + 3] = fmaf(w, g.w, acc[k + 3]);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < CB; ++k) {
          if (c0 + k < C) acc[k] = fmaf(w, __ldg(row + k), acc[k]);
        }
      }
    });

    if (VEC4) {
#pragma unroll
      for (int k = 0; k < CB; k += 4) {
        if (c0 + k < C) {
          *reinterpret_cast<float4*>(dst + c0 + k) =
              make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        if (c0 + k < C) dst[c0 + k] = acc[k];
      }
    }
  }
}

template <int CB, bool VEC4>
void launch(const float* grid, const float* coords, float* out, int64_t n,
            int C, int D, int H, int W, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  grid_sample_fwd_kernel<CB, VEC4><<<dim3(unsigned(blocks)), kThreads, 0, stream>>>(
      grid, coords, out, n, C, D, H, W);
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers; `vec4` asks for the
// float4 path and requires C % 4 == 0 with 16-byte aligned grid and out (the
// wrapper checks).  Returns cudaGetLastError() right after the launch.
extern "C" int lfgc_grid_sample_fwd_f32(const void* grid, const void* coords,
                                        void* out, int64_t n, int C, int D,
                                        int H, int W, int vec4, void* stream) {
  if (n <= 0) return int(cudaSuccess);
  const float* g = static_cast<const float*>(grid);
  const float* p = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cb = C <= 4 ? 4 : C <= 8 ? 8 : C <= 16 ? 16 : 32;
  if (vec4) {
    switch (cb) {
      case 4: launch<4, true>(g, p, o, n, C, D, H, W, s); break;
      case 8: launch<8, true>(g, p, o, n, C, D, H, W, s); break;
      case 16: launch<16, true>(g, p, o, n, C, D, H, W, s); break;
      default: launch<32, true>(g, p, o, n, C, D, H, W, s); break;
    }
  } else {
    switch (cb) {
      case 4: launch<4, false>(g, p, o, n, C, D, H, W, s); break;
      case 8: launch<8, false>(g, p, o, n, C, D, H, W, s); break;
      case 16: launch<16, false>(g, p, o, n, C, D, H, W, s); break;
      default: launch<32, false>(g, p, o, n, C, D, H, W, s); break;
    }
  }
  return int(cudaGetLastError());
}

extern "C" const char* lfgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
