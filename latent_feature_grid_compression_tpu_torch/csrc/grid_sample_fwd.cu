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
// far below the float32 rate.  So what matters is how the accesses coalesce
// and how much latency is in flight.
//
// Design: lanes run over channel groups.  A sample's C channels go to
// L = ceil(C / 4) neighbouring lanes, 4 channels a lane: in a float4 where
// C % 4 == 0 and the grid and the output are 16-byte aligned, else with up to
// 4 scalar loads a corner (as fused_forward.cu's build_x0_tc; one channel a
// lane issued ~5x the instructions a sample at C = 5 and lost to
// F.grid_sample); a warp takes 32 / L samples at a step (8 at C = 16).  Every
// lane finds its sample's cell itself: a warp issues the same instructions
// as when one lane finds it, and shuffling it to the others costs more than
// it saves (ablate_fetch.py, fwd_cell_shfl).  Each corner is
// then one warp-wide load of whole rows (the sample's L lanes read its
// 4*C-byte row), and each output store writes the step's samples' rows,
// which are contiguous.  Where a sample needs more than 32 lanes (C > 128)
// its lanes loop over the rest.  Blocks are persistent:
// as many as the card holds at once (occupancy x SMs), each warp walking
// steps with a grid stride and loading the next step's coordinates before
// it fetches this step's corners, so their latency hides behind the corner
// loads.  The unrolled corners keep 8 loads in flight a lane (61 registers
// with float4s, 4 blocks an SM); a launch bound that caps them at 40 for 6
// blocks an SM spills and runs ~60% slower (fwd_min_blocks_6).
//
// The pixel map and corner weights come from trilinear.cuh (shared with the
// gradient and the one-kernel forward); they round exactly as the plain
// PyTorch version does.  Each channel is the fmaf chain from 0 over the
// in-range corners in for_each_corner's order, as fused_forward.cu's
// build_x0_tc computes it, so the one-kernel forward's features equal this
// kernel's output bit for bit; the plain version differs only in the
// rounding of the 8-term sum.
//
// The 'bf16' mode (the TPU kernels' precision='bf16', the bf16 compute
// path) is a kernel of its own, grid_sample_fwd_bf16_kernel below: it reads
// a bf16 channel-minor copy of the grid, which the wrapper makes (the TPU
// kernel rounds G to bf16 before the MXU, so the rounding point is the
// same), and computes trilinear.cuh's 'bf16' formula, summing each z plane's
// 4 corners in float32 and rounding the plane's sum times wz to bf16.  A
// 16-byte load carries 8 channels, so a lane takes 8 (a C-16 row is two
// lanes) and half as many lanes load a row as in float32; where C % 8 != 0
// or a pointer is not 16-byte aligned, guarded scalar loads.  Bound:
// bytes, as the float32 kernel, with the grid at 2 bytes an element.  It is
// the simple design (one warp step a sample group, no persistent blocks and
// no coordinate prefetch); the output stays float32.  Its channels are
// computed as fused_forward.cu's 'bf16' x0 build computes them
// (lfgc::fetch_channels), so the two agree bit for bit, and with the plain
// version too: the sums are taken in the same order, and each product is
// exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "trilinear.cuh"

namespace {

constexpr int kThreads = 256;

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_kernel(const float* __restrict__ grid,    // (D*H*W, C)
                       const float* __restrict__ coords,  // (N, 3)
                       float* __restrict__ out,           // (N, C)
                       int64_t n, int C, int D, int H, int W) {
  const int L = (C + 3) / 4;            // lanes a sample needs
  const int Lw = L < 32 ? L : 32;       // lanes it gets
  const int P = 32 / Lw;                // samples a warp step
  const int lane = threadIdx.x & 31, slot = lane / Lw, sub = lane - slot * Lw;
  if (slot >= P) return;                // lanes past the last whole sample
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t stride = (int64_t(gridDim.x) * blockDim.x >> 5) * P;

  int64_t i = warp * P + slot;
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  if (i < n) {
    cx = __ldg(coords + 3 * i + 0);
    cy = __ldg(coords + 3 * i + 1);
    cz = __ldg(coords + 3 * i + 2);
  }
  for (; i < n; i += stride) {
    // the next step's coordinates, in flight while this step's corners load
    const int64_t next = i + stride;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (next < n) {
      nx = __ldg(coords + 3 * next + 0);
      ny = __ldg(coords + 3 * next + 1);
      nz = __ldg(coords + 3 * next + 2);
    }
    const lfgc::Cell cell = lfgc::cell_of(cx, cy, cz, D, H, W);
    float* __restrict__ dst = out + i * int64_t(C);
    for (int c = 4 * sub; c < C; c += 4 * Lw) {
      if (VEC4) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        lfgc::for_each_corner(cell, D, H, W, [&](int64_t r, float w) {
          const float4 g = __ldg(reinterpret_cast<const float4*>(grid + r * C + c));
          acc.x = fmaf(w, g.x, acc.x);
          acc.y = fmaf(w, g.y, acc.y);
          acc.z = fmaf(w, g.z, acc.z);
          acc.w = fmaf(w, g.w, acc.w);
        });
        *reinterpret_cast<float4*>(dst + c) = acc;
      } else {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        lfgc::for_each_corner(cell, D, H, W, [&](int64_t r, float w) {
          const float* __restrict__ row = grid + r * C + c;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (c + k < C) acc[k] = fmaf(w, __ldg(row + k), acc[k]);
          }
        });
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c + k < C) dst[c + k] = acc[k];
        }
      }
    }
    cx = nx;
    cy = ny;
    cz = nz;
  }
}

// How the fetch launches for n samples of C channels.
struct Plan {
  int vec4;      // 4 channels a lane in a float4, else with scalar loads
  int per_sm;    // blocks an SM holds at once
  int blocks;    // the grid: at most per_sm x SMs, at most one warp a step
  int samples;   // samples a warp takes at a step
};

// SMs and blocks an SM holds, queried once a card and lane width.
cudaError_t occupancy_of(bool vec4, int* sms, int* per_sm) {
  static lfgc::PerCard cache[2];
  return lfgc::per_card(cache[vec4], sms, per_sm, [&](int* s, int* b) {
    return vec4 ? lfgc::occupancy(grid_sample_fwd_kernel<true>, kThreads, 0, b, s)
                : lfgc::occupancy(grid_sample_fwd_kernel<false>, kThreads, 0, b, s);
  });
}

cudaError_t plan_of(int64_t n, int C, bool vec4, Plan* p) {
  const int L = (C + 3) / 4;
  p->vec4 = vec4;
  p->samples = 32 / (L < 32 ? L : 32);
  int sms = 0;
  const cudaError_t err = occupancy_of(vec4, &sms, &p->per_sm);
  if (err != cudaSuccess) return err;
  const int64_t steps = (n + p->samples - 1) / p->samples;
  const int64_t need = (steps + kThreads / 32 - 1) / (kThreads / 32);
  const int64_t most = int64_t(sms) * p->per_sm;
  p->blocks = int(need < most ? (need > 0 ? need : 1) : most);
  return cudaSuccess;
}

// 'bf16': a sample's C channels on ceil(C / 8) neighbouring lanes, 8 a
// lane (one 16-byte load a corner where VEC8, else guarded scalar loads),
// 32 / lanes samples a warp, a warp a step of samples; the block's warps
// take neighbouring steps.
template <bool VEC8>
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ grid,  // (D*H*W, C)
                            const float* __restrict__ coords,        // (N, 3)
                            float* __restrict__ out,                 // (N, C)
                            int64_t n, int C, int D, int H, int W) {
  const int lanes = (C + 7) / 8 < 32 ? (C + 7) / 8 : 32;
  const int per_warp = 32 / lanes;
  const int lane = threadIdx.x & 31, group = lane / lanes, sub = lane - group * lanes;
  const int64_t s = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t i = s * per_warp + group;
  if (group >= per_warp || i >= n) return;
  const lfgc::Cell cell = lfgc::cell_of(__ldg(coords + 3 * i), __ldg(coords + 3 * i + 1),
                                        __ldg(coords + 3 * i + 2), D, H, W);
  float* __restrict__ dst = out + i * int64_t(C);
  for (int c0 = 8 * sub; c0 < C; c0 += 8 * lanes) {
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    lfgc::fetch_channels<true>(cell, D, H, W, [&](int64_t r, float* v) {
      const __nv_bfloat16* __restrict__ src = grid + r * C + c0;
      if (VEC8) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(p[k]);
          v[2 * k] = f.x;
          v[2 * k + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = c0 + k < C ? __bfloat162float(src[k]) : 0.0f;
      }
    }, acc);
    if (VEC8) {
      *reinterpret_cast<float4*>(dst + c0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(dst + c0 + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (c0 + k < C) dst[c0 + k] = acc[k];
      }
    }
  }
}

// How the 'bf16' fetch launches: samples a warp step and blocks (every step
// its own warp).
void bf16_plan_of(int64_t n, int C, int* samples, int* blocks) {
  const int lanes = (C + 7) / 8 < 32 ? (C + 7) / 8 : 32;
  *samples = 32 / lanes;
  const int64_t steps = (n + *samples - 1) / *samples;
  const int64_t need = (steps + kThreads / 32 - 1) / (kThreads / 32);
  *blocks = int(need > 0 ? need : 1);
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers; `vec4` asks for
// float4 lanes and requires C % 4 == 0 with 16-byte aligned grid and out (the
// wrapper checks).  Returns the first CUDA error of the plan or
// cudaGetLastError() right after the launch.
extern "C" int lfgc_grid_sample_fwd_f32(const void* grid, const void* coords,
                                        void* out, int64_t n, int C, int D,
                                        int H, int W, int vec4, void* stream) {
  if (n <= 0 || C <= 0) return int(cudaSuccess);
  Plan p;
  const cudaError_t err = plan_of(n, C, vec4 != 0, &p);
  if (err != cudaSuccess) return int(err);
  const float* g = static_cast<const float*>(grid);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.vec4) {
    grid_sample_fwd_kernel<true><<<p.blocks, kThreads, 0, s>>>(g, c, o, n, C, D, H, W);
  } else {
    grid_sample_fwd_kernel<false><<<p.blocks, kThreads, 0, s>>>(g, c, o, n, C, D, H, W);
  }
  return int(cudaGetLastError());
}

// For reports, the fetch's launch for this shape on the current card: out =
// [route (1 float4 lanes, 0 scalar), threads a block, blocks an SM, blocks,
// samples a warp step, channels a lane (4), shared bytes a block (0)].
extern "C" int lfgc_grid_sample_fwd_plan(int64_t n, int C, int D, int H, int W,
                                         int vec4, int* out) {
  (void)D; (void)H; (void)W;
  if (C <= 0) return int(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan_of(n, C, vec4 != 0, &p);
  if (err != cudaSuccess) return int(err);
  const int report[7] = {p.vec4, kThreads, p.per_sm, p.blocks, p.samples, 4, 0};
  for (int k = 0; k < 7; ++k) out[k] = report[k];
  return int(cudaSuccess);
}

// The 'bf16' fetch: `grid` is the bf16 channel-minor copy, `out` float32.
// `vec8` asks for 16-byte loads of 8 channels and requires C % 8 == 0 with
// 16-byte aligned grid and out (the wrapper checks).  Returns
// cudaGetLastError() right after the launch.
extern "C" int lfgc_grid_sample_fwd_bf16(const void* grid, const void* coords,
                                         void* out, int64_t n, int C, int D,
                                         int H, int W, int vec8, void* stream) {
  if (n <= 0 || C <= 0) return int(cudaSuccess);
  int samples = 0, blocks = 0;
  bf16_plan_of(n, C, &samples, &blocks);
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(grid);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec8) {
    grid_sample_fwd_bf16_kernel<true><<<blocks, kThreads, 0, s>>>(g, c, o, n, C, D, H, W);
  } else {
    grid_sample_fwd_bf16_kernel<false><<<blocks, kThreads, 0, s>>>(g, c, o, n, C, D, H, W);
  }
  return int(cudaGetLastError());
}

// For reports, the 'bf16' fetch's launch: out = [route (1 16-byte lanes, 0
// scalar), threads a block, blocks an SM, blocks, samples a warp step,
// channels a lane (8), shared bytes a block (0)].
extern "C" int lfgc_grid_sample_fwd_bf16_plan(int64_t n, int C, int D, int H, int W,
                                              int vec8, int* out) {
  (void)D; (void)H; (void)W;
  if (C <= 0) return int(cudaErrorInvalidValue);
  int samples = 0, blocks = 0, per_sm = 0, sms = 0;
  bf16_plan_of(n, C, &samples, &blocks);
  const cudaError_t err =
      vec8 ? lfgc::occupancy(grid_sample_fwd_bf16_kernel<true>, kThreads, 0, &per_sm, &sms)
           : lfgc::occupancy(grid_sample_fwd_bf16_kernel<false>, kThreads, 0, &per_sm, &sms);
  if (err != cudaSuccess) return int(err);
  const int report[7] = {vec8 != 0, kThreads, per_sm, blocks, samples, 8, 0};
  for (int k = 0; k < 7; ++k) out[k] = report[k];
  return int(cudaSuccess);
}

extern "C" const char* lfgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
