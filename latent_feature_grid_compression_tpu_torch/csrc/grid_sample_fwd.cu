// Trilinear feature-grid fetch, forward, for Hopper (sm_90a).
//
// Replaces the two forward Pallas TPU kernels of
// latent_feature_grid_compression_tpu/ops/pallas_kernels.py, in both of
// their precisions ('f32', and 'bf16': `_dot`'s single bf16 pass):
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
// corners skipped.  The grid is channel-minor (D, H, W, C) float32 in both
// modes, so a corner is one contiguous row of C floats.
//
// Bound on the card: bytes, in both modes (the float32 grid is read in
// both).  Per sample it reads 12 bytes of coordinates and writes 4*C bytes;
// the grid (216 KB at the flagship 16 x 15^3, 15.2 MB at 16 x 62^3) stays in
// the 50 MB L2, so its 8*C-float corner reads per sample are L2 traffic, not
// DRAM traffic.  Arithmetic is ~2*8*C FLOPs per sample, far below the
// float32 rate, so in 'f32' what matters is how the accesses coalesce and
// how much latency is in flight.  'bf16' adds ~1.5 conversions a grid value
// read (8*C a sample), which make it issue-bound where the card is full.
//
// Design: lanes run over channel groups.  A sample's C channels go to
// L = ceil(C / K) neighbouring lanes, K channels a lane (4; 8 in 'bf16'
// where n is large, below): in float4s where C % 4 == 0 and the grid and
// the output are 16-byte aligned, else with up to K guarded scalar loads a
// corner (one channel a lane issued ~5x the instructions a sample at C = 5
// and lost to F.grid_sample); a warp takes 32 / L samples at a step (8 at
// C = 16 and 4 a lane).  Every lane finds its
// sample's cell itself: a warp issues the same instructions as when one lane
// finds it, and shuffling it to the others costs more than it saves
// (ablate_fetch.py, fwd_cell_shfl).  Each corner is then one warp-wide load
// of whole rows (the sample's L lanes read its 4*C-byte row), and each
// output store writes the step's samples' rows, which are contiguous.  Where
// a sample needs more than 32 lanes (C > 128) its lanes loop over the rest.
// Blocks are persistent: as many as the card holds at once (occupancy x
// SMs, queried for each route and mode), each warp walking steps with a
// grid stride and loading the next step's coordinates before it fetches
// this step's corners, so their latency hides behind the corner loads.  The
// unrolled corners keep 8 loads in flight a lane (61 registers with float4s
// in 'f32', 4 blocks an SM); a launch bound that caps them at 40 for 6
// blocks an SM spills and runs ~60% slower (fwd_min_blocks_6).
//
// The pixel map, the corner weights and the sums come from trilinear.cuh
// (lfgc::fetch_channels, shared with the gradient and the one-kernel
// forward); they round exactly as the plain PyTorch version does.  'f32':
// each channel is the fmaf chain from 0 over the in-range corners in
// for_each_corner's order, so the one-kernel forward's features equal this
// kernel's output bit for bit; the plain version differs only in the
// rounding of the 8-term sum.  'bf16' (the bf16 compute path): the TPU
// kernel's rounding points, each grid value and xy weight rounded to bf16
// as it is loaded (the TPU kernel rounds G to bf16 before the MXU, so no
// bf16 copy of the grid is made: the grid's bytes are the float32 mode's),
// each z plane's 4 corners summed in float32, the plane's sum times wz
// rounded to bf16, the planes added in float32; the output stays float32.
// The products are exact and the sums run in the plain version's order, so
// the kernel equals it bit for bit (and the one-kernel forward's 'bf16'
// features).  The conversions are packed two to an instruction
// (lfgc::bf16_round_all): one at a time, or by integer operations, they are
// slower (ablate_fetch.py, fwd_bf16_round_each, fwd_bf16_round_int).  Where
// the samples fill the card several times over (kWideSteps), 'bf16' lanes
// take 8 channels (two float4s a corner, or 8 scalar loads), so that a
// corner's weights, their rounding and its row offset serve twice the
// channels: faster on a lattice chunk and at C = 5, though the plane sums
// then hold 103 registers on the scalar route and 76 on the float4 route
// (2 and 3 blocks an SM).  A train step's batch gives each warp one step,
// and there 4 a lane keeps twice the warps in flight and is faster
// (fwd_8_a_lane, fwd_4_a_lane, fwd_8_a_lane_scalar; PERF.md section 6).
// The occupancy query sizes each kernel's grid on its own.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "trilinear.cuh"

namespace {

constexpr int kThreads = 256;
// 'bf16': lanes take 8 channels (wide) where the warp steps at 4 a lane are
// at least kWideSteps times the warps the card holds (a lattice chunk or a
// query of 2^18 points), else 4 (a train step's 32,768 samples).
constexpr int kWideSteps = 4;

// K channels of a corner's row from column c into v: float4s where VEC4
// (each group of 4 past the first guarded by C), else guarded scalar loads;
// zeros past C.
template <bool VEC4, int K>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int c, int C,
                                         float* v) {
  if (VEC4) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 g = q == 0 || c + 4 * q < C
                           ? __ldg(reinterpret_cast<const float4*>(src) + q)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * q] = g.x;
      v[4 * q + 1] = g.y;
      v[4 * q + 2] = g.z;
      v[4 * q + 3] = g.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = c + k < C ? __ldg(src + k) : 0.0f;
  }
}

template <bool VEC4, bool BF16, int K>
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_kernel(const float* __restrict__ grid,    // (D*H*W, C)
                       const float* __restrict__ coords,  // (N, 3)
                       float* __restrict__ out,           // (N, C)
                       int64_t n, int C, int D, int H, int W) {
  static_assert(K % 4 == 0, "a lane takes whole groups of 4 channels");
  const int L = (C + K - 1) / K;        // lanes a sample needs
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
    for (int c = K * sub; c < C; c += K * Lw) {
      float acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0.0f;
      lfgc::fetch_channels<BF16, K>(cell, D, H, W, [&](int64_t r, float* v) {
        load_row<VEC4, K>(grid + r * C + c, c, C, v);
      }, acc);
      if (VEC4) {
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          if (q == 0 || c + 4 * q < C) {
            *reinterpret_cast<float4*>(dst + c + 4 * q) =
                make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
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
  int vec4;      // float4 lanes, else scalar loads
  int channels;  // channels a lane: 4, or 8 (wide, 'bf16' only)
  int per_sm;    // blocks an SM holds at once
  int blocks;    // the grid: at most per_sm x SMs, at most one warp a step
  int samples;   // samples a warp takes at a step
};

using Kernel = void (*)(const float*, const float*, float*, int64_t, int, int, int, int);

// The kernel of a route, mode and lane width (8 only in 'bf16').
Kernel kernel_of(bool vec4, bool bf16, int channels) {
  if (!bf16) {
    return vec4 ? grid_sample_fwd_kernel<true, false, 4> : grid_sample_fwd_kernel<false, false, 4>;
  }
  if (channels == 8) {
    return vec4 ? grid_sample_fwd_kernel<true, true, 8> : grid_sample_fwd_kernel<false, true, 8>;
  }
  return vec4 ? grid_sample_fwd_kernel<true, true, 4> : grid_sample_fwd_kernel<false, true, 4>;
}

// SMs and blocks an SM holds, queried once a card and kernel.
cudaError_t occupancy_of(bool vec4, bool bf16, int channels, int* sms, int* per_sm) {
  static lfgc::PerCard cache[8];
  return lfgc::per_card(cache[vec4 + 2 * bf16 + 4 * (channels == 8)], sms, per_sm,
                        [&](int* s, int* b) {
                          return lfgc::occupancy(kernel_of(vec4, bf16, channels), kThreads,
                                                 0, b, s);
                        });
}

cudaError_t plan_of(int64_t n, int C, bool vec4, bool bf16, Plan* p) {
  p->vec4 = vec4;
  int sms = 0;
  int64_t steps = 0;
  for (p->channels = 4;; p->channels = 8) {
    const int L = (C + p->channels - 1) / p->channels;
    p->samples = 32 / (L < 32 ? L : 32);
    const cudaError_t err = occupancy_of(vec4, bf16, p->channels, &sms, &p->per_sm);
    if (err != cudaSuccess) return err;
    steps = (n + p->samples - 1) / p->samples;
    const int64_t warps = int64_t(sms) * p->per_sm * (kThreads / 32);
    const bool wide = bf16 && steps >= kWideSteps * warps;
    if (p->channels == 8 || !wide) break;
  }
  const int64_t need = (steps + kThreads / 32 - 1) / (kThreads / 32);
  const int64_t most = int64_t(sms) * p->per_sm;
  p->blocks = int(need < most ? (need > 0 ? need : 1) : most);
  return cudaSuccess;
}

int launch(const void* grid, const void* coords, void* out, int64_t n, int C, int D,
           int H, int W, bool vec4, bool bf16, void* stream) {
  if (n <= 0 || C <= 0) return int(cudaSuccess);
  Plan p;
  const cudaError_t err = plan_of(n, C, vec4, bf16, &p);
  if (err != cudaSuccess) return int(err);
  const Kernel kernel = kernel_of(p.vec4, bf16, p.channels);
  kernel<<<p.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), static_cast<const float*>(coords),
      static_cast<float*>(out), n, C, D, H, W);
  return int(cudaGetLastError());
}

// For reports: out = [route (1 float4 lanes, 0 scalar), threads a block,
// blocks an SM, blocks, samples a warp step, channels a lane, shared bytes a
// block (0)].
int report(int64_t n, int C, bool vec4, bool bf16, int* out) {
  if (C <= 0) return int(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan_of(n, C, vec4, bf16, &p);
  if (err != cudaSuccess) return int(err);
  const int r[7] = {p.vec4, kThreads, p.per_sm, p.blocks, p.samples, p.channels, 0};
  for (int k = 0; k < 7; ++k) out[k] = r[k];
  return int(cudaSuccess);
}

}  // namespace

// Plain C entries for ctypes, one a mode ('f32', 'bf16'), with the same
// arguments: the float32 channel-minor grid, float32 coordinates and
// output.  Pointers are device pointers; `vec4` asks for float4 lanes and
// requires C % 4 == 0 with 16-byte aligned grid and out (the wrapper
// checks).  Returns the first CUDA error of the plan or cudaGetLastError()
// right after the launch.
extern "C" int lfgc_grid_sample_fwd_f32(const void* grid, const void* coords,
                                        void* out, int64_t n, int C, int D,
                                        int H, int W, int vec4, void* stream) {
  return launch(grid, coords, out, n, C, D, H, W, vec4 != 0, false, stream);
}

extern "C" int lfgc_grid_sample_fwd_bf16(const void* grid, const void* coords,
                                         void* out, int64_t n, int C, int D,
                                         int H, int W, int vec4, void* stream) {
  return launch(grid, coords, out, n, C, D, H, W, vec4 != 0, true, stream);
}

// The launch each mode's entry makes for this shape on the current card
// (see report).
extern "C" int lfgc_grid_sample_fwd_plan(int64_t n, int C, int D, int H, int W,
                                         int vec4, int* out) {
  (void)D; (void)H; (void)W;
  return report(n, C, vec4 != 0, false, out);
}

extern "C" int lfgc_grid_sample_fwd_bf16_plan(int64_t n, int C, int D, int H, int W,
                                              int vec4, int* out) {
  (void)D; (void)H; (void)W;
  return report(n, C, vec4 != 0, true, out);
}

extern "C" const char* lfgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
