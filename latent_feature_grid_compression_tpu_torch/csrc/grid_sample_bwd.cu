// Trilinear feature-grid fetch, gradient with respect to the grid, for Hopper
// (sm_90a).
//
// Replaces the two backward Pallas TPU kernels of
// latent_feature_grid_compression_tpu/ops/pallas_kernels.py:
//   _bwd_kernel          (H*W <= 512, grids up to 22, the flagship grid 15)
//   _bwd_kernel_blocked  (H*W > 512, grids 23..62)
// Those build one-hot weight matrices so that the TPU can avoid scatter, and
// compute dG_stack = W2^T @ (Hz * (g @ S^T)), accumulated over blocks of
// samples on a sequential grid.  Here the same function is computed
// directly, as the transpose of the forward (csrc/grid_sample_fwd.cu):
//
//   dG[z, y, x, c] += w(n, corner) * g[n, c]   for every sample n and each
//                                               of its 8 in-range corners
//
// with the forward's pixel map (align_corners=False, zero padding):
// pix = ((coord + 1) * size - 1) / 2, coords[:, 0] -> W, [:, 1] -> H,
// [:, 2] -> D, floor for the lower corner.  The gradient is channel-minor
// (D, H, W, C) like the forward's grid; the wrapper zeroes it first.
//
// Bound on the card: not bytes.  Per sample it reads 12 bytes of coordinates
// and 4*C bytes of g, and the gradient (216 KB at the flagship 16 x 15^3) is
// written once; at N = 32,768 that is ~0.8 us of HBM traffic.  But summed
// straight into dG it takes N*8*C/4 float4 atomics (1,048,576 at the
// flagship shape), 8N/(D*H*W) of them to each address (78 at the flagship,
// 4,096 at grid 4): the rate at which L2 takes vector atomics, and the
// serialisation of those that hit one address, set the time.  Two routes,
// chosen in one place (plan_of) from the shape and N before the launch:
//
// Shared route, where dG fits in one block's shared memory and the global
// route would add at least kSharedMinAdds times into each address.  Each of
// about one block an SM zeroes its own copy of dG (channel-minor), adds w * g
// of its samples into it with shared-memory atomicAdd, one channel a lane so
// that a sample's C channels hit neighbouring banks, and after a barrier
// adds the copy into dG with one float4 atomicAdd a row and 4 channels:
// 132 * D*H*W*C/4 global atomics on an H100 whatever N is (33,792 at grid 4,
// against 1,048,576 for a train step's batch).  Its cost is the shared adds
// and that flush, so it pays only where the global route serialises on few
// addresses: on an H100 (ablate_fetch.py) from ~1,000 adds an address up
// (grid 6 at 32,768 samples, 1,214 an address) and not below (grid 8, 512).
// Splitting one copy across a thread-block cluster, so that larger grids
// fit, was measured too and lost at every shape: an add into another block's
// shared memory (map_shared_rank) costs several times one into the block's
// own.  A pad column does not help either: rows of 16 floats start on banks
// 0 and 16, so two samples of a warp conflict only when their rows have the
// same parity, and a pitch of 20 makes that more frequent, not less.
//
// Global route, everywhere else (the flagship included): one thread per
// (sample, group of channels), a group of 4 with float4 loads of g and the
// sm_90 float4 atomicAdd where C % 4 == 0 and g and dG are 16-byte aligned,
// else one channel with a scalar atomicAdd; neighbouring threads hold
// neighbouring channels of one sample.
//
// Not bitwise reproducible on either route: shared and global atomics add
// in an order that changes from run to run, so two runs differ in the last
// bits of each sum (the JAX backward, a sequential sum of matmuls, is
// reproducible).  Tolerances on the card are stated with that reason.
//
// The pixel map and corner weights come from trilinear.cuh (shared with the
// forward and the one-kernel forward); they round exactly as the plain
// PyTorch version does.  Launches allocate nothing and do not synchronise;
// the card's limits are queried once a card.
//
// The 'bf16' mode (the TPU kernels' precision='bf16', the bf16 compute
// path) is the BF16 instantiation of both routes' kernels: each corner adds
// trilinear.cuh's 'bf16' term bf16(wxy) * bf16(wz * bf16(g)) (lfgc::
// grad_term), an exact product, so the float32 sums differ from the plain
// version's only in their order, as in 'f32'.  g and dG stay float32; the
// route and the launch are chosen as in 'f32'.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "trilinear.cuh"

namespace {

constexpr int kThreads = 256;          // global route
constexpr int kSharedThreads = 1024;   // shared route: one block fills an SM's warps
// the shared route's least adds an address on the global route (8N / rows)
constexpr int64_t kSharedMinAdds = 1024;

template <bool VEC4, bool BF16>
__global__ void __launch_bounds__(kThreads)
grid_sample_bwd_kernel(const float* __restrict__ g,       // (N, C)
                       const float* __restrict__ coords,  // (N, 3)
                       float* __restrict__ dgrid,         // (D*H*W, C), zeroed
                       int64_t n, int C, int D, int H, int W) {
  constexpr int kPer = VEC4 ? 4 : 1;
  const int groups = C / kPer;
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * groups) return;
  const int64_t i = t / groups;
  const int c = int(t - i * groups) * kPer;

  const lfgc::Cell cell =
      lfgc::cell_of(coords[3 * i + 0], coords[3 * i + 1], coords[3 * i + 2], D, H, W);

  float gv[4];
  if (VEC4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(g + i * int64_t(C) + c));
    gv[0] = v.x; gv[1] = v.y; gv[2] = v.z; gv[3] = v.w;
  } else {
    gv[0] = __ldg(g + i * int64_t(C) + c);
  }

  lfgc::for_each_corner_split(cell, D, H, W, [&](int64_t r, float wxy, float wz) {
    float* dst = dgrid + r * int64_t(C) + c;
    if (VEC4) {
      atomicAdd(reinterpret_cast<float4*>(dst),
                make_float4(lfgc::grad_term<BF16>(wxy, wz, gv[0]),
                            lfgc::grad_term<BF16>(wxy, wz, gv[1]),
                            lfgc::grad_term<BF16>(wxy, wz, gv[2]),
                            lfgc::grad_term<BF16>(wxy, wz, gv[3])));
    } else {
      atomicAdd(dst, lfgc::grad_term<BF16>(wxy, wz, gv[0]));
    }
  });
}

// The shared route: the block's shared memory holds dG, rows `pitch` floats
// apart.  `vec4`: the flush may add float4s (C % 4 == 0, dG 16-byte aligned).
template <bool BF16>
__global__ void __launch_bounds__(kSharedThreads, 1)
grid_sample_bwd_shared_kernel(const float* __restrict__ g,       // (N, C)
                              const float* __restrict__ coords,  // (N, 3)
                              float* __restrict__ dgrid,         // (D*H*W, C), zeroed
                              int64_t n, int C, int D, int H, int W, int pitch, int vec4) {
  extern __shared__ float4 smem4[];
  float* sum = reinterpret_cast<float*>(smem4);
  const int rows = D * H * W;
  for (int e = threadIdx.x; e < rows * pitch; e += blockDim.x) sum[e] = 0.0f;
  __syncthreads();

  const int Lw = C < 32 ? C : 32, P = 32 / Lw;
  const int lane = threadIdx.x & 31, slot = lane / Lw, sub = lane - slot * Lw;
  if (slot < P) {
    const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int64_t stride = (int64_t(gridDim.x) * blockDim.x >> 5) * P;
    for (int64_t i = warp * P + slot; i < n; i += stride) {
      const lfgc::Cell cell = lfgc::cell_of(__ldg(coords + 3 * i + 0), __ldg(coords + 3 * i + 1),
                                            __ldg(coords + 3 * i + 2), D, H, W);
      for (int c = sub; c < C; c += Lw) {
        const float gv = __ldg(g + i * C + c);
        lfgc::for_each_corner_split(cell, D, H, W, [&](int64_t r, float wxy, float wz) {
          atomicAdd(sum + int(r) * pitch + c, lfgc::grad_term<BF16>(wxy, wz, gv));
        });
      }
    }
  }
  __syncthreads();

  const int Q = vec4 ? C / 4 : C;
  for (int e = threadIdx.x; e < rows * Q; e += blockDim.x) {
    const int r = e / Q, q = e - r * Q;
    const float* src = sum + r * pitch;
    if (vec4) {
      atomicAdd(reinterpret_cast<float4*>(dgrid + int64_t(r) * C) + q,
                make_float4(src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]));
    } else {
      atomicAdd(dgrid + int64_t(r) * C + q, src[q]);
    }
  }
}

// The current card's SMs and the shared memory a block may opt into, queried
// once a card; the first query also lets the shared-route kernel (both
// modes) take all of it, so that every shape whose dG fits launches.
cudaError_t card_limits(int* sms, int* optin) {
  static lfgc::PerCard cache;
  return lfgc::per_card(cache, sms, optin, [](int* s, int* o) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(s, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(o, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err == cudaSuccess) {
      err = lfgc::allow_smem(grid_sample_bwd_shared_kernel<false>, size_t(*o));
    }
    if (err == cudaSuccess) err = lfgc::allow_smem(grid_sample_bwd_shared_kernel<true>, size_t(*o));
    return err;
  });
}

// How the gradient of n samples launches.
struct Plan {
  int shared;    // 1: the shared route
  int blocks;
  int threads;
  int pitch;     // shared route: floats a row of the copy takes
  int smem;      // shared route: dynamic shared bytes a block
};

// The route, in one place: shared where one block's shared memory holds dG
// and the global route would add at least kSharedMinAdds times into each
// address of dG.
cudaError_t plan_of(int64_t n, int C, int D, int H, int W, bool vec4, Plan* p) {
  int sms = 0, optin = 0;
  const cudaError_t err = card_limits(&sms, &optin);
  if (err != cudaSuccess) return err;
  p->pitch = C;
  const int64_t rows = int64_t(D) * H * W, bytes = rows * p->pitch * 4;
  p->smem = int(bytes <= optin ? bytes : 0);
  p->shared = bytes <= optin && 8 * n >= kSharedMinAdds * rows;
  if (p->shared) {
    const int lanes = C < 32 ? C : 32, per_warp = 32 / lanes;
    const int64_t warps = (n + per_warp - 1) / per_warp;
    const int64_t need = (warps + kSharedThreads / 32 - 1) / (kSharedThreads / 32);
    p->blocks = int(need < sms ? need : sms);
    p->threads = kSharedThreads;
  } else {
    const int64_t threads = n * (C / (vec4 ? 4 : 1));
    p->blocks = int((threads + kThreads - 1) / kThreads);
    p->threads = kThreads;
  }
  return cudaSuccess;
}

// The gradient in a mode: the route from plan_of, then its kernel.
template <bool BF16>
cudaError_t launch(const void* g, const void* coords, void* dgrid, int64_t n, int C,
                   int D, int H, int W, int vec4, void* stream) {
  if (n <= 0 || C <= 0) return cudaSuccess;
  Plan p;
  const cudaError_t err = plan_of(n, C, D, H, W, vec4 != 0, &p);
  if (err != cudaSuccess) return err;
  const float* gp = static_cast<const float*>(g);
  const float* c = static_cast<const float*>(coords);
  float* d = static_cast<float*>(dgrid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.shared) {
    grid_sample_bwd_shared_kernel<BF16><<<p.blocks, kSharedThreads, p.smem, s>>>(
        gp, c, d, n, C, D, H, W, p.pitch, vec4);
  } else if (vec4) {
    grid_sample_bwd_kernel<true, BF16><<<p.blocks, kThreads, 0, s>>>(gp, c, d, n, C, D, H, W);
  } else {
    grid_sample_bwd_kernel<false, BF16><<<p.blocks, kThreads, 0, s>>>(gp, c, d, n, C, D, H, W);
  }
  return cudaGetLastError();
}

// The launch report of a mode (see lfgc_grid_sample_bwd_plan).
template <bool BF16>
cudaError_t report(int64_t n, int C, int D, int H, int W, int vec4, int* out) {
  if (C <= 0) return cudaErrorInvalidValue;
  Plan p;
  int per_sm = 0, sms = 0;
  cudaError_t err = plan_of(n, C, D, H, W, vec4 != 0, &p);
  if (err == cudaSuccess) {
    err = p.shared ? lfgc::occupancy(grid_sample_bwd_shared_kernel<BF16>, kSharedThreads,
                                     size_t(p.smem), &per_sm, &sms)
          : vec4 ? lfgc::occupancy(grid_sample_bwd_kernel<true, BF16>, kThreads, 0, &per_sm,
                                   &sms)
                 : lfgc::occupancy(grid_sample_bwd_kernel<false, BF16>, kThreads, 0, &per_sm,
                                   &sms);
  }
  if (err != cudaSuccess) return err;
  const int per = p.shared || !vec4 ? 1 : 4, lanes = C / per < 32 ? C / per : 32;
  const int rep[7] = {p.shared, p.threads, per_sm, p.blocks, 32 / lanes, per,
                      p.shared ? p.smem : 0};
  for (int k = 0; k < 7; ++k) out[k] = rep[k];
  return cudaSuccess;
}

}  // namespace

// Plain C entries for ctypes, one a mode ('f32', 'bf16').  Pointers are
// device pointers; `dgrid` must be zeroed by the caller.  `vec4` asks for
// float4 loads and atomics and requires C % 4 == 0 with 16-byte aligned g
// and dgrid (the wrapper checks).  The route comes from the shape and n
// (plan_of).  Returns the first CUDA error of the plan or cudaGetLastError()
// right after the launch.
extern "C" int lfgc_grid_sample_bwd_f32(const void* g, const void* coords,
                                        void* dgrid, int64_t n, int C, int D,
                                        int H, int W, int vec4, void* stream) {
  return int(launch<false>(g, coords, dgrid, n, C, D, H, W, vec4, stream));
}

extern "C" int lfgc_grid_sample_bwd_bf16(const void* g, const void* coords,
                                         void* dgrid, int64_t n, int C, int D,
                                         int H, int W, int vec4, void* stream) {
  return int(launch<true>(g, coords, dgrid, n, C, D, H, W, vec4, stream));
}

// For reports, the gradient's launch for n samples of this shape on the
// current card, one entry a mode: out = [route (1 shared, 0 global), threads
// a block, blocks an SM, blocks, samples a warp step, channels a lane,
// shared bytes a block (0 on the global route)].
extern "C" int lfgc_grid_sample_bwd_plan(int64_t n, int C, int D, int H, int W,
                                         int vec4, int* out) {
  return int(report<false>(n, C, D, H, W, vec4, out));
}

extern "C" int lfgc_grid_sample_bwd_bf16_plan(int64_t n, int C, int D, int H, int W,
                                              int vec4, int* out) {
  return int(report<true>(n, C, D, H, W, vec4, out));
}

extern "C" const char* lfgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
