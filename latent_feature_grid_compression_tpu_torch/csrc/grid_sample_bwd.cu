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
// Design: one thread per (sample, group of channels): a group of 4 with
// float4 loads of g and the sm_90 float4 atomicAdd where C % 4 == 0 and g and
// dG are 16-byte aligned, else one channel with a scalar atomicAdd.
// Neighbouring threads hold neighbouring channels of one sample, so a warp's
// atomics to one corner row land on neighbouring addresses.  One kernel
// covers every grid: the H*W blocking of the TPU kernel was a VMEM limit.
//
// Bound on the card: not bytes.  Per sample it reads 12 bytes of coordinates
// and 4*C bytes of g, and the gradient (216 KB at the flagship 16 x 15^3) is
// written once; at N = 32,768 that is ~0.9 us of HBM traffic.  But it issues
// N*8*C atomic additions (4.2 M at the flagship shape) into D*H*W*C addresses
// (54,000), ~78 to each: L2 atomic throughput and contention on those
// addresses set its time.  Privatising dG in shared memory (216 KB nearly
// fills a block) or a sort-by-cell deterministic variant is later work.
//
// Not bitwise reproducible: the atomics add in an order that changes from
// run to run, so two runs differ in the last bits of each sum (the JAX
// backward, a sequential sum of matmuls, is reproducible).  Tolerances on the
// card are stated with that reason.
//
// The pixel map uses __fmul_rn/__fadd_rn so that it is not contracted into an
// FMA and rounds exactly as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool VEC4>
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

  const float cx = coords[3 * i + 0];
  const float cy = coords[3 * i + 1];
  const float cz = coords[3 * i + 2];
  const float px = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(cx, 1.0f), float(W)), -1.0f), 0.5f);
  const float py = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(cy, 1.0f), float(H)), -1.0f), 0.5f);
  const float pz = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(cz, 1.0f), float(D)), -1.0f), 0.5f);
  const float lx = floorf(px), ly = floorf(py), lz = floorf(pz);
  const float fx = __fadd_rn(px, -lx), fy = __fadd_rn(py, -ly), fz = __fadd_rn(pz, -lz);
  const int x0 = int(lx), y0 = int(ly), z0 = int(lz);

  float gv[4];
  if (VEC4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(g + i * int64_t(C) + c));
    gv[0] = v.x; gv[1] = v.y; gv[2] = v.z; gv[3] = v.w;
  } else {
    gv[0] = __ldg(g + i * int64_t(C) + c);
  }

#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const int z = z0 + dz;
    if (z < 0 || z >= D) continue;
    const float wz = dz ? fz : __fadd_rn(1.0f, -fz);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int y = y0 + dy;
      if (y < 0 || y >= H) continue;
      const float wy = dy ? fy : __fadd_rn(1.0f, -fy);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int x = x0 + dx;
        if (x < 0 || x >= W) continue;
        const float wx = dx ? fx : __fadd_rn(1.0f, -fx);
        const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
        float* dst = dgrid + ((int64_t(z) * H + y) * W + x) * int64_t(C) + c;
        if (VEC4) {
          atomicAdd(reinterpret_cast<float4*>(dst),
                    make_float4(__fmul_rn(w, gv[0]), __fmul_rn(w, gv[1]),
                                __fmul_rn(w, gv[2]), __fmul_rn(w, gv[3])));
        } else {
          atomicAdd(dst, __fmul_rn(w, gv[0]));
        }
      }
    }
  }
}

template <bool VEC4>
void launch(const float* g, const float* coords, float* dgrid, int64_t n,
            int C, int D, int H, int W, cudaStream_t stream) {
  const int64_t threads = n * (C / (VEC4 ? 4 : 1));
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  grid_sample_bwd_kernel<VEC4><<<dim3(unsigned(blocks)), kThreads, 0, stream>>>(
      g, coords, dgrid, n, C, D, H, W);
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers; `dgrid` must be
// zeroed by the caller.  `vec4` asks for the float4 path and requires
// C % 4 == 0 with 16-byte aligned g and dgrid (the wrapper checks).  Returns
// cudaGetLastError() right after the launch.
extern "C" int lfgc_grid_sample_bwd_f32(const void* g, const void* coords,
                                        void* dgrid, int64_t n, int C, int D,
                                        int H, int W, int vec4, void* stream) {
  if (n <= 0 || C <= 0) return int(cudaSuccess);
  const float* gp = static_cast<const float*>(g);
  const float* p = static_cast<const float*>(coords);
  float* d = static_cast<float*>(dgrid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    launch<true>(gp, p, d, n, C, D, H, W, s);
  } else {
    launch<false>(gp, p, d, n, C, D, H, W, s);
  }
  return int(cudaGetLastError());
}

extern "C" const char* lfgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
