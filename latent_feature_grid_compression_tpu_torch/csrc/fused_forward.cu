// The one-kernel model forward (trilinear fetch + Fourier embedding + the
// SnakeAlt MLP), forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// latent_feature_grid_compression_tpu/ops/fused_forward.py:
//   _fwd_kernel  (from _fused_fwd)
//   _bwd_kernel  (from _fused_bwd: recompute the MLP, emit dW, db and the
//                 grid's gradient; no coordinate gradient)
// Those fetch through one-hot matmuls over a G_stack layout so that the TPU
// avoids gathers and scatters, and keep x0 and the activations in VMEM.  Here
// each sample's features come straight from the channel-minor (D, H, W, C)
// grid with the fetch kernel's own pixel map and corner order
// (trilinear.cuh), so they equal csrc/grid_sample_fwd.cu's bit for bit; x0 =
// [coords | sin/cos(2^j 2 pi coords) | features] goes into shared memory, and
// the MLP runs there as in csrc/mlp_fused.cu (snake_mlp.cuh).  Only the
// (N, d_out) output leaves the block: the backward recomputes x0 (cheaper
// than storing it) and the chain.
//
// The backward's dW and db are reduced per block and then in a fixed order;
// the feature columns of dX (float32) are routed into the channel-minor
// gradient of the grid through the 8 corner weights with atomicAdd, like
// csrc/grid_sample_bwd.cu.  The atomics add in an order that changes from run
// to run: the grid's gradient is not bitwise reproducible.
//
// Bound on the card: operations.  Per sample it reads 12 bytes of
// coordinates and writes 4 * d_out (the grid, 216 KB at the flagship, stays
// in L2), while the MLP costs 8,192 FLOPs forward at the flagship widths (the
// fetch 2 * 8 * C more): 0.00067 ms forward and 0.00162 ms backward for
// 32,768 samples in 'mixed'.  The 'mixed' kernels run the MLP's products on
// the tensor cores (mma.sync on bf16 fragments, snake_mlp_tc.cuh, shared with
// the MLP kernels of mlp_fused.cu) in blocks that stage the weights once and
// walk tiles of samples: x0 goes into its bf16 layer-0 buffer, the forward
// runs the same chain as the backward's recompute, and the backward hands dX
// back in float32.  The 'f32' kernels run the MLP on the CUDA cores in
// float32 FMAs out of shared memory (snake_mlp.cuh), a forward block a tile.
//
// Precision: `bf16` set is the TPU kernel's 'mixed' (the fetch and the
// routing into dG in float32, the MLP's products on bfloat16 operands);
// unset, everything is float32.  `interp_bf16` set with `bf16` is the TPU
// kernel's 'bf16': the MLP half as in 'mixed', the fetch of x0's feature
// columns and the routing of dX into dG by trilinear.cuh's 'bf16' formulas
// (lfgc::fetch_channels, lfgc::grad_term: the same code as the 'bf16' fetch
// and gradient kernels, so the features equal grid_sample_fwd.cu's 'bf16'
// output bit for bit; the grid's float32 values are rounded to bf16 as
// they are loaded).  The mode reaches the kernels in Grid::bf16, a branch
// taken alike by every thread.  sinf/cosf, not the fast intrinsics: the
// Fourier arguments reach 2^(n_freqs-1) * 2 pi * |coord|.

#include <cuda_runtime.h>
#include <stdint.h>

#include "snake_mlp.cuh"
#include "snake_mlp_tc.cuh"
#include "trilinear.cuh"

namespace {

using namespace lfgc;

struct Grid {
  const float* data;  // (D, H, W, C)
  int C, D, H, W;
  int bf16;           // the interpolation in 'bf16' (else float32)
};

// float32(2^j * 2 pi), as the plain version's np.float32(2**j * 2 * pi).
__device__ __forceinline__ float freq(int j) { return ldexpf(6.28318548f, j); }

// Column col < 3 + 6 n_freqs of x0 at the coordinates c: the coordinate,
// or per frequency j the sin of the 3 coordinates, then the cos of the 3.
__device__ __forceinline__ float embedding(const float* c, int col) {
  if (col < 3) return c[col];
  const int j = (col - 3) / 6, q = col - 3 - 6 * j;
  const float arg = __fmul_rn(c[q % 3], freq(j));
  return q < 3 ? sinf(arg) : cosf(arg);
}

// put(s, col, v) for x0 of the tile's rows (zeros past n).
template <class Put>
__device__ void build_x0(Put&& put, const float* __restrict__ coords, const Grid& g,
                         int n_freqs, int S, int64_t row0, int64_t n) {
  const int emb = 3 + 6 * n_freqs, K0 = emb + g.C;
  for (int e = threadIdx.x; e < S * K0; e += blockDim.x) {
    const int s = e / K0, col = e - s * K0;
    const int64_t r = row0 + s;
    float v = 0.0f;
    if (r < n) {
      const float* c = coords + 3 * r;
      if (col < emb) {
        v = embedding(c, col);
      } else {
        const int ch = col - emb;
        float acc = 0.0f;
        for_each_corner(cell_of(c[0], c[1], c[2], g.D, g.H, g.W), g.D, g.H, g.W,
                        [&](int64_t row, float w) {
                          acc = fmaf(w, __ldg(g.data + row * g.C + ch), acc);
                        });
        v = acc;
      }
    }
    put(s, col, v);
  }
}

// op(x0) into rows of pitch P of a.
template <bool BF16>
__device__ void build_x0(float* a, int P, const float* __restrict__ coords,
                         const Grid& g, int n_freqs, int S, int64_t row0, int64_t n) {
  build_x0([&](int s, int col, float v) { a[s * P + col] = op<BF16>(v); }, coords, g,
           n_freqs, S, row0, n);
}

// op(x0) of the tile's rows into the bf16 layer-0 buffer of the tensor-core
// plan p (zeros past n).  The embedding one entry a thread, as build_x0; the
// features one thread a sample and 4 channels, which finds the cell and its
// corner weights once for the 4 and loads them together (one float4 where
// the grid allows).  Each channel is computed by the fetch kernels' code in
// the mode IBF16 (lfgc::fetch_channels), so the features equal their output
// bit for bit.
template <bool IBF16>
__device__ void build_x0_tc(const TcPlan& p, unsigned char* smem,
                            const float* __restrict__ coords, const Grid& g, int n_freqs,
                            int64_t row0, int64_t n) {
  bf16* x0 = tc_x0(p, smem);
  const int S = p.S, P0 = tc_x0_pitch(p), emb = 3 + 6 * n_freqs, C = g.C, Q = (C + 3) / 4;
  for (int e = threadIdx.x; e < S * emb; e += blockDim.x) {
    const int s = e / emb, col = e - s * emb;
    const int64_t r = row0 + s;
    x0[s * P0 + col] = __float2bfloat16_rn(r < n ? embedding(coords + 3 * r, col) : 0.0f);
  }
  const bool vec4 = C % 4 == 0 && (reinterpret_cast<uintptr_t>(g.data) & 15) == 0;
  for (int e = threadIdx.x; e < S * Q; e += blockDim.x) {
    const int s = e / Q, c0 = 4 * (e - s * Q);
    const int64_t r = row0 + s;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r < n) {
      const float* c = coords + 3 * r;
      fetch_channels<IBF16>(cell_of(c[0], c[1], c[2], g.D, g.H, g.W), g.D, g.H, g.W,
                            [&](int64_t row, float* v) {
                              const float* src = g.data + row * C + c0;
                              if (vec4) {
                                const float4 f = __ldg(reinterpret_cast<const float4*>(src));
                                v[0] = f.x;
                                v[1] = f.y;
                                v[2] = f.z;
                                v[3] = f.w;
                              } else {
#pragma unroll
                                for (int k = 0; k < 4; ++k) {
                                  v[k] = c0 + k < C ? __ldg(src + k) : 0.0f;
                                }
                              }
                            },
                            acc);
    }
    bf16* d = x0 + s * P0 + emb + c0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k < C) d[k] = __float2bfloat16_rn(acc[k]);
    }
  }
}

// 'f32': tile_forward of snake_mlp.cuh, a block a tile of kFwdTile samples
// (the plan p unused).
template <bool BF16>
__global__ void __launch_bounds__(kMlpThreads)
fused_fwd_kernel(const __grid_constant__ Mlp m, const __grid_constant__ TcPlan p, Grid g,
                 const float* __restrict__ coords, float* __restrict__ out, int64_t n,
                 int n_freqs) {
  extern __shared__ float smem[];
  const int S = kFwdTile, P = m.pitch;
  float* a = smem;
  float* b = a + S * P;
  float* wst = b + S * P;
  const int64_t row0 = int64_t(blockIdx.x) * S;
  build_x0<BF16>(a, P, coords, g, n_freqs, S, row0, n);
  tile_forward<BF16>(m, a, b, wst, S, out, row0, n);
}

// 'mixed': x0 into the bf16 layer-0 buffer, then the tensor-core
// tile_forward_tc (snake_mlp_tc.cuh), on tiles of p.S samples in blocks of
// kTcFwdThreads that stage the weights once (where they stay) and walk tiles
// blockIdx.x, + gridDim.x, ...
template <>
__global__ void __launch_bounds__(kTcFwdThreads, kTcFwdMinBlocks)
fused_fwd_kernel<true>(const __grid_constant__ Mlp m, const __grid_constant__ TcPlan p,
                       Grid g, const float* __restrict__ coords, float* __restrict__ out,
                       int64_t n, int n_freqs) {
  extern __shared__ float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  tc_stage_resident(m, p, base);
  const int64_t tiles = (n + p.S - 1) / p.S;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row0 = t * p.S;
    __syncthreads();  // the previous tile's readers are done
    tc_zero_x0_pad(m, p, base);   // a later layer's h shares h_0's buffer
    if (g.bf16) {
      build_x0_tc<true>(p, base, coords, g, n_freqs, row0, n);
    } else {
      build_x0_tc<false>(p, base, coords, g, n_freqs, row0, n);
    }
    tile_forward_tc(m, p, base, out, row0, n);
  }
}

// Routes the feature columns of dX (pitch P) into dG through the corner
// weights, by atomics, in the mode IBF16 (lfgc::grad_term, the gradient
// kernels' terms).
template <bool IBF16>
__device__ void route_dx(const float* dx, int P, int emb, const Grid& g,
                         const float* __restrict__ coords, float* __restrict__ dgrid,
                         int S, int64_t row0, int64_t n) {
  for (int e = threadIdx.x; e < S * g.C; e += blockDim.x) {
    const int s = e / g.C, ch = e - s * g.C;
    const int64_t r = row0 + s;
    if (r >= n) continue;
    const float v = dx[s * P + emb + ch];
    const float* c = coords + 3 * r;
    for_each_corner_split(cell_of(c[0], c[1], c[2], g.D, g.H, g.W), g.D, g.H, g.W,
                          [&](int64_t row, float wxy, float wz) {
                            atomicAdd(dgrid + row * g.C + ch, grad_term<IBF16>(wxy, wz, v));
                          });
  }
}

// 'f32': tile_backward of snake_mlp.cuh on tiles of S samples (the plan p
// unused).
template <bool BF16>
__global__ void __launch_bounds__(kMlpThreads)
fused_bwd_kernel(const __grid_constant__ Mlp m, const __grid_constant__ TcPlan p, Grid g,
                 const float* __restrict__ coords, const float* __restrict__ gout,
                 float* __restrict__ dgrid, float* __restrict__ partial, int64_t n,
                 int n_freqs, int S) {
  extern __shared__ float smem[];
  const int P = m.pitch, D = m.dim[m.nw], emb = 3 + 6 * n_freqs;
  float* dz = smem + (2 * m.nw - 1) * S * P;
  float* slot = partial + int64_t(blockIdx.x) * m.total;
  const int64_t tiles = (n + S - 1) / S;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row0 = t * S;
    __syncthreads();  // the previous tile's readers are done
    build_x0<BF16>(smem, P, coords, g, n_freqs, S, row0, n);
    for (int e = threadIdx.x; e < S * D; e += blockDim.x) {
      const int s = e / D, o = e - s * D;
      dz[s * P + o] = row0 + s < n ? gout[(row0 + s) * D + o] : 0.0f;
    }
    const float* dx = tile_backward<BF16>(m, smem, S, slot, t == blockIdx.x);
    route_dx<false>(dx, P, emb, g, coords, dgrid, S, row0, n);
  }
}

// 'mixed': the tensor-core tile_backward_tc (snake_mlp_tc.cuh) on tiles of
// p.S samples, two blocks of kTcThreads an SM; x0 goes into its bf16 layer-0
// buffer; dW and db summed across the block's tiles in `acc` and written to
// its slot once.
template <>
__global__ void __launch_bounds__(kTcThreads, 2)
fused_bwd_kernel<true>(const __grid_constant__ Mlp m, const __grid_constant__ TcPlan p,
                       Grid g, const float* __restrict__ coords,
                       const float* __restrict__ gout, float* __restrict__ dgrid,
                       float* __restrict__ partial, int64_t n, int n_freqs, int) {
  extern __shared__ float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int P0 = tc_x0_pitch(p), emb = 3 + 6 * n_freqs;
  float* slot = partial + int64_t(blockIdx.x) * m.total;
  float* acc = tc_acc(p, base, slot);
  tc_begin(m, p, base, acc);
  const int64_t tiles = (n + p.S - 1) / p.S;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row0 = t * p.S;
    __syncthreads();  // the previous tile's readers are done
    if (g.bf16) {
      build_x0_tc<true>(p, base, coords, g, n_freqs, row0, n);
    } else {
      build_x0_tc<false>(p, base, coords, g, n_freqs, row0, n);
    }
    tc_load_grad(m, p, base, gout, row0, n);
    const float* dx = tile_backward_tc(m, p, base, acc);
    if (g.bf16) {
      route_dx<true>(dx, P0, emb, g, coords, dgrid, p.S, row0, n);
    } else {
      route_dx<false>(dx, P0, emb, g, coords, dgrid, p.S, row0, n);
    }
  }
  tc_end(m, p, base, acc, slot);
}

// The forward kernel at a precision.
inline decltype(&fused_fwd_kernel<true>) fwd_kernel(bool bf16) {
  return bf16 ? fused_fwd_kernel<true> : fused_fwd_kernel<false>;
}

template <bool BF16>
cudaError_t launch_fwd(const Mlp& m, const Grid& g, const float* coords, float* out,
                       int64_t n, int n_freqs, cudaStream_t stream) {
  Launch b;
  cudaError_t err = fwd_launch(fwd_kernel(BF16), BF16, m, n, &b);
  if (err != cudaSuccess) return err;
  fused_fwd_kernel<BF16><<<dim3(unsigned(b.blocks)), b.threads, b.smem, stream>>>(
      m, b.p, g, coords, out, n, n_freqs);
  return cudaGetLastError();
}

// The backward kernel at a precision.
inline decltype(&fused_bwd_kernel<true>) bwd_kernel(bool bf16) {
  return bf16 ? fused_bwd_kernel<true> : fused_bwd_kernel<false>;
}

template <bool BF16>
cudaError_t launch_bwd(const Mlp& m, const Grid& g, const float* coords,
                       const float* gout, float* dgrid, float* dparams,
                       float* partial, int64_t n, int n_freqs, cudaStream_t stream) {
  Launch b;
  cudaError_t err = bwd_launch(bwd_kernel(BF16), BF16, m, n, &b);
  if (err != cudaSuccess) return err;
  fused_bwd_kernel<BF16><<<dim3(unsigned(b.blocks)), b.threads, b.smem, stream>>>(
      m, b.p, g, coords, gout, dgrid, partial, n, n_freqs, b.S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_slots(partial, dparams, m.total, b.blocks, stream);
}

// The kernels' arguments; false where they do not fit, or where the
// interpolation is asked for in bf16 with a float32 MLP (no TPU mode).
bool make_args(Mlp* m, Grid* g, const void* grid, const void* const* w,
               const void* const* b, const int* dims, int nw, int C, int D, int H,
               int W, int n_freqs, int bf16, int interp_bf16) {
  if (!make_mlp(m, w, b, dims, nw) || n_freqs < 0 || C < 1 || D < 1 || H < 1 ||
      W < 1 || dims[0] != 3 + 6 * n_freqs + C || (interp_bf16 && !bf16)) {
    return false;
  }
  g->bf16 = interp_bf16 != 0;
  g->data = static_cast<const float*>(grid);
  g->C = C;
  g->D = D;
  g->H = H;
  g->W = W;
  return true;
}

}  // namespace

// Plain C entries for ctypes.  Pointers are device pointers except `w`, `b`
// (host arrays of nw device pointers, one per layer) and `dims` (host array
// of nw + 1 widths, dims[0] = 3 + 6 n_freqs + C); the launcher copies them
// into the kernel's by-value parameters.  `bf16` and `interp_bf16` give the
// precision: 'f32' (0, 0), 'mixed' (1, 0) or 'bf16' (1, 1).  Each returns
// the CUDA error of its launches (0 on success).

// out (n, dims[nw]) from the channel-minor grid (D, H, W, C) at coords (n, 3).
extern "C" int lfgc_fused_forward_fwd(const void* grid, const void* coords,
                                      const void* const* w, const void* const* b,
                                      const int* dims, int nw, void* out, int64_t n,
                                      int C, int D, int H, int W, int n_freqs,
                                      int bf16, int interp_bf16, void* stream) {
  Mlp m;
  Grid g;
  if (!make_args(&m, &g, grid, w, b, dims, nw, C, D, H, W, n_freqs, bf16, interp_bf16)) {
    return int(cudaErrorInvalidValue);
  }
  if (n <= 0) return int(cudaSuccess);
  const float* cp = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bf16 ? launch_fwd<true>(m, g, cp, o, n, n_freqs, s)
                  : launch_fwd<false>(m, g, cp, o, n, n_freqs, s));
}

// For reports, the forward's launch at these widths and precision on the
// current card: out = [samples a tile, dynamic shared bytes a block, blocks
// an SM, weights resident] (snake_mlp_tc.cuh launch_report).
extern "C" int lfgc_fused_forward_fwd_plan(const int* dims, int nw, int bf16, int* out) {
  Mlp m;
  Launch b;
  if (!make_mlp(&m, nullptr, nullptr, dims, nw)) return int(cudaErrorInvalidValue);
  const cudaError_t err = fwd_launch(fwd_kernel(bf16), bf16, m, 1, &b);
  if (err == cudaSuccess) launch_report(b, out);
  return int(err);
}

// The number of partial slots lfgc_fused_forward_bwd needs at this precision
// on the current card; 0 if the widths do not fit.
extern "C" int lfgc_fused_forward_bwd_slots(int64_t n, const int* dims, int nw, int bf16) {
  Mlp m;
  if (!make_mlp(&m, nullptr, nullptr, dims, nw) || n <= 0) return 0;
  Launch b;
  return bwd_launch(bwd_kernel(bf16), bf16, m, n, &b) == cudaSuccess ? b.blocks : 0;
}

// For reports, the backward's launch at these widths and precision on the
// current card: out = [samples a tile, dynamic shared bytes a block, blocks
// an SM, weights and sums resident] (snake_mlp_tc.cuh launch_report).
extern "C" int lfgc_fused_forward_bwd_plan(const int* dims, int nw, int bf16, int* out) {
  Mlp m;
  Launch b;
  if (!make_mlp(&m, nullptr, nullptr, dims, nw)) return int(cudaErrorInvalidValue);
  const cudaError_t err = bwd_launch(bwd_kernel(bf16), bf16, m, 1, &b);
  if (err == cudaSuccess) launch_report(b, out);
  return int(err);
}

// For the output gradient gout (n, dims[nw]): dgrid (D, H, W, C), zeroed by
// the caller and summed here by atomics, and the flat dparams = [dW_0 ..
// dW_{nw-1} ((out, in) each), db_0 .. db_{nw-1}].
extern "C" int lfgc_fused_forward_bwd(const void* grid, const void* coords,
                                      const void* const* w, const void* const* b,
                                      const int* dims, int nw, const void* gout,
                                      void* dgrid, void* dparams, void* partial,
                                      int64_t n, int C, int D, int H, int W,
                                      int n_freqs, int bf16, int interp_bf16,
                                      void* stream) {
  Mlp m;
  Grid g;
  if (!make_args(&m, &g, grid, w, b, dims, nw, C, D, H, W, n_freqs, bf16, interp_bf16)) {
    return int(cudaErrorInvalidValue);
  }
  if (n <= 0) return int(cudaSuccess);
  const float* cp = static_cast<const float*>(coords);
  const float* gp = static_cast<const float*>(gout);
  float* dg = static_cast<float*>(dgrid);
  float* dpp = static_cast<float*>(dparams);
  float* pp = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bf16 ? launch_bwd<true>(m, g, cp, gp, dg, dpp, pp, n, n_freqs, s)
                  : launch_bwd<false>(m, g, cp, gp, dg, dpp, pp, n, n_freqs, s));
}

extern "C" const char* lfgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
