// The float32 inference head after the fetch, in one kernel, for Hopper
// (sm_90a):
//
//   x0  = [coords | sin/cos(2^j 2 pi coords) | features]   (fourier_embed's order)
//   h   = SnakeAlt(x0 W_0^T + b_0), then each hidden layer h = SnakeAlt(h W_i^T + b_i)
//   out = clamp(h W_L^T + b_L, -1, 1)
//
// No JAX counterpart: it replaces no TPU kernel.  The JAX package leaves
// this head to XLA, which fuses it.  In PyTorch the same chain is ~30
// launches (the 31-wide torch.cat, the embedding's sin and cos, five
// F.linear calls on cuBLAS with SnakeAlt's sin, mul, mul and add after each
// hidden one, the clamp), and each elementwise pass writes and reads an
// (N, 32) float32 intermediate: about 1 GB of device traffic for a chunk of
// 2^18 samples.  Here a sample's activations stay in registers: the whole
// head reads 12 + 4 C bytes a sample and writes 4.
//
// Bound on the card: operations.  At the flagship widths (input 31, four
// hidden layers of 32, one output) a sample needs ~8,850 float32
// operations (4,096 FMAs in the products, 12 sin/cos and 128 SnakeAlts),
// 0.035 ms for 2^18 samples at 67 TFLOP/s, against 0.006 ms for its bytes.
//
// Design.  The widths are compile-time constants: hidden 32, d_in 3, d_out
// 1, two frequencies, C 16 or 22 (every published configuration).  The
// hidden layers after the first (0 .. kMaxLayers - 2 of them) are a runtime
// loop over one layer body.  A thread holds one sample, whose activations are register arrays.
// Blocks are persistent (as many as the card holds at once): each stages
// every weight and bias into shared memory once, transposed (for each input
// k the 32 outputs' weights in a row), then walks the samples with a grid
// stride.  A layer runs k-outer: one float4 broadcast load gives
// W[o .. o+3][k] to every lane, and the 32 accumulators are independent FMA
// chains, while each output still sums its terms in order from k = 0, as a
// serial dot product does, then adds its bias.  On an H100 (700 W), 2^18
// samples at the flagship widths take 0.130 ms this way (80 registers, 6
// blocks of 128 an SM); two samples a thread, which halve the loads a FMA,
// took 0.219 ms (168 registers, 3 blocks an SM: too few warps to hide the
// loads and the sines), three 0.366 ms, and the weights in the constant
// bank, read as FMA operands, 0.182 ms.  Nothing is written but the
// output, no weight passes through kernel parameters (a graph captures the
// launch with the weights' addresses), and nothing is read back to the host.
//
// Precision: float32 FMAs on the CUDA cores, nothing in TF32 or bf16.
// sinf/cosf, not the fast intrinsics (the Fourier arguments reach
// 2^(n_freqs-1) 2 pi |coord|); the Fourier argument is coord *
// float32(2^j 2 pi), and SnakeAlt is rounded as the plain chain's
// 0.5 z + sin(z)^2 (snake_mlp.cuh's snake).  The result differs from the
// chain's only in the order of the float32 sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "snake_mlp.cuh"

namespace {

using namespace lfgc;

constexpr int kHidden = 32;
constexpr int kFreqs = 2;
constexpr int kEmb = 3 + 6 * kFreqs;    // x0's columns before the features
constexpr int kThreads = 128;            // a sample a thread
constexpr int kLayerFloats = kHidden * kHidden + kHidden;   // a hidden W^T and b

struct Head {
  const float* w[kMaxLayers];   // (out, in) row-major: (32, 15 + C), (32, 32) ..., (1, 32)
  const float* b[kMaxLayers];
  int nw;                       // weight matrices, 2 .. kMaxLayers
};

// Floats of the staged weights: W_0^T (K0 x 32) and b_0, each hidden W^T
// (32 x 32) and b, the output's w (32) and b (padded to 4).
__host__ __device__ constexpr int stage_floats(int K0, int nw) {
  return K0 * kHidden + kHidden + (nw - 2) * kLayerFloats + kHidden + 4;
}

// Every weight and bias of h into s, transposed, then a barrier.
__device__ void stage_weights(float* s, const Head& h, int K0) {
  for (int e = threadIdx.x; e < K0 * kHidden; e += blockDim.x) {
    const int k = e / kHidden, o = e - k * kHidden;
    s[e] = __ldg(h.w[0] + o * K0 + k);
  }
  float* p = s + K0 * kHidden;
  for (int l = 0; l < h.nw - 1; ++l) {
    if (l > 0) {
      for (int e = threadIdx.x; e < kHidden * kHidden; e += blockDim.x) {
        const int k = e / kHidden, o = e - k * kHidden;
        p[e] = __ldg(h.w[l] + o * kHidden + k);
      }
      p += kHidden * kHidden;
    }
    for (int e = threadIdx.x; e < kHidden; e += blockDim.x) p[e] = __ldg(h.b[l] + e);
    p += kHidden;
  }
  for (int e = threadIdx.x; e < kHidden; e += blockDim.x) p[e] = __ldg(h.w[h.nw - 1] + e);
  if (threadIdx.x == 0) p[kHidden] = __ldg(h.b[h.nw - 1]);
  __syncthreads();
}

// x0 of sample r: coordinates, the embedding, the features (float4 loads
// where C % 4 == 0, float2 where C % 2 == 0; the wrapper checks the
// alignment).
template <int C>
__device__ __forceinline__ void load_x0(float (&x)[kEmb + C], const float* __restrict__ coords,
                                        const float* __restrict__ feats, int64_t r) {
  float c[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) c[q] = __ldg(coords + 3 * r + q);
#pragma unroll
  for (int q = 0; q < 3; ++q) x[q] = c[q];
#pragma unroll
  for (int j = 0; j < kFreqs; ++j) {
    // float32(2^j * 2 pi), as the plain version's np.float32(2**j * 2 * pi)
    const float f = 6.28318548f * float(1 << j);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float arg = __fmul_rn(c[q], f);
      x[3 + 6 * j + q] = sinf(arg);
      x[6 + 6 * j + q] = cosf(arg);
    }
  }
  const float* src = feats + r * C;
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int k = 0; k < C; k += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + k));
      x[kEmb + k] = v.x;
      x[kEmb + k + 1] = v.y;
      x[kEmb + k + 2] = v.z;
      x[kEmb + k + 3] = v.w;
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int k = 0; k < C; k += 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(src + k));
      x[kEmb + k] = v.x;
      x[kEmb + k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) x[kEmb + k] = __ldg(src + k);
  }
}

// y = SnakeAlt(x W^T + b); w is W^T (K x 32) and b its 32 biases, in
// shared memory.
template <int K>
__device__ __forceinline__ void dense_snake(const float (&x)[K], float (&y)[kHidden],
                                            const float* __restrict__ w,
                                            const float* __restrict__ b) {
#pragma unroll
  for (int o = 0; o < kHidden; ++o) y[o] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 0; o < kHidden; o += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w + k * kHidden + o);
      y[o] = fmaf(x[k], v.x, y[o]);
      y[o + 1] = fmaf(x[k], v.y, y[o + 1]);
      y[o + 2] = fmaf(x[k], v.z, y[o + 2]);
      y[o + 3] = fmaf(x[k], v.w, y[o + 3]);
    }
  }
#pragma unroll
  for (int o = 0; o < kHidden; o += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + o);
    y[o] = snake(__fadd_rn(y[o], v.x));
    y[o + 1] = snake(__fadd_rn(y[o + 1], v.y));
    y[o + 2] = snake(__fadd_rn(y[o + 2], v.z));
    y[o + 3] = snake(__fadd_rn(y[o + 3], v.w));
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
inference_head_kernel(const __grid_constant__ Head h, const float* __restrict__ coords,
                      const float* __restrict__ feats, float* __restrict__ out, int64_t n) {
  constexpr int K0 = kEmb + C;
  extern __shared__ __align__(16) float smem[];
  stage_weights(smem, h, K0);
  const float* w0 = smem;
  const float* hidden = w0 + K0 * kHidden + kHidden;
  const float* wout = hidden + (h.nw - 2) * kLayerFloats;
  const float bout = wout[kHidden];
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x; r < n; r += stride) {
    float a[kHidden];
    {
      float x[K0];
      load_x0<C>(x, coords, feats, r);
      dense_snake<K0>(x, a, w0, w0 + K0 * kHidden);
    }
#pragma unroll 1
    for (int l = 0; l < h.nw - 2; ++l) {
      float t[kHidden];
      const float* w = hidden + l * kLayerFloats;
      dense_snake<kHidden>(a, t, w, w + kHidden * kHidden);
#pragma unroll
      for (int o = 0; o < kHidden; ++o) a[o] = t[o];
    }
    float z = 0.0f;
#pragma unroll
    for (int k = 0; k < kHidden; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(wout + k);
      z = fmaf(a[k], v.x, z);
      z = fmaf(a[k + 1], v.y, z);
      z = fmaf(a[k + 2], v.z, z);
      z = fmaf(a[k + 3], v.w, z);
    }
    // as torch.clamp: NaN stays NaN
    const float v = __fadd_rn(z, bout);
    out[r] = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
  }
}

size_t smem_bytes(int C, int nw) { return size_t(stage_floats(kEmb + C, nw)) * sizeof(float); }

// SMs and blocks an SM holds, queried once a card, C and layer count (the
// shared memory a block takes grows with the layers).  Above 48 KB (from 12
// hidden layers) the kernel's opt-in is set first, at every call: it is the
// current card's.
template <int C>
cudaError_t occupancy_of(int nw, int* sms, int* per_sm) {
  static PerCard cache[kMaxLayers + 1];
  const size_t smem = smem_bytes(C, nw);
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem(inference_head_kernel<C>, smem);
    if (err != cudaSuccess) return err;
  }
  return per_card(cache[nw], sms, per_sm, [&](int* s, int* b) {
    return occupancy(inference_head_kernel<C>, kThreads, smem, b, s);
  });
}

int blocks_for(int64_t n, int sms, int per_sm) {
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t most = int64_t(sms) * per_sm;
  return int(need < most ? need : most);
}

template <int C>
cudaError_t launch(const Head& h, const float* coords, const float* feats, float* out,
                   int64_t n, cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  const cudaError_t err = occupancy_of<C>(h.nw, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  inference_head_kernel<C><<<blocks_for(n, sms, per_sm), kThreads, smem_bytes(C, h.nw),
                             stream>>>(h, coords, feats, out, n);
  return cudaGetLastError();
}

bool takes(int C, int nw) { return (C == 16 || C == 22) && nw >= 2 && nw <= kMaxLayers; }

}  // namespace

// Plain C entry for ctypes: device pointers to the (n, 3) coordinates, the
// (n, C) features (16-byte aligned where C % 4 == 0, 8-byte where
// C % 2 == 0) and the (n, 1) output, all float32 and contiguous; `w` and
// `b` the nw weight matrices ((out, in) row-major: (32, 15 + C), nw - 2 of
// (32, 32), (1, 32)) and their biases.  C must be 16 or 22 and nw 2 ..
// kMaxLayers.  Returns the first CUDA error of the plan or
// cudaGetLastError() right after the launch.
extern "C" int lfgc_inference_head(const void* coords, const void* feats, const void* const* w,
                                   const void* const* b, int nw, int C, void* out, int64_t n,
                                   void* stream) {
  if (!takes(C, nw)) return int(cudaErrorInvalidValue);
  if (n <= 0) return int(cudaSuccess);
  Head h;
  for (int i = 0; i < nw; ++i) {
    h.w[i] = static_cast<const float*>(w[i]);
    h.b[i] = static_cast<const float*>(b[i]);
  }
  h.nw = nw;
  const float* c = static_cast<const float*>(coords);
  const float* f = static_cast<const float*>(feats);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(C == 16 ? launch<16>(h, c, f, o, n, s) : launch<22>(h, c, f, o, n, s));
}

// For reports: out = [threads a block, blocks an SM, blocks for n samples,
// shared bytes a block].
extern "C" int lfgc_inference_head_plan(int C, int nw, int64_t n, int* out) {
  if (!takes(C, nw)) return int(cudaErrorInvalidValue);
  int sms = 0, per_sm = 0;
  const cudaError_t err = C == 16 ? occupancy_of<16>(nw, &sms, &per_sm)
                                  : occupancy_of<22>(nw, &sms, &per_sm);
  if (err != cudaSuccess) return int(err);
  const int r[4] = {kThreads, per_sm, blocks_for(n, sms, per_sm), int(smem_bytes(C, nw))};
  for (int k = 0; k < 4; ++k) out[k] = r[k];
  return int(cudaSuccess);
}

extern "C" const char* lfgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
