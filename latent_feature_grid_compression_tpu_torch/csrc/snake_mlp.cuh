// The SnakeAlt MLP on a tile of samples held in shared memory, forward and
// backward, shared by mlp_fused.cu (the fused MLP) and fused_forward.cu (the
// one-kernel model forward).
//
// Layers i = 0 .. nw-1 take width dim[i] to dim[i+1] (every width <= 128):
// z = h W_i^T + b_i, the hidden layers h' = SnakeAlt(z) = 0.5 z + sin(z)^2,
// the last one linear.  Weights are the port's (out, in) row-major layout.
//
// Precision (the TPU kernels' modes): with BF16 every operand of a matrix
// product is rounded to bfloat16 (__float2bfloat16_rn) and the products,
// exact in float32, are summed in float32: the TPU's single MXU pass up to
// the order of the sum.  Bias, activation, dz = dh * (0.5 + sin 2z) and the
// bias gradients stay float32.  Without BF16 everything is float32.  Each
// buffer of layer inputs holds them already rounded, as the products take
// them.
//
// Layout: a block of kMlpThreads threads holds S samples; activations are
// rows of an odd pitch P >= the widest layer (neighbouring samples fall in
// different banks), and one layer's weights at a time are staged in shared
// memory with an odd pitch too, transposed for the forward (neighbouring
// threads read neighbouring outputs) and as they are for dX.
//
// The backward gives dW and db per block: each block walks tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... and adds each tile's sums into its
// own slot of a partial buffer (the first tile writes it); a second kernel,
// reduce_slots_kernel, sums the slots in a fixed order.  So dW and db are
// reproducible bit for bit on one card, and no atomics are needed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lfgc {

constexpr int kMaxLayers = 16;    // weight matrices (ops/mlp_fused.py MAX_LAYERS)
constexpr int kMaxWidth = 128;    // every width (ops/mlp_fused.py MAX_WIDTH)
constexpr int kMlpThreads = 256;
constexpr int kFwdTile = 64;      // samples a forward block holds
constexpr int kBwdTile = 32;      // at most, a backward block holds
constexpr int kMaxSlots = 264;    // backward blocks: two per SM of an H100
constexpr int kSmemLimit = 232448;  // shared memory a block may use (227 KB)

struct Mlp {
  const float* w[kMaxLayers];   // (dim[i+1], dim[i]) row-major
  const float* b[kMaxLayers];   // (dim[i+1])
  int dim[kMaxLayers + 1];
  int offw[kMaxLayers];         // offsets of dW_i and db_i in the flat
  int offb[kMaxLayers];         // [dW_0 .. dW_{nw-1}, db_0 .. db_{nw-1}]
  int total;                    // its length
  int nw;
  int pitch;                    // row pitch of the activation buffers
  int stage;                    // floats of the weight-staging buffer
};

__host__ __device__ inline int odd(int w) { return w | 1; }
inline int imax(int a, int b) { return a > b ? a : b; }

// Fills `m` from a C entry's arguments (w and b may be null where only the
// sizes are wanted); false if the widths or the layer count are out of range.
inline bool make_mlp(Mlp* m, const void* const* w, const void* const* b,
                     const int* dims, int nw) {
  if (nw < 1 || nw > kMaxLayers) return false;
  int maxw = 0;
  for (int i = 0; i <= nw; ++i) {
    if (dims[i] < 1 || dims[i] > kMaxWidth) return false;
    m->dim[i] = dims[i];
    maxw = imax(maxw, dims[i]);
  }
  int off = 0, stage = 0;
  for (int i = 0; i < nw; ++i) {
    const int K = dims[i], M = dims[i + 1];
    m->w[i] = w ? static_cast<const float*>(w[i]) : nullptr;
    m->b[i] = b ? static_cast<const float*>(b[i]) : nullptr;
    m->offw[i] = off;
    off += K * M;
    stage = imax(stage, imax(K * odd(M), M * odd(K)));
  }
  for (int i = 0; i < nw; ++i) {
    m->offb[i] = off;
    off += dims[i + 1];
  }
  m->total = off;
  m->nw = nw;
  m->pitch = odd(maxw);
  m->stage = stage;
  return true;
}

inline size_t fwd_smem_bytes(const Mlp& m) {
  return size_t(2 * kFwdTile * m.pitch + m.stage) * sizeof(float);
}

// hs[0 .. nw-1], sg[0 .. nw-2], dz, dh: 2 nw + 1 buffers of S rows.
inline size_t bwd_smem_bytes(const Mlp& m, int S) {
  return size_t((2 * m.nw + 1) * S * m.pitch + m.stage) * sizeof(float);
}

// The largest backward tile whose buffers fit, 0 if none does.
inline int bwd_tile(const Mlp& m) {
  for (int S = kBwdTile; S >= 1; S /= 2) {
    if (bwd_smem_bytes(m, S) <= size_t(kSmemLimit)) return S;
  }
  return 0;
}

// Backward blocks, each with one slot of the partial buffer.
inline int bwd_slots(int64_t n, int S) {
  const int64_t tiles = (n + S - 1) / S;
  return int(tiles < kMaxSlots ? tiles : kMaxSlots);
}

template <bool BF16>
__device__ __forceinline__ float op(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Rounded as the plain version's 0.5 * z + s * s (no FMA contraction).
__device__ __forceinline__ float snake(float z) {
  const float s = sinf(z);
  return __fadd_rn(__fmul_rn(0.5f, z), __fmul_rn(s, s));
}

__device__ __forceinline__ float snake_grad(float z) {
  return __fadd_rn(0.5f, sinf(2.0f * z));
}

// wst[k * odd(M) + o] = op(W[o][k]): the weights transposed, for the forward.
template <bool BF16>
__device__ __forceinline__ void stage_transposed(float* wst, const float* w, int K,
                                                 int M) {
  const int MP = odd(M);
  for (int e = threadIdx.x; e < K * M; e += blockDim.x) {
    const int o = e / K, k = e - o * K;
    wst[k * MP + o] = op<BF16>(__ldg(w + e));
  }
}

// ws[o * odd(K) + k] = op(W[o][k]): the weights as they are, for dX.
template <bool BF16>
__device__ __forceinline__ void stage(float* ws, const float* w, int K, int M) {
  const int KP = odd(K);
  for (int e = threadIdx.x; e < K * M; e += blockDim.x) {
    const int o = e / K, k = e - o * K;
    ws[o * KP + k] = op<BF16>(__ldg(w + e));
  }
}

// z[s][o] = sum_k in[s][k] W[o][k] + b[o] for the tile's S rows (W staged
// transposed in wst); epi(s, o, z) takes each.  Threads walk (s, o) with o
// fastest.
template <class Epi>
__device__ __forceinline__ void layer_forward(const float* in, const float* wst,
                                              const float* bias, int S, int K, int M,
                                              int P, Epi&& epi) {
  const int MP = odd(M);
  for (int e = threadIdx.x; e < S * M; e += blockDim.x) {
    const int s = e / M, o = e - s * M;
    const float* h = in + s * P;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) acc = fmaf(h[k], wst[k * MP + o], acc);
    epi(s, o, __fadd_rn(acc, __ldg(bias + o)));
  }
}

// The forward of the S rows in `a` (the layer-0 input, rounded, written by
// the caller before the call): hidden layers ping-pong between a and b, the
// head writes rows row0 .. of out (n, dim[nw]) that are < n.
template <bool BF16>
__device__ void tile_forward(const Mlp& m, float* a, float* b, float* wst, int S,
                             float* out, int64_t row0, int64_t n) {
  const int P = m.pitch;
  for (int i = 0; i < m.nw; ++i) {
    const int K = m.dim[i], M = m.dim[i + 1];
    __syncthreads();  // a is complete; earlier readers of wst and b are done
    stage_transposed<BF16>(wst, m.w[i], K, M);
    __syncthreads();
    if (i + 1 < m.nw) {
      float* nxt = b;
      layer_forward(a, wst, m.b[i], S, K, M, P, [&](int s, int o, float z) {
        nxt[s * P + o] = op<BF16>(snake(z));
      });
      b = a;
      a = nxt;
    } else {
      layer_forward(a, wst, m.b[i], S, K, M, P, [&](int s, int o, float z) {
        if (row0 + s < n) out[(row0 + s) * M + o] = z;
      });
    }
  }
}

// The backward of one tile.  smem holds hs[0 .. nw-1] (layer inputs,
// rounded), sg[0 .. nw-2] (0.5 + sin 2z of the hidden layers), dz, dh, then
// the staging buffer, each activation buffer S rows of pitch P.  The caller
// has written op(x) into hs[0] and the output gradient into dz (zero rows
// past n).  Adds the tile's dW, db into `slot` (writes them when `first`)
// and returns the buffer that holds dX (float32).
template <bool BF16>
__device__ const float* tile_backward(const Mlp& m, float* smem, int S, float* slot,
                                      bool first) {
  const int P = m.pitch, SP = S * P, L = m.nw - 1;
  float* hs = smem;
  float* sg = smem + m.nw * SP;
  float* dz = smem + (2 * m.nw - 1) * SP;
  float* dh = dz + SP;
  float* wst = dh + SP;

  // recompute the hidden layers
  for (int i = 0; i < L; ++i) {
    const int K = m.dim[i], M = m.dim[i + 1];
    __syncthreads();
    stage_transposed<BF16>(wst, m.w[i], K, M);
    __syncthreads();
    float* hn = hs + (i + 1) * SP;
    float* sgi = sg + i * SP;
    layer_forward(hs + i * SP, wst, m.b[i], S, K, M, P, [&](int s, int o, float z) {
      hn[s * P + o] = op<BF16>(snake(z));
      sgi[s * P + o] = snake_grad(z);
    });
  }

  for (int i = L; i >= 0; --i) {
    const int K = m.dim[i], M = m.dim[i + 1], KP = odd(K);
    __syncthreads();  // dz is complete; earlier readers of wst and dh are done
    stage<BF16>(wst, m.w[i], K, M);
    // the tile's dW_i[o][k] = sum_s op(dz[s][o]) h_i[s][k] and db_i[o] =
    // sum_s dz[s][o]; each entry has one owner thread in every tile
    const float* h = hs + i * SP;
    for (int e = threadIdx.x; e < M * K + M; e += blockDim.x) {
      float acc = 0.0f;
      float* p;
      if (e < M * K) {
        const int o = e / K, k = e - o * K;
        for (int s = 0; s < S; ++s) acc = fmaf(op<BF16>(dz[s * P + o]), h[s * P + k], acc);
        p = slot + m.offw[i] + e;
      } else {
        const int o = e - M * K;
        for (int s = 0; s < S; ++s) acc = __fadd_rn(acc, dz[s * P + o]);
        p = slot + m.offb[i] + o;
      }
      *p = first ? acc : __fadd_rn(*p, acc);
    }
    __syncthreads();  // wst is staged
    // dh[s][k] = sum_o op(dz[s][o]) W[o][k]; below the first layer it
    // becomes the next dz = dh * sg of the layer below
    const float* sgl = i > 0 ? sg + (i - 1) * SP : nullptr;
    for (int e = threadIdx.x; e < S * K; e += blockDim.x) {
      const int s = e / K, k = e - s * K;
      const float* d = dz + s * P;
      float acc = 0.0f;
#pragma unroll 4
      for (int o = 0; o < M; ++o) acc = fmaf(op<BF16>(d[o]), wst[o * KP + k], acc);
      dh[s * P + k] = sgl ? __fmul_rn(acc, sgl[s * P + k]) : acc;
    }
    float* t = dz;
    dz = dh;
    dh = t;
  }
  __syncthreads();
  return dz;
}

// out[e] = the sum of partial[slot][e] over the slots, in a fixed order:
// eight interleaved runs over the slots, then the eight in order.  Blocks of
// (32, 8) threads, one column of 32 entries each.
__global__ void __launch_bounds__(256)
reduce_slots_kernel(const float* __restrict__ partial, float* __restrict__ out,
                    int total, int slots) {
  __shared__ float part[8][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (e < total) {
    for (int s = threadIdx.y; s < slots; s += 8) {
      acc = __fadd_rn(acc, partial[int64_t(s) * total + e]);
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < total) {
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum = __fadd_rn(sum, part[j][threadIdx.x]);
    out[e] = sum;
  }
}

inline cudaError_t launch_reduce_slots(const float* partial, float* out, int total,
                                       int slots, cudaStream_t stream) {
  reduce_slots_kernel<<<dim3(unsigned((total + 31) / 32)), dim3(32, 8), 0, stream>>>(
      partial, out, total, slots);
  return cudaGetLastError();
}

// Lets `kernel` take `bytes` of dynamic shared memory (needed above 48 KB).
template <class K>
inline cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace lfgc
