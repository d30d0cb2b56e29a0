// The SnakeAlt MLP on a tile of samples with bf16 operands, on Hopper's
// tensor cores, forward and backward: the routines that the bf16 kernels of
// mlp_fused.cu (mlp_fwd_kernel<true>, mlp_bwd_kernel<true>) and
// fused_forward.cu (fused_fwd_kernel<true>, fused_bwd_kernel<true>) share.
//
// Replaces, with the 'bf16' operands of the TPU kernels, the Pallas
//   _fwd_kernel and _bwd_kernel of latent_feature_grid_compression_tpu/ops/mlp_pallas.py:103,111
//   _fwd_kernel and _bwd_kernel of latent_feature_grid_compression_tpu/ops/fused_forward.py:113,129
// (the MLP part of the latter two; the caller builds x0 and routes dX).  The
// forward runs the hidden chain z = h_i W_i^T + b_i, h_{i+1} = SnakeAlt(z),
// then the head's z + b into the output.  The backward recomputes the same
// chain with the same per-layer code (tc_chain), also keeping sg = 0.5 + sin
// 2z, then from the head down dW_i = op(dz)^T h_i, db_i = sum dz, dh = op(dz)
// W_i, and below it dz = dh * sg.  The 'f32' kernels keep tile_forward and
// tile_backward of snake_mlp.cuh.
//
// Bound on an H100 at the flagship widths (31 -> 4 x 32 -> 1, 32,768
// samples): by bytes, 0.00126 ms forward (4.2 MB over 3.35 TB/s) and
// 0.00248 ms backward (8.3 MB; its 805 MFLOP of products take 0.8 us at the
// bf16 tensor-core rate), the one-kernel forward and backward by operations
// (the products plus the fetch, embedding and activation in float32).  The
// CUDA-core routines of snake_mlp.cuh run 45-100x above those: every product
// is a float32 FMA fed by two shared-memory loads, and a forward block of 64
// samples stages every layer's weights again between a barrier pair.  Here
// the products of a layer are warp-level mma.sync.m16n8k16 on bf16 fragments
// loaded by ldmatrix, 16 x 16 operands a warp instruction instead of two
// shared loads a product; the weights are staged once a block, and blocks
// walk tiles blockIdx.x, + gridDim.x, ... so that several blocks an SM
// overlap one another's barriers and loads.  What is left is the float32
// epilogues (sinf of the activation, and of its derivative backward) and the
// latency of short phases between barriers.
//
// Arithmetic, as tile_forward<true> / tile_backward<true>: every product
// operand is rounded to bf16 (__float2bfloat16_rn) and the exact products are
// summed in float32; only the order of the float32 sums differs.  Bias,
// activation, sg = 0.5 + sin 2z, dz = dh * sg, db, dX and the output stay
// float32.  mma.sync computes Z = H W^T with A = the rows of H and B = W as
// staged, (out, in) row-major, which is the column-major B of .row.col; dH =
// op(dZ) W reads the same staged W through ldmatrix.trans, and dW = op(dZ)^T
// H reads both operands transposed.
//
// Layout (TcPlan, chosen on the host from the widths): every width is padded
// with zeros to a multiple of 16 (31 -> 32, 1 -> 16); each row of a buffer
// has a pitch of its padded width + 8 elements, so the eight 16-byte rows an
// ldmatrix reads fall in distinct bank groups, and the epilogues' paired
// stores are conflict-free too.  A tile is S samples, a multiple of 16.
// The backward (tc_plan: blocks of kTcThreads, 16 warps; S the largest up to
// kTcMaxTile whose buffers fit in 227 KB, 64 at the flagship, 115,472 bytes;
// 48 at width 128) holds
//   W      bf16, every layer staged once a block
//   acc    the block's dW and db in the flat [dW_0 .. dW_{nw-1}, db_0 ..
//          db_{nw-1}] layout of its partial slot, float32, summed across the
//          tiles the block walks and written to the slot once at the end
// Where W and acc do not fit beside a tile of 16 (width 128), they are not
// resident: one layer's weights at a time are staged, and the sums are added
// in the slot itself, in L2.
//   h_i    bf16 layer inputs, i = 0 .. nw-1 (h_0 = op(x0) from the caller)
//   sg_i   float32 0.5 + sin 2z of the hidden layers; the backward writes
//          dz_i = dh * sg_i over it in place (each entry by the lane that
//          reads it)
//   dzt    float32 dz of the head (the caller's output gradient), later dX
//   dzb[2] bf16 dz, the products' operand, ping-pong between layers
// The forward (tc_fwd_plan: blocks of kTcFwdThreads; S up to kTcFwdMaxTile;
// 64 at the flagship, 21,760 bytes) holds W (resident where it fits, as
// above) and the h_i in two buffers that alternate between layers: no acc,
// sg or dz.
// Work in a layer is split into jobs, taken by the warps in turn: blocks of
// 16 rows and 8 columns (one m16n8 tile) of Z in the forward and of dH in the
// backward, 16 x 16 blocks of dW and 8-column sums of db.  Each dW and db
// entry has one owner lane in every tile, and the tiles of a block go in
// order: the block's sums, and with reduce_slots_kernel the whole dW and db,
// are reproducible bit for bit on one card, with no atomics.  Global loads
// (the weights, x and the output gradient) go kBatch at a time, so a thread
// waits for their latency once a batch rather than once a load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "snake_mlp.cuh"

namespace lfgc {

constexpr int kTcMaxTile = 64;            // samples a backward block holds, at most
constexpr int kTcThreads = 512;           // a backward block's threads
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcFwdMaxTile = 64;         // samples a forward block holds, at most
constexpr int kTcFwdThreads = 256;        // a forward block's threads
// forward blocks an SM at 64 registers a thread (the launch bound)
constexpr int kTcFwdMinBlocks = 65536 / 64 / kTcFwdThreads;
constexpr int kBatch = 8;                 // global loads a thread has in flight

__host__ __device__ inline int pad16(int w) { return (w + 15) & ~15; }
inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Where everything lives in a block's dynamic shared memory (byte offsets).
struct TcPlan {
  int S;                        // samples a tile (a multiple of 16)
  int resident;                 // all weights (and backward the dW, db sums)
                                // in shared memory (else one layer's weights
                                // at a time, the sums in the slot)
  int kp[kMaxLayers + 1];       // widths padded to 16
  int w_off[kMaxLayers];        // layer i's first element in W (resident)
  int w, acc;                   // W (bf16), acc (float32)
  int h[kMaxLayers];            // h_i (bf16, S x (kp[i] + 8))
  int sg[kMaxLayers];           // sg_i, then dz_i (float32, S x (kp[i+1] + 8))
  int dzt, dx;                  // dz_L and dX (float32; one buffer if nw > 1)
  int dzb[2];                   // bf16 dz, S x (max kp + 8)
  int bytes;                    // all of it
};

// The padded widths and the weights' offsets of `m` into `p`; returns the
// widest padded width, and in *wall and *wmax the elements of all the
// staged weights and of the largest layer's.
inline int tc_widths(TcPlan* p, const Mlp& m, int* wall, int* wmax) {
  int maxp = 0;
  for (int i = 0; i <= m.nw; ++i) {
    p->kp[i] = pad16(m.dim[i]);
    maxp = imax(maxp, p->kp[i]);
  }
  *wall = *wmax = 0;
  for (int i = 0; i < m.nw; ++i) {
    const int e = p->kp[i + 1] * (p->kp[i] + 8);
    p->w_off[i] = *wall;
    *wall += e;
    *wmax = imax(*wmax, e);
  }
  return maxp;
}

// The backward's plan for `m`: the largest tile that fits, resident where
// that fits; false if no tile of 16 fits.
inline bool tc_plan(TcPlan* p, const Mlp& m) {
  const int nw = m.nw;
  int wall, wmax;
  const int maxp = tc_widths(p, m, &wall, &wmax);
  for (int S = kTcMaxTile; S >= 16; S -= 16) {
    for (int res = 1; res >= 0; --res) {
      int off = 0;
      p->w = off;
      off += align16(2 * (res ? wall : wmax));
      p->acc = off;
      off += res ? align16(4 * m.total) : 0;
      for (int i = 0; i < nw; ++i) {
        p->h[i] = off;
        off += 2 * S * (p->kp[i] + 8);
      }
      for (int i = 0; i + 1 < nw; ++i) {
        p->sg[i] = off;
        off += 4 * S * (p->kp[i + 1] + 8);
      }
      // dz_L is read in the head's step only, dX written in the first
      // layer's: below two layers one buffer holds both
      p->dzt = off;
      off += 4 * S * ((nw > 1 ? imax(p->kp[0], p->kp[nw]) : p->kp[nw]) + 8);
      p->dx = nw > 1 ? p->dzt : off;
      off += nw > 1 ? 0 : 4 * S * (p->kp[0] + 8);
      for (int j = 0; j < 2; ++j) {
        p->dzb[j] = off;
        off += 2 * S * (maxp + 8);
      }
      if (off <= kSmemLimit) {
        p->S = S;
        p->resident = res;
        p->bytes = off;
        return true;
      }
    }
  }
  return false;
}

// The forward's plan for `m`: W, then h_i in buffer i % 2 (each S rows of
// the widest pitch); the largest tile that fits, resident where that fits;
// false if no tile of 16 fits.
inline bool tc_fwd_plan(TcPlan* p, const Mlp& m) {
  *p = TcPlan{};
  int wall, wmax;
  const int maxp = tc_widths(p, m, &wall, &wmax);
  for (int S = kTcFwdMaxTile; S >= 16; S -= 16) {
    for (int res = 1; res >= 0; --res) {
      const int hb = 2 * S * (maxp + 8), w = align16(2 * (res ? wall : wmax));
      for (int i = 0; i < m.nw; ++i) p->h[i] = w + (i & 1) * hb;
      const int bytes = w + (m.nw > 1 ? 2 : 1) * hb;
      if (bytes <= kSmemLimit) {
        p->S = S;
        p->resident = res;
        p->bytes = bytes;
        return true;
      }
    }
  }
  return false;
}

// How a kernel is launched for n samples.
struct Launch {
  TcPlan p;      // the tile plan ('bf16'; zeros for 'f32')
  int threads;   // a block's threads
  int S;         // samples a tile
  size_t smem;   // dynamic shared memory a block
  int per_sm;    // blocks an SM holds at once
  int blocks;    // blocks; a backward kernel's each have one partial slot
};

// The rest of the launch of `kernel` once b->threads, b->S and b->smem are
// set: the blocks an SM holds, and the grid: `bf16` kernels walk tiles, as
// many blocks as fit on the card at once and at most one a tile; else
// `f32_blocks`.  The block count is a function of n and the widths on a
// given card, so the fixed-order sum of a backward's slots is reproducible.
template <class Kernel>
inline cudaError_t occupy(Kernel* kernel, bool bf16, int64_t n, int64_t f32_blocks,
                          Launch* b) {
  int sms = 0;
  cudaError_t err = allow_smem(kernel, b->smem);
  if (err == cudaSuccess) err = occupancy(kernel, b->threads, b->smem, &b->per_sm, &sms);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + b->S - 1) / b->S, most = int64_t(sms) * b->per_sm;
  b->blocks = int(bf16 ? (tiles < most ? tiles : most) : f32_blocks);
  return cudaSuccess;
}

// The launch of a backward kernel (its bf16 or f32 instantiation): 'bf16'
// takes tc_plan, 'f32' the tile and the block count of snake_mlp.cuh.
template <class Kernel>
inline cudaError_t bwd_launch(Kernel* kernel, bool bf16, const Mlp& m, int64_t n,
                              Launch* b) {
  b->p = TcPlan{};
  b->threads = bf16 ? kTcThreads : kMlpThreads;
  if (bf16) {
    if (!tc_plan(&b->p, m)) return cudaErrorInvalidValue;
    b->S = b->p.S;
    b->smem = size_t(b->p.bytes);
  } else {
    b->S = bwd_tile(m);
    if (b->S == 0) return cudaErrorInvalidValue;
    b->smem = bwd_smem_bytes(m, b->S);
  }
  return occupy(kernel, bf16, n, bf16 ? 0 : bwd_slots(n, b->S), b);
}

// The launch of a forward kernel: 'bf16' takes tc_fwd_plan, 'f32' one block
// of kMlpThreads a tile of kFwdTile (snake_mlp.cuh).
template <class Kernel>
inline cudaError_t fwd_launch(Kernel* kernel, bool bf16, const Mlp& m, int64_t n,
                              Launch* b) {
  b->p = TcPlan{};
  b->threads = bf16 ? kTcFwdThreads : kMlpThreads;
  if (bf16) {
    if (!tc_fwd_plan(&b->p, m)) return cudaErrorInvalidValue;
    b->S = b->p.S;
    b->smem = size_t(b->p.bytes);
  } else {
    b->S = kFwdTile;
    b->smem = fwd_smem_bytes(m);
  }
  return occupy(kernel, bf16, n, (n + b->S - 1) / b->S, b);
}

// For reports: out = [samples a tile, dynamic shared bytes a block, blocks
// an SM, weights (and sums) resident].
inline void launch_report(const Launch& b, int* out) {
  out[0] = b.S;
  out[1] = int(b.smem);
  out[2] = b.per_sm;
  out[3] = b.p.resident;
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ bf16* tc_bf(unsigned char* smem, int off) {
  return reinterpret_cast<bf16*>(smem + off);
}

__device__ __forceinline__ float* tc_f(unsigned char* smem, int off) {
  return reinterpret_cast<float*>(smem + off);
}

// h_0, where the caller writes op(x0): S rows of pitch kp[0] + 8.
__device__ __forceinline__ bf16* tc_x0(const TcPlan& p, unsigned char* smem) {
  return tc_bf(smem, p.h[0]);
}

__device__ __forceinline__ int tc_x0_pitch(const TcPlan& p) { return p.kp[0] + 8; }

// Layer i's staged weights.
__device__ __forceinline__ const bf16* tc_w(const TcPlan& p, unsigned char* smem, int i) {
  return tc_bf(smem, p.w) + (p.resident ? p.w_off[i] : 0);
}

// ldmatrix of four 8 x 8 bf16 matrices, as they are or transposed; lane l
// gives the address of row l % 8 of matrix l / 8.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  }
}

// d (16 x 8, float32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix of two 8 x 8 bf16 matrices (lanes 0-15 give the addresses).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(a));
  }
}

// acc += A B over `steps` depths of 16 for one output block of 16 rows and
// 8 NT columns (NT = 1 or 2; acc[4 q .. 4 q + 3] the m16n8 accumulator of
// columns 8 q .. 8 q + 7).  `a` points at the block's A origin: A (16 x
// depth) stored as it is (rows x depth, pitch pa), or with TA stored
// transposed (depth x rows).  `b` points at B's origin: B (depth x 8 NT)
// stored transposed (columns x depth, pitch pb: W as staged), or with TB as
// it is (depth x columns).
template <bool TA, bool TB, int NT>
__device__ __forceinline__ void block_mma(float* acc, const bf16* a, int pa, const bf16* b,
                                          int pb, int steps) {
  const int l = threadIdx.x & 31, r = l & 7, j0 = (l >> 3) & 1, j1 = l >> 4;
  // matrices 0-3 of A: rows 0-7 / 8-15 by depth 0-7, then by depth 8-15;
  // of B: depth 0-7 / 8-15 by columns 0-7, then by columns 8-15
  const bf16* al = TA ? a + (r + 8 * j1) * pa + 8 * j0 : a + (r + 8 * j0) * pa + 8 * j1;
  const bf16* bl = TB ? b + (r + 8 * j0) * pb + 8 * j1 : b + (r + 8 * j1) * pb + 8 * j0;
  const int da = TA ? 16 * pa : 16, db = TB ? 16 * pb : 16;
  for (int s = 0; s < steps; ++s) {
    uint32_t fa[4], fb[4];
    ldsm_x4<TA>(fa, al + s * da);
    if (NT == 2) {
      ldsm_x4<TB>(fb, bl + s * db);
    } else {
      ldsm_x2<TB>(fb, bl + s * db);
    }
    mma_bf16(acc, fa, fb[0], fb[1]);
    if (NT == 2) mma_bf16(acc + 4, fa, fb[2], fb[3]);
  }
}

// f(row, col, v0, v1) for the lane's pairs of a block of 16 rows and 8 NT
// columns at (r0, c0): (row, col) and (row, col + 1), col even.
template <int NT, class F>
__device__ __forceinline__ void for_pairs(const float* acc, int r0, int c0, F&& f) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int q = 0; q < 2 * NT; ++q) {
    f(r0 + g + 8 * (q & 1), c0 + 8 * (q >> 1) + 2 * t, acc[2 * q], acc[2 * q + 1]);
  }
}

// store(e, load(e)) for e = threadIdx.x, + blockDim.x, .. < count, kBatch of
// them at a time: their loads are all in flight before the first store.
template <class T, class Load, class Store>
__device__ __forceinline__ void copy_batched(int count, Load&& load, Store&& store) {
  for (int e0 = threadIdx.x; e0 < count; e0 += kBatch * blockDim.x) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = e < count ? load(e) : T{};
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < count) store(e, v[u]);
    }
  }
}

__device__ __forceinline__ void store_bf2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// op(W_i) into the weight buffer, zero in the padding.
__device__ __forceinline__ void tc_stage(const Mlp& m, const TcPlan& p, unsigned char* smem,
                                         int i) {
  const int K = m.dim[i], M = m.dim[i + 1], KP = p.kp[i], PW = KP + 8;
  bf16* ws = tc_bf(smem, p.w) + (p.resident ? p.w_off[i] : 0);
  const float* w = m.w[i];
  if (K % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    // rows of whole 16-byte groups: four weights a load
    const int Q = KP / 4;
    copy_batched<float4>(
        p.kp[i + 1] * Q,
        [&](int e) {
          const int o = e / Q, k = 4 * (e - o * Q);
          return o < M && k < K ? __ldg(reinterpret_cast<const float4*>(w + o * K + k))
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        },
        [&](int e, float4 v) {
          const int o = e / Q;
          bf16* d = ws + o * PW + 4 * (e - o * Q);
          store_bf2(d, v.x, v.y);
          store_bf2(d + 2, v.z, v.w);
        });
    return;
  }
  copy_batched<float>(
      p.kp[i + 1] * KP,
      [&](int e) {
        const int o = e / KP, k = e - o * KP;
        return o < M && k < K ? __ldg(w + o * K + k) : 0.0f;
      },
      [&](int e, float v) {
        const int o = e / KP;
        ws[o * PW + e - o * KP] = __float2bfloat16_rn(v);
      });
}

// The block's dW and db sums: in shared memory, or its slot.
__device__ __forceinline__ float* tc_acc(const TcPlan& p, unsigned char* smem, float* slot) {
  return p.resident ? tc_f(smem, p.acc) : slot;
}

// Zero h_0's padding columns (the caller writes the others).
__device__ __forceinline__ void tc_zero_x0_pad(const Mlp& m, const TcPlan& p,
                                               unsigned char* smem) {
  const int K0 = m.dim[0], pad = p.kp[0] - K0, P0 = tc_x0_pitch(p);
  bf16* h0 = tc_x0(p, smem);
  for (int e = threadIdx.x; e < p.S * pad; e += blockDim.x) {
    const int s = e / pad;
    h0[s * P0 + K0 + e - s * pad] = __float2bfloat16_rn(0.0f);
  }
}

// Every layer's weights, if they stay.
__device__ __forceinline__ void tc_stage_resident(const Mlp& m, const TcPlan& p,
                                                  unsigned char* smem) {
  if (p.resident) {
    for (int i = 0; i < m.nw; ++i) tc_stage(m, p, smem, i);
  }
}

// Once a backward block, before its first tile: zero the sums, zero h_0's
// padding (nothing else writes it), stage the weights if they stay.
__device__ void tc_begin(const Mlp& m, const TcPlan& p, unsigned char* smem, float* acc) {
  for (int e = threadIdx.x; e < m.total; e += blockDim.x) acc[e] = 0.0f;
  tc_zero_x0_pad(m, p, smem);
  tc_stage_resident(m, p, smem);
}

// Once a block, after its last tile: the sums into its slot.
__device__ void tc_end(const Mlp& m, const TcPlan& p, unsigned char* smem, float* acc,
                       float* slot) {
  if (!p.resident) return;
  __syncthreads();
  for (int e = threadIdx.x; e < m.total; e += blockDim.x) slot[e] = acc[e];
}

// The tile's output gradient g (n, dim[nw]) rows row0 .. into dz_L and its
// bf16 copy, zero past n and in the padding.
__device__ void tc_load_grad(const Mlp& m, const TcPlan& p, unsigned char* smem,
                             const float* __restrict__ g, int64_t row0, int64_t n) {
  const int D = m.dim[m.nw], DP = p.kp[m.nw], PD = DP + 8;
  float* dz = tc_f(smem, p.dzt);
  bf16* dzb = tc_bf(smem, p.dzb[0]);
  copy_batched<float>(
      p.S * DP,
      [&](int e) {
        const int s = e / DP, o = e - s * DP;
        return o < D && row0 + s < n ? g[(row0 + s) * D + o] : 0.0f;
      },
      [&](int e, float v) {
        const int s = e / DP, i = s * PD + e - s * DP;
        dz[i] = v;
        dzb[i] = __float2bfloat16_rn(v);
      });
}

// The tile's rows row0 .. of x (n, dim[0]) into h_0, rounded (zero past n).
__device__ void tc_load_x(const Mlp& m, const TcPlan& p, unsigned char* smem,
                          const float* __restrict__ x, int64_t row0, int64_t n) {
  const int K0 = m.dim[0], P0 = tc_x0_pitch(p);
  bf16* h0 = tc_x0(p, smem);
  copy_batched<float>(
      p.S * K0,
      [&](int e) { return row0 + e / K0 < n ? x[row0 * K0 + e] : 0.0f; },
      [&](int e, float v) {
        const int s = e / K0;
        h0[s * P0 + e - s * K0] = __float2bfloat16_rn(v);
      });
}

// One layer on the tile: z = h W^T for the S rows of h (KP deep, pitch KP +
// 8) and W as staged, one job a block of 16 rows and 8 columns of z (`cb`
// column blocks), taken by the warps in turn; epi(row, col, z0, z1) gets the
// lane's pairs of each job as for_pairs does, before the bias.
template <class Epi>
__device__ __forceinline__ void tc_layer(int S, int KP, int cb, const bf16* h, const bf16* w,
                                         Epi&& epi) {
  const int PK = KP + 8, jobs = (S / 16) * cb, warps = blockDim.x >> 5;
  for (int j = threadIdx.x >> 5; j < jobs; j += warps) {
    const int r0 = (j / cb) * 16, c0 = (j % cb) * 8;
    float z[4] = {};
    block_mma<false, false, 1>(z, h + r0 * PK, PK, w + c0 * PK, PK, KP / 16);
    for_pairs<1>(z, r0, c0, epi);
  }
}

// Hidden layer i: h_{i+1} = op(snake(z)) for z = h_i W_i^T + b_i and, with
// SG, sg_i = 0.5 + sin 2z; zero in the padding.
template <bool SG>
__device__ __forceinline__ void tc_hidden(const Mlp& m, const TcPlan& p, unsigned char* smem,
                                          int i) {
  const int M = m.dim[i + 1], MP = p.kp[i + 1], PM = MP + 8;
  bf16* hn = tc_bf(smem, p.h[i + 1]);
  float* sg = tc_f(smem, p.sg[i]);
  const float* bias = m.b[i];
  tc_layer(p.S, p.kp[i], MP / 8, tc_bf(smem, p.h[i]), tc_w(p, smem, i),
           [&](int r, int c, float z0, float z1) {
             float h0 = 0.0f, h1 = 0.0f, s0 = 0.0f, s1 = 0.0f;
             if (c < M) {
               z0 = __fadd_rn(z0, __ldg(bias + c));
               h0 = snake(z0);
               if (SG) s0 = snake_grad(z0);
             }
             if (c + 1 < M) {
               z1 = __fadd_rn(z1, __ldg(bias + c + 1));
               h1 = snake(z1);
               if (SG) s1 = snake_grad(z1);
             }
             store_bf2(hn + r * PM + c, h0, h1);
             if (SG) *reinterpret_cast<float2*>(sg + r * PM + c) = make_float2(s0, s1);
           });
}

// The hidden chain of a tile, forward or (with SG) the backward's
// recompute.  The caller has written h_0 (and its other inputs) after a
// __syncthreads() that follows the previous tile's last reads.  On return
// h_L is complete and (not resident) W_L staged.
template <bool SG>
__device__ void tc_chain(const Mlp& m, const TcPlan& p, unsigned char* smem) {
  __syncthreads();  // h_0 is complete
  if (!p.resident) {
    tc_stage(m, p, smem, 0);
    __syncthreads();
  }
  for (int i = 0; i + 1 < m.nw; ++i) {
    tc_hidden<SG>(m, p, smem, i);
    __syncthreads();
    if (!p.resident) {
      tc_stage(m, p, smem, i + 1);
      __syncthreads();
    }
  }
}

// The forward of one tile: the chain, then the head's z + b_L into rows
// row0 .. (< n) of out (n, dim[nw]).  The caller has written op(x0) into h_0
// (every column; tc_x0) after a __syncthreads() that follows the previous
// tile's last reads.  Column blocks wholly in the head's padding are
// skipped; only lanes whose column is < dim[nw] store.
__device__ void tile_forward_tc(const Mlp& m, const TcPlan& p, unsigned char* smem,
                                float* __restrict__ out, int64_t row0, int64_t n) {
  const int L = m.nw - 1, D = m.dim[m.nw];
  const float* bias = m.b[L];
  tc_chain<false>(m, p, smem);
  tc_layer(p.S, p.kp[L], (D + 7) / 8, tc_bf(smem, p.h[L]), tc_w(p, smem, L),
           [&](int r, int c, float z0, float z1) {
             if (row0 + r >= n) return;
             float* o = out + (row0 + r) * D;
             if (c < D) o[c] = __fadd_rn(z0, __ldg(bias + c));
             if (c + 1 < D) o[c + 1] = __fadd_rn(z1, __ldg(bias + c + 1));
           });
}

// The backward of one tile.  The caller has written op(x0) into h_0 (columns
// < dim[0]; tc_x0) and the output gradient with tc_load_grad (zero rows past
// n), after a __syncthreads() that follows the previous tile's last reads.
// Adds the tile's dW and db into `acc` and returns dX (float32, S rows of
// pitch kp[0] + 8), complete when it returns.
__device__ const float* tile_backward_tc(const Mlp& m, const TcPlan& p,
                                         unsigned char* smem, float* acc) {
  const int S = p.S, L = m.nw - 1, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // recompute the hidden layers: h_{i+1} and sg_i = 0.5 + sin 2z
  tc_chain<true>(m, p, smem);

  // from the head down: dW_i, db_i, and dh = op(dz) W_i, which below the
  // first layer becomes the next dz = dh * sg_{i-1}, and at it dX.  Jobs: a
  // 16 x 16 block of dW (the longest, first), 8 columns of db, a block of 16
  // rows and 8 columns of dh.
  int cur = 0;
  for (int i = L; i >= 0; --i) {
    const int K = m.dim[i], M = m.dim[i + 1], KP = p.kp[i], MP = p.kp[i + 1];
    const int PK = KP + 8, PM = MP + 8, cw = KP / 16, ch = KP / 8;
    const bf16* h = tc_bf(smem, p.h[i]);
    const bf16* w = tc_w(p, smem, i);
    const float* dz = tc_f(smem, i == L ? p.dzt : p.sg[i]);
    const bf16* dzb = tc_bf(smem, p.dzb[cur]);
    float* dzo = tc_f(smem, i > 0 ? p.sg[i - 1] : p.dx);  // dz_{i-1} over sg_{i-1}, or dX
    bf16* dzbo = tc_bf(smem, p.dzb[cur ^ 1]);
    float* dw = acc + m.offw[i];
    const int n_dw = (MP / 16) * cw, n_db = MP / 8, n_dh = (S / 16) * ch;
    for (int j = warp; j < n_dw + n_db + n_dh; j += kTcWarps) {
      if (j < n_dw) {
        // the (o0, c0) block of dW_i = op(dz)^T h_i, summed onto acc; lane
        // (g, t) holds entries (o0 + g [+ 8], c0 [+ 8] + 2t [+ 1]), as
        // for_pairs walks them
        const int o0 = (j / cw) * 16, c0 = (j % cw) * 16, g = lane >> 2, t = lane & 3;
        float d[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int o = o0 + g + 8 * ((q >> 1) & 1), k = c0 + 8 * (q >> 2) + 2 * t + (q & 1);
          d[q] = o < M && k < K ? dw[o * K + k] : 0.0f;
        }
        block_mma<true, true, 2>(d, dzb + o0, PM, h + c0, PK, S / 16);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int o = o0 + g + 8 * ((q >> 1) & 1), k = c0 + 8 * (q >> 2) + 2 * t + (q & 1);
          if (o < M && k < K) dw[o * K + k] = d[q];
        }
      } else if (j < n_dw + n_db) {
        // db_i for 8 columns: lane (q, c) sums rows q, q + 4, .. of column
        // c in order, then (q0 + q1) + (q2 + q3)
        const int c = 8 * (j - n_dw) + (lane & 7);
        float sum = 0.0f;
        for (int s = lane >> 3; s < S; s += 4) sum = __fadd_rn(sum, dz[s * PM + c]);
        sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, 8));
        sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, 16));
        if (lane < 8 && c < M) acc[m.offb[i] + c] = __fadd_rn(acc[m.offb[i] + c], sum);
      } else {
        // the (r0, c0) block of dh = op(dz) W_i
        const int jj = j - n_dw - n_db, r0 = (jj / ch) * 16, c0 = (jj % ch) * 8;
        float d[4] = {};
        block_mma<false, true, 1>(d, dzb + r0 * PM, PM, w + c0, PK, MP / 16);
        if (i > 0) {
          for_pairs<1>(d, r0, c0, [&](int r, int c, float d0, float d1) {
            float2* z = reinterpret_cast<float2*>(dzo + r * PK + c);
            const float2 s = *z;  // sg_{i-1}
            const float v0 = __fmul_rn(d0, s.x), v1 = __fmul_rn(d1, s.y);
            *z = make_float2(v0, v1);
            store_bf2(dzbo + r * PK + c, v0, v1);
          });
        } else {
          for_pairs<1>(d, r0, c0, [&](int r, int c, float d0, float d1) {
            *reinterpret_cast<float2*>(dzo + r * PK + c) = make_float2(d0, d1);
          });
        }
      }
    }
    __syncthreads();
    cur ^= 1;
    if (!p.resident && i > 0) {
      tc_stage(m, p, smem, i - 1);
      __syncthreads();
    }
  }
  return tc_f(smem, p.dx);
}

}  // namespace lfgc
