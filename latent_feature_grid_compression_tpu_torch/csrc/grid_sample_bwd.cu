// Trilinear feature-grid fetch, gradient with respect to the grid, summed in
// a fixed order, for Hopper (sm_90a).
//
// Replaces the two backward Pallas TPU kernels of
// latent_feature_grid_compression_tpu/ops/pallas_kernels.py:
//   _bwd_kernel          (H*W <= 512, grids up to 22, the flagship grid 15)
//   _bwd_kernel_blocked  (H*W > 512, grids 23..62)
// Those compute dG_stack = W2^T @ (Hz * (g @ S^T)) block by block on a
// sequential grid, so the same inputs give the same dG bit for bit.  This
// kernel keeps that property on the card: it is a gather, not a scatter.
// Each entry dG[z, y, x, c] is one thread's float32 sum, taken in the order
// of the plain PyTorch version (ops/interpolation.py::
// grid_sample_channel_minor_backward, or _backward_bf16 in the 'bf16'
// mode), which adds corner by corner in the order z, y, x (index_add_ once
// a corner) and, within a corner, sample by sample in ascending order (the
// CPU's index_add_ adds in index order):
//
//   dG[z, y, x, c] = sum over corners (dz, dy, dx), then over the samples n
//                    whose lower corner is (z - dz, y - dy, x - dx), n
//                    ascending, of term(w(n, corner), g[n, c])
//
// with the fetch's pixel map and weights (trilinear.cuh: the same cell_of,
// the same 1 - f, the same products, unfused), so on finite inputs the
// kernel equals the plain version run on the CPU bit for bit, and two calls
// give the same dG.  An out-of-range corner's term, which the plain version
// adds to a clamped row with weight 0, is skipped: adding +-0 to a sum that
// starts at +0 changes no bit.
//
// One cooperative launch, six phases between grid-wide barriers (the
// wrapper allocates dG and the int32 scratch with torch.empty; nothing is
// zeroed before the launch):
//   1. zero the bucket counts;
//   2. each sample's bucket, its lower corner: (D+1)(H+1)(W+1) buckets, as
//      the lower corner runs over [-1, size-1] on each axis (a sample whose
//      corner lies outside touches no row and is dropped), counted by
//      integer atomics;
//   3. each block scans its share of the counts;
//   4. each block adds up the blocks' totals in its shared memory (so a
//      bucket's start is its local prefix plus its block's offset), and each
//      sample takes a slot in its bucket's range by an integer atomic;
//   5. each placed sample counts the smaller sample indices of its bucket,
//      which is its rank: the bucket is sorted ascending, and the sample's
//      record (its cell fractions) and its row of g are written at its rank;
//      each block writes out its share of the buckets' first slots;
//   6. the gather: a group of min(C, 32) lanes a row of dG, one channel a
//      lane, walks the row's 8 neighbouring buckets in corner order and
//      adds each sample's term with __fadd_rn into its one register.  The
//      records and g's rows lie in bucket order, so a term's two loads
//      depend on nothing but the loop index and run ahead of the sums.
// Integer atomics only decide where a sample's record lands within its
// bucket before the sort, never a float's value.
//
// Bound on the card: bytes and operations both well under 1 us at a train
// step's 32,768 samples.  What sets the time here is latency: five grid
// barriers, and each entry's dependent chain of 8N/(D*H*W) float adds (78 at
// the flagship, thousands at grid 4, where few threads carry long chains).
// Work per phase is O(N) but for phase 5, whose rank count is O(bucket
// size) per sample, so O(sum of the buckets' squared sizes) in all: ~10 a
// sample at the flagship, ~260 at grid 4 (one train step).  That is the
// worst case to know: samples crowded into few cells (a small grid under a
// large batch, or clustered positions) make phase 5 grow with the square of
// the crowd; at grid 4 a batch of 262,144 uniform samples (~2,100 a bucket)
// takes milliseconds where the train step's takes microseconds
// (ablate_fetch.py's case 'bwd uniform C16 G4 n262144').  A stable counting
// sort (each sample's slot from a scan of the keys in index order) would
// make it O(N) at the cost of more grid barriers on every call.
// On an H100 (ablate_fetch.py's cuts) phases 1-5 take ~20 us whatever the
// shape, the barriers most of it; the gather the rest: ~16 us at the
// flagship, where each step of a chain waits on its loads (hence kBatch
// terms' loads issued at once), and at large grids the per-row set-up of
// ~240,000 nearly empty rows (grid 62).
//
// The 'bf16' mode (the bf16 compute path) is the BF16 instantiation: each
// term is trilinear.cuh's lfgc::grad_term<true>, bf16(wxy) * bf16(wz *
// bf16(g)), as the plain 'bf16' version forms it plane by plane.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "trilinear.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// at most (fewer where the work is small): one leaves a thread 128
// registers, and each grid barrier fewer blocks to wait for
constexpr int kBlocksPerSm = 1;
// most blocks a launch takes: the scratch holds one partial sum a block
// (ops/grid_sample.py BWD_SCRATCH_BLOCKS)
constexpr int kMaxBlocks = 1024;
constexpr int kBatch = 4;   // the gather's terms a step, loaded together

struct Args {
  const float* g;        // (N, C)
  const float* coords;   // (N, 3)
  float* dgrid;          // (D*H*W, C), every entry written
  int* scratch;          // scratch_words(n, C, D, H, W) ints, 16-byte aligned
  int n;
  int C, D, H, W;
};

__host__ __device__ inline int64_t buckets_of(int D, int H, int W) {
  return int64_t(D + 1) * (H + 1) * (W + 1);
}

// Ints of scratch a call needs: the sorted records (4 a sample) and rows of
// g (C a sample), the keys and the placed indices (1 a sample each), the
// counts, the blocks' local prefixes and the buckets' first slots (one
// more than the buckets each) and one partial sum a block.
__host__ __device__ inline int64_t scratch_words(int64_t n, int C, int D, int H, int W) {
  return (6 + int64_t(C)) * n + 3 * buckets_of(D, H, W) + 2 + kMaxBlocks;
}

// The exclusive prefix sum of v over the block's threads in thread order,
// and the block's total in *total.  Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();   // warp_sums is reused by the next call
  return before + x - v;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
grid_sample_bwd_kernel(const Args a) {
  extern __shared__ int offsets[];   // gridDim.x: each block's first slot
  __shared__ int warp_sums[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int n = a.n, C = a.C, D = a.D, H = a.H, W = a.W;
  const int B = int(buckets_of(D, H, W));
  float4* rec = reinterpret_cast<float4*>(a.scratch);   // (n): fx, fy, fz, 0
  float* sg = reinterpret_cast<float*>(a.scratch) + 4 * int64_t(n);   // (n, C)
  int* key = a.scratch + (4 + int64_t(C)) * n;          // (n): bucket, or -1
  int* placed = key + n;                                // (kept): indices by bucket
  int* count = placed + n;                              // (B)
  int* local = count + B;                               // (B + 1)
  int* begin = local + B + 1;                           // (B + 1): first slots
  int* partial = begin + B + 1;                         // (gridDim.x)
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t threads = int64_t(gridDim.x) * blockDim.x;

  // 1. zero the counts
  for (int64_t k = tid; k < B; k += threads) count[k] = 0;
  grid.sync();

  // 2. each sample's bucket, counted
  for (int64_t i = tid; i < n; i += threads) {
    const lfgc::Cell c = lfgc::cell_of(__ldg(a.coords + 3 * i), __ldg(a.coords + 3 * i + 1),
                                       __ldg(a.coords + 3 * i + 2), D, H, W);
    int k = -1;
    if (c.x0 >= -1 && c.x0 < W && c.y0 >= -1 && c.y0 < H && c.z0 >= -1 && c.z0 < D) {
      k = ((c.z0 + 1) * (H + 1) + (c.y0 + 1)) * (W + 1) + (c.x0 + 1);
      atomicAdd(count + k, 1);
    }
    key[i] = k;
  }
  grid.sync();

  // 3. this block's share of the B + 1 entries (the last one 0), scanned
  const int entries = B + 1;
  const int chunk = (entries + int(gridDim.x) - 1) / int(gridDim.x);
  {
    const int lo = int(blockIdx.x) * chunk;
    const int hi = min(lo + chunk, entries);
    int running = 0;
    for (int base = lo; base < hi; base += kThreads) {
      const int k = base + threadIdx.x;
      const int v = k < hi && k < B ? __ldcg(count + k) : 0;
      int total;
      const int ex = block_exclusive_scan(v, warp_sums, &total);
      if (k < hi) local[k] = running + ex;
      running += total;
    }
    if (threadIdx.x == 0) partial[blockIdx.x] = running;
  }
  grid.sync();

  // 4. the blocks' offsets, then each sample's slot in its bucket's range
  {
    int running = 0;
    for (int base = 0; base < int(gridDim.x); base += kThreads) {
      const int j = base + threadIdx.x;
      const int v = j < int(gridDim.x) ? __ldcg(partial + j) : 0;
      int total;
      const int ex = block_exclusive_scan(v, warp_sums, &total);
      if (j < int(gridDim.x)) offsets[j] = running + ex;
      running += total;
    }
    __syncthreads();
  }
  auto start = [&](int k) { return __ldcg(local + k) + offsets[k / chunk]; };
  for (int64_t i = tid; i < n; i += threads) {
    const int k = key[i];
    if (k >= 0) placed[start(k) + atomicSub(count + k, 1) - 1] = int(i);
  }
  grid.sync();

  // 5. each bucket sorted by sample index: a sample's rank is the number of
  // smaller indices in its bucket; and this block's share of the buckets'
  // first slots written out for the gather (start(k) of a k in the share)
  {
    const int lo = int(blockIdx.x) * chunk, hi = min(lo + chunk, entries);
    for (int k = lo + threadIdx.x; k < hi; k += kThreads) {
      begin[k] = __ldcg(local + k) + offsets[blockIdx.x];
    }
  }
  const int kept = start(B);
  // g's rows move as float4s where they are whole, aligned float4s
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(a.g) % 16 == 0;
  for (int64_t p = tid; p < kept; p += threads) {
    const int i = __ldcg(placed + p);
    const int k = __ldcg(key + i);
    const int lo = start(k), hi = start(k + 1);
    int rank = 0;
#pragma unroll 8
    for (int q = lo; q < hi; ++q) rank += __ldcg(placed + q) < i;
    const lfgc::Cell c = lfgc::cell_of(__ldg(a.coords + 3 * i), __ldg(a.coords + 3 * i + 1),
                                       __ldg(a.coords + 3 * i + 2), D, H, W);
    rec[lo + rank] = make_float4(c.fx, c.fy, c.fz, 0.0f);
    const float* from = a.g + int64_t(i) * C;
    float* to = sg + int64_t(lo + rank) * C;
    if (vec4) {
      for (int ch = 0; ch < C; ch += 4) {
        *reinterpret_cast<float4*>(to + ch) = __ldg(reinterpret_cast<const float4*>(from + ch));
      }
    } else {
      for (int ch = 0; ch < C; ++ch) to[ch] = __ldg(from + ch);
    }
  }
  grid.sync();

  // 6. the gather: min(C, 32) lanes a row, one channel a lane (more channels
  // in turns), each entry one float32 sum in the plain version's order
  const int Lw = C < 32 ? C : 32, P = 32 / Lw;
  const int lane = threadIdx.x & 31, slot = lane / Lw, sub = lane - slot * Lw;
  const int64_t rows = int64_t(D) * H * W;
  const int64_t units = (rows + P - 1) / P;
  for (int64_t u = tid >> 5; u < units; u += threads >> 5) {
    const int64_t r = u * P + slot;
    if (slot >= P || r >= rows) continue;
    const int zy = int(r) / W, x = int(r) - zy * W, z = zy / H, y = zy - z * H;
    int first[8], last[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
      const int b = ((z - dz + 1) * (H + 1) + (y - dy + 1)) * (W + 1) + (x - dx + 1);
      first[k] = __ldcg(begin + b);
      last[k] = __ldcg(begin + b + 1);
    }
    for (int c = sub; c < C; c += Lw) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
        // kBatch terms a step, every load issued before the sums; past the
        // bucket's end a term is g = 0 at fractions 0, exactly +0, which
        // leaves the sum (never -0: it starts at +0) as it is
        for (int p = first[k]; p < last[k]; p += kBatch) {
          float4 s[kBatch];
          float gv[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const bool in = p + j < last[k];
            s[j] = in ? __ldcg(rec + p + j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            gv[j] = in ? __ldcg(sg + int64_t(p + j) * C + c) : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const float wx = dx ? s[j].x : __fadd_rn(1.0f, -s[j].x);
            const float wy = dy ? s[j].y : __fadd_rn(1.0f, -s[j].y);
            const float wz = dz ? s[j].z : __fadd_rn(1.0f, -s[j].z);
            acc = __fadd_rn(acc, lfgc::grad_term<BF16>(__fmul_rn(wx, wy), wz, gv[j]));
          }
        }
      }
      a.dgrid[r * C + c] = acc;
    }
  }
}

using Kernel = decltype(&grid_sample_bwd_kernel<false>);

Kernel kernel_of(bool bf16) {
  return bf16 ? grid_sample_bwd_kernel<true> : grid_sample_bwd_kernel<false>;
}

// How a call launches.
struct Plan {
  int blocks;
  int per_sm;    // blocks an SM can hold (occupancy)
  int rows;      // rows of dG a warp sums at once
  int lanes;     // lanes a row
  int smem;      // dynamic shared bytes a block
};

// Blocks enough for the largest phase (the samples, the counts, or the
// gather's warps), at most kBlocksPerSm an SM (as many as the card holds at
// once, which a cooperative launch needs) and kMaxBlocks.
cudaError_t plan_of(int64_t n, int C, int D, int H, int W, bool bf16, Plan* p) {
  static lfgc::PerCard cache[2];
  int sms = 0;
  const cudaError_t err = lfgc::per_card(cache[bf16], &sms, &p->per_sm, [&](int* s, int* b) {
    return lfgc::occupancy(kernel_of(bf16), kThreads, kMaxBlocks * sizeof(int), b, s);
  });
  if (err != cudaSuccess) return err;
  p->lanes = C < 32 ? C : 32;
  p->rows = 32 / p->lanes;
  const int64_t units = (int64_t(D) * H * W + p->rows - 1) / p->rows;
  int64_t work = n > units * 32 ? n : units * 32;
  if (buckets_of(D, H, W) + 1 > work) work = buckets_of(D, H, W) + 1;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(p->per_sm < kBlocksPerSm ? p->per_sm : kBlocksPerSm) * sms;
  if (blocks > cap) blocks = cap;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  p->blocks = int(blocks);
  p->smem = int(blocks * sizeof(int));
  return cudaSuccess;
}

// Shapes the kernel's int indices hold.
bool fits(int64_t n, int C, int D, int H, int W) {
  return n >= 0 && C > 0 && D > 0 && H > 0 && W > 0 && n < (int64_t(1) << 30) &&
         buckets_of(D, H, W) < (int64_t(1) << 30) && int64_t(C) * n < (int64_t(1) << 40);
}

template <bool BF16>
cudaError_t launch(const void* g, const void* coords, void* dgrid, void* scratch,
                   int64_t scratch_len, int64_t n, int C, int D, int H, int W,
                   void* stream) {
  if (!fits(n, C, D, H, W) || scratch_len < scratch_words(n, C, D, H, W) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  Plan p;
  const cudaError_t err = plan_of(n, C, D, H, W, BF16, &p);
  if (err != cudaSuccess) return err;
  Args args{static_cast<const float*>(g), static_cast<const float*>(coords),
            static_cast<float*>(dgrid), static_cast<int*>(scratch), int(n), C, D, H, W};
  void* params[] = {&args};
  const cudaError_t launched =
      cudaLaunchCooperativeKernel(kernel_of(BF16), dim3(unsigned(p.blocks)), dim3(kThreads),
                                  params, size_t(p.smem), static_cast<cudaStream_t>(stream));
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes, one a mode ('f32', 'bf16').  Pointers are
// device pointers: g (n, C) and coords (n, 3) float32, dgrid (D*H*W, C)
// float32 (every entry written: no zeroing needed), scratch `scratch_words`
// ints (at least scratch_words(n, C, D, H, W) above; the wrapper's
// bwd_scratch_words), 16-byte aligned.  Returns the first CUDA error of the
// plan or the launch.
extern "C" int lfgc_grid_sample_bwd_f32(const void* g, const void* coords, void* dgrid,
                                        void* scratch, int64_t scratch_words, int64_t n, int C,
                                        int D, int H, int W, void* stream) {
  return int(launch<false>(g, coords, dgrid, scratch, scratch_words, n, C, D, H, W, stream));
}

extern "C" int lfgc_grid_sample_bwd_bf16(const void* g, const void* coords, void* dgrid,
                                         void* scratch, int64_t scratch_words, int64_t n, int C,
                                         int D, int H, int W, void* stream) {
  return int(launch<true>(g, coords, dgrid, scratch, scratch_words, n, C, D, H, W, stream));
}

// For reports, the launch for n samples into a (D, H, W, C) gradient on the
// current card, in a mode (bf16 0 or 1): out = [threads a block, blocks an
// SM, blocks, buckets, rows a warp, lanes a row, dynamic shared bytes].
extern "C" int lfgc_grid_sample_bwd_plan(int64_t n, int C, int D, int H, int W, int bf16,
                                         int* out) {
  if (!fits(n, C, D, H, W)) return int(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan_of(n, C, D, H, W, bf16 != 0, &p);
  if (err != cudaSuccess) return int(err);
  const int rep[7] = {kThreads, p.per_sm, p.blocks, int(buckets_of(D, H, W)), p.rows, p.lanes,
                      p.smem};
  for (int k = 0; k < 7; ++k) out[k] = rep[k];
  return int(cudaSuccess);
}

extern "C" const char* lfgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
