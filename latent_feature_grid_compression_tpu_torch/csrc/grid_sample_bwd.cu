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
// the same 1 - f, the same products, unfused; a term is grad_weight times
// grad_scale, which is grad_term), so on finite inputs the kernel equals
// the plain version run on the CPU bit for bit, and two calls give the same
// dG.  An out-of-range corner's term, which the plain version adds to a
// clamped row with weight 0, is skipped: adding +-0 to a sum that starts at
// +0 changes no bit.
//
// A sample's bucket is its lower corner: (D+1)(H+1)(W+1) buckets, as the
// lower corner runs over [-1, size-1] on each axis (a sample whose corner
// lies outside touches no row); a bucket row is the W+1 buckets of one
// (z, y), a bin one or more whole bucket rows.  Two ordinary launches on
// the caller's stream, no grid barrier, no float atomics (the wrapper
// allocates dG and the int32 scratch with torch.empty; nothing is zeroed):
//   1. grid_sample_bwd_tiles_kernel: the sample order in tiles (128
//      samples, more past 131,072), a block each; a tile's kept samples
//      sorted by bin, stably: the bins' counts scanned into first slots,
//      then the 4 warps, each a contiguous share, take turns in order, 32
//      samples a step, a sample's slot its bin's next one plus its rank
//      among the equal bins of its step (__match_any_sync, __popc): a
//      sample's slot comes from the index order, no bucket is scanned.  It
//      writes the (index, bucket) pairs and each bin's first item.
//   2. grid_sample_bwd_kernel: a block owns a box of dG's rows (whole
//      z-planes, a range of y in one plane, or a range of x in one line)
//      and a group of channels.  The rows of a box read the buckets of a
//      box one larger on each axis: one, two or four runs of consecutive
//      buckets, in the bins of one or two ranges.  The block
//      a. reads, tile after tile, its ranges' items (a segment a tile and
//         range: within a bucket they are in index order) and keeps those in
//         its runs: an ordered block compaction (a block scan of the
//         threads' counts);
//      b. sorts them by bucket in shared memory, stably and in time linear
//         in their number: each of a few warps counts the buckets of a
//         contiguous share of them into a (bucket, warp) table, a scan of
//         the table in bucket-major order gives each warp its first slot in
//         each bucket, and the warps walk their shares again together,
//         ranking equal buckets as the tile kernel does;
//      c. stages each kept sample's 8 corner weights and its row of g for
//         the block's channels in shared memory (in 'bf16' g scaled for both
//         z planes; there both factors are bf16 numbers, kept as 16 bits);
//      d. gathers: a group of lanes a row, 1, 2 or 4 channels a lane (more
//         where the box has rows to spare), walk the row's 8 buckets in
//         corner order and add each term, both factors read from shared
//         memory, with __fadd_rn into one register a channel, then write the
//         entry (+0 where no sample reaches it).
//      Where a box holds more samples than its shared memory (crowded
//      positions, a small grid under a large batch), the block takes the
//      corners one at a time, each from the items of the bucket rows that
//      corner reads, and, within a corner, windows of them that fill its
//      shared memory, each entry's running sum kept in dG between passes
//      by the thread that owns it: the same adds in the same order, O(N) a
//      pass, (8 + windows) passes.
// The plan (plan_of) picks the boxes and channel groups so that a box's
// expected samples (uniform positions) fit its shared memory, in the
// fewest estimated cycles (waves of one block an SM times a block's).
//
// Bound on the card: bytes and operations both well under 1 us at a train
// step's 32,768 samples; what sets the time is latency and issue: two
// launches, the tiles' and the boxes' barriers, and each entry's dependent
// chain of 8N/(D*H*W) float adds (78 at the flagship, thousands at grid 4),
// fed from shared memory, so a step of a chain waits on the add (~4
// cycles), its loads issued a group ahead, not on L2.
//
// The 'bf16' mode (the bf16 compute path) is the BF16 instantiation: each
// term is bf16(wxy) * bf16(wz * bf16(g)), as the plain 'bf16' version forms
// it plane by plane.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"
#include "trilinear.cuh"

namespace {

constexpr int kThreads = 512;            // the box kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kTileThreads = 128;        // the tile kernel's block
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kMinTile = 128;            // samples a tile, at least
constexpr int kMaxTiles = 1024;          // tiles a call, at most
constexpr int kMaxBins = 2048;           // bins (of whole bucket rows) a tile sorts into
constexpr int kItemsPerThread = 4;       // items a thread tests a filter step
constexpr int kMaxLocalBuckets = 4096;   // buckets a box reads
constexpr int kTableInts = 4096;         // the sort's (bucket, warp) counts
constexpr int kMinCapacity = 256;        // samples a block stages at once, at least
constexpr int kWeights = 8;              // a staged sample's weights, one a corner
constexpr int kUnroll = 8;               // a lane's terms loaded together (all its channels)

// The tiles of the sample order: samples a tile, tiles, bucket rows a bin,
// bins (the bucket row of key k is k / (W + 1), its bin that over f).
struct Tiling {
  int T, tiles, f, nb;
};

__host__ __device__ inline Tiling tiling_of(int64_t n, int D, int H) {
  Tiling t;
  int64_t T = (n + kMaxTiles - 1) / kMaxTiles;
  T = (T + kTileThreads - 1) / kTileThreads * kTileThreads;
  t.T = int(T < kMinTile ? kMinTile : T);
  t.tiles = int((n + t.T - 1) / t.T);
  const int64_t rows = int64_t(D + 1) * (H + 1);
  t.f = int((rows + kMaxBins - 1) / kMaxBins);
  t.nb = int((rows + t.f - 1) / t.f);
  return t;
}

struct Args {
  const float* g;        // (N, C)
  const float* coords;   // (N, 3)
  float* dgrid;          // (D*H*W, C), every entry written
  const int2* items;     // (tiles, T): each tile's kept samples (index, key) by bin
  const int* starts;     // (tiles, nb + 1): each bin's first item in its tile
  Tiling tl;
  int n;
  int C, D, H, W;
};

// How the box kernel splits the work (plan_of).
struct Boxes {
  int zs, ys, xs;    // rows of a box along z, y, x (the last on an axis may have fewer)
  int nz, ny, nx;    // boxes along z, y, x
  int groups, cb;    // channel groups, channels a group (the last may have fewer)
  int cap;           // samples a block stages at once
  int lb;            // buckets a whole box reads: (zs+1)(ys+1)(xs+1)
  int nwp;           // warps that sort (their (bucket, warp) counts fill kTableInts)
  int k;             // channels a lane of the gather: 1, 2 or 4
  int segs;          // most segments a box reads: two a tile
  int per_corner;    // 1: take the corners one at a time from the start
};

__host__ __device__ inline int64_t buckets_of(int D, int H, int W) {
  return int64_t(D + 1) * (H + 1) * (W + 1);
}

// Ints of scratch a call needs: the tiles' items (two ints a sample, a
// whole tile each) and their bins' first items.
__host__ __device__ inline int64_t scratch_words(int64_t n, int D, int H) {
  const Tiling t = tiling_of(n, D, H);
  return 2 * int64_t(t.tiles) * t.T + int64_t(t.tiles) * (t.nb + 1);
}

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// A staged sample's 8 weights in their type's units (in 'bf16' padded to
// an odd number of 32-bit words, the last of which holds the sample's fz).
__host__ __device__ constexpr int weight_stride(bool bf16) {
  return bf16 ? 10 : 8;
}

// A staged sample's row of g in 32-bit words, one a channel (in 'bf16' the
// pair of its scaled values for the two z planes): whole 16-byte chunks
// for the asynchronous copies, 4 words over, so that the rows of a warp's
// samples rarely meet on a bank.
__host__ __device__ inline int scale_words(int cb) {
  return (cb + 3) / 4 * 4 + 4;
}

// Byte offsets of the box kernel's dynamic shared memory.
struct Layout {
  int seg_off, seg_at, mask, begin, tab, sorted, wt, gs, total;
};

__host__ __device__ inline Layout layout_of(const Boxes& b, bool bf16) {
  Layout L;
  int at = 0;
  L.seg_off = at;   // (segs + 1) ints: each segment's first place in the box's items
  at = align16(at + 4 * (b.segs + 1));
  L.seg_at = at;    // (segs) ints: each segment's first item in the tiles
  at = align16(at + 4 * b.segs);
  L.mask = at;      // (lb) bytes: the corners whose rows of the box a bucket feeds
  at = align16(at + b.lb);
  L.begin = at;     // (lb + 1) ints: each bucket's first staged slot
  at = align16(at + 4 * (b.lb + 1));
  L.tab = at;       // (lb * nwp) ints: the sort's counts, then slots
  at = align16(at + 4 * b.lb * b.nwp);
  L.sorted = at;    // (cap) ints: the kept samples' indices by bucket
  at = align16(at + 4 * b.cap);
  L.wt = at;        // (cap, 8) factors: a weight a corner; the kept list before
  at = align16(at + weight_stride(bf16) * (bf16 ? 2 : 4) * b.cap);
  L.gs = at;        // (cap, cb) words: g, in 'bf16' scaled, a pair of bf16 values a word
  at = align16(at + 4 * scale_words(b.cb) * b.cap);
  L.total = at;
  return L;
}

// The exclusive prefix sum of v over the block's NT threads in thread
// order, and the block's total in *total.  Every thread of the block calls
// it.
template <int NT = kThreads>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  constexpr int kScanWarps = NT / 32;
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
    int s = lane < kScanWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kScanWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kScanWarps - 1];
  __syncthreads();   // warp_sums is reused by the next call
  return before + x - v;
}

// v[0..len) replaced by its exclusive prefix sums; every thread of the
// block's NT calls it.
template <int NT = kThreads>
__device__ void scan_in_place(int* v, int len, int* warp_sums) {
  const int per = (len + NT - 1) / NT;
  const int lo = min(len, int(threadIdx.x) * per), hi = min(len, lo + per);
  int s = 0;
  for (int e = lo; e < hi; ++e) s += v[e];
  int total;
  int ex = block_exclusive_scan<NT>(s, warp_sums, &total);
  for (int e = lo; e < hi; ++e) {
    const int x = v[e];
    v[e] = ex;
    ex += x;
  }
  __syncthreads();
}

// A box's buckets as runs of consecutive keys: run r holds the keys
// lo[r] .. lo[r] + len - 1, local buckets r * len .. r * len + len - 1.
struct Runs {
  int lo[4];
  int len, count;
  unsigned span;   // lo[count - 1] + len - lo[0]: the keys from the first run's to the last's
};

__device__ __forceinline__ int local_bucket(int key, const Runs& r) {
  if (unsigned(key - r.lo[0]) >= r.span) return -1;   // most keys: before or past every run
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned t = unsigned(key - r.lo[k]);
    if (k < r.count && t < unsigned(r.len)) return k * r.len + int(t);
  }
  return -1;
}

// The box's items: for each tile in order, the items of the bins that hold
// its bucket rows (one or two ranges of bins), a segment each.  seg_at[s]
// is segment s's first item in the tiles, seg_off[s] its first place in
// the box's items (seg_off[segments] their count).  Within a bucket they
// are in index order: a bucket's samples lie in one bin, tile after tile.
// Returns their count.
__device__ int segments(const Args& a, const int (&rlo)[2], const int (&rhi)[2], int nr,
                        int* seg_at, int* seg_off, int* warp_sums) {
  const int ns = a.tl.tiles * nr;
  for (int q = threadIdx.x; q <= ns; q += kThreads) {
    if (q == ns) {
      seg_off[q] = 0;
      continue;
    }
    const int t = q / nr, r = q - t * nr;
    const int* st = a.starts + int64_t(t) * (a.tl.nb + 1);
    const int lo = __ldg(st + (r ? rlo[1] : rlo[0]));
    seg_at[q] = t * a.tl.T + lo;
    seg_off[q] = __ldg(st + (r ? rhi[1] : rhi[0]) + 1) - lo;
  }
  __syncthreads();
  scan_in_place(seg_off, ns + 1, warp_sums);
  return seg_off[ns];
}

// Keeps, in the order of the box's items (index order within a bucket), the
// items from place `from` on whose key lies in the runs and whose local
// bucket passes take(), at most cap of them: their sample indices in idx[],
// their local buckets in lbs[].  Returns how many were kept; *next is the
// place of the first passing item not kept (total when none was left).
template <class Take>
__device__ int fill(const Args& a, const int* seg_at, const int* seg_off, int ns, int total,
                    int from, int cap, const Runs& runs, Take take, int* idx, int* lbs,
                    int* warp_sums, int* cut, int* next) {
  constexpr int kStep = kThreads * kItemsPerThread;
  if (threadIdx.x == 0) *cut = total;
  int kept = 0;
  for (int base = from; base < total; base += kStep) {
    const int q = base + int(threadIdx.x) * kItemsPerThread;
    // the segment of place q: the last whose first place is at most q
    int s = 0;
    if (q < total) {
      int hi = ns;
      while (s + 1 < hi) {
        const int mid = (s + hi) >> 1;
        if (seg_off[mid] <= q) s = mid; else hi = mid;
      }
    }
    int id[kItemsPerThread], lb[kItemsPerThread];
    int count = 0;
#pragma unroll
    for (int e = 0; e < kItemsPerThread; ++e) {
      lb[e] = -1;
      if (q + e >= total) continue;
      while (seg_off[s + 1] <= q + e) ++s;
      const int2 it = __ldg(a.items + seg_at[s] + (q + e - seg_off[s]));
      id[e] = it.x;
      int l = local_bucket(it.y, runs);
      if (l >= 0 && !take(l)) l = -1;
      lb[e] = l;
      count += l >= 0;
    }
    int sum;
    int pos = kept + block_exclusive_scan(count, warp_sums, &sum);
#pragma unroll
    for (int e = 0; e < kItemsPerThread; ++e) {
      if (lb[e] < 0) continue;
      if (pos < cap) {
        idx[pos] = id[e];
        lbs[pos] = lb[e];
      } else if (pos == cap) {
        *cut = q + e;
      }
      ++pos;
    }
    kept += sum;
    if (kept > cap) break;
  }
  __syncthreads();
  *next = *cut;
  return kept < cap ? kept : cap;
}

// Sorts the m kept samples by local bucket, stably (index order within a
// bucket): sorted[] their indices, begin[0..nb] each bucket's first slot
// (begin[nb] = m).
__device__ void place(int m, int nb, int nwp, const int* idx, const int* lbs, int* tab,
                      int* begin, int* sorted, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cells = nb * nwp;
  for (int e = threadIdx.x; e < cells; e += kThreads) tab[e] = 0;
  __syncthreads();
  // warp w's share of the kept list, contiguous in index order
  const int lo = warp < nwp ? int(int64_t(m) * warp / nwp) : 0;
  const int hi = warp < nwp ? int(int64_t(m) * (warp + 1) / nwp) : 0;
  for (int j = lo + lane; j < hi; j += 32) atomicAdd(tab + lbs[j] * nwp + warp, 1);
  __syncthreads();
  scan_in_place(tab, cells, warp_sums);   // bucket-major: (bucket, warp) slots
  for (int k = threadIdx.x; k < nb; k += kThreads) begin[k] = tab[k * nwp];
  if (threadIdx.x == 0) begin[nb] = m;
  __syncthreads();
  if (warp < nwp) {
    for (int s = lo; s < hi; s += 32) {
      const int j = s + lane;
      const bool in = j < hi;
      const int key = in ? lbs[j] : -1 - lane;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      int* slot = tab + (in ? key : 0) * nwp + warp;
      const int at = in ? *slot : 0;
      if (in) sorted[at + rank] = idx[j];
      __syncwarp();
      if (in && rank == 0) *slot = at + __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
}

// A staged factor of a term: a float in 'f32'; in 'bf16', where both
// factors are bf16 numbers (grad_weight, grad_scale), its 16 bits.
template <bool BF16>
struct Factor {
  using T = float;
  __device__ static T pack(float v) { return v; }
  __device__ static float unpack(T v) { return v; }
};

template <>
struct Factor<true> {
  using T = unsigned short;
  __device__ static T pack(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
  __device__ static float unpack(T v) { return __uint_as_float(unsigned(v) << 16); }
};

// Each sorted sample's 8 corner weights and its g for channels c0.. c0+cw
// into shared memory: g's rows by asynchronous copies (16 bytes where the
// rows allow, else 4), the weights from the sample's cell meanwhile; in
// 'bf16' each copied value then replaced by its pair of values scaled for
// the two z planes.
template <bool BF16>
__device__ void stage(int m, const int* sorted, const Args& a, int c0, int cw, int cb,
                      typename Factor<BF16>::T* wt, typename Factor<BF16>::T* gs) {
  using F = Factor<BF16>;
  const int ws = weight_stride(BF16), gw = scale_words(cb);
  float* raw = reinterpret_cast<float*>(gs);
  if (cw % 4 == 0 && a.C % 4 == 0 && c0 % 4 == 0 &&
      reinterpret_cast<uintptr_t>(a.g) % 16 == 0) {
    const int q4 = cw / 4;
    for (int e = threadIdx.x; e < m * q4; e += kThreads) {
      const int p = e / q4, q = e - p * q4;
      __pipeline_memcpy_async(raw + p * gw + 4 * q,
                              a.g + int64_t(sorted[p]) * a.C + c0 + 4 * q, 16);
    }
  } else {
    for (int e = threadIdx.x; e < m * cw; e += kThreads) {
      const int p = e / cw, c = e - p * cw;
      __pipeline_memcpy_async(raw + p * gw + c, a.g + int64_t(sorted[p]) * a.C + c0 + c, 4);
    }
  }
  __pipeline_commit();
  for (int p = threadIdx.x; p < m; p += kThreads) {
    const int64_t i = sorted[p];
    const lfgc::Cell c = lfgc::cell_of(__ldg(a.coords + 3 * i), __ldg(a.coords + 3 * i + 1),
                                       __ldg(a.coords + 3 * i + 2), a.D, a.H, a.W);
    const float wx[2] = {__fadd_rn(1.0f, -c.fx), c.fx};
    const float wy[2] = {__fadd_rn(1.0f, -c.fy), c.fy};
    const float wz[2] = {__fadd_rn(1.0f, -c.fz), c.fz};
#pragma unroll
    for (int k = 0; k < kWeights; ++k) {
      wt[p * ws + k] =
          F::pack(lfgc::grad_weight<BF16>(__fmul_rn(wx[k & 1], wy[(k >> 1) & 1]), wz[k >> 2]));
    }
    if (BF16) reinterpret_cast<float*>(wt + p * ws)[kWeights / 2] = c.fz;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (BF16) {
    // cw lanes a sample, a channel a lane
    const int per = 32 / cw, lane = threadIdx.x & 31, c = lane % cw;
    if (lane < per * cw) {
      for (int p = (threadIdx.x >> 5) * per + lane / cw; p < m; p += kWarps * per) {
        const float fz = reinterpret_cast<const float*>(wt + p * ws)[kWeights / 2];
        const float x = raw[p * gw + c];
        const unsigned lo = F::pack(lfgc::grad_scale<BF16>(__fadd_rn(1.0f, -fz), x));
        const unsigned hi = F::pack(lfgc::grad_scale<BF16>(fz, x));
        reinterpret_cast<unsigned*>(raw)[p * gw + c] = lo | (hi << 16);
      }
    }
    __syncthreads();
  }
}

// The sort and the staging as calls, for the crowded passes of 'bf16': its
// gather there runs faster with them out of line (fewer registers live
// across it), where 'f32' and the one-pass route run faster inline.
__device__ __noinline__ void place_call(int m, int nb, int nwp, const int* idx, const int* lbs,
                                        int* tab, int* begin, int* sorted, int* warp_sums) {
  place(m, nb, nwp, idx, lbs, tab, begin, sorted, warp_sums);
}

template <bool BF16>
__device__ __noinline__ void stage_call(int m, const int* sorted, const Args& a, int c0, int cw,
                                        int cb, typename Factor<BF16>::T* wt,
                                        typename Factor<BF16>::T* gs) {
  stage<BF16>(m, sorted, a, c0, cw, cb, wt, gs);
}

// The rows of a block's box, origin and extent.
struct Box {
  int z0, y0, x0, Z, Y, X;
};

// Adds the staged samples' terms of corners k0..k1 into each entry of the
// box's rows for channels c0.. c0+cw: a group of ceil(cb / K) lanes a row,
// K channels a lane (channels sub, sub + lanes, ..); the sum starts at +0 on
// the first pass and from dG after it.  A row's 8 buckets' bounds are read
// at once, and each whole group of terms' loads is issued before the last
// group's adds (the rest one term at a time).
template <bool BF16, int K>
__device__ void gather(const Args& a, const Box& x, int c0, int cw, int cb, const int* begin,
                       const typename Factor<BF16>::T* wt, const typename Factor<BF16>::T* gs,
                       int k0, int k1, bool first) {
  using F = Factor<BF16>;
  const int Lw = (cb + K - 1) / K, P = 32 / Lw;
  const int lane = threadIdx.x & 31, slot = lane / Lw, sub = lane - slot * Lw;
  const int rows = x.Z * x.Y * x.X;
  const int units = (rows + P - 1) / P;
  const int XB = x.X + 1, YB = x.Y + 1;
  // a staged value's place: sample j, channel c, plane dz at
  // s[j * gsd + c * cs + dz] ('f32' has one plane)
  constexpr int ws = weight_stride(BF16), cs = BF16 ? 2 : 1;
  const int gsd = cs * scale_words(cb);
  bool on[K];   // a lane's channels within the group (the first is: sub < cw)
  on[0] = true;
#pragma unroll
  for (int e = 1; e < K; ++e) on[e] = sub + e * Lw < cw;
  for (int u = threadIdx.x >> 5; u < units; u += kWarps) {
    const int r = u * P + slot;
    if (slot >= P || r >= rows || sub >= cw) continue;
    const int t = r / x.X, xl = r - t * x.X, zl = t / x.Y, yl = t - zl * x.Y;
    const int64_t at =
        ((int64_t(x.z0 + zl) * a.H + (x.y0 + yl)) * a.W + (x.x0 + xl)) * a.C + c0 + sub;
    float acc[K];
#pragma unroll
    for (int e = 0; e < K; ++e) acc[e] = first || !on[e] ? 0.0f : a.dgrid[at + e * Lw];
    const int base = ((zl + 1) * YB + (yl + 1)) * XB + (xl + 1);
    int lo[8], hi[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b = base - ((k >> 2) * YB + ((k >> 1) & 1)) * XB - (k & 1);
      lo[k] = begin[b];
      hi[k] = begin[b + 1];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < k0 || k > k1 || lo[k] >= hi[k]) continue;
      const typename F::T* w = wt + k;
      const typename F::T* s = gs + cs * sub + (BF16 ? k >> 2 : 0);
      const int end = hi[k];
      int j = lo[k];
      // whole groups of U terms: the next group's loads issued before this
      // group's adds, its products after them, so the adds wait on each
      // other only
      constexpr int U = kUnroll / K;
      typename F::T rw[U], rs[U][K];
      float pv[U][K];
      auto load = [&](int j0) {
#pragma unroll
        for (int q = 0; q < U; ++q) {
          rw[q] = w[(j0 + q) * ws];
#pragma unroll
          for (int e = 0; e < K; ++e) rs[q][e] = on[e] ? s[(j0 + q) * gsd + e * Lw * cs] : 0;
        }
      };
      auto multiply = [&]() {
#pragma unroll
        for (int q = 0; q < U; ++q) {
#pragma unroll
          for (int e = 0; e < K; ++e) pv[q][e] = __fmul_rn(F::unpack(rw[q]), F::unpack(rs[q][e]));
        }
      };
      auto add = [&]() {
#pragma unroll
        for (int q = 0; q < U; ++q) {
#pragma unroll
          for (int e = 0; e < K; ++e) acc[e] = __fadd_rn(acc[e], pv[q][e]);
        }
      };
      if (j + U <= end) {
        load(j);
        multiply();
        for (; j + 2 * U <= end; j += U) {
          load(j + U);
          add();
          multiply();
        }
        add();
        j += U;
      }
      for (; j < end; ++j) {
        const float wq = F::unpack(w[j * ws]);
#pragma unroll
        for (int e = 0; e < K; ++e) {
          if (on[e]) {
            acc[e] = __fadd_rn(acc[e], __fmul_rn(wq, F::unpack(s[j * gsd + e * Lw * cs])));
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < K; ++e) {
      if (on[e]) a.dgrid[at + e * Lw] = acc[e];
    }
  }
}

// The bucket of sample i (its lower corner), or -1 where that lies outside.
__device__ __forceinline__ int bucket_of(const float* __restrict__ coords, int i, int D, int H,
                                         int W) {
  const int64_t j = 3 * int64_t(i);
  const lfgc::Cell c = lfgc::cell_of(__ldg(coords + j), __ldg(coords + j + 1),
                                     __ldg(coords + j + 2), D, H, W);
  if (c.x0 < -1 || c.x0 >= W || c.y0 < -1 || c.y0 >= H || c.z0 < -1 || c.z0 >= D) return -1;
  return ((c.z0 + 1) * (H + 1) + (c.y0 + 1)) * (W + 1) + (c.x0 + 1);
}

// A tile of T samples (a block): each kept sample's (index, key) sorted by
// bin, stably, into the tile's items, and each bin's first item (the last
// entry: the tile's kept count) into starts.  The bins' counts are scanned
// into their first slots; then the warps, each a contiguous share of the
// tile, take their turns in order, 32 samples a step, each sample's slot its
// bin's next slot plus its rank among the equal bins of its step
// (__match_any_sync, __popc).
__global__ void __launch_bounds__(kTileThreads)
grid_sample_bwd_tiles_kernel(const float* __restrict__ coords, int2* __restrict__ items,
                             int* __restrict__ starts, int n, Tiling tl, int D, int H, int W) {
  extern __shared__ int cursor[];   // (nb + 1): a bin's count, then its next slot
  __shared__ int warp_sums[kTileWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int share = tl.T / kTileWarps;
  const int first = int(blockIdx.x) * tl.T + warp * share + lane;
  auto bin_of = [&](int i, int* key) {   // the dropped samples' bin last
    *key = i < n ? bucket_of(coords, i, D, H, W) : -1;
    return *key < 0 ? tl.nb : *key / (W + 1) / tl.f;
  };
  for (int b = threadIdx.x; b <= tl.nb; b += kTileThreads) cursor[b] = 0;
  __syncthreads();
  int key0;
  const int bin0 = bin_of(first, &key0);   // a share's first step, kept for the walk
  atomicAdd(cursor + bin0, 1);
  for (int s = 32; s < share; s += 32) {
    int key;
    atomicAdd(cursor + bin_of(first + s, &key), 1);
  }
  __syncthreads();
  scan_in_place<kTileThreads>(cursor, tl.nb + 1, warp_sums);
  int* st = starts + int64_t(blockIdx.x) * (tl.nb + 1);
  for (int b = threadIdx.x; b <= tl.nb; b += kTileThreads) st[b] = cursor[b];
  __syncthreads();
  int2* out = items + int64_t(blockIdx.x) * tl.T;
  for (int w = 0; w < kTileWarps; ++w) {
    if (warp == w) {
      for (int s = 0; s < share; s += 32) {
        int key = key0;
        const int bin = s == 0 ? bin0 : bin_of(first + s, &key);
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const int at = cursor[bin];
        if (bin < tl.nb) out[at + rank] = make_int2(first + s, key);
        __syncwarp();
        if (rank == 0) cursor[bin] = at + __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
  }
  // the box kernel may start its set-up (it waits for this grid's end
  // before it reads the items)
  asm volatile("griddepcontrol.launch_dependents;");
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
grid_sample_bwd_kernel(const Args a, const Boxes b) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[kWarps];
  __shared__ int cut;
  const Layout L = layout_of(b, BF16);
  int* seg_off = reinterpret_cast<int*>(smem + L.seg_off);
  int* seg_at = reinterpret_cast<int*>(smem + L.seg_at);
  unsigned char* mask = smem + L.mask;
  int* begin = reinterpret_cast<int*>(smem + L.begin);
  int* tab = reinterpret_cast<int*>(smem + L.tab);
  int* sorted = reinterpret_cast<int*>(smem + L.sorted);
  using T = typename Factor<BF16>::T;
  T* wt = reinterpret_cast<T*>(smem + L.wt);
  T* gs = reinterpret_cast<T*>(smem + L.gs);
  int* idx = reinterpret_cast<int*>(smem + L.wt);   // the kept list, until it is staged
  int* lbs = idx + b.cap;

  // this block's box of rows and its channels
  const int box = int(blockIdx.x) / b.groups, grp = int(blockIdx.x) - box * b.groups;
  const int ix = box % b.nx, iy = (box / b.nx) % b.ny, iz = box / (b.nx * b.ny);
  Box x;
  x.z0 = iz * b.zs;
  x.y0 = iy * b.ys;
  x.x0 = ix * b.xs;
  x.Z = min(b.zs, a.D - x.z0);
  x.Y = min(b.ys, a.H - x.y0);
  x.X = min(b.xs, a.W - x.x0);
  const int c0 = grp * b.cb, cw = min(b.cb, a.C - c0);
  const int XB = x.X + 1, YB = x.Y + 1, nb = (x.Z + 1) * YB * XB;

  // its buckets (z0..z0+Z, y0..y0+Y, x0..x0+X) as runs of keys: whole
  // planes, a y range of two planes, or an x range of four lines
  const int row = a.W + 1, plane = (a.H + 1) * row;
  // the bins of its bucket rows: one range for whole planes, else a range a
  // plane (one range where they meet)
  int rlo[2], rhi[2], nr = 1;
  if (b.nx == 1 && b.ny == 1) {
    rlo[0] = x.z0 * (a.H + 1) / a.tl.f;
    rhi[0] = ((x.z0 + x.Z) * (a.H + 1) + a.H) / a.tl.f;
  } else {
    nr = 2;
    for (int q = 0; q < 2; ++q) {
      rlo[q] = ((x.z0 + q) * (a.H + 1) + x.y0) / a.tl.f;
      rhi[q] = ((x.z0 + q) * (a.H + 1) + x.y0 + x.Y) / a.tl.f;
    }
    if (rlo[1] <= rhi[0] + 1) {
      nr = 1;
      rhi[0] = rhi[1];
    }
  }
  Runs runs;
  if (b.nx == 1 && b.ny == 1) {
    runs.count = 1;
    runs.len = nb;
  } else if (b.nx == 1) {
    runs.count = x.Z + 1;
    runs.len = YB * XB;
  } else {
    runs.count = (x.Z + 1) * YB;
    runs.len = XB;
  }
  auto run_start = [&](int q) {
    const int rz = b.nx == 1 && b.ny == 1 ? 0 : (b.nx == 1 ? q : q / YB);
    const int ry = b.nx == 1 ? 0 : q % YB;
    return (x.z0 + rz) * plane + (x.y0 + ry) * row + (b.nx == 1 ? 0 : x.x0);
  };
#pragma unroll
  for (int r = 0; r < 4; ++r) runs.lo[r] = run_start(r < runs.count ? r : 0);
  runs.span = unsigned(run_start(runs.count - 1) + runs.len - runs.lo[0]);
  // the corners through which each bucket feeds a row of the box
  for (int l = threadIdx.x; l < nb; l += kThreads) {
    const int t = l / XB, lx = l - t * XB, lz = t / YB, ly = t - lz * YB;
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int zl = lz - 1 + (k >> 2), yl = ly - 1 + ((k >> 1) & 1), xl = lx - 1 + (k & 1);
      if (zl >= 0 && zl < x.Z && yl >= 0 && yl < x.Y && xl >= 0 && xl < x.X) bits |= 1u << k;
    }
    mask[l] = static_cast<unsigned char>(bits);
  }
  // launched before the tile kernel ends (programmatic dependent launch):
  // wait here, after the set-up that needs none of its output, until the
  // tile kernel is done and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int ns = a.tl.tiles * nr;
  const int total = segments(a, rlo, rhi, nr, seg_at, seg_off, warp_sums);

  auto gather_pass = [&](int k0, int k1, bool first) {
    if (b.k == 4) {
      gather<BF16, 4>(a, x, c0, cw, b.cb, begin, wt, gs, k0, k1, first);
    } else if (b.k == 2) {
      gather<BF16, 2>(a, x, c0, cw, b.cb, begin, wt, gs, k0, k1, first);
    } else {
      gather<BF16, 1>(a, x, c0, cw, b.cb, begin, wt, gs, k0, k1, first);
    }
  };
  bool per_corner = b.per_corner != 0;
  int next = total;
  if (!per_corner) {
    // one pass: every sample of the box, every corner
    const int m = fill(a, seg_at, seg_off, ns, total, 0, b.cap, runs, [](int) { return true; },
                       idx, lbs, warp_sums, &cut, &next);
    if (next < total) {
      per_corner = true;   // more than fit: a corner at a time
    } else {
      place(m, nb, b.nwp, idx, lbs, tab, begin, sorted, warp_sums);
      stage<BF16>(m, sorted, a, c0, cw, b.cb, wt, gs);
      gather_pass(0, 7, true);
    }
  }
  if (per_corner) {
    for (int k = 0; k < 8; ++k) {
      // the items of the bucket rows whose buckets feed the box's rows
      // through corner k: one range of bins
      const int dz = k >> 2, dy = (k >> 1) & 1;
      const int klo[2] = {((x.z0 + 1 - dz) * (a.H + 1) + x.y0 + 1 - dy) / a.tl.f, 0};
      const int khi[2] = {((x.z0 + x.Z - dz) * (a.H + 1) + x.y0 + x.Y - dy) / a.tl.f, 0};
      __syncthreads();   // the last pass is done with the segments and staged samples
      const int ktotal = segments(a, klo, khi, 1, seg_at, seg_off, warp_sums);
      int from = 0;
      do {
        const int m = fill(a, seg_at, seg_off, a.tl.tiles, ktotal, from, b.cap, runs,
                           [&](int l) { return ((mask[l] >> k) & 1u) != 0; }, idx, lbs,
                           warp_sums, &cut, &next);
        if (BF16) {
          place_call(m, nb, b.nwp, idx, lbs, tab, begin, sorted, warp_sums);
          stage_call<BF16>(m, sorted, a, c0, cw, b.cb, wt, gs);
        } else {
          place(m, nb, b.nwp, idx, lbs, tab, begin, sorted, warp_sums);
          stage<BF16>(m, sorted, a, c0, cw, b.cb, wt, gs);
        }
        gather_pass(k, k, k == 0 && from == 0);
        from = next;
        __syncthreads();   // the pass is done with the staged samples
      } while (from < ktotal);
    }
  }
}

using Kernel = decltype(&grid_sample_bwd_kernel<false>);

Kernel kernel_of(bool bf16) {
  return bf16 ? grid_sample_bwd_kernel<true> : grid_sample_bwd_kernel<false>;
}

// The current card's SMs and the dynamic shared memory a block of the box
// kernel may take (its opt-in limit less its static shared memory), which
// both instantiations are allowed once a card.
cudaError_t card(int* sms, int* smem) {
  static lfgc::PerCard cache;
  return lfgc::per_card(cache, sms, smem, [](int* s, int* m) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(s, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    size_t used = 0;
    for (int bf16 = 0; bf16 < 2 && err == cudaSuccess; ++bf16) {
      cudaFuncAttributes fa;
      err = cudaFuncGetAttributes(&fa, kernel_of(bf16 != 0));
      if (err == cudaSuccess && fa.sharedSizeBytes > used) used = fa.sharedSizeBytes;
    }
    *m = optin - int(used);
    for (int bf16 = 0; bf16 < 2 && err == cudaSuccess; ++bf16) {
      err = lfgc::allow_smem(kernel_of(bf16 != 0), size_t(*m));
    }
    // the box kernel's split of L1 and shared memory for the tile kernel
    // too, so that the card need not change the split between the launches
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(grid_sample_bwd_tiles_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 int(cudaSharedmemCarveoutMaxShared));
    }
    if (err == cudaSuccess && *m < 1) err = cudaErrorInvalidValue;
    return err;
  });
}

// How a call launches.
struct Plan {
  Boxes b;
  int64_t blocks;
  int expected;   // samples a whole box holds, positions uniform over the buckets
  int smem;       // dynamic shared bytes a block
  double cycles;  // a block's estimated issue cycles (split)
};

// The split into boxes of zs x ys x xs rows and groups of at most cb
// channels, if the box kernel can take it: boxes below whole planes only in
// one plane, below whole lines only in one line (so a box's buckets are at
// most four runs of keys), at most kMaxLocalBuckets buckets a box, and
// shared memory for kMinCapacity samples.
bool split(int64_t n, int C, int D, int H, int W, bool bf16, int smem_max, int cb, int zs,
           int ys, int xs, Plan* p) {
  Boxes& b = p->b;
  b.groups = (C + cb - 1) / cb;
  b.cb = (C + b.groups - 1) / b.groups;
  b.zs = zs < D ? zs : D;
  b.ys = ys < H ? ys : H;
  b.xs = xs < W ? xs : W;
  b.nz = (D + b.zs - 1) / b.zs;
  b.ny = (H + b.ys - 1) / b.ys;
  b.nx = (W + b.xs - 1) / b.xs;
  if ((b.ny > 1 && b.zs > 1) || (b.nx > 1 && (b.zs > 1 || b.ys > 1))) return false;
  b.segs = 2 * tiling_of(n, D, H).tiles;
  const int64_t lb = int64_t(b.zs + 1) * (b.ys + 1) * (b.xs + 1);
  if (lb > kMaxLocalBuckets) return false;
  b.lb = int(lb);
  b.nwp = kTableInts / b.lb;
  b.nwp = b.nwp < 1 ? 1 : (b.nwp > kWarps ? kWarps : b.nwp);
  p->blocks = int64_t(b.nz) * b.ny * b.nx * b.groups;
  if (p->blocks > (int64_t(1) << 30)) return false;
  b.cap = 0;
  const int fixed = layout_of(b, bf16).total;
  const int per = 4 + weight_stride(bf16) * (bf16 ? 2 : 4) + 4 * scale_words(b.cb);
  b.cap = (smem_max - fixed) / per;
  while (b.cap > 0 && layout_of(b, bf16).total > smem_max) --b.cap;
  if (b.cap < kMinCapacity) return false;
  const double expected = double(n) * double(lb) / double(buckets_of(D, H, W));
  p->expected = int(expected < double(1 << 30) ? expected : double(1 << 30));
  // uniform positions fill a box of interior buckets up to ~1.15x the
  // grid's mean (edge buckets are narrower), plus 3 sigma of their spread
  b.per_corner = 1.15 * expected + 3.0 * sqrt(expected) + 64.0 > double(b.cap);
  p->smem = layout_of(b, bf16).total;
  // A block's cycles, roughly: the segments' set-up (a load each), the
  // filter of its items (whole bucket rows: ~2 a sample, every pass),
  // staging (~40 + 2 a channel a sample, over 128 lanes), and the gather's
  // units (a warp's rows), either issue-bound (all warps) or latency-bound
  // (a warp's units in turn).
  // the gather's channels a lane: the most of 4, 2, 1 that still give
  // every warp a unit (a warp's rows)
  const int64_t rows = int64_t(b.zs) * b.ys * b.xs;
  auto units_of = [&](int k) {
    const int per_warp = 32 / ((b.cb + k - 1) / k);
    return (rows + per_warp - 1) / per_warp;
  };
  b.k = 1;
  for (int k = 4; k > 1; k /= 2) {
    if (k <= b.cb && units_of(k) >= kWarps) {
      b.k = k;
      break;
    }
  }
  const double terms = 8.0 * double(n) / double(buckets_of(D, H, W));
  const int64_t units = units_of(b.k);
  const double issue = double(units) * (100.0 + terms * (2.0 + 2.0 * b.k)) / 4.0;
  const double latency = double((units + kWarps - 1) / kWarps) * (300.0 + 5.0 * terms);
  const double gather = issue > latency ? issue : latency;
  const double items = expected * double(W + 1) / double(b.xs + 1);
  p->cycles = 2.0 * tiling_of(n, D, H).tiles + (b.per_corner ? 9.0 : 1.0) * 2.0 * items +
              expected * (40.0 + 2.0 * b.cb) / 128.0 + gather;
  return true;
}

// Boxes and channel groups for n samples into a (D, H, W, C) gradient:
// among splits whose boxes' expected samples fit (one pass), the fewest
// estimated cycles; if none fits, the fewest among all (a corner at a
// time).  The candidates: for 32, 16, .. 1 channels a group and 1, 2, 4, 8
// waves of one block an SM, the smallest whole planes, y ranges and x
// ranges that give no more blocks than the waves hold; and, whatever the
// waves, the longest y range and the longest x range within
// kMaxLocalBuckets, so that every shape fits takes has a split (a large
// grid, whose y ranges for 8 waves read too many buckets).
cudaError_t plan_of(int64_t n, int C, int D, int H, int W, bool bf16, Plan* out) {
  int sms = 0, smem_max = 0, dev = 0;
  cudaError_t err = card(&sms, &smem_max);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // a training run asks for one shape a step: the thread's last plan a mode
  thread_local int64_t last_key[2][6] = {{-1}, {-1}};
  thread_local Plan last[2];
  const int64_t key[6] = {n, C, D, H, W, dev};
  bool same = true;
  for (int k = 0; k < 6; ++k) same = same && last_key[bf16][k] == key[k];
  if (same) {
    *out = last[bf16];
    return cudaSuccess;
  }
  // p before q: fewer cycles in all (waves of one block an SM times a
  // block's), then fewer channel groups
  auto before = [&](const Plan& p, const Plan& q) {
    const double tp = double((p.blocks + sms - 1) / sms) * p.cycles;
    const double tq = double((q.blocks + sms - 1) / sms) * q.cycles;
    if (tp != tq) return tp < tq;
    return p.b.groups < q.b.groups;
  };
  bool have_fit = false, have_any = false;
  Plan fit{}, any{};
  auto consider = [&](int cb, int zs, int ys, int xs) {
    Plan p;
    if (!split(n, C, D, H, W, bf16, smem_max, cb, zs, ys, xs, &p)) return;
    if (!p.b.per_corner && (!have_fit || before(p, fit))) {
      fit = p;
      have_fit = true;
    }
    if (!have_any || before(p, any)) {
      any = p;
      have_any = true;
    }
  };
  for (int cb = C < 32 ? C : 32;; cb = (cb + 1) / 2) {
    const int groups = (C + cb - 1) / cb;
    for (int waves = 1; waves <= 8; waves *= 2) {
      int64_t allowed = int64_t(waves) * sms / groups;
      if (allowed < 1) allowed = 1;
      consider(cb, int((D + allowed - 1) / allowed), H, W);
      if (allowed >= D) consider(cb, 1, int((H + allowed / D - 1) / (allowed / D)), W);
      const int64_t lines = int64_t(D) * H;
      if (allowed >= lines) consider(cb, 1, 1, int((W + allowed / lines - 1) / (allowed / lines)));
    }
    const int64_t ys_fit = kMaxLocalBuckets / (2 * (int64_t(W) + 1)) - 1;
    if (ys_fit >= 1) consider(cb, 1, int(ys_fit), W);
    consider(cb, 1, 1, kMaxLocalBuckets / 4 - 1);
    if (cb == 1) break;
  }
  if (!have_fit && !have_any) return cudaErrorInvalidValue;
  *out = have_fit ? fit : any;
  out->b.per_corner = !have_fit;
  last[bf16] = *out;
  for (int k = 0; k < 6; ++k) last_key[bf16][k] = key[k];
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
  if (!fits(n, C, D, H, W) || scratch_len < scratch_words(n, D, H) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  Plan p;
  cudaError_t err = plan_of(n, C, D, H, W, BF16, &p);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tiling tl = tiling_of(n, D, H);
  int2* items = static_cast<int2*>(scratch);
  int* starts = static_cast<int*>(scratch) + 2 * int64_t(tl.tiles) * tl.T;
  grid_sample_bwd_tiles_kernel<<<tl.tiles, kTileThreads, size_t(4) * (tl.nb + 1), s>>>(
      static_cast<const float*>(coords), items, starts, int(n), tl, D, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Args args{static_cast<const float*>(g), static_cast<const float*>(coords),
                  static_cast<float*>(dgrid), items, starts, tl, int(n), C, D, H, W};
  // the box kernel, allowed to start before the tile kernel ends
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(p.blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(p.smem);
  cfg.stream = s;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel_of(BF16), args, p.b);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes, one a mode ('f32', 'bf16').  Pointers are
// device pointers: g (n, C) and coords (n, 3) float32, dgrid (D*H*W, C)
// float32 (every entry written: no zeroing needed), scratch `scratch_words`
// ints (at least scratch_words(n, D, H) above; the wrapper's
// bwd_scratch_words),
// 16-byte aligned.  Returns the first CUDA error of the plan or the two
// launches.
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
// current card, in a mode (bf16 0 or 1): out = [threads a block, blocks,
// rows of a box along z, y, x, channel groups, channels a group, buckets a
// box, samples staged at once, samples a box expects, corner at a time (0
// or 1), rows a warp, lanes a row, channels a lane, warps that sort,
// dynamic shared bytes, buckets of the grid].
extern "C" int lfgc_grid_sample_bwd_plan(int64_t n, int C, int D, int H, int W, int bf16,
                                         int* out) {
  if (!fits(n, C, D, H, W)) return int(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan_of(n, C, D, H, W, bf16 != 0, &p);
  if (err != cudaSuccess) return int(err);
  const Boxes& b = p.b;
  const int lanes = (b.cb + b.k - 1) / b.k;
  const int rep[17] = {kThreads, int(p.blocks), b.zs, b.ys, b.xs, b.groups, b.cb, b.lb,
                       b.cap, p.expected, b.per_corner, 32 / lanes, lanes, b.k, b.nwp,
                       p.smem, int(buckets_of(D, H, W))};
  for (int k = 0; k < 17; ++k) out[k] = rep[k];
  return int(cudaSuccess);
}

extern "C" const char* lfgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
