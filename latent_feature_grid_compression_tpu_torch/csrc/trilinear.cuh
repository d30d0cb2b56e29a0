// The trilinear fetch's pixel map and corner weights, shared by the fetch
// kernel (grid_sample_fwd.cu), its gradient (grid_sample_bwd.cu) and the
// one-kernel model forward (fused_forward.cu), so that all three compute the
// same features and route gradients through the same weights.
//
// torch grid_sample semantics (align_corners=False, zero padding):
// pix = ((coord + 1) * size - 1) / 2, coords[0] -> W, [1] -> H, [2] -> D,
// floor (not truncation) for the lower corner, out-of-range corners skipped.
// The grid is channel-minor (D, H, W, C): a corner is one row of C floats.
//
// __fmul_rn/__fadd_rn keep the map from being contracted into an FMA, so it
// rounds exactly as the plain PyTorch version (ops/interpolation.py) does.
//
// Two modes, as the TPU kernels' `precision` (ops/pallas_kernels.py `_dot`):
// 'f32' weighs each corner by w = (wx * wy) * wz in float32; 'bf16' rounds
// where the TPU kernel's single bf16 MXU passes round.  There the xy weight
// wxy = wx * wy and the grid enter the products as bf16, the 4 corners of a
// z plane are summed in float32, that sum times wz is rounded to bf16, and
// the planes are added in float32:
//
//   out[n, c] = sum_z bf16(wz * sum_xy bf16(wxy) * bf16(G[z, y, x, c]))
//   dG[z, y, x, c] += bf16(wxy) * bf16(wz * bf16(g[n, c]))
//
// A product of two bf16 values is exact in float32, so the kernels' fmaf
// rounds as the plain version's product-then-add.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lfgc {

struct Cell {
  int x0, y0, z0;     // lower corner
  float fx, fy, fz;   // fractions towards the upper corner
};

__device__ __forceinline__ float pixel(float c, int size) {
  return __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(c, 1.0f), float(size)), -1.0f), 0.5f);
}

// The cell of the point (cx, cy, cz) in a (D, H, W) grid.
__device__ __forceinline__ Cell cell_of(float cx, float cy, float cz, int D, int H,
                                        int W) {
  const float px = pixel(cx, W), py = pixel(cy, H), pz = pixel(cz, D);
  const float lx = floorf(px), ly = floorf(py), lz = floorf(pz);
  Cell c;
  c.fx = __fadd_rn(px, -lx);
  c.fy = __fadd_rn(py, -ly);
  c.fz = __fadd_rn(pz, -lz);
  c.x0 = int(lx);
  c.y0 = int(ly);
  c.z0 = int(lz);
  return c;
}

// x rounded to bf16 (to nearest even) and back.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Each of v[0..K) rounded as bf16_round rounds it, two at a time: one packed
// conversion (cvt.rn.bf16x2.f32) a pair, half the conversions of K
// bf16_round calls (a fetch rounds 8 * C grid values a sample).
template <int K>
__device__ __forceinline__ void bf16_round_all(float* v) {
#pragma unroll
  for (int k = 0; k + 1 < K; k += 2) {
    const float2 r = __bfloat1622float2(__floats2bfloat162_rn(v[k], v[k + 1]));
    v[k] = r.x;
    v[k + 1] = r.y;
  }
  if (K % 2) v[K - 1] = bf16_round(v[K - 1]);
}

// Visits the in-range corners of `c` plane by plane, lower z first: for each
// in-range plane, plane(wz, xy), where xy(f) calls f(row, wxy) for the
// plane's in-range corners in the order y, x (upper corner last on each
// axis); `row` is the corner's flat row (z * H + y) * W + x and wxy = wx * wy.
template <class P>
__device__ __forceinline__ void for_each_plane(const Cell& c, int D, int H, int W,
                                               P&& plane) {
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const int z = c.z0 + dz;
    if (z < 0 || z >= D) continue;
    const float wz = dz ? c.fz : __fadd_rn(1.0f, -c.fz);
    plane(wz, [&](auto&& f) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int y = c.y0 + dy;
        if (y < 0 || y >= H) continue;
        const float wy = dy ? c.fy : __fadd_rn(1.0f, -c.fy);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int x = c.x0 + dx;
          if (x < 0 || x >= W) continue;
          const float wx = dx ? c.fx : __fadd_rn(1.0f, -c.fx);
          f((int64_t(z) * H + y) * W + x, __fmul_rn(wx, wy));
        }
      }
    });
  }
}

// Calls f(row, wxy, wz) for each in-range corner of `c`, in the order z, y, x.
template <class F>
__device__ __forceinline__ void for_each_corner_split(const Cell& c, int D, int H, int W,
                                                      F&& f) {
  for_each_plane(c, D, H, W, [&](float wz, auto&& xy) {
    xy([&](int64_t row, float wxy) { f(row, wxy, wz); });
  });
}

// Calls f(row, w) for each in-range corner of `c`, in the order z, y, x,
// with w = (wx * wy) * wz its float32 weight.
template <class F>
__device__ __forceinline__ void for_each_corner(const Cell& c, int D, int H, int W,
                                                F&& f) {
  for_each_corner_split(c, D, H, W,
                        [&](int64_t row, float wxy, float wz) { f(row, __fmul_rn(wxy, wz)); });
}

// K channels of the sample in cell `c`, added into acc (zeros on entry):
// load(row, v) puts the K channels of a corner's row into v (zeros past C).
// 'f32': the fmaf chain over the corners in for_each_corner's order; 'bf16':
// as the TPU kernel rounds (see the top of this file).
template <bool BF16, int K, class Load>
__device__ __forceinline__ void fetch_channels(const Cell& c, int D, int H, int W,
                                               Load&& load, float (&acc)[K]) {
  if (!BF16) {
    for_each_corner(c, D, H, W, [&](int64_t row, float w) {
      float v[K];
      load(row, v);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = fmaf(w, v[k], acc[k]);
    });
    return;
  }
  for_each_plane(c, D, H, W, [&](float wz, auto&& xy) {
    float s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = 0.0f;
    xy([&](int64_t row, float wxy) {
      const float w = bf16_round(wxy);
      float v[K];
      load(row, v);
      bf16_round_all<K>(v);
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] = fmaf(w, v[k], s[k]);
    });
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = __fmul_rn(wz, s[k]);
    bf16_round_all<K>(s);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = __fadd_rn(acc[k], s[k]);
  });
}

// The term a corner of weights (wxy, wz) adds to the grid's gradient for the
// output gradient x: 'f32' ((wxy * wz) * x) or 'bf16' (see the top).
template <bool BF16>
__device__ __forceinline__ float grad_term(float wxy, float wz, float x) {
  return BF16 ? __fmul_rn(bf16_round(wxy), bf16_round(__fmul_rn(wz, bf16_round(x))))
              : __fmul_rn(__fmul_rn(wxy, wz), x);
}

}  // namespace lfgc
