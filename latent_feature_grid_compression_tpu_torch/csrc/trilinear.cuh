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

#pragma once

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

// Calls f(row, w) for each in-range corner of `c`, in the order z, y, x
// (upper corner last on each axis): `row` is the corner's flat row
// (z * H + y) * W + x and w = (wx * wy) * wz its weight.
template <class F>
__device__ __forceinline__ void for_each_corner(const Cell& c, int D, int H, int W,
                                                F&& f) {
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const int z = c.z0 + dz;
    if (z < 0 || z >= D) continue;
    const float wz = dz ? c.fz : __fadd_rn(1.0f, -c.fz);
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
        f((int64_t(z) * H + y) * W + x, __fmul_rn(__fmul_rn(wx, wy), wz));
      }
    }
  }
}

}  // namespace lfgc
