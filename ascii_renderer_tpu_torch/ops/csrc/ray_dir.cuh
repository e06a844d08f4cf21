// The primary ray direction's arithmetic, shared by the ray grids of
// ray_grid.cu and by the ray tracer's frame (rt_trace.cu), which computes
// its primary rays itself in its grid form: one header, one rounding.
// Also the path tracer's jitter draw (unit), which X7 (pt_rays_kernel)
// takes for each sample ray.
// Built with -fmad=false, so only the explicit fmaf calls fuse; sqrtf and
// the division are IEEE (nvcc's -prec-sqrt / -prec-div defaults).
#pragma once

#include <stdint.h>

namespace ray_dir {

// normalize(x * u + y * v + fw) into o[0..2]. kJit: the reference's jitted
// rounding, fma(x, u, y * v) + fw (the left product fused, fw added
// apart); else its eager one, every product and add rounded alone. The
// norm's sum of squares is fused either way.
template <bool kJit>
__device__ __forceinline__ void direction(float x, float y, const float* u,
                                          const float* v, const float* fw,
                                          float* __restrict__ o) {
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    d[k] = kJit ? fmaf(x, u[k], y * v[k]) + fw[k] : x * u[k] + y * v[k] + fw[k];
  const float len = sqrtf(fmaf(d[2], d[2], fmaf(d[1], d[1], d[0] * d[0])));
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = d[k] / len;
}

// The jitted grid's cell centre of global row `row`, column `col` of a
// rows-row grid, as the reference's jitted program rounds it (XLA turns
// the division by the grid size into a product, which fuses):
//   px = fma(col + 0.5, 2 / cols, -1) * aspect,
//   py = fma(rows - 1 - row + 0.5, 2 / rows, -1)
// sx = 2 / cols, sy = 2 / rows and aspect are the host's float32 values.
__device__ __forceinline__ void jit_centre(int rows, int row, int col,
                                           float sx, float sy, float aspect,
                                           float& x, float& y) {
  x = fmaf((float)col + 0.5f, sx, -1.0f) * aspect;
  y = fmaf((float)(rows - 1 - row) + 0.5f, sy, -1.0f);
}

// lowbias32 of x (x = uid ^ key), its top 23 bits as a float in [1, 2),
// minus 1: ops/pt_kernel.hash_unit, the path tracer's jitter draw.
__device__ __forceinline__ float unit(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return __uint_as_float((x >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace ray_dir
