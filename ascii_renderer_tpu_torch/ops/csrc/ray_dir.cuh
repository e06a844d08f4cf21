// The primary ray direction's arithmetic, shared by the ray grids of
// ray_grid.cu and by the ray tracer's frame (rt_trace.cu), which computes
// its primary rays itself in its grid form: one header, one rounding.
// Also the path tracer's jitter draw (unit), which X7 (pt_rays_kernel)
// takes for each sample ray, and a view's camera basis from its trig
// (view_basis), which the ray tracer's grid form forms on the card for a
// batch of views.
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

// A view's camera basis from its trig (core/camera.bases_from_trig, the
// chain of the reference's camera_basis): t = origin (3), cos and sin of
// the pitch, cos and sin of the yaw, tan(fov_y / 2); b = origin, uu, vv,
// focal * ww. The norms and crosses fuse as the host's fma32_np does (a
// cross's component k: fma(a[k+1], b[k+2], -(a[k+2] b[k+1]))); the clamps
// keep a NaN, as np.maximum does; focal * ww is a plain product.
__device__ __forceinline__ float norm3(const float* a) {
  return sqrtf(fmaf(a[2], a[2], fmaf(a[1], a[1], a[0] * a[0])));
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int k1 = (k + 1) % 3, k2 = (k + 2) % 3;
    o[k] = fmaf(a[k1], b[k2], -(a[k2] * b[k1]));
  }
}

__device__ __forceinline__ float max_keep_nan(float v, float lo) {
  return isnan(v) ? v : (v < lo ? lo : v);
}

__device__ __forceinline__ void view_basis(const float* t, float* b) {
  const float cp = t[3], sp = t[4], cy = t[5], sy = t[6];
  float ww[3] = {cp * cy, sp, cp * sy};
  const float nw = norm3(ww);
#pragma unroll
  for (int k = 0; k < 3; ++k) ww[k] = ww[k] / nw;
  const float up[3] = {0.0f, 1.0f, 0.0f};
  float uu[3], vv[3];
  cross3(ww, up, uu);
  const float nu = norm3(uu);
  if (nu < 1e-3f) {
    uu[0] = 1.0f;
    uu[1] = uu[2] = 0.0f;
  } else {
    const float d = max_keep_nan(nu, 1e-20f);
#pragma unroll
    for (int k = 0; k < 3; ++k) uu[k] = uu[k] / d;
  }
  cross3(uu, ww, vv);
  const float nv = norm3(vv);
  const float focal = 1.0f / max_keep_nan(t[7], 1e-6f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b[k] = t[k];
    b[3 + k] = uu[k];
    b[6 + k] = vv[k] / nv;
    b[9 + k] = focal * ww[k];
  }
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
