// The path tracer's primary ray directions: per ray i,
//   d = px[i] * uu + py[i] * vv + fw        (each product and add rounded)
//   out[i] = d / sqrtf(fma(d.z, d.z, fma(d.y, d.y, d.x * d.x)))
// as the reference's eager ray grid rounds it: the components one IEEE
// float32 operation at a time in its order, the norm's sum of squares
// fused as jnp.linalg.norm's jitted reduction fuses it
// (core/camera.ray_dirs is the plain version; core/fp.py the rules).
//
// Stands for XLA code, not a Pallas kernel: the ray grid of
// ascii_renderer_tpu/backends/pathtrace.py (primary_ray_grid, render_pt's
// centre rays and batch_rays). On CUDA tensors the plain version is a
// dozen torch and core/fp.fma32 launches over every ray; this kernel does
// the whole grid in one launch with fmaf.
//
// The same source holds the ray tracer's grid (ray_grid_jit_kernel, the
// template flag kJit of direction()): the reference renders the ray tracer
// under jax.jit, whose grid fuses the cell centres and px*uu + py*vv;
// one launch covers every view of a batch (the 1,024-view farm).
//
// What bounds it on the H100: memory, 8 bytes in and 12 out a ray (the
// jitted grid: 12 out). Built with -fmad=false, so only the explicit fmaf
// calls fuse; sqrtf and the division are IEEE (nvcc's -prec-sqrt /
// -prec-div defaults).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Basis {
  float u[3], v[3], fw[3];  // uu, vv and focal * ww
};

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

__global__ void __launch_bounds__(kThreads)
ray_grid_kernel(const float* __restrict__ px, const float* __restrict__ py,
                float* __restrict__ out, int n, Basis b) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  direction<false>(px[i], py[i], b.u, b.v, b.fw, out + 3 * i);
}

// The ray tracer's grid, as the reference's jitted program rounds it, for
// V views in one launch (blockIdx.y is the view): the cell centre
//   px = fma(col + 0.5, 2 / cols, -1) * aspect,
//   py = fma(rows - 1 - row + 0.5, 2 / rows, -1)
// (XLA turns the division by the grid size into a product, which fuses),
// then d = fma(px, uu, py * vv) + fw (the left product fuses; fw = focal *
// ww, the same for every ray, is formed apart) and d / |d| with the fused
// norm. bases: V x (uu, vv, fw), 9 floats a view. The launch covers the
// row band [row_lo, row_lo + band) of the rows x cols grid: row is the
// global row, so a band equals those rows of the full grid bit for bit.
__global__ void __launch_bounds__(kThreads)
ray_grid_jit_kernel(const float* __restrict__ bases, float* __restrict__ out,
                    int rows, int cols, int row_lo, int band, float sx,
                    float sy, float aspect) {
  const int n = band * cols;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int view = blockIdx.y;
  const float* b = bases + 9 * view;
  const int r = i / cols, col = i - r * cols;
  const float x = fmaf((float)col + 0.5f, sx, -1.0f) * aspect;
  const float y = fmaf((float)(rows - 1 - (row_lo + r)) + 0.5f, sy, -1.0f);
  direction<true>(x, y, b, b + 3, b + 6, out + ((size_t)view * n + i) * 3);
}

}  // namespace

// bases: device floats [views, 9] (uu, vv, focal * ww a view); out: device
// floats [views, band, cols, 3], rows [row_lo, row_lo + band) of the
// rows x cols grid; sx = 2 / cols, sy = 2 / rows (float32)
extern "C" int ray_grid_jit_launch(const float* bases, float* out, int rows,
                                   int cols, int row_lo, int band, int views,
                                   float sx, float sy, float aspect,
                                   void* stream) {
  if (rows < 0 || cols < 0 || views < 0 || views > 65535 || row_lo < 0 ||
      band < 0 || row_lo + band > rows)
    return (int)cudaErrorInvalidValue;
  const int n = band * cols;
  if (n == 0 || views == 0) return 0;
  dim3 grid((n + kThreads - 1) / kThreads, views);
  ray_grid_jit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      bases, out, rows, cols, row_lo, band, sx, sy, aspect);
  return (int)cudaGetLastError();
}

// basis9: uu, vv, focal * ww (host floats)
extern "C" int ray_grid_launch(const float* px, const float* py, float* out,
                               int n, const float* basis9, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Basis b;
  for (int k = 0; k < 3; ++k) {
    b.u[k] = basis9[k];
    b.v[k] = basis9[3 + k];
    b.fw[k] = basis9[6 + k];
  }
  ray_grid_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    (cudaStream_t)stream>>>(px, py, out, n, b);
  return (int)cudaGetLastError();
}
