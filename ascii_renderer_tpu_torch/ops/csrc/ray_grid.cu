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
// centre rays and batch_rays). On CUDA tensors the plain version's fused
// sums are float64 emulations (core/fp.fma32, ~27 launches each over every
// ray); this kernel does the whole grid in one launch with fmaf.
//
// What bounds it on the H100: memory, 8 bytes in and 12 out a ray. Built
// with -fmad=false, so only the two explicit fmaf calls fuse; sqrtf and
// the division are IEEE (nvcc's -prec-sqrt / -prec-div defaults).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Basis {
  float u[3], v[3], fw[3];  // uu, vv and focal * ww
};

__global__ void __launch_bounds__(kThreads)
ray_grid_kernel(const float* __restrict__ px, const float* __restrict__ py,
                float* __restrict__ out, int n, Basis b) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = px[i], y = py[i];
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = x * b.u[k] + y * b.v[k] + b.fw[k];
  const float len = sqrtf(fmaf(d[2], d[2], fmaf(d[1], d[1], d[0] * d[0])));
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 * i + k] = d[k] / len;
}

}  // namespace

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
