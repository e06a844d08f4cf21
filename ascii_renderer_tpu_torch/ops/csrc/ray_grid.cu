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
// one launch covers every view of a batch (the 1,024-view farm). No
// render path launches it: the ray tracer's frame (rt_trace.cu) computes
// the same rays itself in its grid form. It stays as the source of device
// rays for that kernel's rd3 form in the tools and tests.
//
// The render paths' form is X7, pt_rays_kernel: the path tracer's rays of
// one sample batch (and of the probe) in one launch, each ray's cell
// centre and jitter computed from its pixel's uid in the kernel, written
// straight into the megakernel's padded ray block (below).
//
// What bounds it on the H100: memory, 8 bytes in and 12 out a ray (the
// jitted grid: 12 out; X7: 12 out a ray, 4 or 8 in a pixel). Built with -fmad=false, so only the explicit fmaf
// calls fuse; sqrtf and the division are IEEE (nvcc's -prec-sqrt /
// -prec-div defaults). The arithmetic is ray_dir.cuh's, which the ray
// tracer's frame (rt_trace.cu) shares.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_dir.cuh"

namespace {

constexpr int kThreads = 256;

struct Basis {
  float u[3], v[3], fw[3];  // uu, vv and focal * ww
};

using ray_dir::direction;

__global__ void __launch_bounds__(kThreads)
ray_grid_kernel(const float* __restrict__ px, const float* __restrict__ py,
                float* __restrict__ out, int n, Basis b) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  direction<false>(px[i], py[i], b.u, b.v, b.fw, out + 3 * i);
}

// X7: the rays of one path-tracer sample batch, or of the probe (kJitter
// false), in B5's padded ray block. Stands for the reference's batch_rays
// (ascii_renderer_tpu/backends/pathtrace.py:579-602) with its centre rays
// (:394-415, and :537-544 under compaction); the plain version is the
// torch chain of ops/ray_grid.pt_rays_ref. Ray s * pc + p is sample s
// (s < samples, the batch's sample slot) of stream slot p < pc. A thread
// is one slot p and a run of `per` samples (blockIdx.y * per on): it
// forms its pixel's part of the ray once, then each sample's own part:
//   uid      pix_uid[p], or uid0 + p (uid0 = row_lo * cols) uncompacted;
//            row = uid / cols, col = uid % cols (the global cell);
//   centre   x = (col + 0.5) / cols, px = (-1 + 2 x) * aspect,
//            y = (rows - 1 - row + 0.5) / rows, py = -1 + 2 y
//            (core/camera.ndc_grid's operations in its order, IEEE
//            division, nothing fused);
//   fetched  fet0[p] > 0.5 (NaN counts as not fetched);
// and for each sample s:
//   jitter   samples s0 + s > 0 of a pixel whose probe fetched no texel:
//            u = lowbias32 of (s * rows * cols + uid) ^ key, key_x / key_y
//            the host's (seed * 0x9E3779B1 + ctr * 0x85EBCA6B) for the
//            counters 0x40000001 / 0x40000002 (ops/pt_kernel.hash_unit),
//            then jx = ((2 (u - 0.5)) / rows) * aspect, jy = (2 (u - 0.5))
//            / rows, else 0; x = px + jx and y = py + jy always added, as
//            the plain chain adds its zeros;
//   ray      direction<false>(x, y), the eager grid's rounding.
// Rays n_rays .. n_out - 1 are the block's padding: 0, as
// pt_kernel.blockify pads.
// Its bound is bytes: 12 out a ray, 4 (8 with compaction) in a pixel. A
// thread a ray repeated the pixel's divisions and load for every sample
// and ran at 42% of that bound at the HD batch. `per` is the host's: every
// sample of a slot in one thread where the launch has slots enough to
// fill the card, one where it has not (the small batches: the pixel's
// work then repeats, as the launch floor hides). kStaged: a block's rays
// of a sample go through shared memory and out as consecutive floats,
// where a launch of more than one sample a thread takes it (at the HD
// batch, 8 samples a thread, three stride-3 stores a thread took 0.0498
// ms and the staged block 0.0287; at one sample a thread the direct
// stores were the faster, 0.0048 ms against 0.0054 at the HD probe; an
// NVIDIA H100 80GB HBM3 at 700 W). A fill of the HD
// batch's 49.8 MB takes 0.0163 ms: the rest is the per-ray arithmetic
// (the jitter's two IEEE divisions, the direction's root and three
// divisions), which no store form moves.
template <bool kJitter, bool kStaged>
__global__ void __launch_bounds__(kThreads)
pt_rays_kernel(const int* __restrict__ pix_uid, const float* __restrict__ fet0,
               float* __restrict__ out, int pc, int samples, int per,
               int n_out, int rows, int cols, int uid0, float aspect, int s0,
               uint32_t key_x, uint32_t key_y, Basis b) {
  __shared__ float st[kStaged ? 3 * kThreads : 1];
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + threadIdx.x;
  const bool live = p < pc;
  const int n_rays = pc * samples;
  if (blockIdx.y == 0 && p < pc) {  // the padding, over the first row
    for (long long q = n_rays + (long long)p; q < n_out; q += pc) {
      float* o = out + 3 * q;
      o[0] = o[1] = o[2] = 0.0f;
    }
  }
  if (!kStaged && !live) return;
  int uid = 0;
  float px = 0.0f, py = 0.0f;
  bool jitter = false;
  if (live) {
    uid = pix_uid != nullptr ? pix_uid[p] : uid0 + p;
    const int row = uid / cols, col = uid - row * cols;
    const float x = ((float)col + 0.5f) / (float)cols;
    px = (-1.0f + 2.0f * x) * aspect;
    const float y = ((float)(rows - 1 - row) + 0.5f) / (float)rows;
    py = -1.0f + 2.0f * y;
    jitter = kJitter && !(fet0[p] > 0.5f);
  }
  const int s_lo = blockIdx.y * per;
  const int s_hi = min(s_lo + per, samples);
  const int cnt = 3 * min(kThreads, pc - p0);  // the block's floats a sample
  for (int s = s_lo; s < s_hi; ++s) {
    if (live) {
      float x = px, y = py;
      if (kJitter) {
        float jx = 0.0f, jy = 0.0f;
        if (jitter && s0 + s > 0) {
          const uint32_t us = (uint32_t)s * (uint32_t)(rows * cols) +
                              (uint32_t)uid;
          jx = ((2.0f * (ray_dir::unit(us ^ key_x) - 0.5f)) / (float)rows) *
               aspect;
          jy = (2.0f * (ray_dir::unit(us ^ key_y) - 0.5f)) / (float)rows;
        }
        x = x + jx;
        y = y + jy;
      }
      direction<false>(x, y, b.u, b.v, b.fw,
                       kStaged ? st + 3 * threadIdx.x
                               : out + 3 * ((size_t)s * pc + p));
    }
    if (!kStaged) continue;
    __syncthreads();
    float* o = out + 3 * ((size_t)s * pc + p0);
    for (int j = threadIdx.x; j < cnt; j += kThreads) o[j] = st[j];
    __syncthreads();
  }
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
  float x, y;
  ray_dir::jit_centre(rows, row_lo + r, col, sx, sy, aspect, x, y);
  direction<true>(x, y, b, b + 3, b + 6, out + ((size_t)view * n + i) * 3);
}

template <bool kJitter>
void launch_pt_rays(const int* pix_uid, const float* fet0, float* out,
                    int pc, int samples, int per, int n_out, int rows,
                    int cols, int uid0, float aspect, int s0, unsigned key_x,
                    unsigned key_y, Basis b, cudaStream_t stream) {
  const dim3 grid((pc + kThreads - 1) / kThreads, (samples + per - 1) / per);
  if (per == 1)
    pt_rays_kernel<kJitter, false><<<grid, kThreads, 0, stream>>>(
        pix_uid, fet0, out, pc, samples, per, n_out, rows, cols, uid0,
        aspect, s0, key_x, key_y, b);
  else
    pt_rays_kernel<kJitter, true><<<grid, kThreads, 0, stream>>>(
        pix_uid, fet0, out, pc, samples, per, n_out, rows, cols, uid0,
        aspect, s0, key_x, key_y, b);
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

// X7 (pt_rays_kernel): samples x pc rays into out (device floats
// [n_out, 3], n_out >= samples * pc, the padded block), jittered where
// jitter != 0 (then fet0 is the probe's fetch output, pc floats); pix_uid
// (pc ints) or null for uid0 + p; a thread takes `per` samples of a slot
// (1 <= per <= samples); basis9: uu, vv, focal * ww (host)
extern "C" int pt_rays_launch(const int* pix_uid, const float* fet0,
                              float* out, int pc, int samples, int per,
                              int n_out, int rows, int cols, int uid0,
                              float aspect, int s0, unsigned key_x,
                              unsigned key_y, int jitter,
                              const float* basis9, void* stream) {
  if (pc <= 0 || samples <= 0 || per < 1 || per > samples || rows <= 0 ||
      cols <= 0 || n_out < 0 || (long long)pc * samples > n_out ||
      (samples + per - 1) / per > 65535 || (jitter && fet0 == nullptr))
    return (int)cudaErrorInvalidValue;
  Basis b;
  for (int k = 0; k < 3; ++k) {
    b.u[k] = basis9[k];
    b.v[k] = basis9[3 + k];
    b.fw[k] = basis9[6 + k];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (jitter)
    launch_pt_rays<true>(pix_uid, fet0, out, pc, samples, per, n_out, rows,
                         cols, uid0, aspect, s0, key_x, key_y, b, s);
  else
    launch_pt_rays<false>(pix_uid, fet0, out, pc, samples, per, n_out, rows,
                          cols, uid0, aspect, s0, key_x, key_y, b, s);
  return (int)cudaGetLastError();
}
