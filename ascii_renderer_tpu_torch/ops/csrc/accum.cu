// K1b: the progressive tracer's statistics step, one launch a batch.
//
// Stands for XLA code, not a Pallas kernel: the reference jits its
// accumulate (ascii_renderer_tpu/sim/accum.py:110, with active_mask :90)
// into the progressive step's one program. The plain version is
// ops/accum.py's accumulate_ref, the torch chain the port ran before (about
// 45 launches a batch, four of them fma32); kernel and plain version agree
// bit for bit (NaN payloads aside).
//
// A thread a pixel, its block's [n, 3] planes (mean, m2, the sample in;
// the new mean, m2 and the display out) staged in shared memory so that
// every global access is coalesced (a thread's 3 floats straight from
// global memory took 0.040 ms at 518,400 pixels, 39% of the bound, on an
// NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py). It reads the old state
// (count, mean, m2, mean_y, m2_y, alpha), or a zero state where `reset`
// is set (a camera move: no fill launch, the old state stays as it was),
// and the batch's sample rgb and alpha byte; it writes the new state into
// new buffers, the display rgb, the pre-update active mask, the next
// batch's skip mask (active_mask of the new state) and, by a warp vote,
// the batch's any-active flag, whose other ping-pong slot block 0 clears
// for the next batch.
//
// Rounding is the chain's, site by site (built with -fmad=false, so only
// the explicit fmaf fuse; division and sqrtf are IEEE):
//   perceptual y = fmaf(b, 0.11f, fmaf(r, 0.3f, g * 0.59f));
//   luminance = (x + y + z) * float32(1/3), XLA's product for the mean;
//   mean' = mean + delta / k1, m2' = fmaf(delta, s - mean', m2);
//   ci = 1.96f * sqrtf(clamp(var, 0) / k), tol the float32 max_tolerance;
//   torch.clamp's NaN rule: a NaN stays NaN.
// The statistics mode is a template flag, not a runtime branch.
//
// Bytes-bound: 50 bytes read a pixel (the state's 45 floats' bytes, the
// sample's 12, the alpha bytes) and 51 written (the state, the display,
// two masks), 101 in all; ~60 float operations a pixel are far below the
// FP32 rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  // the old state (ignored where reset) and the batch's samples
  const float* count;
  const float* mean;  // [n, 3]
  const float* m2;    // [n, 3]
  const float* mean_y;
  const float* m2_y;
  const uint8_t* alpha;
  const float* sample;         // [n, 3]
  const uint8_t* sample_alpha;  // null: the alpha plane stays
  // the new state and the batch's outputs
  float* o_count;
  float* o_mean;
  float* o_m2;
  float* o_mean_y;
  float* o_m2_y;
  uint8_t* o_alpha;
  float* display;  // [n, 3]
  uint8_t* act;    // the pre-update active mask
  uint8_t* skip;   // active_mask of the new state
  int* any_set;    // set to 1 where a pixel was active; may be null
  int* any_clear;  // zeroed by block 0 for the next batch; may be null
  unsigned n;
  int reset;
  float tol;          // max_tolerance as float32
  float max_samples;  // max_samples as float32
};

// torch.clamp(v, min=lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : (v < lo ? lo : v);
}

// luminance: the channels' sum times float32(1/3)
__device__ __forceinline__ float lum(float a, float b, float c) {
  return (a + b + c) * (1.0f / 3.0f);
}

// active_mask of one pixel's statistics (sim/accum.active_mask)
template <bool kPerceptual>
__device__ __forceinline__ bool active(const Args& a, float count,
                                       const float* mean, const float* m2,
                                       float mean_y, float m2_y) {
  const float k = clamp_min(count, 1.0f);
  const float km1 = clamp_min(k - 1.0f, 1.0f);
  float ci, ref;
  if (kPerceptual) {
    ci = 1.96f * sqrtf(clamp_min(m2_y / km1, 0.0f) / k);
    ref = clamp_min(mean_y, 1e-8f);
  } else {
    const float var = lum(m2[0] / km1, m2[1] / km1, m2[2] / km1);
    ci = 1.96f * sqrtf(clamp_min(var, 0.0f) / k);
    ref = clamp_min(lum(fabsf(mean[0]), fabsf(mean[1]), fabsf(mean[2])),
                    1e-3f);
  }
  const bool unconverged = ci > a.tol * ref;
  const bool warmup = count < 2.0f;
  return (warmup || unconverged) && count < a.max_samples;
}

// A block's span of a [n, 3] plane (its pixels' 3 nb floats from f0)
// copied between global and shared memory a float a thread, kThreads
// apart, so that both sides are coalesced (a thread's own 3 floats, 12
// bytes apart across the warp, are read and written in shared memory,
// stride 3: no bank conflict).
__device__ __forceinline__ void span_in(float* sm, const float* g,
                                        size_t f0, unsigned nf) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const unsigned e = threadIdx.x + r * kThreads;
    if (e < nf) sm[e] = g[f0 + e];
  }
}

__device__ __forceinline__ void span_out(float* g, const float* sm,
                                         size_t f0, unsigned nf) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const unsigned e = threadIdx.x + r * kThreads;
    if (e < nf) g[f0 + e] = sm[e];
  }
}

template <bool kPerceptual>
__global__ void __launch_bounds__(kThreads) accum_kernel(const Args a) {
  // the block's mean, m2 and sample spans, then its new mean, m2 and
  // display
  __shared__ float sm[3][3 * kThreads];
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  const unsigned base = blockIdx.x * kThreads;
  const unsigned nf = 3 * min((unsigned)kThreads, a.n - base);  // its floats
  const size_t f0 = 3 * (size_t)base;
  span_in(sm[2], a.sample, f0, nf);
  if (!a.reset) {
    span_in(sm[0], a.mean, f0, nf);
    span_in(sm[1], a.m2, f0, nf);
  }
  __syncthreads();
  const unsigned t3 = 3 * threadIdx.x;
  bool act = false;
  float mean[3], m2[3], s[3];
  bool seen = false;
  if (i < a.n) {
    float count = 0.0f, mean_y = 0.0f, m2_y = 0.0f;
    uint8_t alpha = 255;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mean[c] = a.reset ? 0.0f : sm[0][t3 + c];
      m2[c] = a.reset ? 0.0f : sm[1][t3 + c];
      s[c] = sm[2][t3 + c];
    }
    if (!a.reset) {
      count = a.count[i];
      mean_y = a.mean_y[i];
      m2_y = a.m2_y[i];
      alpha = a.alpha[i];
    }
    act = active<kPerceptual>(a, count, mean, m2, mean_y, m2_y);
    const float k1 = count + 1.0f;
    float mean1[3], m21[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float delta = s[c] - mean[c];
      mean1[c] = mean[c] + delta / k1;
      m21[c] = fmaf(delta, s[c] - mean1[c], m2[c]);
    }
    const float y = fmaf(s[2], 0.11f, fmaf(s[0], 0.3f, s[1] * 0.59f));
    const float delta_y = y - mean_y;
    const float mean_y1 = mean_y + delta_y / k1;
    const float m2_y1 = fmaf(delta_y, y - mean_y1, m2_y);
    if (act) {
      count = k1;
      mean_y = mean_y1;
      m2_y = m2_y1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        mean[c] = mean1[c];
        m2[c] = m21[c];
      }
      if (a.sample_alpha != nullptr) alpha = a.sample_alpha[i];
    }
    a.o_count[i] = count;
    a.o_mean_y[i] = mean_y;
    a.o_m2_y[i] = m2_y;
    a.o_alpha[i] = alpha;
    seen = count > 0.0f;
    a.act[i] = act;
    a.skip[i] = active<kPerceptual>(a, count, mean, m2, mean_y, m2_y);
  }
  __syncthreads();  // the spans are read: they take the outputs
  if (i < a.n) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sm[0][t3 + c] = mean[c];
      sm[1][t3 + c] = m2[c];
      sm[2][t3 + c] = seen ? mean[c] : s[c];
    }
  }
  __syncthreads();
  span_out(a.o_mean, sm[0], f0, nf);
  span_out(a.o_m2, sm[1], f0, nf);
  span_out(a.display, sm[2], f0, nf);
  // every thread of the warp votes, those past n with act false
  if (a.any_set != nullptr && __any_sync(0xffffffffu, act) &&
      (threadIdx.x & 31) == 0)
    *a.any_set = 1;
  if (a.any_clear != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *a.any_clear = 0;
}

}  // namespace

// state: count, mean [n, 3], m2 [n, 3], mean_y, m2_y (device floats) and
// alpha (bytes), read unless reset; sample [n, 3] device floats;
// sample_alpha device bytes or null; out_f: the new count, mean, m2,
// mean_y, m2_y and the display (device floats); out_b: the new alpha, act
// and skip (device bytes); any_set / any_clear: the batch's any-active
// flag and the next batch's, or null; perceptual: the statistics mode
extern "C" int accum_launch(const float* count, const float* mean,
                            const float* m2, const float* mean_y,
                            const float* m2_y, const uint8_t* alpha,
                            const float* sample, const uint8_t* sample_alpha,
                            float* o_count, float* o_mean, float* o_m2,
                            float* o_mean_y, float* o_m2_y, float* display,
                            uint8_t* o_alpha, uint8_t* act, uint8_t* skip,
                            int* any_set, int* any_clear, long long n,
                            int reset, float tol, float max_samples,
                            int perceptual, void* stream) {
  if (n < 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (!reset && (count == nullptr || mean == nullptr || m2 == nullptr ||
                 mean_y == nullptr || m2_y == nullptr || alpha == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0 && any_clear == nullptr) return 0;
  Args a{count,    mean,     m2,     mean_y,  m2_y,     alpha,
         sample,   sample_alpha,     o_count, o_mean,   o_m2,
         o_mean_y, o_m2_y,   o_alpha, display, act,     skip,
         any_set,  any_clear, (unsigned)n,     reset,   tol,
         max_samples};
  const unsigned blocks =
      n == 0 ? 1u : (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (perceptual)
    accum_kernel<true><<<blocks, kThreads, 0, st>>>(a);
  else
    accum_kernel<false><<<blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
