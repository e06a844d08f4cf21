// 2-D homogeneous triangle setup (Olano-Greer): per triangle, the MVP and
// viewport fold of its three vertices, then from the adjugate of the folded
// clip matrix the 3 edge planes, the screen-z plane, 3A attribute planes and
// the perspective denominator plane; plus the id, the binning bbox (with the
// EPS_W near guard) and the valid flag.
//
// Replaces: ascii_renderer_tpu/ops/setup2dh.py:_setup_kernel (Pallas, TPU),
// called through setup_2dh_fused.
//
// What bounds it on the H100: device memory traffic. Each triangle reads
// 9 + 3A floats and writes 16 + 3A + 3 + 5 floats (about 0.25 KB at A = 6)
// for roughly 300 flops, far below the card's flop-to-byte ratio.
// Design: one thread per triangle, channel-major [C, Tp] input and output,
// so neighbouring threads touch neighbouring addresses on every load and
// store (fully coalesced); all intermediates stay in registers. The MVP is
// a by-value kernel argument (constant bank), so no extra load.
//
// Exactness: every chain below keeps the JAX op order (setup2dh.py:55-155)
// and fuses a product into the add it feeds exactly where the reference's
// compiler does (explicit fmaf; the build uses -fmad=false so nothing else
// fuses, and IEEE division), so the output equals the plain-torch version
// (ops/setup2dh.py:setup_channels) and the JAX setup bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEpsW = 1e-4f;
constexpr float kInvEps = 10000.0f;  // float32(1 / 1e-4)

struct Mat4 {
  float m[16];
};

// torch.minimum / torch.maximum semantics: a NaN operand propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

// a*b - c*d with the left product fused
__device__ __forceinline__ float diff2(float a, float b, float c, float d) {
  return fmaf(a, b, -(c * d));
}
// a0*b0 + a1*b1 + a2*b2 as fma(a2, b2, fma(a0, b0, a1*b1))
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return fmaf(a2, b2, fmaf(a0, b0, a1 * b1));
}

__global__ void setup2dh_kernel(const float* __restrict__ pos9,
                                const float* __restrict__ attrs, Mat4 M,
                                float* __restrict__ out, int T, int Tp,
                                int A, float half_cols, float half_rows) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tp) return;
  const bool live = t < T;  // pad slots are all-zero triangles
  const float* m = M.m;

  float vx[3], vy[3], vz[3], vw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float px = live ? pos9[(3 * i + 0) * T + t] : 0.0f;
    const float py = live ? pos9[(3 * i + 1) * T + t] : 0.0f;
    const float pz = live ? pos9[(3 * i + 2) * T + t] : 0.0f;
    // r0*px + r1*py + r2*pz + r3: the first two products fuse
    const float xc = fmaf(m[2], pz, fmaf(m[0], px, m[1] * py)) + m[3];
    const float yc = fmaf(m[6], pz, fmaf(m[4], px, m[5] * py)) + m[7];
    const float zc = fmaf(m[10], pz, fmaf(m[8], px, m[9] * py)) + m[11];
    const float wc = fmaf(m[14], pz, fmaf(m[12], px, m[13] * py)) + m[15];
    vx[i] = (xc + wc) * half_cols;
    vy[i] = (wc - yc) * half_rows;
    vz[i] = (zc + wc) * 0.5f;
    vw[i] = wc;
  }

  // e_k = cross3(s1, s2) for (s1, s2) = (b, c), (c, a), (a, b)
  float e[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int p = (k + 1) % 3, q = (k + 2) % 3;
    e[k][0] = diff2(vy[p], vw[q], vw[p], vy[q]);
    e[k][1] = diff2(vw[p], vx[q], vx[p], vw[q]);
    e[k][2] = diff2(vx[p], vy[q], vy[p], vx[q]);
  }
  const float det = dot3(vx[0], e[0][0], vy[0], e[0][1], vw[0], e[0][2]);
  const float det_safe = fabsf(det) < 1e-30f ? -1e-30f : det;
  const float ninv = 1.0f / det_safe;  // negative for front faces
  const float inv = -ninv;             // positive scale: inside <=> <= 0

  size_t ch = 0;
  auto put = [&](float v) { out[ch * (size_t)Tp + t] = v; ++ch; };
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    put(e[k][0] * inv);
    put(e[k][1] * inv);
    put(e[k][2] * inv);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    put(dot3(vz[0], e[0][j], vz[1], e[1][j], vz[2], e[2][j]) * ninv);
  put((float)t);
  put(0.0f);
  put(0.0f);
  put(0.0f);
  for (int jj = 0; jj < A; ++jj) {
    const float aa = live ? attrs[(size_t)jj * T + t] : 0.0f;
    const float ab = live ? attrs[(size_t)(A + jj) * T + t] : 0.0f;
    const float ac = live ? attrs[(size_t)(2 * A + jj) * T + t] : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      put(dot3(aa, e[0][c], ab, e[1][c], ac, e[2][c]) * ninv);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) put((e[0][c] + e[1][c] + e[2][c]) * ninv);

  // ---- binning bbox over projectable candidates ----
  float x0 = 1e9f, x1 = -1e9f, y0 = 1e9f, y1 = -1e9f;
  bool front[3];
  float iw3[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    front[i] = vw[i] > kEpsW;
    iw3[i] = 1.0f / (front[i] ? vw[i] : 1.0f);
    if (front[i]) {
      const float xq = vx[i] * iw3[i], yq = vy[i] * iw3[i];
      x0 = min_nan(x0, xq);
      x1 = max_nan(x1, xq);
      y0 = min_nan(y0, yq);
      y1 = max_nan(y1, yq);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {  // edges (a,b), (b,c), (c,a)
    const int j = (i + 1) % 3;
    const bool crossing = front[i] != front[j];
    const float tt = (vw[i] - kEpsW) / (crossing ? vw[i] - vw[j] : 1.0f);
    if (crossing) {
      const float xq = fmaf(tt, vx[j] - vx[i], vx[i]) * kInvEps;
      const float yq = fmaf(tt, vy[j] - vy[i], vy[i]) * kInvEps;
      x0 = min_nan(x0, xq);
      x1 = max_nan(x1, xq);
      y0 = min_nan(y0, yq);
      y1 = max_nan(y1, yq);
    }
  }
  put(x0);
  put(x1);
  put(y0);
  put(y1);

  // ---- validity ----
  const bool all_front = front[0] && front[1] && front[2];
  const float a2h = det * iw3[0] * iw3[1] * iw3[2];
  const float sz0 = vz[0] * iw3[0], sz1 = vz[1] * iw3[1], sz2 = vz[2] * iw3[2];
  const float szmin = min_nan(min_nan(sz0, sz1), sz2);
  const float szmax = max_nan(max_nan(sz0, sz1), sz2);
  const bool valid_front = (a2h < 0.0f) && (fabsf(a2h) > 1e-12f) &&
                           (szmax >= 0.0f) && (szmin <= 1.0f);
  const bool valid_cross = det < -1e-20f;
  put((all_front ? valid_front : valid_cross) ? 1.0f : 0.0f);
}

}  // namespace

extern "C" int setup2dh_launch(const float* pos9, const float* attrs,
                               const float* mvp16, float* out, int T, int Tp,
                               int A, int rows, int cols, void* stream) {
  Mat4 M;
  for (int i = 0; i < 16; ++i) M.m[i] = mvp16[i];
  const int threads = 256;
  const int blocks = (Tp + threads - 1) / threads;
  setup2dh_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pos9, attrs, M, out, T, Tp, A, 0.5f * (float)cols, 0.5f * (float)rows);
  return (int)cudaGetLastError();
}
