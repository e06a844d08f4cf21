// 2-D homogeneous triangle setup (Olano-Greer): per triangle, the MVP and
// viewport fold of its three vertices, then from the adjugate of the folded
// clip matrix the 3 edge planes, the screen-z plane, 3A attribute planes and
// the perspective denominator plane; plus the id, the binning bbox (with the
// EPS_W near guard) and the valid flag. Two kernels share that math
// (setup_triangle), so they cannot drift apart:
//
//   setup2dh_kernel         channel-major [C, Tp] output.  Replaces
//                           ascii_renderer_tpu/ops/setup2dh.py:_setup_kernel
//                           (B2), called through setup_2dh_fused.
//   setup2dh_packed_kernel  the bbox channel-major [5, Tp], the walk entry
//                           rows [Tp, 16] and the shade rows [Tp, tw]
//                           row-major: B2 with B3's transpose fused.
//                           Replaces :_setup_kernel_packed (B10), called
//                           through setup_2dh_fused_packed.
//
// What bounds them on the H100: device memory traffic. Each triangle reads
// 9 + 3A floats and writes 16 + 3A + 3 + 5 floats (about 0.25 KB at A = 6)
// for roughly 300 flops, far below the card's flop-to-byte ratio.
// Design: one thread per triangle, all intermediates in registers, the MVP
// a by-value kernel argument (constant bank). Channel-major loads and
// stores put neighbouring threads on neighbouring addresses (coalesced).
// The packed kernel stages its block's rows in shared memory and writes
// them out with consecutive float4 stores: a thread storing its own rows
// (64 and 96-128 bytes apart across a warp) made B10 no faster than B2 +
// B3 (PERF.md). The TPU kernel transposed through an MXU identity dot,
// which turns -0.0 into +0.0; these copies keep every bit.
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
constexpr int kMaxA = 9;             // attributes: normal, color, world pos
constexpr int kMaxTw = 32;           // shade row width >= 3 * kMaxA + 3

struct Mat4 {
  float m[16];
};

// Where setup_triangle puts one triangle's outputs: the 16 walk-entry
// channels (e0a..e2c, zx, zy, zc, id, three zeros), the attribute planes
// p{j}{a,b,c} (j < 3A), the denominator plane and the bbox + valid flag.
// B2 stores each value the moment it is computed, straight to its
// channel-major row, so no value waits in a register.
struct ChannelMajorOut {
  float* col;  // out + t: channel c of this triangle at col[c * Tp]
  int Tp, A;
  __device__ void walk(int c, float v) { col[(size_t)c * Tp] = v; }
  __device__ void attr(int j, float v) { col[(size_t)(16 + j) * Tp] = v; }
  __device__ void dn(int c, float v) {
    col[(size_t)(16 + 3 * A + c) * Tp] = v;
  }
  __device__ void bbox(int c, float v) {
    col[(size_t)(19 + 3 * A + c) * Tp] = v;
  }
};
// B10 keeps the triangle's rows in registers for its float4 stores.
struct RowsOut {
  float walk_[16], attr_[3 * kMaxA], dn_[3], bbox_[5];
  __device__ void walk(int c, float v) { walk_[c] = v; }
  __device__ void attr(int j, float v) { attr_[j] = v; }
  __device__ void dn(int c, float v) { dn_[c] = v; }
  __device__ void bbox(int c, float v) { bbox_[c] = v; }
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

template <class Out>
__device__ __forceinline__ void setup_triangle(
    const float* __restrict__ pos9, const float* __restrict__ attrs,
    const Mat4& M, int t, int T, int A, float half_cols, float half_rows,
    Out& o) {
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

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.walk(3 * k, e[k][0] * inv);
    o.walk(3 * k + 1, e[k][1] * inv);
    o.walk(3 * k + 2, e[k][2] * inv);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    o.walk(9 + j,
           dot3(vz[0], e[0][j], vz[1], e[1][j], vz[2], e[2][j]) * ninv);
  o.walk(12, (float)t);
  o.walk(13, 0.0f);
  o.walk(14, 0.0f);
  o.walk(15, 0.0f);
#pragma unroll
  for (int jj = 0; jj < kMaxA; ++jj) {
    if (jj < A) {
      const float aa = live ? attrs[(size_t)jj * T + t] : 0.0f;
      const float ab = live ? attrs[(size_t)(A + jj) * T + t] : 0.0f;
      const float ac = live ? attrs[(size_t)(2 * A + jj) * T + t] : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        o.attr(3 * jj + c,
               dot3(aa, e[0][c], ab, e[1][c], ac, e[2][c]) * ninv);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) o.dn(c, (e[0][c] + e[1][c] + e[2][c]) * ninv);

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
  o.bbox(0, x0);
  o.bbox(1, x1);
  o.bbox(2, y0);
  o.bbox(3, y1);

  // ---- validity ----
  const bool all_front = front[0] && front[1] && front[2];
  const float a2h = det * iw3[0] * iw3[1] * iw3[2];
  const float sz0 = vz[0] * iw3[0], sz1 = vz[1] * iw3[1], sz2 = vz[2] * iw3[2];
  const float szmin = min_nan(min_nan(sz0, sz1), sz2);
  const float szmax = max_nan(max_nan(sz0, sz1), sz2);
  const bool valid_front = (a2h < 0.0f) && (fabsf(a2h) > 1e-12f) &&
                           (szmax >= 0.0f) && (szmin <= 1.0f);
  const bool valid_cross = det < -1e-20f;
  o.bbox(4, (all_front ? valid_front : valid_cross) ? 1.0f : 0.0f);
}

// out [16 + 3A + 3 + 5, Tp]: walk channels, attribute planes, denominator,
// bbox + valid
__global__ void setup2dh_kernel(const float* __restrict__ pos9,
                                const float* __restrict__ attrs, Mat4 M,
                                float* __restrict__ out, int T, int Tp,
                                int A, float half_cols, float half_rows) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tp) return;
  ChannelMajorOut o{out + t, Tp, A};
  setup_triangle(pos9, attrs, M, t, T, A, half_cols, half_rows, o);
}

constexpr int kPackedThreads = 128;  // triangles per block of B10

// bbox [5, Tp] channel-major; src16 [Tp, 16] and table [Tp, tw] row-major
// (shade planes, then the denominator, then zeros up to tw)
__global__ void __launch_bounds__(kPackedThreads)
setup2dh_packed_kernel(const float* __restrict__ pos9,
                       const float* __restrict__ attrs, Mat4 M,
                       float* __restrict__ bbox, float* __restrict__ src16,
                       float* __restrict__ table, int T, int Tp, int A,
                       int tw, float half_cols, float half_rows) {
  // the block's rows, laid out as in device memory (8 KB + up to 16 KB)
  __shared__ float4 s_src[kPackedThreads * 4];
  __shared__ float4 s_tbl[kPackedThreads * kMaxTw / 4];
  const int t0 = blockIdx.x * kPackedThreads;
  const int t = t0 + threadIdx.x;
  const int q4 = tw / 4;  // float4s per shade row
  if (t < Tp) {
    RowsOut o;
    setup_triangle(pos9, attrs, M, t, T, A, half_cols, half_rows, o);
#pragma unroll
    for (int c = 0; c < 5; ++c) bbox[(size_t)c * Tp + t] = o.bbox_[c];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      s_src[threadIdx.x * 4 + q] =
          make_float4(o.walk_[4 * q], o.walk_[4 * q + 1], o.walk_[4 * q + 2],
                      o.walk_[4 * q + 3]);
    float row[kMaxTw];
#pragma unroll
    for (int j = 0; j < kMaxTw; ++j) {
      const int d = j - 3 * A;  // index into the denominator plane
      row[j] = j < 3 * A ? o.attr_[j < 3 * kMaxA ? j : 0]
               : d == 0  ? o.dn_[0]
               : d == 1  ? o.dn_[1]
               : d == 2  ? o.dn_[2]
                         : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kMaxTw / 4; ++q)
      if (q < q4)
        s_tbl[threadIdx.x * q4 + q] = make_float4(
            row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
  }
  __syncthreads();
  // the block's rows are contiguous in src16 and in table
  const int n = min(kPackedThreads, Tp - t0);
  float4* gsrc = reinterpret_cast<float4*>(src16 + (size_t)t0 * 16);
  for (int i = threadIdx.x; i < n * 4; i += kPackedThreads) gsrc[i] = s_src[i];
  float4* gtbl = reinterpret_cast<float4*>(table + (size_t)t0 * tw);
  for (int i = threadIdx.x; i < n * q4; i += kPackedThreads)
    gtbl[i] = s_tbl[i];
}

Mat4 to_mat4(const float* mvp16) {
  Mat4 M;
  for (int i = 0; i < 16; ++i) M.m[i] = mvp16[i];
  return M;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int setup2dh_launch(const float* pos9, const float* attrs,
                               const float* mvp16, float* out, int T, int Tp,
                               int A, int rows, int cols, void* stream) {
  setup2dh_kernel<<<(Tp + kThreads - 1) / kThreads, kThreads, 0,
                    (cudaStream_t)stream>>>(
      pos9, attrs, to_mat4(mvp16), out, T, Tp, A, 0.5f * (float)cols,
      0.5f * (float)rows);
  return (int)cudaGetLastError();
}

extern "C" int setup2dh_packed_launch(const float* pos9, const float* attrs,
                                      const float* mvp16, float* bbox,
                                      float* src16, float* table, int T,
                                      int Tp, int A, int tw, int rows,
                                      int cols, void* stream) {
  setup2dh_packed_kernel<<<(Tp + kPackedThreads - 1) / kPackedThreads,
                           kPackedThreads, 0, (cudaStream_t)stream>>>(
      pos9, attrs, to_mat4(mvp16), bbox, src16, table, T, Tp, A, tw,
      0.5f * (float)cols, 0.5f * (float)rows);
  return (int)cudaGetLastError();
}
